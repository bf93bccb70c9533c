"""``repro_torch.core.streaming`` and ``repro_torch.data.stream`` against the
reference on the CPU, plus the port's own bit-identity contracts:
quarantine skip == never-seen, and the ``stream_update`` loop ==
``stream_fit``.

Tolerances against the reference: per-batch ELBO rtol 1e-4 and final
posterior rtol/atol 1e-3 (float32 sums in another order, compounded over
the batches and sweeps); drift and quarantine flags exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import (T, assert_params_close, plates,  # noqa: E402
                           trees_equal)
from repro.core import streaming as jst  # noqa: E402
from repro.data import stream as jstream  # noqa: E402
from repro.data.synthetic import drift_stream  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import streaming as tst  # noqa: E402
from repro_torch.data import stream as tstream  # noqa: E402

SPEC = dict(n_features=3, latent_card=2)
KW = dict(sweeps=6, tol=0.0, drift_threshold=3.0)


@pytest.fixture(scope="module")
def setup():
    stream, _ = drift_stream(750, 3, seed=8)       # shift at batch 3 of 6
    xcs = np.stack([np.asarray(b.xc) for b in stream.batches(250)])
    xds = np.zeros(xcs.shape[:2] + (0,), np.int32)
    return plates(0, None, **SPEC) + (xcs, xds)


def _port_fit(setup, xcs, **kw):
    _, _, _, tcp, tprior, tinit, _, xds = setup
    return tst.stream_fit(tcp, tprior, tst.stream_init(tprior, tinit),
                          xcs, xds[:len(xcs)], **{**KW, **kw})


def test_stream_fit_matches_reference_on_drift(setup):
    jcp, jprior, jinit, _, _, _, xcs, xds = setup
    js, jinfo = jst.stream_fit(jcp, jprior, jst.stream_init(jprior, jinit),
                               jnp.asarray(xcs), jnp.asarray(xds), **KW)
    ts, tinfo = _port_fit(setup, xcs)
    assert tinfo["drifted"].tolist() == np.asarray(jinfo["drifted"]).tolist()
    assert any(tinfo["drifted"].tolist())
    assert tinfo["quarantined"].tolist() == np.asarray(
        jinfo["quarantined"]).tolist()
    assert tinfo["sweeps"].tolist() == np.asarray(jinfo["sweeps"]).tolist()
    for k in ("elbo", "score", "n_eff", "rho"):
        np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert_params_close(js.post, ts.post, rtol=1e-3, atol=1e-3)
    assert int(ts.n_drifts) == int(js.n_drifts)
    assert float(ts.n_seen) == float(js.n_seen)


def test_stream_fit_window_is_bit_identical(setup):
    xcs = setup[6]
    full, finfo = _port_fit(setup, xcs)
    win, winfo = _port_fit(setup, xcs, window=4)       # ragged last window
    assert trees_equal(full, win)
    for k in finfo:
        assert torch.equal(finfo[k], winfo[k]), k
    with pytest.raises(ValueError, match="window"):
        _port_fit(setup, xcs, window=0)


def test_quarantine_skip_is_bit_identical_to_never_seen(setup):
    jcp, jprior, jinit, _, _, _, xcs, xds = setup
    bad = xcs.copy()
    bad[[1, 4], 7] = np.nan
    sp, info = _port_fit(setup, bad)
    keep = [0, 2, 3, 5]
    sc, _ = _port_fit(setup, xcs[keep])
    q = info["quarantined"].tolist()
    assert q == [False, True, False, False, True, False]
    assert int(sp.n_quarantined) == 2
    assert float(sp.n_seen) == float(sc.n_seen)
    assert trees_equal(sp.post, sc.post)
    assert trees_equal(sp.prior, sc.prior)
    assert trees_equal(sp.drift, sc.drift)
    for k in ("elbo", "score", "ph"):
        assert bool(torch.isfinite(info[k]).all())
    _, jinfo = jst.stream_fit(jcp, jprior, jst.stream_init(jprior, jinit),
                              jnp.asarray(bad), jnp.asarray(xds), **KW)
    assert q == np.asarray(jinfo["quarantined"]).tolist()


def test_stream_update_loop_is_bit_identical_to_stream_fit(setup):
    _, _, _, tcp, tprior, tinit, xcs, xds = setup
    bad = xcs.copy()
    bad[2, 0] = np.inf
    state = tst.stream_init(tprior, tinit)
    flags = []
    for t in range(len(bad)):
        state, info = tst.stream_update(tcp, tprior, state, *T(bad[t], xds[t]),
                                        **KW)
        flags.append(bool(info["quarantined"]))
    fit, finfo = _port_fit(setup, bad)
    assert flags == finfo["quarantined"].tolist()
    assert trees_equal(state, fit)


def test_stream_init_copies_and_mesh_is_not_ported(setup):
    _, _, _, tcp, tprior, tinit, xcs, xds = setup
    state = tst.stream_init(tprior, tinit)
    assert state.prior.reg.m.data_ptr() != tprior.reg.m.data_ptr()
    assert state.post.reg.m.data_ptr() != tinit.reg.m.data_ptr()
    with pytest.raises(TypeError, match="DeviceMesh"):
        tst.stream_update(tcp, tprior, state, *T(xcs[0], xds[0]), mesh=object())


def test_drift_update_matches_reference():
    scores = [-3.0, -2.5, -2.4, -2.45, -9.0, -8.0]
    jd, td = jst.drift_init(), tst.drift_init()
    for s in scores:
        jd, jph = jst.drift_update(jd, jnp.asarray(s, jnp.float32))
        td, tph = tst.drift_update(td, torch.tensor(s))
        np.testing.assert_allclose(float(tph), float(jph), rtol=1e-6,
                                   atol=1e-6)
    assert int(td.t) == int(jd.t)


def test_stream_state_converts_from_reference(setup):
    _, jprior, jinit = setup[:3]
    js = jst.stream_init(jprior, jinit)
    ts = convert.stream_state_from_numpy(js, "cpu")
    assert_params_close(js.post, ts.post, rtol=0, atol=0)
    assert int(ts.n_quarantined) == 0 and ts.drift.t.dtype == torch.int64


# -- DataStream ----------------------------------------------------------------


def _attrs(mod):
    return [mod.Attribute("a", mod.REAL), mod.Attribute("b", mod.REAL),
            mod.Attribute("c", mod.FINITE, 3)]


def _chunks():
    g = np.random.default_rng(0)
    xc = g.standard_normal((40, 2)).astype(np.float32)
    xc[[3, 17], 1] = np.nan
    xd = g.integers(0, 3, (40, 1)).astype(np.int32)
    xd[[5, 30], 0] = [3, -1]
    return [(xc[:25], xd[:25]), (xc[25:], xd[25:])]


def _stream(mod, validate):
    parts = _chunks()
    return mod.DataStream(_attrs(mod), lambda: iter(parts), n_instances=40,
                          validate=validate)


def test_validate_quarantines_like_reference():
    ts, js = _stream(tstream, True), _stream(jstream, True)
    tc, jc = list(ts.chunks()), list(js.chunks())
    assert ts.chunk_quarantine == js.chunk_quarantine == [3, 1]
    assert ts.quarantined == js.quarantined == 4
    for (a, b), (c, d) in zip(tc, jc):
        np.testing.assert_array_equal(a, np.asarray(c))
        np.testing.assert_array_equal(b, np.asarray(d))


def test_batches_and_collect_like_reference():
    ts, js = _stream(tstream, False), _stream(jstream, False)
    tb, jb = list(ts.batches(16)), list(js.batches(16))
    assert len(tb) == len(jb) == 3
    for a, b in zip(tb, jb):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, np.asarray(y))
    tcol = ts.collect(limit=30)
    np.testing.assert_array_equal(tcol.xc, np.asarray(js.collect(limit=30).xc))
    assert tcol.xc.shape == (30, 2)


def test_concat_checks_schema():
    a = tstream.DataStream.from_arrays(_attrs(tstream)[:2],
                                       np.zeros((4, 2), np.float32))
    b = tstream.DataStream.from_arrays([tstream.Attribute("x", tstream.REAL)],
                                       np.zeros((4, 1), np.float32))
    with pytest.raises(ValueError, match="schema"):
        tstream.DataStream.concat([a, b])
    both = tstream.DataStream.concat([a, a])
    assert both.n_instances == 8 and len(list(both.chunks())) == 2
