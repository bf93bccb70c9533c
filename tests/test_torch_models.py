"""The port's static model zoo through its public API (``update_model`` on a
multi-chunk drifting stream, then ``posterior_z``) against
``repro.pgm_models`` on the CPU: the whole slice, end to end.

Both models start from the reference's initial posterior (carried over
with ``repro_torch.convert``: ``jax.random`` cannot be reproduced) and run
``tol = 0`` so the sweep counts agree.  Tolerance: posteriors rtol/atol
2e-3, ELBO rtol 1e-4 and responsibilities atol 1e-3 — float32 sums in
another order, compounded over 6 batches x 5 sweeps."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_params_close, trees_equal  # noqa: E402
from repro import pgm_models as jpm  # noqa: E402
from repro.data import stream as jstream  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import pgm_models as tpm  # noqa: E402
from repro_torch.data import stream as tstream  # noqa: E402

RTOL = ATOL = 2e-3


def _drifting(n_chunks=6, n=200, f=4, fd=0, seed=0):
    """Chunks of a 2-component mixture whose means jump at half the
    stream; fd discrete card-3 leaves follow the component."""
    g = np.random.default_rng(seed)
    mu = g.uniform(-3, 3, (2, f)).astype(np.float32)
    tables = g.dirichlet(np.ones(3), size=(2, fd))
    chunks = []
    for t in range(n_chunks):
        z = g.integers(0, 2, n)
        shift = 5.0 if t >= n_chunks // 2 else 0.0
        xc = (mu[z] + shift + g.standard_normal((n, f))).astype(np.float32)
        xd = np.stack([[g.choice(3, p=tables[zi, j]) for j in range(fd)]
                       for zi in z]).astype(np.int32).reshape(n, fd)
        chunks.append((xc, xd))
    return chunks


def _attrs(mod, f, fd=0):
    return ([mod.Attribute(f"X{i}", mod.REAL) for i in range(f)]
            + [mod.Attribute(f"D{j}", mod.FINITE, 3) for j in range(fd)])


def _streams(chunks, f, fd=0):
    out = []
    for mod in (jstream, tstream):
        out.append(mod.DataStream(_attrs(mod, f, fd),
                                  lambda: iter(chunks),
                                  n_instances=sum(len(c[0]) for c in chunks)))
    return out


def _pair(name, f, fd=0, **kw):
    ref = getattr(jpm, name)(_attrs(jstream, f, fd), seed=0, **kw)
    port = getattr(tpm, name)(_attrs(tstream, f, fd), device="cpu", **kw)
    port.posterior = convert.plate_params_from_numpy(ref.posterior, "cpu")
    return ref, port


def _query(ref, port, xc, xd):
    jz = np.asarray(ref.posterior_z(jstream.Batch(
        xc, xd, np.ones(len(xc), np.float32))))
    tz = port.posterior_z(tstream.Batch(xc, xd,
                                        np.ones(len(xc), np.float32)))
    np.testing.assert_allclose(tz.numpy(), jz, atol=1e-3)
    return tz


@pytest.mark.parametrize("name,kw,fd", [
    ("GaussianMixture", dict(n_states=2), 0),
    ("NaiveBayes", dict(n_states=2), 2),
    ("FactorAnalysis", dict(n_hidden=2), 0),
    ("MixtureOfFA", dict(n_states=2, n_hidden=2), 0),
])
def test_update_model_on_drifting_stream_matches_reference(name, kw, fd):
    chunks = _drifting(fd=fd, seed=1)
    js, ts = _streams(chunks, 4, fd)
    ref, port = _pair(name, 4, fd, **kw)
    assert dataclasses.astuple(port.spec) == dataclasses.astuple(ref.spec)
    e_ref = ref.update_model(js, sweeps=5, tol=0.0)
    e_port = port.update_model(ts, sweeps=5, tol=0.0)
    np.testing.assert_allclose(e_port, e_ref, rtol=1e-4)
    assert port.n_seen == ref.n_seen == 1200
    assert_params_close(ref.posterior, port.posterior, RTOL, ATOL, name)
    assert port.last_stream_info["drifted"].shape == (6,)
    xc, xd = chunks[-1]
    z = _query(ref, port, xc, xd)
    assert z.shape == (200, port.cp.layout.K)


def test_gmm_drift_fires_at_the_switch():
    chunks = _drifting(n_chunks=8, n=300, seed=2)
    _, ts = _streams(chunks, 4)
    m = tpm.GaussianMixture(_attrs(tstream, 4), n_states=2, device="cpu")
    m.update_model(ts, sweeps=5, tol=0.0)
    flags = m.last_stream_info["drifted"].tolist()
    assert flags.index(True) in (4, 5), flags


def test_ragged_stream_uses_per_batch_updates():
    chunks = _drifting(n_chunks=3, n=200, seed=3)
    chunks[1] = (chunks[1][0][:150], chunks[1][1][:150])
    js, ts = _streams(chunks, 4)
    ref, port = _pair("GaussianMixture", 4, n_states=2)
    e_ref = ref.update_model(js, sweeps=5, tol=0.0)
    e_port = port.update_model(ts, sweeps=5, tol=0.0)
    np.testing.assert_allclose(e_port, e_ref, rtol=1e-4)
    assert port.n_seen == ref.n_seen == 550
    assert_params_close(ref.posterior, port.posterior, RTOL, ATOL)


def test_stream_window_is_bit_identical():
    chunks = _drifting(seed=4)
    a = tpm.GaussianMixture(_attrs(tstream, 4), n_states=2, device="cpu")
    b = tpm.GaussianMixture(_attrs(tstream, 4), n_states=2, device="cpu")
    ea = a.update_model(_streams(chunks, 4)[1], sweeps=4, tol=0.0)
    eb = b.update_model(_streams(chunks, 4)[1], sweeps=4, tol=0.0,
                        stream_window=4)
    assert ea == eb and trees_equal(a.posterior, b.posterior)


def test_repeated_batch_updates_follow_eq3():
    g = np.random.default_rng(5)
    x1 = g.standard_normal((300, 3)).astype(np.float32)
    x2 = (g.standard_normal((300, 3)) + 2).astype(np.float32)
    ref, port = _pair("GaussianMixture", 3, n_states=2)
    for x in (x1, x2):
        np.testing.assert_allclose(port.update_model(x, sweeps=6, tol=0.0),
                                   ref.update_model(x, sweeps=6, tol=0.0),
                                   rtol=1e-4)
    assert port.n_seen == 600
    assert_params_close(ref.posterior, port.posterior, RTOL, ATOL)


def test_supervised_naive_bayes_classifier():
    g = np.random.default_rng(6)
    y = g.integers(0, 3, 400)
    xc = (y[:, None] * 2.0 + g.standard_normal((400, 3))).astype(np.float32)
    xd = np.stack([g.integers(0, 3, 400), y], 1).astype(np.int32)
    mk = lambda mod: ([mod.Attribute(f"G{i}", mod.REAL) for i in range(3)]
                      + [mod.Attribute("D0", mod.FINITE, 3),
                         mod.Attribute("Class", mod.FINITE, 3)])
    ref = jpm.NaiveBayesClassifier(mk(jstream), seed=0)
    port = tpm.NaiveBayesClassifier(mk(tstream), device="cpu")
    port.posterior = convert.plate_params_from_numpy(ref.posterior, "cpu")
    jb = jstream.Batch(xc, xd, np.ones(400, np.float32))
    tb = tstream.Batch(xc, xd, np.ones(400, np.float32))
    np.testing.assert_allclose(port.update_model(tb), ref.update_model(jb),
                               rtol=1e-4)
    assert_params_close(ref.posterior, port.posterior, 1e-4, 1e-4)
    np.testing.assert_array_equal(port.predict(tb).numpy(),
                                  np.asarray(ref.predict(jb)))


def test_regression_models_match_reference():
    g = np.random.default_rng(7)
    x = g.standard_normal((400, 3)).astype(np.float32)
    x[:, 2] = 0.7 + x[:, 0] - 2 * x[:, 1] + 0.1 * g.standard_normal(400)
    for name in ("BayesianLinearRegression", "MultivariateGaussian"):
        ref, port = _pair(name, 3)
        np.testing.assert_allclose(port.update_model(x, sweeps=3, tol=0.0),
                                   ref.update_model(x, sweeps=3, tol=0.0),
                                   rtol=1e-4)
        assert_params_close(ref.posterior, port.posterior, RTOL, ATOL, name)
    np.testing.assert_allclose(port.joint_mean(), ref.joint_mean(), atol=1e-3)
    blr_ref, blr = _pair("BayesianLinearRegression", 3)
    blr_ref.update_model(x, sweeps=3, tol=0.0)
    blr.update_model(x, sweeps=3, tol=0.0)
    np.testing.assert_allclose(blr.coefficients(), blr_ref.coefficients(),
                               atol=1e-3)
    np.testing.assert_allclose(blr.coefficients(), [0.7, 1.0, -2.0],
                               atol=0.1)


def test_custom_global_local_model_dense_latent_block():
    g = np.random.default_rng(8)
    x = g.standard_normal((300, 3)).astype(np.float32)
    ref, port = _pair("CustomGlobalLocalModel", 3, n_states=2)
    np.testing.assert_allclose(port.update_model(x, sweeps=4, tol=0.0),
                               ref.update_model(x, sweeps=4, tol=0.0),
                               rtol=1e-4)
    assert not port.cp.hh_shared
    assert_params_close(ref.posterior, port.posterior, RTOL, ATOL)
    _query(ref, port, x, np.zeros((300, 0), np.int32))


def test_model_without_device_needs_a_card():
    attrs = _attrs(tstream, 2)
    if torch.cuda.is_available():
        m = tpm.GaussianMixture(attrs)
        assert m.device.type == "cuda" and m.backend == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpm.GaussianMixture(attrs)
    m = tpm.GaussianMixture(attrs, device="cpu")
    assert m.backend == "einsum"
    with pytest.raises(ValueError, match="CUDA"):
        tpm.GaussianMixture(attrs, device="cpu", backend="cuda")
