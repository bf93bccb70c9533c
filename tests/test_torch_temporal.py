"""The port's temporal models (``repro_torch.pgm_models.dynamic``,
``core.factored_frontier``, ``kernels.clg_stats.clg_seq_suffstats``, the
sequence generators and ``PGMQueryEngine(mode="temporal")``) against the
JAX package on the same numpy inputs, on the CPU.

The reference draws its initial emission means, fHMM means and LDS / SLDS
matrices with ``jax.random``; the port cannot reproduce those draws, so
every fit starts the port from the reference's state (``convert``).

Tolerances.  Recursions and suff-stats agree to float32 rounding: 1e-5
(beliefs, gammas, xi) and rtol 1e-4 (moments, ELBOs).  Fitted models carry
those differences through several sweeps: ELBO rtol 1e-4, emission means
and LDS / SLDS parameters atol 1e-3 (fHMM means 2e-3), as
``tests/test_temporal.py`` holds the reference's own fused and unfused
fits.  The reference's fits run ``fused=True`` (its own tests hold its
``fused=False`` to it); the port runs both.  Within the port, the held
sweep loop and the host loop with ``break`` adopt the same sweeps, so their
states are the same bits, and a quarantined batch leaves the stream's state
the same bits as a stream that never saw it.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import factored_frontier as jff  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.data.stream import DynamicDataStream as JStream  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.pgm_models import dynamic as jdyn  # noqa: E402
from repro.serve.engine import PGMQueryEngine as JQE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import factored_frontier as tff  # noqa: E402
from repro_torch.core.streaming import tree_leaves  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.data.stream import (DynamicDataStream,  # noqa: E402
                                     SequenceBatch)
from repro_torch.kernels import clg_stats  # noqa: E402
from repro_torch.pgm_models import dynamic as tdyn  # noqa: E402
from repro_torch.serve.engine import PGMQueryEngine  # noqa: E402

torch.set_num_threads(1)

HMM_FAMILY = ("HiddenMarkovModel", "AutoRegressiveHMM", "InputOutputHMM",
              "DynamicNaiveBayes")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, exp, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(_np(got), _np(exp), atol=atol, rtol=rtol,
                               err_msg=msg)


def _same_bits(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# data: the generators and the sequence stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("hmm_sequences", dict(s=5, t=7, states=3, f=2, seed=4)),
    ("lds_sequences", dict(s=4, t=6, dim_h=2, f=3, seed=5)),
    ("hmm_stream", dict(n_batches=3, s=4, t=5, states=2, f=2, seed=6)),
    ("slds_stream", dict(n_batches=3, s=4, t=6, dim_h=2, f=3, seed=7)),
])
def test_generators_match_reference(name, kw):
    """Numpy-only generators: the same arrays, bit for bit."""
    ref, got = getattr(jsyn, name)(**kw), getattr(tsyn, name)(**kw)

    def arrays(out):
        for x in out:
            if isinstance(x, list):
                for s in x:
                    yield from arrays([s])
            elif hasattr(x, "xc"):
                yield np.asarray(x.xc)
                yield np.asarray(x.mask)
            elif isinstance(x, np.ndarray):
                yield x

    ra, ga = list(arrays(ref)), list(arrays(got))
    assert len(ra) == len(ga) > 0
    for a, b in zip(ra, ga):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_dynamic_stream_batches_pad_the_tail():
    g = np.random.default_rng(0)
    xc = g.standard_normal((7, 4, 2)).astype(np.float32)
    mask = (g.random((7, 4)) > 0.3).astype(np.float32)
    ours = list(DynamicDataStream([], xc, mask=mask).batches(3))
    ref = list(JStream([], xc, mask=mask).batches(3))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert isinstance(a, SequenceBatch)
        for x, y in zip(a, b):
            assert np.array_equal(x, np.asarray(y))
    assert ours[-1].mask[1:].sum() == 0.0


# ---------------------------------------------------------------------------
# masked forward-backward and the factored frontier
# ---------------------------------------------------------------------------


def _fb_inputs(B=6, T=9, S=3, seed=0):
    g = np.random.default_rng(seed)
    li = np.log(g.dirichlet(np.ones(S))).astype(np.float32)
    lt = np.log(0.2 * g.dirichlet(np.ones(S), size=S)
                + 0.8 * np.eye(S)).astype(np.float32)
    ll = g.standard_normal((B, T, S)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, :3] = 0.0            # left padding
    mask[2, -4:] = 0.0           # right padding
    mask[3] = 0.0                # fully masked
    mask[4, [2, 5]] = 0.0        # holes
    ll[mask == 0] = np.nan       # padded values are never read
    return li, lt, ll, mask


def test_forward_backward_matches_reference():
    """Batched over sequences against the reference vmapped: gamma and xi
    within 1e-5, logZ rtol 1e-5; left padding seeds from the initial
    distribution, a fully masked sequence has logZ 0 and zero marginals."""
    li, lt, ll, mask = _fb_inputs()
    g, xi, lz = tdyn.forward_backward(*map(torch.from_numpy,
                                           (li, lt, ll, mask)))
    ref = jax.jit(jax.vmap(jdyn.forward_backward, in_axes=(None, None, 0, 0)))
    for got, exp, name in zip((g, xi, lz), ref(*map(jnp.asarray,
                                                    (li, lt, ll, mask))),
                              ("gamma", "xi", "logZ")):
        _close(got, exp, 1e-5, rtol=1e-5, msg=name)
    assert torch.isfinite(g).all() and torch.isfinite(xi).all()
    assert float(lz[3]) == 0.0 and float(g[3].abs().sum()) == 0.0
    assert float(xi[3].abs().sum()) == 0.0
    # the left-padded sequence behaves as its observed suffix alone
    g1, xi1, lz1 = tdyn.forward_backward(
        torch.from_numpy(li), torch.from_numpy(lt),
        torch.from_numpy(ll[1:2, 3:]), torch.ones(1, ll.shape[1] - 3))
    _close(g[1, 3:], g1[0], 1e-5)
    _close(xi[1], xi1[0], 1e-5)
    _close(lz[1], lz1[0], 0.0, rtol=1e-5)


def test_factored_frontier_matches_reference():
    """Filter, smooth and the predictive roll with masks (C = 2 chains)
    against the reference per sequence: 1e-5.  Masked steps hold the
    belief and add 0 to the bound."""
    g = np.random.default_rng(1)
    B, T, C, S = 4, 7, 2, 3
    init = g.dirichlet(np.ones(S), size=C).astype(np.float32)
    trans = g.dirichlet(np.ones(S), size=(C, S)).astype(np.float32)
    ll = g.standard_normal((B, T, C, S)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, 3] = 0.0
    mask[2, :2] = 0.0
    ll[mask == 0] = np.nan
    tm = tff.Factorial2TBN(torch.from_numpy(init), torch.from_numpy(trans))
    jm = jff.Factorial2TBN(jnp.asarray(init), jnp.asarray(trans))
    beliefs, lls = tff.factored_frontier_filter(tm, torch.from_numpy(ll),
                                                torch.from_numpy(mask))
    gam = tff.factored_frontier_smooth(tm, torch.from_numpy(ll),
                                       torch.from_numpy(mask))
    pred = tff.predictive_posterior(tm, beliefs[:, -1], 3)

    @jax.jit
    @functools.partial(jax.vmap, in_axes=(0, 0))
    def ref(ll_b, mask_b):
        rb, rl = jff.factored_frontier_filter(jm, ll_b, mask_b)
        return (rb, rl, jff.factored_frontier_smooth(jm, ll_b, mask_b),
                jff.predictive_posterior(jm, rb[-1], 3))

    for got, exp, name in zip((beliefs, lls, gam, pred),
                              ref(jnp.asarray(ll), jnp.asarray(mask)),
                              ("beliefs", "bound", "smooth", "predict")):
        _close(got, exp, 1e-5, rtol=1e-5, msg=name)
    assert torch.equal(beliefs[0, 3], beliefs[0, 2])
    assert float(lls[0, 3]) == 0.0 and torch.isfinite(gam).all()
    # the single-chain oracle
    hb, hl = tff.hmm_forward(torch.from_numpy(init[0]),
                             torch.from_numpy(trans[0]),
                             torch.from_numpy(ll[1, :, 0])[None])
    rb, rl = jff.hmm_forward(jnp.asarray(init[0]), jnp.asarray(trans[0]),
                             jnp.asarray(ll[1, :, 0]))
    _close(hb[0], rb, 1e-5)
    _close(hl[0], rl, 1e-5, rtol=1e-5)


@pytest.mark.parametrize("D", [1, 2])
def test_clg_seq_suffstats_matches_reference(D):
    """The wrapper's plain route (a CPU tensor) against the reference's
    ``clg_seq_suffstats`` (the Pallas kernel in interpret mode), with a
    ragged mask folded into r: rtol 1e-4, atol 1e-4 x max|ref|."""
    g = np.random.default_rng(2 + D)
    B, T, F, K = 5, 8, 3, 4
    d = g.standard_normal((B, T, F, D)).astype(np.float32)
    y = g.standard_normal((B, T, F)).astype(np.float32)
    r = g.dirichlet(np.ones(K), size=(B, T)).astype(np.float32)
    r[1, 5:] = 0.0
    r[3, :2] = 0.0
    before = dict(clg_stats.LAUNCHES)
    got = clg_stats.clg_seq_suffstats(*map(torch.from_numpy, (d, y, r)))
    assert clg_stats.LAUNCHES == before      # the plain route launches none
    ref = jops.clg_seq_suffstats(jnp.asarray(d), jnp.asarray(y),
                                 jnp.asarray(r))
    for a, b in zip(got, ref):
        b = np.asarray(b)
        _close(a, b, 1e-4 * np.abs(b).max(), rtol=1e-4)
    with pytest.raises(ValueError, match="B, T"):
        clg_stats.clg_seq_suffstats(*map(torch.from_numpy,
                                         (d[0], y[0], r[0])))


# ---------------------------------------------------------------------------
# the seven models against the reference
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _hmm_data():
    return tsyn.hmm_sequences(s=12, t=10, states=2, f=2, seed=3)[0]


@functools.lru_cache(maxsize=None)
def _hmm_reference(cls, backend):
    stream = _hmm_data()
    m = getattr(jdyn, cls)(stream.attributes, n_states=2, seed=0)
    init = convert.hmm_posterior_from_numpy(m.posterior, "cpu")
    e = m.update_model(JStream(stream.attributes, stream.xc),
                       sweeps=6, tol=0.0, fused=True, backend=backend)
    return init, e, m.posterior, m.state_means()


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("backend", ["einsum", "cuda"])
@pytest.mark.parametrize("cls", HMM_FAMILY)
def test_hmm_family_matches_reference(cls, backend, fused):
    """Port ``"einsum"`` against reference ``"einsum"``; the port's
    ``"cuda"`` route (``clg_seq_suffstats``, plain on a CPU tensor) against
    reference ``"pallas"`` (interpret mode).  ELBO rtol 1e-4, emission
    means atol 1e-3, Dirichlet counts rtol 1e-3."""
    init, e_ref, post_ref, sm_ref = _hmm_reference(
        cls, "einsum" if backend == "einsum" else "pallas")
    stream = _hmm_data()
    m = getattr(tdyn, cls)(stream.attributes, n_states=2, seed=0,
                           device="cpu")
    m.posterior = init
    m.backend = backend          # the cuda route runs its plain version here
    e = m.update_model(stream, sweeps=6, tol=0.0, fused=fused)
    np.testing.assert_allclose(e, e_ref, rtol=1e-4)
    _close(m.posterior.emis.m, post_ref.emis.m, 1e-3)
    _close(m.posterior.trans.alpha, post_ref.trans.alpha, 0.0, rtol=1e-3)
    _close(m.posterior.init.alpha, post_ref.init.alpha, 0.0, rtol=1e-3)
    np.testing.assert_allclose(m.state_means(), sm_ref, atol=1e-3)
    assert len(m.fit_metrics.elbo) == 6


@functools.lru_cache(maxsize=None)
def _fhmm_reference(backend):
    stream = tsyn.hmm_sequences(s=10, t=9, states=2, f=3, seed=5)[0]
    m = jdyn.FactorialHMMModel(stream.attributes, n_chains=2, n_states=2,
                               seed=0)
    init = convert.fhmm_params_from_numpy(m.means, m.log_trans, m.log_init,
                                          m.noise, "cpu")
    e = m.update_model(JStream(stream.attributes, stream.xc),
                       sweeps=5, tol=0.0, fused=True, backend=backend)
    return stream, init, e, np.asarray(m.means), np.asarray(m.gammas)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_fhmm_matches_reference(backend, fused):
    """Chain-batched Jacobi sweeps; the cuda route runs one
    ``clg_seq_suffstats`` a chain on the chain-major residuals.  ELBO rtol
    1e-4, means atol 2e-3, gammas atol 1e-3."""
    stream, init, e_ref, means, gammas = _fhmm_reference(
        "einsum" if backend == "einsum" else "pallas")
    m = tdyn.FactorialHMMModel(stream.attributes, n_chains=2, n_states=2,
                               seed=0, device="cpu")
    m.means, m.log_trans, m.log_init, m.noise = init
    m.backend = backend
    e = m.update_model(stream, sweeps=5, tol=0.0, fused=fused)
    np.testing.assert_allclose(e, e_ref, rtol=1e-4)
    _close(m.means, means, 2e-3)
    _close(m.gammas, gammas, 1e-3)


@functools.lru_cache(maxsize=None)
def _kf_reference():
    stream = tsyn.lds_sequences(s=10, t=12, dim_h=2, f=3, seed=6)[0]
    mask = np.ones(stream.xc.shape[:2], np.float32)
    mask[2, -3:] = 0.0                   # a ragged sequence
    m = jdyn.KalmanFilter(stream.attributes, n_hidden=2, seed=0)
    init = convert.lds_params_from_numpy(m.A, m.C, m.q, m.r, "cpu")
    e = m.update_model(JStream(stream.attributes, stream.xc,
                                              mask=mask),
                       sweeps=5, tol=0.0, fused=True)
    ref = {k: np.asarray(v) for k, v in m.get_model().items()}
    return stream, mask, init, e, ref, np.asarray(m.smoothed)


@pytest.mark.parametrize("fused", [True, False])
def test_kalman_matches_reference(fused):
    """Masked Kalman smoothing + EM (the numpy PCA warm start included):
    ELBO rtol 1e-4, A, C, q, r atol 1e-3, smoothed means atol 2e-3."""
    stream, mask, init, e_ref, ref, sm = _kf_reference()
    m = tdyn.KalmanFilter(stream.attributes, n_hidden=2, seed=0,
                          device="cpu")
    m.A, m.C, m.q, m.r = init
    e = m.update_model(DynamicDataStream(stream.attributes, stream.xc,
                                         mask=mask),
                       sweeps=5, tol=0.0, fused=fused)
    np.testing.assert_allclose(e, e_ref, rtol=1e-4)
    for k, v in m.get_model().items():
        _close(v, ref[k], 1e-3, msg=k)
    _close(m.smoothed, sm, 2e-3)


@functools.lru_cache(maxsize=None)
def _slds_reference():
    stream = tsyn.slds_stream(1, s=10, t=14, dim_h=2, f=3, seed=7)[0][0]
    m = jdyn.SwitchingLDS(stream.attributes, n_states=2, n_hidden=2, seed=0)
    init = convert.slds_params_from_numpy(m.A, m.C, m.q, m.r, m.log_trans,
                                          "cpu")
    e = m.update_model(JStream(stream.attributes, stream.xc),
                       sweeps=4, tol=0.0, fused=True)
    return (stream, init, e, np.asarray(m.A), np.asarray(m.C),
            np.asarray(m.q), np.asarray(m.r), np.asarray(m.resp))


@pytest.mark.parametrize("fused", [True, False])
def test_slds_matches_reference(fused):
    """Structured VB: ELBO rtol 1e-4, A, C, q, r atol 1e-3, switch
    responsibilities atol 1e-3."""
    stream, init, e_ref, A, C, q, r, resp = _slds_reference()
    m = tdyn.SwitchingLDS(stream.attributes, n_states=2, n_hidden=2, seed=0,
                          device="cpu")
    m.A, m.C, m.q, m.r, m.log_trans = init
    e = m.update_model(stream, sweeps=4, tol=0.0, fused=fused)
    np.testing.assert_allclose(e, e_ref, rtol=1e-4)
    for got, exp in ((m.A, A), (m.C, C), (m.q, q), (m.r, r)):
        _close(got, exp, 1e-3)
    _close(m.resp, resp, 1e-3)


def _ragged(stream):
    """``stream``'s sequences with a mask that left-pads, right-pads, holes
    and pads both ends of some of them (the rest full): the mask passed to
    each package's own stream."""
    s, t = stream.xc.shape[:2]
    mask = np.ones((s, t), np.float32)
    mask[1, :3] = 0.0                    # left padding
    mask[2, -4:] = 0.0                   # right padding
    mask[4, [2, 5]] = 0.0                # holes
    mask[6, :2] = mask[6, -2:] = 0.0     # both ends
    return (JStream(stream.attributes, stream.xc, mask=mask),
            DynamicDataStream(stream.attributes, stream.xc, mask=mask))


@pytest.mark.parametrize("model,backend", [
    *((cls, b) for cls in HMM_FAMILY for b in ("einsum", "cuda")),
    ("FactorialHMMModel", "einsum"), ("FactorialHMMModel", "cuda"),
    ("SwitchingLDS", "einsum"),
])
def test_ragged_fits_match_reference(model, backend):
    """The HMM family's, the fHMM's and the switching LDS's fits on
    left-padded, right-padded and holed sequences (:func:`_ragged`) from
    the reference's initial state, against the reference on the same mask
    at the full-mask tests' bars: ELBO rtol 1e-4; HMM emission means and
    state means atol 1e-3, Dirichlet counts rtol 1e-3; fHMM means atol
    2e-3, gammas 1e-3; SLDS A, C, q, r and responsibilities atol 1e-3.
    The port's ``"cuda"`` route (its plain version on a CPU tensor)
    against the reference's ``"pallas"`` (interpret mode)."""
    ref_backend = "einsum" if backend == "einsum" else "pallas"
    if model in HMM_FAMILY:
        stream = _hmm_data()
        jm = getattr(jdyn, model)(stream.attributes, n_states=2, seed=0)
        m = getattr(tdyn, model)(stream.attributes, n_states=2, seed=0,
                                 device="cpu")
        m.posterior = convert.hmm_posterior_from_numpy(jm.posterior, "cpu")
        sweeps, kw = 6, dict(backend=ref_backend)
    elif model == "FactorialHMMModel":
        stream = tsyn.hmm_sequences(s=10, t=9, states=2, f=3, seed=5)[0]
        jm = jdyn.FactorialHMMModel(stream.attributes, n_chains=2,
                                    n_states=2, seed=0)
        m = tdyn.FactorialHMMModel(stream.attributes, n_chains=2,
                                   n_states=2, seed=0, device="cpu")
        m.means, m.log_trans, m.log_init, m.noise = \
            convert.fhmm_params_from_numpy(jm.means, jm.log_trans,
                                           jm.log_init, jm.noise, "cpu")
        sweeps, kw = 5, dict(backend=ref_backend)
    else:
        stream = tsyn.slds_stream(1, s=10, t=14, dim_h=2, f=3,
                                  seed=7)[0][0]
        jm = jdyn.SwitchingLDS(stream.attributes, n_states=2, n_hidden=2,
                               seed=0)
        m = tdyn.SwitchingLDS(stream.attributes, n_states=2, n_hidden=2,
                              seed=0, device="cpu")
        m.A, m.C, m.q, m.r, m.log_trans = convert.slds_params_from_numpy(
            jm.A, jm.C, jm.q, jm.r, jm.log_trans, "cpu")
        sweeps, kw = 4, {}
    jstream, tstream = _ragged(stream)
    e_ref = jm.update_model(jstream, sweeps=sweeps, tol=0.0, fused=True,
                            **kw)
    m.backend = backend
    e = m.update_model(tstream, sweeps=sweeps, tol=0.0, fused=True)
    np.testing.assert_allclose(e, e_ref, rtol=1e-4)
    if model in HMM_FAMILY:
        _close(m.posterior.emis.m, jm.posterior.emis.m, 1e-3)
        _close(m.posterior.trans.alpha, jm.posterior.trans.alpha, 0.0,
               rtol=1e-3)
        _close(m.posterior.init.alpha, jm.posterior.init.alpha, 0.0,
               rtol=1e-3)
        np.testing.assert_allclose(m.state_means(), jm.state_means(),
                                   atol=1e-3)
    elif model == "FactorialHMMModel":
        _close(m.means, jm.means, 2e-3)
        _close(m.gammas, jm.gammas, 1e-3)
    else:
        for got, exp in ((m.A, jm.A), (m.C, jm.C), (m.q, jm.q),
                         (m.r, jm.r)):
            _close(got, exp, 1e-3)
        _close(m.resp, jm.resp, 1e-3)


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------


def _fit_pair(name, tol):
    """Two fresh models of ``name`` fitted with fused=True and fused=False
    at ``tol`` (30 sweeps at most): (held model, host-loop model, elbos)."""
    if name == "FactorialHMMModel":
        s = tsyn.hmm_sequences(s=10, t=9, states=2, f=3, seed=5)[0]
        make = lambda: tdyn.FactorialHMMModel(s.attributes, n_chains=2,
                                              n_states=2, device="cpu")
    elif name == "KalmanFilter":
        s = tsyn.lds_sequences(s=10, t=12, dim_h=2, f=3, seed=6)[0]
        make = lambda: tdyn.KalmanFilter(s.attributes, n_hidden=2,
                                         device="cpu")
    elif name == "SwitchingLDS":
        s = tsyn.slds_stream(1, s=10, t=14, dim_h=2, f=3, seed=7)[0][0]
        make = lambda: tdyn.SwitchingLDS(s.attributes, n_states=2,
                                         n_hidden=2, device="cpu")
    else:
        s = _hmm_data()
        make = lambda: getattr(tdyn, name)(s.attributes, n_states=2,
                                           device="cpu")
    a, b = make(), make()
    ea = a.update_model(s, sweeps=30, tol=tol, fused=True)
    eb = b.update_model(s, sweeps=30, tol=tol, fused=False)
    return a, b, ea, eb


_STATE = {"FactorialHMMModel": ("means", "log_trans", "gammas"),
          "KalmanFilter": ("A", "C", "q", "r", "smoothed"),
          "SwitchingLDS": ("A", "C", "q", "r", "resp", "smoothed")}


@pytest.mark.parametrize("name,tol", [
    ("HiddenMarkovModel", 1e-5), ("AutoRegressiveHMM", 1e-5),
    ("InputOutputHMM", 1e-3), ("DynamicNaiveBayes", 1e-5),
    ("FactorialHMMModel", 0.3), ("KalmanFilter", 1e-2),
    ("SwitchingLDS", 1e-3),
])
def test_fused_hold_equals_host_break(name, tol):
    """At a tolerance where the fit converges before its last sweep, the
    device hold adopts exactly the sweeps the host loop runs before its
    ``break``: the same state bits, the same last ELBO, and the held
    columns' active entries are the host loop's."""
    a, b, ea, eb = _fit_pair(name, tol)
    n = len(b.fit_metrics.elbo)
    act = _np(a.fit_metrics.active)
    assert 1 < n < 30 and int(act.sum()) == n and act[:n].all()
    assert ea == eb
    np.testing.assert_array_equal(_np(a.fit_metrics.elbo)[:n],
                                  b.fit_metrics.elbo.astype(np.float32))
    assert (_np(a.fit_metrics.delta)[n:] == 0).all()
    for field in _STATE.get(name, ("posterior",)):
        assert _same_bits(getattr(a, field), getattr(b, field)), field


def test_models_default_to_the_card():
    attrs = _hmm_data().attributes
    for make in (lambda: tdyn.HiddenMarkovModel(attrs),
                 lambda: tdyn.FactorialHMMModel(attrs),
                 lambda: tdyn.KalmanFilter(attrs),
                 lambda: tdyn.SwitchingLDS(attrs)):
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    with pytest.raises(ValueError, match="CUDA device"):
        tdyn.HiddenMarkovModel(attrs, device="cpu", backend="cuda")


# ---------------------------------------------------------------------------
# streaming: drift, tempering, quarantine
# ---------------------------------------------------------------------------


def test_seq_stream_fit_matches_reference():
    """``syn.hmm_stream`` with a regime switch at batch 3: the same drift
    flags and sweeps, the per-batch columns (elbo, score, ph) rtol 1e-4,
    the final emission means atol 1e-3."""
    kw = dict(n_batches=5, s=12, t=10, states=2, f=2, shift=8.0, seed=10)
    jb, attrs, switch = jsyn.hmm_stream(**kw)
    tb, _, _ = tsyn.hmm_stream(**kw)
    jm = jdyn.HiddenMarkovModel(attrs, n_states=2, seed=0)
    tm = tdyn.HiddenMarkovModel(attrs, n_states=2, seed=0, device="cpu")
    tm.posterior = convert.hmm_posterior_from_numpy(jm.posterior, "cpu")
    ref = jdyn.seq_stream_fit(jm, jb, sweeps=5, tol=0.0)
    got = tdyn.seq_stream_fit(tm, tb, sweeps=5, tol=0.0)
    assert sorted(got) == sorted(ref)
    for k in ("drifted", "quarantined", "sweeps", "n_eff", "rho"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]), k)
    for k in ("elbo", "score", "ph"):
        _close(got[k], ref[k], 1e-4, rtol=1e-4, msg=k)
    drifted = _np(got["drifted"])
    assert drifted.any() and not drifted[:switch].any()
    assert tm.n_drifts == jm.n_drifts and tm.n_quarantined == 0
    _close(tm.posterior.emis.m, jm.posterior.emis.m, 1e-3)


def test_seq_stream_fit_quarantine_is_never_seen():
    """A batch with NaN frames is quarantined: the stream's posterior,
    chained prior and drift statistics are the same bits as those of the
    stream without it."""
    batches, attrs, _ = tsyn.hmm_stream(n_batches=4, s=8, t=8, states=2,
                                        f=2, seed=11)
    bad = DynamicDataStream(attrs, batches[1].xc.copy())
    bad.xc[2, 3, 0] = np.nan
    runs = []
    for seq in (batches, batches[:2] + [bad] + batches[2:]):
        m = tdyn.HiddenMarkovModel(attrs, n_states=2, seed=0, device="cpu")
        info = tdyn.seq_stream_fit(m, seq, sweeps=4, tol=0.0)
        runs.append((m, info))
    (clean, ci), (poisoned, pi) = runs
    assert _np(pi["quarantined"]).tolist() == [False, False, True, False,
                                               False]
    assert poisoned.n_quarantined == 1 and clean.n_quarantined == 0
    assert _same_bits(clean.posterior, poisoned.posterior)
    assert _same_bits(clean._chained_prior, poisoned._chained_prior)
    keep = [0, 1, 3, 4]
    for k in ("elbo", "score", "ph"):
        assert torch.equal(ci[k], pi[k][keep]), k
    assert float(pi["elbo"][2]) == 0.0


# ---------------------------------------------------------------------------
# temporal serving
# ---------------------------------------------------------------------------


def test_temporal_engine_matches_reference():
    """Filter and predict queries of two (T, horizon) buckets, twice: the
    port's engine against the reference engine at 1e-5, cached plans on
    the second flush, results against the model's own API, then a refit
    model served through the same cached plan (the posterior is read at
    run time)."""
    stream = tsyn.hmm_sequences(s=16, t=12, states=3, f=2, seed=12)[0]
    jm = jdyn.HiddenMarkovModel(stream.attributes, n_states=3, seed=0)
    jm.update_model(JStream(stream.attributes, stream.xc),
                    sweeps=5)
    tm = tdyn.HiddenMarkovModel(stream.attributes, n_states=3, seed=0,
                                device="cpu")
    tm.posterior = convert.hmm_posterior_from_numpy(jm.posterior, "cpu")
    xc = stream.xc

    def serve(eng):
        out = []
        for _ in range(2):
            qs = [eng.submit("filter", {}, payload=xc[i]) for i in range(3)]
            qs.append(eng.submit("predict", {"horizon": 4}, payload=xc[3]))
            done = eng.flush()
            assert [q.qid for q in done] == sorted(q.qid for q in done)
            out.append([q.result for q in qs])
        return out

    eng = PGMQueryEngine(tm, mode="temporal")
    got, ref = serve(eng), serve(JQE(jm, mode="temporal"))
    for a, b in zip(sum(got, []), sum(ref, [])):
        assert a.shape == np.asarray(b).shape
        _close(a, b, 1e-5)
    assert eng.plans.stats()["hits"] == 2 and len(eng.plans) == 2
    _close(got[0][0], tm.filtered_posterior(xc[:1])[0], 1e-6)
    _close(got[0][3], tm.predictive(xc[3:4], 4)[0], 1e-6)
    gamma = jax.jit(jm._estep)(jm.posterior, jnp.asarray(xc[:4]),
                               jnp.ones(xc[:4].shape[:2]))[0]
    np.testing.assert_array_equal(_np(tm.viterbi_states(xc[:4])),
                                  np.asarray(gamma.argmax(-1)))
    # a new posterior changes the answers through the cached plan
    emis = tm.posterior.emis
    tm.posterior = tm.posterior._replace(emis=emis._replace(m=emis.m + 2.0))
    qs = [eng.submit("filter", {}, payload=xc[i]) for i in range(3)]
    eng.flush()
    assert eng.plans.stats()["hits"] == 3
    _close(qs[0].result, tm.filtered_posterior(xc[:1])[0], 1e-6)
    assert np.abs(qs[0].result - got[0][0]).max() > 1e-3
    with pytest.raises(ValueError, match="payload"):
        eng.submit("filter", {})
    with pytest.raises(ValueError, match="'filter' or 'predict'"):
        eng.submit("marginal", {}, payload=xc[0])
    kf = tdyn.KalmanFilter(stream.attributes, device="cpu")
    with pytest.raises(ValueError, match="HMM-family"):
        PGMQueryEngine(kf, mode="temporal")
