"""The plain versions of the four factor-algebra kernels (what the CUDA
wrappers run on a CPU tensor) against the JAX package's oracles
(``repro.kernels.ref``) and its Pallas kernels in interpret mode
(``repro.kernels.ops``), at ``tests/test_kernels.py``'s shapes, with
structural ``-inf`` entries, all ``-inf`` rows and dead mixture rows.  Inputs
are numpy arrays made from a seed and handed to both packages.

Tolerances: ``log_product`` and ``evidence_select`` equal the oracle
exactly (the same single float op or a copy); ``log_marginalize`` 1e-5 and
``cg_weak_marg`` 1e-5 abs + 1e-5 rel against the interpret-mode kernels
(float32 sums in another order), ``-inf`` exactly where the reference has
it.  The factor-level functions with ``backend="cuda"`` on CPU tensors
(flattening, permutes, the wrappers' CPU route) equal the plain backend.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.infer_exact import factors as JF  # noqa: E402
from repro.kernels import ops, ref as jref  # noqa: E402
from repro_torch.infer_exact import factors as TF  # noqa: E402
from repro_torch.kernels import factor_ops  # noqa: E402

torch.set_num_threads(1)

SHAPES = [(1, 8, 8), (4, 300, 13), (2, 64, 700), (3, 1, 1)]


def _table(seed, shape, p_neg_inf=0.25):
    """Random log table with structural zeros (evidence indicators)."""
    g = np.random.default_rng(seed)
    x = g.standard_normal(shape, dtype=np.float32)
    x[g.random(shape) < p_neg_inf] = -np.inf
    return x


def _close_inf(got, exp, atol, rtol=0.0):
    got, exp = np.asarray(got), np.asarray(exp)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(exp))
    fin = np.isfinite(exp)
    np.testing.assert_allclose(got[fin], exp[fin], atol=atol, rtol=rtol)


@pytest.mark.parametrize("B,M,N", SHAPES)
def test_log_product_plain_matches_reference(B, M, N):
    a = _table(0, (B, M, N))
    b = np.random.default_rng(1).standard_normal((B, N), dtype=np.float32)
    got = factor_ops.log_product(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.log_product_ref(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        ops.log_product(jnp.asarray(a), jnp.asarray(b), bm=64)), atol=1e-6)


@pytest.mark.parametrize("B,M,N", SHAPES)
def test_log_marginalize_plain_matches_reference(B, M, N):
    x = _table(2, (B, M, N))
    x[0, 0] = -np.inf                       # an all -inf row
    got = factor_ops.log_marginalize(torch.from_numpy(x)).numpy()
    assert np.isneginf(got[0, 0])
    _close_inf(got, ops.log_marginalize(jnp.asarray(x), bm=64, bn=64),
               atol=1e-5)
    _close_inf(got, jref.log_marginalize_ref(jnp.asarray(x)), atol=1e-5)


def test_log_marginalize_all_neg_inf_stays_neg_inf():
    x = torch.full((2, 4, 300), float("-inf"))
    assert bool(torch.isneginf(factor_ops.log_marginalize(x)).all())


@pytest.mark.parametrize("B,M,N", SHAPES[:3])
def test_evidence_select_plain_matches_reference(B, M, N):
    x = _table(3, (B, M, N))
    idx = np.random.default_rng(4).integers(0, N, B).astype(np.int32)
    got = factor_ops.evidence_select(torch.from_numpy(x),
                                     torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.evidence_select_ref(
        jnp.asarray(x), jnp.asarray(idx))))
    np.testing.assert_array_equal(got, np.asarray(ops.evidence_select(
        jnp.asarray(x), jnp.asarray(idx), bm=64)))


def test_evidence_select_out_of_range_gives_neg_inf():
    """The Pallas kernel's mask: an index outside [0, N) selects nothing."""
    x = torch.from_numpy(_table(5, (3, 4, 6), p_neg_inf=0.0))
    out = factor_ops.evidence_select(x, torch.tensor([0, 6, -1]))
    assert bool(torch.isneginf(out[1:]).all())
    assert torch.equal(out[0], x[0, :, 0])


def _mixture(seed, B, M, N, n, scale=1.0, p_neg_inf=0.25):
    g = np.random.default_rng(seed)
    lw = _table(seed, (B, M, N), p_neg_inf)
    mu = g.standard_normal((B, M, N, n), dtype=np.float32)
    a = g.standard_normal((B, M, N, n, n), dtype=np.float32) * scale
    sigma = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(n, dtype=np.float32)
    return lw, mu, sigma


@pytest.mark.parametrize("B,M,N,n", [(1, 4, 3, 1), (3, 130, 6, 2),
                                     (2, 8, 12, 3)])
def test_cg_weak_marg_plain_matches_reference(B, M, N, n):
    lw, mu, sigma = _mixture(6, B, M, N, n)
    lw[0, 0] = -np.inf                      # a dead row
    got = factor_ops.cg_weak_marg(*(torch.from_numpy(t)
                                    for t in (lw, mu, sigma)))
    J = [jnp.asarray(t) for t in (lw, mu, sigma)]
    for exp in (ops.cg_weak_marg(*J, bm=64), jref.cg_weak_marg_ref(*J)):
        _close_inf(got[0].numpy(), exp[0], atol=1e-5, rtol=1e-5)
        for x, y in zip(got[1:], exp[1:]):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5,
                                       rtol=1e-5)
    np.testing.assert_array_equal(got[1][0, 0].numpy(), 0.0)
    np.testing.assert_array_equal(got[2][0, 0].numpy(), np.eye(n))


def test_cg_weak_marg_preserves_moments():
    """The weak marginal keeps the mixture's exact mass, mean and
    covariance (float64 numpy yardstick)."""
    lw, mu, sigma = _mixture(7, 1, 1, 5, 2, scale=0.3, p_neg_inf=0.0)
    lw = np.log(np.exp(lw) / np.exp(lw).sum()) - 0.7   # mass exp(-0.7)
    p, mh, sh = factor_ops.cg_weak_marg(*(torch.from_numpy(
        np.ascontiguousarray(t, np.float32)) for t in (lw, mu, sigma)))
    w = np.exp(lw[0, 0].astype(np.float64))
    m0, s0 = mu[0, 0].astype(np.float64), sigma[0, 0].astype(np.float64)
    mean = (w[:, None] * m0).sum(0) / w.sum()
    cov = (w[:, None, None] * (s0 + m0[:, :, None] * m0[:, None, :])
           ).sum(0) / w.sum() - mean[:, None] * mean[None, :]
    np.testing.assert_allclose(float(p[0, 0]), -0.7, atol=1e-6)
    np.testing.assert_allclose(mh[0, 0].numpy(), mean, atol=1e-5)
    np.testing.assert_allclose(sh[0, 0].numpy(), cov, atol=1e-5)


def test_lanes_per_row():
    assert [factor_ops.lanes_for(n) for n in (1, 4, 5, 16, 17, 128, 700)] \
        == [1, 1, 2, 4, 8, 32, 32]


def test_wrappers_check_inputs():
    x = torch.zeros((2, 3, 4))
    with pytest.raises(TypeError):
        factor_ops.log_marginalize(x.double())
    with pytest.raises(ValueError, match="disagree"):
        factor_ops.log_product(x, torch.zeros((2, 3)))
    with pytest.raises(TypeError, match="integer"):
        factor_ops.evidence_select(x, torch.zeros(2))
    with pytest.raises(ValueError, match="disagree"):
        factor_ops.cg_weak_marg(x, torch.zeros((2, 3, 4, 2)),
                                torch.zeros((2, 3, 4, 3, 3)))


# -- the factor algebra around the kernels (factors.py) ----------------------


def _factors(seed):
    """A [B=3] clique factor over (a, b, c) and a message over (c, a)."""
    g = np.random.default_rng(seed)
    f = _table(seed, (3, 2, 3, 4))
    m = g.standard_normal((3, 4, 2), dtype=np.float32)
    return (("a", "b", "c"), (2, 3, 4), f), (("c", "a"), (4, 2), m)


IDX = np.array([0, 2, 1], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_factor_ops(use_pallas):
    """(absorb, marginalize onto c, reduce b) of the JAX package."""
    (fs, fc, ft), (ms, mc, mt) = _factors(8)
    jf = JF.Factor(fs, fc, jnp.asarray(ft))
    ja = JF.absorb(jf, JF.Factor(ms, mc, jnp.asarray(mt)),
                   use_pallas=use_pallas)
    return (ja, JF.marginalize(ja, ("c",), use_pallas=use_pallas),
            JF.reduce_evidence(jf, "b", jnp.asarray(IDX),
                               use_pallas=use_pallas))


@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_factor_ops_match_reference(backend):
    """absorb / marginalize / reduce_evidence on CPU tensors through both
    backends (the cuda backend's flattening with the wrappers' CPU route)
    against the JAX package's factors with and without Pallas."""
    (fs, fc, ft), (ms, mc, mt) = _factors(8)
    tf, tm = (TF.Factor(fs, fc, torch.from_numpy(ft)),
              TF.Factor(ms, mc, torch.from_numpy(mt)))
    ta = TF.absorb(tf, tm, backend=backend)
    tg = TF.marginalize(ta, ("c",), backend=backend)
    te = TF.reduce_evidence(tf, "b", torch.from_numpy(IDX), backend=backend)
    for use_pallas in (False, True):
        ja, jg, je = _jax_factor_ops(use_pallas)
        order = tuple(ta.scope.index(v) for v in ja.scope)
        _close_inf(ta.logp.permute((0,) + tuple(1 + i for i in order)),
                   ja.logp, atol=1e-6)
        assert tg.scope == jg.scope == ("c",)
        _close_inf(tg.logp, jg.logp, atol=1e-5)
        assert te.scope == je.scope
        np.testing.assert_array_equal(te.logp.numpy(), np.asarray(je.logp))
    unbatched = TF.Factor(fs, fc, torch.from_numpy(ft[0]))
    one = TF.reduce_evidence(unbatched, "c", torch.tensor(3), backend=backend)
    assert torch.equal(one.logp, torch.from_numpy(ft[0, :, :, 3]))


def test_indicator_and_normalize_match_reference():
    idx = np.array([2.0, 0.0, 1.0])                  # floats, as served
    ti = TF.indicator("x", 3, torch.from_numpy(idx))
    np.testing.assert_array_equal(
        ti.logp.numpy(), np.asarray(JF.indicator("x", 3, jnp.asarray(idx)
                                                 ).logp))
    (fs, fc, ft), _ = _factors(9)
    tn = TF.normalize(TF.Factor(fs, fc, torch.from_numpy(ft)))
    jn = JF.normalize(JF.Factor(fs, fc, jnp.asarray(ft)))
    _close_inf(tn.logp, jn.logp, atol=1e-6)
