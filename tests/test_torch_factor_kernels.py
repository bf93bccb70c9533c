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
                                     (2, 8, 12, 3), (2, 5, 4, 9),
                                     (1, 3, 5, 16)])
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


SMS = 132         # an H100 SXM's SMs; the wrapper takes the card's count


# -- cg_weak_marg: the kernel's plan and arithmetic, emulated ----------------


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows,n", [(16384, 4), (1024, 4), (64, 1), (1, 0),
                                    (300, 3), (5000, 9), (40, 12),
                                    (7, 16), (100, 17), (3, 40)])
def test_weak_plan_covers_every_row_and_entry_once(rows, n, sms):
    """G lanes a row (G the power of two >= min(n^2, 32)) cover every row
    once; lane sub's entries e0 + sub + G t of each block of G * EPL cover
    every covariance entry once, at any n, and row 0's entries every mean
    dim; the grid gives every SM a block where a warp a block can."""
    p = factor_ops.weak_plan(rows, n, sms)
    nn = n * n
    assert p.G in (1, 2, 4, 8, 16, 32) and p.G >= min(nn, 32)
    assert p.G == 1 or p.G // 2 < min(nn, 32)
    assert p.EPL in (1, 2, 4, 8) and p.threads in (32, 64, 128, 256)
    blocks = -(-rows * p.G // p.threads)
    assert blocks >= sms or p.threads == 32
    assert p.threads == factor_ops.THREADS or -(-rows * p.G // (
        2 * p.threads)) < sms
    group = np.arange(blocks * p.threads) // p.G
    assert (np.bincount(group[group < rows], minlength=rows) == p.G).all()
    dims = np.zeros(n, np.int64)
    entries = np.zeros(nn, np.int64)
    for sub in range(p.G):
        for e0 in range(0, nn, p.G * p.EPL):
            for t in range(p.EPL):
                e = e0 + sub + p.G * t
                if e < nn:
                    entries[e] += 1
                    if e < n:                 # row 0: writes mean[e]
                        dims[e] += 1
    assert (dims == 1).all() and (entries == 1).all()


def _emulate_weak(lw, mu, sigma):
    """``cg_weak_marg`` as the kernel takes a row (``weak_plan``), in
    float32: the max; the mass sum_j exp(lw_j - max) in j order; each mean
    dim sum_j w_j mu_ja in j order, times 1 / s; each covariance entry of
    each block sum_j (w_j / s) (sigma_jab + d_a d_b) in j order; a dead
    row (-inf, 0, I)."""
    B, M, N = lw.shape
    n = mu.shape[-1]
    rows = B * M
    p = factor_ops.weak_plan(rows, n, SMS)
    f = np.float32
    lw, mu = lw.reshape(rows, N), mu.reshape(rows, N, n)
    sg = sigma.reshape(rows, N, n * n)
    out = (np.full(rows, -np.inf, f), np.zeros((rows, n), f),
           np.tile(np.eye(n, dtype=f).reshape(-1), (rows, 1)))
    for row in range(rows):
        m = lw[row].max() if N else f(-np.inf)
        ms = f(0) if m == -np.inf else m
        w = np.exp(lw[row] - ms).astype(f)
        s = f(0)
        for j in range(N):
            s = f(s + w[j])
        if not s > 0:
            continue
        inv = f(1) / s
        mean = np.zeros(n, f)
        for a in range(n):
            for j in range(N):
                mean[a] = f(mean[a] + w[j] * mu[row, j, a])
        mean = (mean * inv).astype(f)
        cov = np.zeros(n * n, f)
        for e0 in range(0, n * n, p.G * p.EPL):
            for sub in range(p.G):
                for t in range(p.EPL):
                    e = e0 + sub + p.G * t
                    if e >= n * n:
                        continue
                    a, b = divmod(e, n)
                    for j in range(N):
                        d = (mu[row, j, a] - mean[a]) * (mu[row, j, b]
                                                         - mean[b])
                        cov[e] = f(cov[e] + f(w[j] * inv) * f(sg[row, j, e]
                                                              + d))
        out[0][row] = ms + np.log(s)
        out[1][row], out[2][row] = mean, cov
    return (out[0].reshape(B, M), out[1].reshape(B, M, n),
            out[2].reshape(B, M, n, n))


@pytest.mark.parametrize("B,M,N,n", [(2, 9, 4, 4), (1, 4, 3, 1),
                                     (2, 3, 37, 2), (1, 3, 5, 9),
                                     (1, 2, 3, 17), (1, 1, 2, 40)])
def test_cg_weak_marg_kernel_emulated(B, M, N, n):
    """The kernel's arithmetic under its plan (one lane group a row, a
    centred covariance by entry blocks, N past a batch of components, n >
    G dims) against the Pallas kernel in interpret mode and the oracle,
    within chip_smoke's WEAK tolerance (1e-5 + 1e-4 |exp|: the centred
    covariance against second - mean mean^T); dead rows exactly."""
    lw, mu, sigma = _mixture(17, B, M, N, n)
    lw[0, 0] = -np.inf                      # a dead row
    got = _emulate_weak(lw, mu, sigma)
    J = [jnp.asarray(t) for t in (lw, mu, sigma)]
    for exp in (ops.cg_weak_marg(*J, bm=64), jref.cg_weak_marg_ref(*J)):
        _close_inf(got[0], exp[0], atol=1e-5, rtol=1e-5)
        for x, y in zip(got[1:], exp[1:]):
            np.testing.assert_allclose(x, np.asarray(y), atol=1e-5,
                                       rtol=1e-4)
    np.testing.assert_array_equal(got[1][0, 0], 0.0)
    np.testing.assert_array_equal(got[2][0, 0], np.eye(n))


def test_lanes_per_row():
    assert [factor_ops.lse_plan(1 << 20, n, True, SMS).G
            for n in (1, 4, 5, 16, 17, 128, 700)] == [1, 1, 2, 4, 8, 32, 32]


# -- log_marginalize: the kernel's plan and arithmetic, emulated -------------


def _lse_chunks(p, N):
    """The chunks of a row that each lane of a row team reads under plan p,
    as ``log_marginalize_kernel`` in factor_ops.cu indexes them: {(w, sub,
    q, j): chunk} for the chunks that lie in the row."""
    n_chunks = N // p.V
    got = {}
    for q in range(p.rounds):
        for j in range(p.C):
            for w in range(p.W):
                for sub in range(p.G):
                    c = ((q * p.C + j) * p.W + w) * p.G + sub
                    if c < n_chunks:
                        got[(w, sub, q, j)] = c
    return got


@pytest.mark.parametrize("N", [1, 3, 4, 16, 17, 128, 129, 700, 16384])
def test_lse_plan_covers_every_element_once(N):
    """Every element of a row is read by exactly one (warp, lane, round,
    load) of its team, and every row by one lane group of one block, for
    few and many rows, aligned or not."""
    for rows in (1, 7, 1024, 1 << 20):
        for aligned in (True, False):
            p = factor_ops.lse_plan(rows, N, aligned, SMS)
            assert p.V == (4 if aligned and N % 4 == 0 else 1)
            assert p.G in (1, 2, 4, 8, 16, 32) and p.W in (1, 2, 4, 8)
            assert p.W == 1 or (p.G == 32 and p.RPG == 1)
            assert p.C * p.V <= 16               # 64 bytes a lane a round
            if N <= factor_ops.SHORT_N:     # a lane group a row, one round
                assert p.W == 1 and p.rounds == 1
                full = factor_ops.THREADS // p.G * 4 * SMS   # RPG = 4
                assert p.RPG == (4 if rows >= full else 1)   # fills the card
            else:
                assert p.RPG == 1
            seen = np.zeros(N, np.int64)
            for c in _lse_chunks(p, N).values():
                seen[c * p.V:(c + 1) * p.V] += 1
            np.testing.assert_array_equal(seen, 1)
            # rows: block, warp, lane group and the group's r-th row
            per = 32 // p.G
            rpb = factor_ops.lse_rows_per_block(p)
            rows_seen = {}
            n_blocks = -(-min(rows, 4096) // rpb)
            for blk in range(n_blocks):
                for wi in range(0, factor_ops.THREADS // 32, p.W):
                    for grp in range(per):
                        for r in range(p.RPG):
                            row = (blk * rpb + (wi // p.W) * p.RPG * per
                                   + r * per + grp)
                            rows_seen[row] = rows_seen.get(row, 0) + 1
            assert sorted(rows_seen) == list(range(n_blocks * rpb))
            assert set(rows_seen.values()) == {1}
    if N > factor_ops.SHORT_N:        # few long rows: the team grows
        few, many = (factor_ops.lse_plan(n, N, True, SMS)
                     for n in (1, 1 << 20))
        assert many.W == 1
        assert few.W == min(8, max(1, -(-N // (32 * few.C * few.V))))
        # ... until the rows fill the card's warps: half of them on this
        # card, all of them on a card of half the SMs
        half = SMS * factor_ops.WARPS_PER_SM // 2
        if N > 32 * few.C * few.V:
            assert factor_ops.lse_plan(half, N, True, SMS).W == 2
            assert factor_ops.lse_plan(half, N, True, SMS // 2).W == 1


def _lse_merge(m, s, m2, s2):
    """``lse_merge`` of factor_ops.cu (a row's warps) on float32 arrays."""
    with np.errstate(invalid="ignore", over="ignore"):
        e_lo = np.exp(np.minimum(m2 - m, 0), dtype=np.float32)
        e_hi = np.exp(np.minimum(m - m2, 0), dtype=np.float32)
    keep = m >= m2
    s_new = np.where(keep, s + np.where(m2 == m, s2, s2 * e_lo),
                     s * e_hi + s2)
    m_new = np.where(keep, m, m2)
    dead2, dead1 = m2 == -np.inf, m == -np.inf
    s_new = np.where(dead2, s, np.where(dead1, s2, s_new))
    m_new = np.where(dead2, m, np.where(dead1, m2, m_new))
    return m_new.astype(np.float32), s_new.astype(np.float32)


def _emulate_log_marginalize(x, aligned=True):
    """``log_marginalize`` as the kernel computes it under ``lse_plan``, in
    float32: each round's loads, the team's max over them (a rescale of
    the lanes' sums only where a later round raises it), each lane's sum of
    expf(x - max) in load order, the __shfl_down add tree over the G lanes
    and the W warps merged in warp order."""
    B, M, N = x.shape
    rows = x.reshape(B * M, N).astype(np.float32)
    p = factor_ops.lse_plan(B * M, N, aligned, SMS)
    cen = lambda m: np.where(np.isfinite(m), m, np.float32(0))
    m = np.full((B * M, p.W, 1), -np.inf, np.float32)     # a warp's max
    s = np.zeros((B * M, p.W, p.G), np.float32)           # a lane's sum
    for q in range(p.rounds):
        v = np.full((B * M, p.W, p.G, p.C * p.V), -np.inf, np.float32)
        for w in range(p.W):
            for sub in range(p.G):
                for j in range(p.C):
                    c = ((q * p.C + j) * p.W + w) * p.G + sub
                    if c < N // p.V:
                        v[:, w, sub, j * p.V:(j + 1) * p.V] = \
                            rows[:, c * p.V:(c + 1) * p.V]
        mr = v.max(-1).max(-1, keepdims=True)
        up = mr > m
        with np.errstate(invalid="ignore"):
            rs = s * np.exp(m - mr, dtype=np.float32)
        s = np.where(up, np.where(m == -np.inf, np.float32(0), rs), s)
        m = np.where(up, mr, m)
        tot = np.zeros_like(s)
        for t in range(p.C * p.V):
            tot = tot + np.exp(v[..., t] - cen(m), dtype=np.float32)
        s = s + tot
    off = p.G // 2
    while off:
        s = s + np.concatenate([s[..., off:], s[..., -off:]], -1)[..., :p.G]
        off //= 2
    mw, sw = m[:, 0, 0], s[:, 0, 0]
    for w in range(1, p.W):
        mw, sw = _lse_merge(mw, sw, m[:, w, 0], s[:, w, 0])
    with np.errstate(divide="ignore"):
        out = np.where(sw > 0, cen(mw) + np.log(sw), -np.inf)
    return out.astype(np.float32).reshape(B, M)


@pytest.mark.parametrize("B,M,N,aligned", [
    (4, 64, 16, True),        # short rows: float4 loads, G = 4
    (3, 50, 3, True),         # ragged N: scalar loads, C = 4 (one masked)
    (2, 33, 17, False),       # scalar, G = 8
    (2, 5, 129, True),        # long rows, scalar, one warp a row
    (1, 4, 700, True),        # long rows, float4, two warps a row
    (2, 4224, 600, True),     # rows enough to fill the card: two rounds
    (1, 2, 16384, True),      # few long rows: eight warps, four rounds
])
def test_log_marginalize_kernel_emulated(B, M, N, aligned):
    """The kernel's arithmetic, emulated in numpy under its plan, against
    the Pallas kernel in interpret mode and the JAX oracle: within the
    kernel's tolerance 1e-5 (1 + |x|), -inf exactly where they have it."""
    x = _table(20, (B, M, N))
    x[0, 0] = -np.inf                       # an all -inf row
    x[-1, -1, : N // 2] = -np.inf           # a partly -inf row
    p = factor_ops.lse_plan(B * M, N, aligned, SMS)
    assert p.rounds > 1 or B * M * N < 1 << 20
    got = _emulate_log_marginalize(x, aligned)
    assert np.isneginf(got[0, 0])
    exps = [jref.log_marginalize_ref(jnp.asarray(x))]
    if B * M * N < 1 << 20:           # interpret mode: small tables only
        exps.append(ops.log_marginalize(jnp.asarray(x), bm=64, bn=64))
    for exp in exps:
        _close_inf(got, np.asarray(exp), atol=1e-5, rtol=1e-5)


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
