"""The port's suff-stats kernel wrappers on the CPU (their plain PyTorch
versions) against the JAX Pallas kernels in interpret mode and against
``repro.kernels.ref``, on the shapes of ``tests/test_kernels.py``; the
``clg_suffstats``, ``clg_suffstats_latent`` and ``clg_disc_counts``
kernels' instance partition and fixed-order stage 2 (and the latent rsum_k
S_k fold) emulated in numpy against the same, their plans' cover of every
entry and instance at a card's SM count, and the chunked entry against
per-chunk calls.

Tolerance: rtol 1e-4 and atol 1e-3, as tests/test_kernels.py holds the
Pallas kernels to their oracle: float32 sums over up to 1000 instances in
different orders (torch vs XLA einsum differ by up to ~1e-4 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401  (one intra-op thread)
import jax.numpy as jnp  # noqa: E402

from repro.kernels import clg_stats as jk  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import clg_stats, ref  # noqa: E402

RTOL, ATOL = 1e-4, 1e-3
SMS = 132         # an H100 SXM's SMs; the wrappers take the card's count


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _moments_inputs(N, F, D, K, seed):
    g = np.random.default_rng(seed)
    return (g.standard_normal((N, F, D), dtype=np.float32),
            g.standard_normal((N, F), dtype=np.float32),
            _softmax(g.standard_normal((N, K))))


def _close(port, *refs):
    for exp in refs:
        for p, e in zip(port, exp):
            np.testing.assert_allclose(p.numpy(), np.asarray(e), rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("N,F,D,K,block", [
    (1000, 3, 4, 2, 256),
    (513, 1, 2, 5, 128),     # ragged N vs block
    (256, 2, 8, 16, 64),     # K = 16 components
])
def test_clg_suffstats_matches_pallas_and_ref(N, F, D, K, block):
    d, y, r = _moments_inputs(N, F, D, K, 0)
    got = clg_stats.clg_suffstats(*map(torch.from_numpy, (d, y, r)))
    pallas = jk.clg_suffstats(jnp.asarray(d), jnp.asarray(y), jnp.asarray(r),
                              block=block, interpret=True)
    _close(got, pallas, jref.clg_suffstats_ref(d, y, r))


@pytest.mark.parametrize("N,F,Do,K,L,block", [
    (600, 3, 2, 2, 1, 256),
    (513, 2, 1, 3, 2, 128),    # ragged N vs block; FA-style Do = 1
    (256, 1, 3, 4, 8, 64),     # wide latent block (L = 8)
])
def test_clg_suffstats_latent_matches_pallas_and_ref(N, F, Do, K, L, block):
    obs, y, r = _moments_inputs(N, F, Do, K, 1)
    g = np.random.default_rng(2)
    hm = g.standard_normal((N, K, L), dtype=np.float32)
    a = 0.3 * g.standard_normal((K, L, L), dtype=np.float32)
    shh = (a @ a.transpose(0, 2, 1) + np.eye(L)).astype(np.float32)
    got = clg_stats.clg_suffstats_latent(
        *map(torch.from_numpy, (obs, hm, y, r, shh)))
    pallas = jk.clg_suffstats_latent(*map(jnp.asarray, (obs, hm, y, r, shh)),
                                     block=block, interpret=True)
    _close(got, pallas, jref.clg_suffstats_latent_ref(obs, hm, y, r, shh))
    sxx = got[0].numpy()
    np.testing.assert_allclose(sxx, sxx.swapaxes(-1, -2), atol=1e-4)


@pytest.mark.parametrize("N,Fd,C,K,block", [
    (1000, 2, 3, 2, 256),
    (513, 1, 5, 4, 128),     # ragged N vs block
    (128, 3, 2, 7, 64),
    (300, 2, 64, 3, 128),    # C = 64 categories
    (40, 380, 64, 2, 40),    # Fd + K > 376 (once the tile kernel's limit)
])
def test_clg_disc_counts_matches_pallas_and_ref(N, Fd, C, K, block):
    """Category -1 (padded instances) counts nothing, as in jax.nn.one_hot."""
    g = np.random.default_rng(3)
    xd = g.integers(-1, C, (N, Fd)).astype(np.int32)
    r = _softmax(g.standard_normal((N, K)))
    got = clg_stats.clg_disc_counts(torch.from_numpy(xd), torch.from_numpy(r),
                                    C)
    pallas = jk.clg_disc_counts(jnp.asarray(xd), jnp.asarray(r), C,
                                block=block, interpret=True)
    _close([got], [pallas], [jref.clg_disc_counts_ref(xd, r, C)])


def test_masked_instances_contribute_nothing():
    """r = 0 rows (masked instances) add nothing, including to the
    rsum * S_k correction of the latent block."""
    obs, y, r = _moments_inputs(200, 2, 2, 3, 4)
    g = np.random.default_rng(5)
    hm = g.standard_normal((200, 3, 2), dtype=np.float32)
    shh = np.broadcast_to(0.7 * np.eye(2, dtype=np.float32), (3, 2, 2)).copy()
    r[150:] = 0.0
    t = lambda *a: [torch.from_numpy(np.ascontiguousarray(x)) for x in a]
    full = clg_stats.clg_suffstats_latent(*t(obs, hm, y, r, shh))
    trunc = clg_stats.clg_suffstats_latent(
        *t(obs[:150], hm[:150], y[:150], r[:150], shh))
    for a, b in zip(full, trunc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-4)


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    d, y, r = map(torch.from_numpy, _moments_inputs(64, 2, 3, 2, 8))
    with pytest.raises(TypeError):
        clg_stats.clg_suffstats(d.double(), y, r)
    with pytest.raises(ValueError, match="disagree"):
        clg_stats.clg_suffstats(d, y[:10], r)
    with pytest.raises(TypeError):
        clg_stats.clg_disc_counts(torch.zeros((4, 2)), r[:4], 3)
    before = dict(clg_stats.LAUNCHES)
    clg_stats.clg_suffstats(d, y, r)
    assert clg_stats.LAUNCHES == before    # the plain path launches nothing


def test_one_hot_matches_jax_for_padding_category():
    xd = torch.tensor([[-1, 0], [2, 5]], dtype=torch.int32)
    got = ref.one_hot_cmp(xd, 3).numpy()
    import jax

    exp = np.asarray(jax.nn.one_hot(jnp.asarray(xd.numpy()), 3))
    np.testing.assert_array_equal(got, exp)


# -- clg_suffstats: the kernel's partition, emulated; the chunked entry -------


def _unit_moments(d, y, r):
    """One instance's float32 terms [F, K, U]: r_k d_i d_b (b >= i, row by
    row), r_k d_i y, r_k y y -- the order of the kernel's slots."""
    D = d.shape[1]
    iu = np.triu_indices(D)
    rd = r[None, :, None] * d[:, None, :]                      # [F, K, D]
    sxx = rd[:, :, iu[0]] * d[:, None, iu[1]]
    sxy = rd * y[:, None, None]
    syy = r[None, :] * y[:, None] * y[:, None]
    return np.concatenate([sxx, sxy, syy[..., None]], -1).astype(np.float32)


def _emulate_moments(d, y, r):
    """``clg_suffstats`` as the kernel splits it (``moments_plan``): each
    range's lanes sum their instances l, l + NL, ... in order, the lanes
    add in lane order, then 32 range lanes each sum a strided set of ranges
    in order and a fixed tree adds them; the upper triangle is mirrored."""
    N, F, D = d.shape
    K = r.shape[1]
    p = clg_stats.moments_plan(N, F, D, K, SMS)
    U = clg_stats.entries_per_unit(D)
    terms = [_unit_moments(d[n], y[n], r[n]) for n in range(N)]
    part = np.zeros((p.R, F, K, U), np.float32)
    for i in range(p.R):
        n0, n1 = i * p.range_len, min(N, (i + 1) * p.range_len)
        for lane in range(p.NL):
            acc = np.zeros((F, K, U), np.float32)
            for n in range(n0 + lane, n1, p.NL):
                acc += terms[n]
            part[i] += acc
    lanes = np.zeros((clg_stats.RANGE_LANES, F, K, U), np.float32)
    for j in range(clg_stats.RANGE_LANES):
        for i in range(j, p.R, clg_stats.RANGE_LANES):
            lanes[j] += part[i]
    h = clg_stats.RANGE_LANES // 2
    while h:
        lanes[:h] += lanes[h:2 * h]
        h //= 2
    tot = lanes[0]
    T = D * (D + 1) // 2
    sxx = np.zeros((F, K, D, D), np.float32)
    iu = np.triu_indices(D)
    sxx[..., iu[0], iu[1]] = tot[..., :T]
    sxx[..., iu[1], iu[0]] = tot[..., :T]
    return sxx, tot[..., T:T + D], tot[..., -1]


@pytest.mark.parametrize("N,F,D,K,block", [
    (1000, 3, 4, 2, 256),
    (513, 1, 2, 5, 128),     # ragged N vs block
    (256, 2, 8, 16, 64),     # K = 16 components
    (700, 40, 2, 1, 128),    # two leaf tiles of 32
    (300, 2, 10, 3, 64),     # D > 8: a unit is one row of sxx
    (100, 2, 40, 2, 64),     # D > 32: a row in two blocks of columns
])
def test_clg_suffstats_partition_matches_pallas(N, F, D, K, block):
    """The kernel's instance ranges, lanes and fixed-order stage 2,
    emulated in float32, against the Pallas kernel in interpret mode and
    the JAX oracle (the tolerance of the module docstring)."""
    d, y, r = _moments_inputs(N, F, D, K, 12)
    got = _emulate_moments(d, y, r)
    pallas = jk.clg_suffstats(jnp.asarray(d), jnp.asarray(y), jnp.asarray(r),
                              block=block, interpret=True)
    for g_, p_, e_ in zip(got, pallas, jref.clg_suffstats_ref(d, y, r)):
        np.testing.assert_allclose(g_, np.asarray(p_), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g_, np.asarray(e_), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,F,D,K", [
    (1 << 20, 10, 1, 4),      # streaming, gmm_large
    (1 << 20, 10, 1, 3),      # nb_mixed
    (16384, 992, 2, 1),       # a chunk of the CLG search's largest group
    (16384, 1, 2, 1), (16384, 30, 3, 1), (5, 3, 2, 2),
    (777, 7, 12, 3),          # D > 8
    (2000, 3, 40, 2),         # D > 32: two column blocks a row
    (64, 2, 400, 2),          # 13 column blocks a row
    (4099, 33, 6, 64),        # many components: units split over blocks
])
def test_moments_plan_partitions_every_instance_and_entry(n, F, D, K):
    p = clg_stats.moments_plan(n, F, D, K, SMS)
    U = clg_stats.entries_per_unit(D)
    assert p.FT * p.UB * p.NL <= clg_stats.THREADS and p.NL >= 1
    if D <= 8:
        assert p.KG * U <= clg_stats.MAX_SLOTS and p.W * p.KG >= K
    else:
        assert p.KG == 1 and p.W == K * D * -(-D // clg_stats.ROW_BLOCK)
    assert p.n_ublocks * p.UB >= p.W > (p.n_ublocks - 1) * p.UB
    assert p.R * p.range_len >= n > (p.R - 1) * p.range_len
    blocks = -(-F // p.FT) * p.n_ublocks * p.R
    assert p.R == 1 or blocks <= clg_stats.BLOCKS_PER_SM * SMS
    assert p.R <= 65535
    for m in (1, n // 3, n - 1):          # a shorter last chunk: the same
        if m:                             # block, its own ranges
            q = clg_stats.moments_plan(m, F, D, K, SMS)
            assert q[:6] == p[:6]
            assert q.R * q.range_len >= m > (q.R - 1) * q.range_len


def _row_unit_slots(D, K):
    """The D > 8 stage-1 units as ``moments_rows`` in clg_stats.cu maps
    them: unit (k * D + i) * NB + j sums, for slot s < ROW_BLOCK, the
    product d_i d_b with b = ROW_BLOCK * j + s; slot ROW_BLOCK d_i y (the
    block that holds column i) and slot ROW_BLOCK + 1 y^2 (row 0, block 0).
    Yields (k, what the slot sums, the compact entry it is written to) for
    every slot written."""
    B = clg_stats.ROW_BLOCK
    NB = -(-D // B)
    tri = D * (D + 1) // 2
    W = clg_stats.moments_plan(1, 1, D, K, SMS).W
    assert W == K * D * NB
    for u in range(W):
        k, i, j = u // (D * NB), u // NB % D, u % NB
        for s in range(min(B, D - B * j)):
            b = B * j + s
            if b >= i:
                yield k, ("xx", i, b), i * D - i * (i - 1) // 2 + b - i
        if i // B == j:
            yield k, ("xy", i), tri + i
        if i == 0 and j == 0:
            yield k, ("yy",), tri + D


@pytest.mark.parametrize("D,K", [(9, 1), (12, 3), (32, 2), (33, 1),
                                 (40, 2), (70, 2)])
def test_row_units_write_every_entry_once(D, K):
    """Each (component, entry) of sxx's upper triangle, sxy and syy is
    written by exactly one slot of one D > 8 unit, and that slot sums the
    product the entry holds."""
    U = clg_stats.entries_per_unit(D)
    iu = np.triu_indices(D)
    want = ([("xx", int(a), int(b)) for a, b in zip(*iu)]
            + [("xy", i) for i in range(D)] + [("yy",)])
    seen = {}
    for k, what, e in _row_unit_slots(D, K):
        assert (k, e) not in seen
        seen[(k, e)] = what
        assert what == want[e]
    assert len(seen) == K * U


# -- clg_suffstats_latent: the kernel's partition and fold, emulated --------


def _latent_inputs(N, F, Do, K, L, seed):
    obs, y, r = _moments_inputs(N, F, Do, K, seed)
    g = np.random.default_rng(seed + 1)
    hm = g.standard_normal((N, K, L), dtype=np.float32)
    a = 0.3 * g.standard_normal((K, L, L), dtype=np.float32)
    shh = (a @ a.transpose(0, 2, 1) + np.eye(L)).astype(np.float32)
    return obs, hm, y, r, shh


def _range_sums(terms, N, R, range_len, NL):
    """Per-range sums as a kernel's ranges take them: lane l of a range
    sums its instances l, l + NL, ... in order, the lanes add in lane
    order; then stage 2 (:func:`_sum_ranges`)."""
    part = np.zeros((R,) + terms(0).shape, np.float32)
    for i in range(R):
        n0, n1 = i * range_len, min(N, (i + 1) * range_len)
        for lane in range(NL):
            acc = np.zeros_like(part[i])
            for n in range(n0 + lane, n1, NL):
                acc += terms(n)
            part[i] += acc
    return _sum_ranges(part)


def _sum_ranges(part):
    """Stage 2 (``sum_ranges`` in clg_stats.cu): 32 range lanes each sum a
    strided set of the ranges in order, then a fixed tree adds them."""
    R = part.shape[0]
    lanes = np.zeros((clg_stats.RANGE_LANES,) + part.shape[1:], np.float32)
    for j in range(clg_stats.RANGE_LANES):
        for i in range(j, R, clg_stats.RANGE_LANES):
            lanes[j] += part[i]
    h = clg_stats.RANGE_LANES // 2
    while h:
        lanes[:h] += lanes[h:2 * h]
        h //= 2
    return lanes[0]


def _emulate_latent(obs, hm, y, r, shh):
    """``clg_suffstats_latent`` as the kernel splits it (``latent_plan``):
    the (leaf, component) units sum the observed rows of sxx's upper
    triangle, sxy and syy over NL lanes, each component's latent units the
    latent rows and rsum_k over NLh lanes (latent_tile holds a kind's sums
    in one unit, latent_rows in row blocks; each entry is summed over the
    same instances in the same order either way).  Then the latent-latent
    block adds rsum_k S_k (sum, then add)."""
    N, F, Do = obs.shape
    K, L = hm.shape[1], hm.shape[2]
    D = Do + L
    p = clg_stats.latent_plan(N, F, Do, L, K, SMS)
    T = D * (D + 1) // 2
    iu = np.triu_indices(D)

    def design(n):
        return np.concatenate([np.broadcast_to(obs[n][:, None], (F, K, Do)),
                               np.broadcast_to(hm[n][None], (F, K, L))], -1)

    def full_terms(n):                        # [F, K, T + D + 2]
        u = design(n)
        ru = r[n][None, :, None] * u
        syy = r[n][None] * y[n][:, None] * y[n][:, None]
        rs = np.broadcast_to(r[n][None], (F, K))
        return np.concatenate([ru[..., iu[0]] * u[..., iu[1]],
                               ru * y[n][:, None, None], syy[..., None],
                               rs[..., None]], -1).astype(np.float32)

    obs_rows = iu[0] < Do                     # the leaf units' triangle
    u = clg_stats.latent_units(Do, L)
    assert obs_rows.sum() + D + 1 == u.UO and T - obs_rows.sum() + 1 == u.UH
    leaf = _range_sums(lambda n: full_terms(n)[..., np.r_[
        np.flatnonzero(obs_rows), T:T + D + 1]], N, p.R, p.range_len, p.NL)
    hh = _range_sums(lambda n: full_terms(n)[0][:, np.r_[
        np.flatnonzero(~obs_rows), T + D + 1]], N, p.R, p.range_len,
        p.NLh)                                # [K, UH]: leaf-independent
    xx = np.zeros((F, K, T), np.float32)
    xx[..., obs_rows] = leaf[..., :u.UO - D - 1]
    xx[..., ~obs_rows] = hh[None, :, :-1]
    rest = leaf[..., u.UO - D - 1:]           # sxy, syy
    sxx = np.zeros((F, K, D, D), np.float32)
    sxx[..., iu[0], iu[1]] = xx
    sxx[..., iu[1], iu[0]] = xx
    sxx[..., Do:, Do:] += (hh[None, :, -1, None, None] * shh[None]
                           ).astype(np.float32)              # sum, then add
    return sxx, rest[..., :D], rest[..., D]


@pytest.mark.parametrize("N,F,Do,K,L,block", [
    (600, 3, 2, 2, 1, 256),
    (513, 2, 1, 3, 2, 128),    # ragged N vs block; FA-style Do = 1
    (300, 16, 1, 1, 4, 128),   # fa_plate's widths
    (200, 3, 1, 5, 4, 64),     # K = 5 components
    (130, 300, 1, 2, 4, 128),  # a wide row: F = 300 leaves, one launch
    (150, 2, 1, 2, 16, 64),    # L = 16: D = 17 > 8, 32-column row blocks
    (90, 2, 3, 2, 5, 64),      # D = 8 with Do = 3 observed columns
    (70, 3, 40, 2, 3, 64),     # Do = 40: two observed-column blocks
])
def test_clg_suffstats_latent_partition_matches_pallas(N, F, Do, K, L,
                                                       block):
    """The latent kernel's units (split into leaf and latent units),
    instance ranges, lanes, fixed-order stage 2 and rsum_k S_k
    fold, emulated in float32, against the Pallas kernel in interpret mode
    and the JAX oracle (the tolerance of the module docstring)."""
    obs, hm, y, r, shh = _latent_inputs(N, F, Do, K, L, 21)
    got = _emulate_latent(obs, hm, y, r, shh)
    pallas = jk.clg_suffstats_latent(*map(jnp.asarray, (obs, hm, y, r, shh)),
                                     block=block, interpret=True)
    oracle = jref.clg_suffstats_latent_ref(obs, hm, y, r, shh)
    for g_, p_, e_ in zip(got, pallas, oracle):
        np.testing.assert_allclose(g_, np.asarray(p_), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g_, np.asarray(e_), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,F,Do,L,K", [
    (1 << 20, 16, 1, 4, 1),      # fa_plate
    (1 << 20, 300, 1, 4, 2),     # a wide row
    (4099, 992, 2, 3, 5),
    (1000, 3, 7, 1, 300),        # more components than a block's threads
    (777, 2, 1, 16, 5),          # L = 16: D > 8
])
def test_latent_plan_fits_registers(n, F, Do, L, K):
    """A leaf unit and a latent unit each keep at most MAX_SLOTS slots
    (D <= 8: one unit of each kind; D > 8: a row block, ROW_BLOCK + 1
    slots); the leaf and latent blocks fit a block's threads; the ranges
    are sized by the leaf blocks and cover every instance; any F is one
    launch (the leaf blocks are a grid axis).  D > 8 sums the latent rows
    once a component: the units a leaf are the y row's column blocks and
    the observed rows' live blocks, fewer than the whole triangle's."""
    D = Do + L
    p = clg_stats.latent_plan(n, F, Do, L, K, SMS)
    u = clg_stats.latent_units(Do, L)
    assert p.R * p.range_len >= n > (p.R - 1) * p.range_len
    assert p.FT * p.UB * p.NL <= clg_stats.THREADS and p.NL >= 1
    assert p.UBh * p.NLh <= clg_stats.THREADS and p.NLh >= 1
    assert u.UO + u.UH == clg_stats.entries_per_unit(D) + 1 + \
        Do * D - Do * (Do - 1) // 2 - D * (D + 1) // 2 + L * (L + 1) // 2
    if D <= 8:
        assert max(u.UO, u.UH) <= clg_stats.MAX_SLOTS
        assert (u.Wo, u.Wh) == (1, 1)
    else:
        rows = clg_stats.latent_row_units(D, L)
        NB = -(-Do // clg_stats.ROW_BLOCK) + -(-L // clg_stats.ROW_BLOCK)
        assert u.Wo == NB + sum(b.i < Do for b in rows)
        assert u.Wh == sum(b.i >= Do for b in rows)
        assert u.Wo < len(rows)
    leaf_blocks = -(-F // p.FT) * -(-(K * u.Wo) // p.UB)
    assert p.R == 1 or leaf_blocks * p.R <= clg_stats.BLOCKS_PER_SM * SMS


def _latent_row_slots(Do, L):
    """The D > 8 stage-1 units of one component as ``latent_rows`` in
    clg_stats.cu maps them (``LatentLayout``, ``RowUnit``): leaf unit w <
    NB is block w of the y row, slot s summing r y u_b (b = col0 + s) and
    slot ROW_BLOCK r y y (block 0); the other leaf units and the latent
    units are the observed and the latent rows' live blocks of
    ``latent_row_units``, slot s summing r u_i u_b for b >= i, and the
    first latent unit's slot ROW_BLOCK rsum.  Yields (leaf or latent, what
    the slot sums, the entry of the unit's kind it is written to)."""
    D = Do + L
    u = clg_stats.latent_units(Do, L)
    rows = clg_stats.latent_row_units(D, L)
    y_row = [b._replace(i=-1) for b in rows if b.i == 0]
    units = ([("leaf", b) for b in y_row + [b for b in rows if b.i < Do]]
             + [("latent", b) for b in rows if b.i >= Do])
    assert len(units) == u.Wo + u.Wh
    for w, (kind, b) in enumerate(units):
        for s in range(b.width):
            c = b.col0 + s
            if b.i < 0:
                yield kind, ("xy", c), u.UO - 1 - D + c
            elif c >= b.i and kind == "leaf":
                yield kind, ("xx", b.i, c), (b.i * D - b.i * (b.i - 1) // 2
                                             + c - b.i)
            elif c >= b.i:
                l, m = b.i - Do, c - Do
                yield kind, ("xx", b.i, c), l * L - l * (l - 1) // 2 + m - l
        if b.i < 0 and b.j == 0:                   # slot ROW_BLOCK
            yield kind, ("yy",), u.UO - 1
        if w == u.Wo:                              # slot ROW_BLOCK
            yield kind, ("r",), u.UH - 1


@pytest.mark.parametrize("Do,L,K", [(1, 8, 1), (1, 16, 5), (2, 38, 2),
                                    (40, 3, 2)])
def test_latent_row_units_write_every_entry_once(Do, L, K):
    """The latent D > 8 units (observed-column blocks, then latent-column
    blocks, so a block reads one array; the y row's blocks with the leaf
    units): each entry of a leaf unit's (f, k) and of a latent unit's k,
    rsum_k included, is written by exactly one slot that sums its
    product, and the latent units are a component's, not a leaf's."""
    D = Do + L
    u = clg_stats.latent_units(Do, L)
    iu = np.triu_indices(D)
    xx = [("xx", int(a), int(b)) for a, b in zip(*iu)]
    want = {"leaf": [e for e in xx if e[1] < Do]
            + [("xy", i) for i in range(D)] + [("yy",)],
            "latent": [e for e in xx if e[1] >= Do] + [("r",)]}
    assert (len(want["leaf"]), len(want["latent"])) == (u.UO, u.UH)
    seen = {}
    for kind, what, e in _latent_row_slots(Do, L):
        assert (kind, e) not in seen
        seen[(kind, e)] = what
        assert what == want[kind][e]
    assert len(seen) == u.UO + u.UH
    p = clg_stats.latent_plan(1 << 16, 16, Do, L, K, SMS)
    assert p.UBh == min(K * u.Wh, clg_stats.THREADS)


@pytest.mark.parametrize("N,chunk", [(1000, 256), (1024, 256), (300, 512),
                                     (1, 4)])
def test_clg_suffstats_chunks_equals_per_chunk_calls(N, chunk):
    """On CPU tensors (the plain version) each chunk's moments are the
    bits of ``clg_suffstats`` of that chunk; the last chunk may be short."""
    d, y, r = map(torch.from_numpy, _moments_inputs(N, 4, 3, 2, 13))
    before = dict(clg_stats.LAUNCHES)
    got = clg_stats.clg_suffstats_chunks(d, y, r, chunk)
    assert clg_stats.LAUNCHES == before
    n_chunks = -(-N // chunk)
    assert got[0].shape == (n_chunks, 4, 2, 3, 3)
    assert got[1].shape == (n_chunks, 4, 2, 3) and got[2].shape == (
        n_chunks, 4, 2)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        for a, b in zip(got, clg_stats.clg_suffstats(d[sl], y[sl], r[sl])):
            assert torch.equal(a[i], b)
    with pytest.raises(ValueError, match="positive"):
        clg_stats.clg_suffstats_chunks(d, y, r, 0)


# -- clg_disc_counts: the kernel's units, ranges and lanes ---------------------


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n,Fd,K,C", [
    (1 << 20, 2, 3, 4),       # nb_mixed: a unit holds a leaf's 12 entries
    (1 << 18, 400, 4, 8),     # a wide row: a warp of neighbouring leaves
    (3000, 380, 2, 64),       # Fd + K > 376 and C = 64: 16-bin blocks
    (1, 1, 1, 1), (777, 5, 7, 3), (4099, 33, 16, 17),
])
def test_disc_plan_covers_every_entry_and_instance_once(n, Fd, K, C, sms):
    """A unit's sums fit MAX_SLOTS registers; the units write every entry
    (f, k, c) once; a block's positions and lanes fill its threads; the
    ranges and their lanes take every instance once, DISC_MIN_ITERS or
    more a lane, in at most DISC_BLOCKS_PER_SM blocks an SM of the card it
    is given."""
    p = clg_stats.disc_plan(n, Fd, K, C, sms)
    assert 1 <= p.KG <= 4 and p.CB in (2, 4, 8, 16)
    assert p.KG * p.CB <= clg_stats.MAX_SLOTS and p.CB >= min(C, 16)
    assert p.n_kg * p.KG >= K > (p.n_kg - 1) * p.KG
    units = Fd * p.n_kg * p.n_cb
    assert p.PU in (1, 2, 4, 8, 16, 32) and p.PU >= min(units, 32)
    assert p.PU * p.NL == clg_stats.THREADS
    written = np.zeros((Fd, K, C), np.int64)
    for u in range(units):
        f, cb, kg = u % Fd, u // Fd % p.n_cb, u // (Fd * p.n_cb)
        written[f, kg * p.KG:(kg + 1) * p.KG,
                cb * p.CB:(cb + 1) * p.CB] += 1
    assert (written == 1).all()
    assert p.R * p.range_len >= n > (p.R - 1) * p.range_len
    assert p.R <= 65535
    assert p.R == 1 or (p.R * -(-units // p.PU)
                        <= clg_stats.DISC_BLOCKS_PER_SM * sms)
    assert p.R == 1 or p.range_len >= p.NL * clg_stats.DISC_MIN_ITERS
    taken = np.zeros(n, np.int64)
    for q in range(p.R):
        n0, n1 = q * p.range_len, min(n, (q + 1) * p.range_len)
        for lane in range(p.NL):
            taken[n0 + lane:n1:p.NL] += 1
    assert (taken == 1).all()
    if (Fd, K, C) == (2, 3, 4):
        assert (p.KG, p.CB, units, p.PU, p.R) == (3, 4, 2, 2, 256)


def _emulate_disc(xd, r, C):
    """``clg_disc_counts`` as the kernel sums it (``disc_plan``): lane l of
    a range adds r[n, k] into the bin of xd[n, f] for its instances l, l +
    NL, ... in order; a warp's lanes of a position add by a tree, the
    warps in order; then stage 2.  The split into units changes no sum."""
    N, Fd = xd.shape
    K = r.shape[1]
    p = clg_stats.disc_plan(N, Fd, K, C, SMS)
    hot = (xd[:, :, None] == np.arange(C)).astype(np.float32)
    terms = hot[:, :, None, :] * r[:, None, :, None]     # exact: r or 0
    warps = clg_stats.THREADS // 32
    part = np.zeros((p.R, Fd, K, C), np.float32)
    for q in range(p.R):
        n0, n1 = q * p.range_len, min(N, (q + 1) * p.range_len)
        lanes = np.zeros((p.NL, Fd, K, C), np.float32)
        for lane in range(p.NL):
            for n in range(n0 + lane, n1, p.NL):
                lanes[lane] += terms[n]
        lanes = lanes.reshape(warps, p.NL // warps, Fd, K, C)
        h = p.NL // warps // 2
        while h:
            lanes[:, :h] += lanes[:, h:2 * h]
            h //= 2
        for w in range(warps):
            part[q] += lanes[w, 0]
    return _sum_ranges(part)


@pytest.mark.parametrize("N,Fd,C,K", [
    (3000, 2, 4, 3),          # nb_mixed's widths
    (1000, 3, 5, 6),          # CB = 8, the components in two groups of 3
    (513, 40, 3, 2),          # a warp of neighbouring leaf groups
    (300, 2, 64, 3),          # C = 64: four blocks of 16 bins
])
def test_clg_disc_counts_partition_matches_pallas(N, Fd, C, K):
    """The kernel's ranges, lanes, shuffle tree, warp order and stage 2,
    emulated in float32, against the Pallas kernel in interpret mode and
    the JAX oracle; categories -1 and >= C count nothing."""
    g = np.random.default_rng(31)
    xd = g.integers(-1, C + 1, (N, Fd)).astype(np.int32)
    r = _softmax(g.standard_normal((N, K)))
    got = _emulate_disc(xd, r, C)
    pallas = jk.clg_disc_counts(jnp.asarray(xd), jnp.asarray(r), C,
                                block=256, interpret=True)
    for exp in (pallas, jref.clg_disc_counts_ref(xd, r, C)):
        np.testing.assert_allclose(got, np.asarray(exp), rtol=RTOL,
                                   atol=ATOL)
