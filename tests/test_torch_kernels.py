"""The port's suff-stats kernel wrappers on the CPU (their plain PyTorch
versions) against the JAX Pallas kernels in interpret mode and against
``repro.kernels.ref``, on the shapes of ``tests/test_kernels.py``; the
``clg_suffstats`` kernel's instance partition and fixed-order stage 2
emulated in numpy against the same, and its chunked entry against
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


def test_wrapper_padding_is_inert():
    """The CUDA wrappers pad N to a tile multiple with zero r and category
    -1; on the plain versions that padding changes nothing."""
    d, y, r = _moments_inputs(300, 2, 3, 2, 6)
    td, ty, tr = map(torch.from_numpy, (d, y, r))
    T = clg_stats.tile_for(2 * 3 + 2 + 2, "test")
    pad = -(-300 // T) * T - 300
    assert pad > 0
    padded = clg_stats.clg_suffstats(*(clg_stats._pad_rows(x, pad)
                                       for x in (td, ty, tr)))
    for a, b in zip(padded, clg_stats.clg_suffstats(td, ty, tr)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-5)
    xd = torch.from_numpy(np.random.default_rng(7).integers(
        0, 4, (300, 2)).astype(np.int32))
    got = clg_stats.clg_disc_counts(clg_stats._pad_rows(xd, pad, value=-1),
                                    clg_stats._pad_rows(tr, pad), 4)
    np.testing.assert_allclose(got.numpy(),
                               clg_stats.clg_disc_counts(xd, tr, 4).numpy(),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("row,tile", [(24, 256), (48, 128), (200, 32),
                                      (376, 32)])
def test_tile_fits_shared_memory(row, tile):
    assert clg_stats.tile_for(row, "test") == tile
    assert 4 * (tile * row + clg_stats.THREADS) <= clg_stats.SMEM_BYTES


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    d, y, r = map(torch.from_numpy, _moments_inputs(64, 2, 3, 2, 8))
    with pytest.raises(ValueError, match="limit of 376"):
        clg_stats.tile_for(377, "clg_suffstats")
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
    p = clg_stats.moments_plan(N, F, D, K)
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
    p = clg_stats.moments_plan(n, F, D, K)
    U = clg_stats.entries_per_unit(D)
    assert p.FT * p.UB * p.NL <= clg_stats.THREADS and p.NL >= 1
    if D <= 8:
        assert p.KG * U <= clg_stats.MAX_SLOTS and p.W * p.KG >= K
    else:
        assert p.KG == 1 and p.W == K * D * -(-D // clg_stats.ROW_BLOCK)
    assert p.n_ublocks * p.UB >= p.W > (p.n_ublocks - 1) * p.UB
    assert p.R * p.range_len >= n > (p.R - 1) * p.range_len
    blocks = -(-F // p.FT) * p.n_ublocks * p.R
    assert p.R == 1 or blocks <= clg_stats.TARGET_BLOCKS
    assert p.R <= 65535
    for m in (1, n // 3, n - 1):          # a shorter last chunk: the same
        if m:                             # block, its own ranges
            q = clg_stats.moments_plan(m, F, D, K)
            assert q[:6] == p[:6]
            assert q.R * q.range_len >= m > (q.R - 1) * q.range_len


def _row_unit_slots(D, K):
    """The D > 8 stage-1 units as ``moments_rows`` in clg_stats.cu maps
    them: unit (k * D + i) * NB + j sums, for slot s < ROW_BLOCK, the
    product d_i d_b with b = ROW_BLOCK * j + s; slot ROW_BLOCK d_i y and
    slot ROW_BLOCK + 1 y^2.  Yields (k, what the slot sums, the compact
    entry it is written to) for every slot written."""
    B = clg_stats.ROW_BLOCK
    NB = -(-D // B)
    tri = D * (D + 1) // 2
    for unit in range(clg_stats.moments_plan(1, 1, D, K).W):
        k, i, jb = unit // (D * NB), unit // NB % D, unit % NB * B
        if jb + B <= i:                  # left of the diagonal: not live
            continue
        for s in range(B):
            b = jb + s
            if i <= b < D:
                yield k, ("xx", i, b), i * D - i * (i - 1) // 2 + b - i
        if i // B * B == jb:
            yield k, ("xy", i), tri + i
        if i == 0 and jb == 0:
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
