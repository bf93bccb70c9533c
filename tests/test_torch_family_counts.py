"""The port's ``family_counts`` (plain version, stride compaction, launch
plan and the kernel's arithmetic emulated in numpy) and the independence of
the moments' leaf ranges on the CPU, against the JAX package's oracle
``repro.kernels.ref.family_counts_ref`` and its Pallas kernel in interpret
mode.  Inputs are numpy arrays made from a seed and
handed to both packages.

Tolerances: with 0/1 weights every count is an exact integer below 2^24, so
the port's counts equal the reference's exactly; with float weights in
(0, 1) both sum float32 terms in different orders: rtol 1e-5, atol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.family_counts import family_counts as pallas_counts  # noqa: E402,E501
from repro_torch.kernels import clg_stats, ref  # noqa: E402
from repro_torch.kernels import family_counts as fc  # noqa: E402

import _torch_parity  # noqa: E402,F401  (one torch thread per worker)

RTOL = ATOL = 1e-5
SMS = 132         # an H100 SXM's SMs; the wrapper takes the card's count


def _sweep_inputs(N, Fd, seed):
    """The families of ``tests/test_kernels.py::test_family_counts_sweep``:
    each variable with its two successors as parents."""
    g = np.random.default_rng(seed)
    cards = [int(c) for c in g.integers(2, 5, Fd)]
    xd = np.stack([g.integers(0, c, N) for c in cards], 1).astype(np.int32)
    fams = [(f, tuple((f + 1 + j) % Fd for j in range(min(2, Fd - 1))))
            for f in range(Fd)]
    strides = np.zeros((len(fams), Fd), np.int32)
    sizes = []
    for m, (ch, pa) in enumerate(fams):
        strides[m, ch] = 1
        s = cards[ch]
        for p in reversed(pa):
            strides[m, p] = s
            s *= cards[p]
        sizes.append(s)
    w = g.random(N).astype(np.float32)
    return xd, strides, w, max(sizes)


def _port(xd, strides, w, C):
    return fc.family_counts(torch.from_numpy(xd), torch.from_numpy(strides),
                            torch.from_numpy(w), C).numpy()


@pytest.mark.parametrize("N,Fd,block", [(1000, 4, 256), (513, 2, 128),
                                        (100, 6, 64)])
def test_family_counts_sweep_matches_reference_and_pallas(N, Fd, block):
    xd, strides, w, C = _sweep_inputs(N, Fd, seed=N)
    before = dict(fc.LAUNCHES)
    got = _port(xd, strides, w, C)
    assert fc.LAUNCHES == before          # a CPU tensor takes the plain route
    exp = np.asarray(jref.family_counts_ref(jnp.asarray(xd),
                                            jnp.asarray(strides),
                                            jnp.asarray(w), C))
    pal = np.asarray(pallas_counts(jnp.asarray(xd), jnp.asarray(strides),
                                   jnp.asarray(w), C, block=block,
                                   interpret=True))
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)
    ones = np.ones(N, np.float32)
    np.testing.assert_array_equal(
        _port(xd, strides, ones, C),
        np.asarray(jref.family_counts_ref(jnp.asarray(xd),
                                          jnp.asarray(strides),
                                          jnp.asarray(ones), C)))


def test_out_of_range_codes_and_masked_tail_count_nothing():
    """Categories -1 and >= card give codes < 0 or >= C: no bin gets them
    (``jax.nn.one_hot`` and the Pallas ``cols == code`` test agree); a
    masked tail (w = 0) adds nothing."""
    g = np.random.default_rng(3)
    N, Fd, C = 700, 3, 9
    xd = g.integers(-1, 5, (N, Fd)).astype(np.int32)
    strides = np.array([[1, 3, 0], [0, 1, 3], [1, 0, 0], [3, 0, 1]],
                       np.int32)
    w = np.ones(N, np.float32)
    w[-100:] = 0.0
    got = _port(xd, strides, w, C)
    exp = np.asarray(jref.family_counts_ref(jnp.asarray(xd),
                                            jnp.asarray(strides),
                                            jnp.asarray(w), C))
    pal = np.asarray(pallas_counts(jnp.asarray(xd), jnp.asarray(strides),
                                   jnp.asarray(w), C, block=128,
                                   interpret=True))
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, _port(xd[:-100], strides, w[:-100], C))
    assert got.sum() < 600 * len(strides)


def test_plain_version_chunks_instances_and_families(monkeypatch):
    """The plain version's chunking over (instance, family) pairs gives the
    same counts as one chunk."""
    xd, strides, w, C = _sweep_inputs(1000, 6, seed=5)
    whole = _port(xd, strides, w, C)
    monkeypatch.setattr(ref, "FAMILY_CHUNK", 333)
    np.testing.assert_allclose(_port(xd, strides, w, C), whole, rtol=RTOL,
                               atol=ATOL)


def test_compact_strides_keeps_each_family_code():
    """(column, stride) pairs reproduce the dense code of every family."""
    g = np.random.default_rng(7)
    N, Fd, M = 300, 9, 40
    xd = g.integers(0, 4, (N, Fd)).astype(np.int32)
    strides = np.zeros((M, Fd), np.int32)
    for m in range(M):
        cols = g.choice(Fd, size=int(g.integers(1, 5)), replace=False)
        strides[m, cols] = g.integers(1, 50, len(cols))
    cols, svals = fc.compact_strides(torch.from_numpy(strides))
    assert cols.dtype == svals.dtype == torch.int32
    assert cols.shape == (M, 4)
    dense = xd.astype(np.int64) @ strides.T.astype(np.int64)
    pairs = (xd[:, cols.numpy()].astype(np.int64)
             * svals.numpy()[None]).sum(-1)
    np.testing.assert_array_equal(pairs, dense)
    # nonzero strides first, in column order
    for m in range(M):
        nz = np.nonzero(strides[m])[0]
        np.testing.assert_array_equal(cols.numpy()[m, :len(nz)], nz)


U32 = np.uint64(0xFFFFFFFF)


def _codes(tile, cnt, nq, cols, svals, narrow):
    """[M, 4 * nq] uint32 codes of a tile as the kernel computes them: from
    the transposed byte tile as two pairs of packed 16-bit lanes when
    ``narrow`` and the family's largest code fits 16 bits, else from the
    int32 tile with wrap-around arithmetic.  Instances past ``cnt`` read
    zeros (their weights are 0)."""
    x = np.zeros((4 * nq, tile.shape[1]), np.int64)
    x[:cnt] = tile[:cnt]
    sv = svals.astype(np.int64) & 0xFFFFFFFF                   # [M, k]
    xv = x[:, cols].astype(np.int64) & 0xFFFFFFFF             # [4nq, M, k]
    wide = ((xv * sv[None]).sum(-1) & 0xFFFFFFFF).T.astype(np.uint64)
    if not narrow:
        return wide
    b = x.reshape(nq, 4, -1) & 255                            # [nq, 4, Fd]
    words = (b * (1 << (8 * np.arange(4)))[None, :, None]).sum(1)
    v = words[:, cols]                                        # [nq, M, k]
    top = (np.minimum(sv, 65536) * 255).sum(-1)
    packed = (svals >= 0).all(-1) & (top <= 65535)            # [M]
    lo = ((v & 0x00FF00FF) * sv[None]).sum(-1) & 0xFFFFFFFF    # [nq, M]
    hi = (((v >> 8) & 0x00FF00FF) * sv[None]).sum(-1) & 0xFFFFFFFF
    pk = np.stack([lo & 0xFFFF, hi & 0xFFFF, lo >> 16, hi >> 16], 1)
    pk = pk.reshape(4 * nq, -1).T.astype(np.uint64)           # [M, 4nq]
    return np.where(packed[:, None], pk, wide)


def _emulate(xd, strides, w, C, p):
    """The kernel's arithmetic in numpy under plan ``p``: instance slabs
    walked tile by tile; per tile the byte staging where every value lies
    in [0, 255] and the int32 tile otherwise (``_codes``); quads dealt to
    S = 256 / G slices in order; a bin-major histogram of Cb bins and a
    spill bin (index Cb) per thread, for codes outside the block's range;
    four updates a quad in instance order; slice histograms added in order;
    then the slabs summed by 32 lanes, each a strided set of slabs in
    order, and a fixed tree over the lanes."""
    N, M = xd.shape[0], strides.shape[0]
    cols, svals = (t.numpy() for t in fc.compact_strides(
        torch.from_numpy(strides)))
    S = fc.THREADS // p.G
    ar = np.arange(M)
    partial = np.zeros((p.n_slabs, C, M), np.float32)
    for z in range(p.n_cranges):
        c0 = z * p.Cb
        cw = min(p.Cb, C - c0)
        for slab in range(p.n_slabs):
            n0, n1 = slab * p.slab_len, min(N, (slab + 1) * p.slab_len)
            hist = np.zeros((S, M, p.Cb + 1), np.float32)
            for t0 in range(n0, n1, p.T):
                cnt = min(p.T, n1 - t0)
                nq = -(-cnt // 4)
                tile = xd[t0:t0 + cnt]
                narrow = bool(((tile >= 0) & (tile <= 255)).all())
                code = _codes(tile, cnt, nq, cols, svals, narrow)
                idx = np.minimum((code - np.uint64(c0)) & U32,
                                 np.uint64(p.Cb)).astype(np.int64)
                ws = np.zeros(4 * nq, np.float32)
                ws[:cnt] = w[t0:t0 + cnt]
                for q in range(nq):
                    for i in range(4 * q, 4 * q + 4):
                        h = hist[q % S]
                        h[ar, idx[:, i]] = h[ar, idx[:, i]] + ws[i]
            tot = np.zeros((M, cw), np.float32)
            for s_ in range(S):
                tot += hist[s_, :, :cw]
            partial[slab, c0:c0 + cw] = tot.T
    lanes = np.zeros((32, C, M), np.float32)
    for lane in range(32):
        for slab in range(lane, p.n_slabs, 32):
            lanes[lane] += partial[slab]
    for h in (16, 8, 4, 2, 1):
        lanes[:h] += lanes[h:2 * h]
    return lanes[0].T


def _pair_families(M, Fd, card):
    strides = np.zeros((M, Fd), np.int32)
    for m in range(M):
        ch = m % Fd
        strides[m, ch] = 1
        strides[m, (ch + 1) % Fd] = card
    return strides


@pytest.mark.parametrize("N,Fd,M,card,C", [
    (600, 3, 5, 3, 27), (2000, 4, 70, 2, 16), (300, 2, 3, 30, 900),
    (1500, 5, 40, 300, 90000),      # values above 255: the int32 tiles
    (700, 6, 300, 4, 16),           # G = 256: one slice, two groups
])
def test_launch_plan_covers_every_family_bin_and_instance(N, Fd, M, card, C):
    """Emulating the kernel's split (families per block, slabs, tiles,
    quads dealt to slices, C ranges with a spill bin, byte or int32
    staging) with the plan's numbers gives the reference's counts: every
    (family, bin) is written once and every instance counted once."""
    g = np.random.default_rng(N)
    xd = g.integers(0, card, (N, Fd)).astype(np.int32)
    strides = _pair_families(M, Fd, card)
    w = (g.random(N) < 0.9).astype(np.float32)
    p = fc.plan(N, Fd, M, C, SMS)
    if C >= 900:
        assert p.n_cranges > 1
    exp = np.asarray(jref.family_counts_ref(jnp.asarray(xd),
                                            jnp.asarray(strides),
                                            jnp.asarray(w), C))
    np.testing.assert_array_equal(_emulate(xd, strides, w, C, p), exp)


@pytest.mark.parametrize("Fd,T", [(3, 256), (64, 64), (200, 20)])
def test_kernel_emulation_mixes_byte_and_int32_tiles(Fd, T):
    """Tiles with a value above 255 or below 0 take the int32 path, the
    others the byte path, in one launch; negative and out-of-range values
    whose codes come back into [0, C) through other terms (5 + 3 * -1 = 2)
    count where the reference counts them."""
    g = np.random.default_rng(Fd)
    N, C = 1200, 9
    xd = g.integers(0, 3, (N, Fd)).astype(np.int32)
    xd[5, :3] = [5, -1, 1]               # codes 2 (fam 0) and 2 (fam 1)
    xd[T + 7, 2] = 300                   # a second tile above 255
    xd[3 * T + 1, 0] = -2                # a fourth tile below 0
    strides = np.zeros((4, Fd), np.int32)
    strides[:, :3] = [[1, 3, 0], [0, 1, 3], [1, 0, 0], [3, 0, 1]]
    p = fc.plan(N, Fd, len(strides), C, SMS)
    assert p.T == T
    for w in ((g.random(N) < 0.8).astype(np.float32),
              g.random(N).astype(np.float32)):
        exp = np.asarray(jref.family_counts_ref(
            jnp.asarray(xd), jnp.asarray(strides), jnp.asarray(w), C))
        got = _emulate(xd, strides, w, C, p)
        np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
        if (w == w.round()).all():
            np.testing.assert_array_equal(got, exp)
    assert _emulate(xd, strides, np.ones(N, np.float32), C, p)[:2, 2].min() \
        >= 1


def test_kernel_emulation_codes_past_16_bits_from_the_int32_tile():
    """A family whose largest byte-tile code exceeds 16 bits (strides up to
    7^3 over values up to 255) is not coded in packed lanes: its codes come
    from the int32 tile, also in tiles the other families read as bytes,
    and it counts what the reference counts."""
    g = np.random.default_rng(9)
    N, Fd, card = 600, 5, 7
    xd = g.integers(0, card, (N, Fd)).astype(np.int32)
    strides = np.array([[1, 7, 49, 343, 0], [0, 1, 7, 49, 343],
                        [1, 7, 0, 0, 0]], np.int32)     # the last packs
    C = card ** 4
    w = (g.random(N) < 0.9).astype(np.float32)
    p = fc.plan(N, Fd, 3, C, SMS)
    exp = np.asarray(jref.family_counts_ref(
        jnp.asarray(xd), jnp.asarray(strides), jnp.asarray(w), C))
    np.testing.assert_array_equal(_emulate(xd, strides, w, C, p), exp)


@pytest.mark.parametrize("N,Fd,M,C", [
    (1 << 20, 32, 15904, 64),       # all candidates, <= 2 parents
    (1 << 20, 32, 992, 16),         # hill-climbing's first step
    (1 << 20, 32, 31, 256),         # a step with 3-parent families
    (5, 3, 1, 4), (20000, 5, 33, 2401), (777, 511, 65, 27),
    (1 << 16, 8, 3000, 100000),
])
def test_launch_plan_fits_the_card(N, Fd, M, C):
    p = fc.plan(N, Fd, M, C, SMS)
    assert p.smem_bytes <= fc.SMEM_MAX
    assert p.smem_bytes == fc.smem_bytes(Fd, p.Cb, p.T)
    assert p.T % 4 == 0 and p.blocks_per_sm >= 1
    assert p.G in (32, 64, 128, 256) and p.n_groups * p.G >= M
    assert p.n_cranges * p.Cb >= C > (p.n_cranges - 1) * p.Cb
    assert p.T >= fc.MIN_TILE and p.slab_len % p.T == 0
    assert p.n_slabs * p.slab_len >= N > (p.n_slabs - 1) * p.slab_len
    assert p.n_slabs == 1 or p.n_slabs * M * C <= fc.PARTIAL_WORDS
    assert p.n_slabs <= 65535 and p.n_cranges <= 65535


@pytest.mark.parametrize("N,M,C,blocks,ranges", [
    (1 << 20, 15904, 64, 2, 1),     # all candidates
    (1 << 20, 992, 16, 4, 1),       # hill climbing's first step
    (1 << 16, 631, 256, 1, 2),      # the adaptive stream's largest call
    (1 << 20, 992, 200, 2, 3),      # two blocks an SM cost fewer passes
])
def test_launch_plan_weighs_ranges_against_resident_blocks(N, M, C, blocks,
                                                          ranges):
    """C = 256: two ranges at one block an SM tie with four at two, and the
    tie keeps the fewer; C = 200: three ranges at two blocks an SM beat two
    at one."""
    p = fc.plan(N, 32, M, C, SMS)
    assert (p.blocks_per_sm, p.n_cranges) == (blocks, ranges)
    assert p.blocks_per_sm == fc.resident_blocks(p.smem_bytes)


def test_launch_plan_raises_beyond_the_tile_limit():
    with pytest.raises(ValueError, match="limit of 511"):
        fc.plan(100, 512, 4, 8, SMS)


# -- leaf ranges of the moments ------------------------------------------------


def test_chunked_plain_moments_equal_unchunked():
    """Each leaf's moments are independent: the plain moments of the leaf
    ranges, joined, equal the moments of the whole row (same bits: the
    einsum sums every leaf over the same instances in the same order)."""
    g = np.random.default_rng(11)
    N, F, D, K = 400, 150, 2, 3
    d = torch.from_numpy(g.standard_normal((N, F, D), dtype=np.float32))
    y = torch.from_numpy(g.standard_normal((N, F), dtype=np.float32))
    r = torch.softmax(torch.from_numpy(
        g.standard_normal((N, K), dtype=np.float32)), -1)
    ranges = [(0, 37), (37, 75), (75, 112), (112, 150)]
    whole = ref.clg_suffstats_ref(d, y, r)
    parts = [ref.clg_suffstats_ref(d[:, a:b], y[:, a:b], r)
             for a, b in ranges]
    for w_, p_ in zip(whole, zip(*parts)):
        torch.testing.assert_close(torch.cat(p_, 0), w_, rtol=1e-6,
                                   atol=1e-5)
    got = clg_stats.clg_suffstats(d, y, r)        # CPU: the plain version
    for a, b in zip(got, whole):
        assert torch.equal(a, b)
