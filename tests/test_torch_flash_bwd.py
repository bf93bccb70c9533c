"""``flash_attention``'s gradient on the CPU route against ``jax.grad`` of
the reference's ``attention_blockwise``; the plain backward
(``flash_attention_backward_plain``, the backward kernels' oracle) against
autograd; the backward kernels' plans (``bwd_tile_plan``,
``dq_kv_tile_range``, ``q_tile_range``, ``dkdv_heads``) at each tile plan
emulated in numpy; and the bf16 kernels' rounding points emulated in
torch in their tile order.

Tolerances (relative L2 error of each gradient): fp32 1e-5 (the same fp32
products summed in another order); bf16 2^-6 (both packages round the
inputs' products, p and the outputs to bf16, at other places; measured
worst ~2^-8).  The plain backward against autograd of
``attention_reference`` in float64: 1e-5 (the plain backward works in
fp32).  The plans: every live (q, k) pair exactly once.  The emulated
bf16 kernels: half of chip_smoke.py's bar (2^-7) against the plain
backward in fp32, and 2^-6 against ``jax.grad`` in bf16.

The plain backward at the fp32 kernels' wide heads (D = 144, 256; causal
GQA, windowed, at an offset) against ``jax.grad`` in fp32 at 1e-5.

The causal q offset (query i at position q_offset + i): the CPU route's
gradients at an offset against ``jax.grad`` (fp32, 1e-5) and the plain
backward against autograd in float64 (1e-5); the plans at offset 0 equal
to the plans before the offset for any shape, and at any offset covering
every live pair of the shifted mask once (hypothesis over shapes).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

import _torch_parity  # noqa: E402,F401  (one torch thread per worker)
from _torch_tf32 import _mm3  # noqa: E402
from repro.nn import attention as JA  # noqa: E402
from repro_torch.kernels import flash_attn  # noqa: E402
from repro_torch.nn import attention as A  # noqa: E402

REL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}

# (B, Sq, Sk, Hq, Hkv, D, causal, window)
ROUTES = {
    "causal_mha": (2, 96, 96, 2, 2, 16, True, None),
    "causal_gqa4": (1, 96, 96, 8, 2, 16, True, None),
    "window": (1, 130, 130, 4, 1, 16, True, 40),
    "noncausal": (2, 70, 70, 4, 4, 32, False, None),
    "cross_ragged": (1, 40, 150, 4, 1, 16, False, None),
    "window_only": (1, 100, 100, 2, 2, 16, False, 30),
}


def _inputs(B, Sq, Sk, Hq, Hkv, D, seed=0):
    g = np.random.default_rng(seed)
    return [g.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                      (B, Sq, Hq, D))]


def _rel(got, exp):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float(np.linalg.norm(got - exp) / max(np.linalg.norm(exp), 1e-30))


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_gradients_match_jax_grad(route, dtype):
    """kv_block 32 in both packages, so that Sk spans several blocks and
    the ragged one."""
    B, Sq, Sk, Hq, Hkv, D, causal, window = ROUTES[route]
    q, k, v, g = _inputs(B, Sq, Sk, Hq, Hkv, D)
    jdt = getattr(jnp, dtype)

    def jloss(q_, k_, v_):
        o = JA.attention_blockwise(q_, k_, v_, causal=causal, window=window,
                                   kv_block=32)
        return jnp.sum(o.astype(jnp.float32) * g)

    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    exp = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    flash_attn.reset_launches()
    o = flash_attn.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert flash_attn.LAUNCHES == {"flash_attention": 0,
                                   "flash_attention_backward": 0}
    # the CPU route is attention_blockwise with its default block; kv_block
    # only regroups the same sums, which the fp32 bar covers
    (o.float() * torch.from_numpy(g)).sum().backward()
    for got, e in zip((tq.grad, tk.grad, tv.grad), exp):
        assert got.dtype == tdt
        assert _rel(got.float().numpy(), np.asarray(e, np.float32)) \
            <= REL[dtype]


@pytest.mark.parametrize("route", list(ROUTES))
def test_plain_backward_matches_autograd(route):
    """The plain backward, from the forward's output and the plain lse,
    against autograd of ``attention_reference`` in float64; kv blocks of
    32 and of the whole Sk give the same function."""
    B, Sq, Sk, Hq, Hkv, D, causal, window = ROUTES[route]
    q, k, v, g = (torch.from_numpy(a).double()
                  for a in _inputs(B, Sq, Sk, Hq, Hkv, D, seed=1))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o = A.attention_reference(qr, kr, vr, causal=causal, window=window)
    exp = torch.autograd.grad(o, (qr, kr, vr), g)
    lse = flash_attn.attention_lse_plain(q, k, causal=causal, window=window)
    for kv_block in (32, 1024):
        got = flash_attn.flash_attention_backward_plain(
            q, k, v, o.detach(), lse, g, causal=causal, window=window,
            kv_block=kv_block)
        for a, e in zip(got, exp):
            assert a.dtype == torch.float32 and a.shape == e.shape
            assert _rel(a.numpy(), e.numpy()) <= 1e-5


def test_lse_matches_logsumexp_of_the_masked_scores():
    B, Sq, Sk, Hq, Hkv, D, causal, window = ROUTES["window"]
    q, k, _, _ = (torch.from_numpy(a) for a in _inputs(B, Sq, Sk, Hq, Hkv, D))
    lse = flash_attn.attention_lse_plain(q, k, causal=causal, window=window,
                                         kv_block=48)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(),
                     k.double()[:, :, torch.arange(Hq) % Hkv]) / D ** 0.5
    bias = A._mask_bias(Sq, Sk, 0, causal, window).double()
    exp = torch.logsumexp(s + torch.where(bias < 0, -torch.inf, 0.0), -1)
    torch.testing.assert_close(lse.double(), exp, rtol=1e-6, atol=1e-5)


def test_backward_wrapper_takes_cuda_tensors_only():
    q, k, v, g = (torch.from_numpy(a)
                  for a in _inputs(1, 16, 16, 2, 2, 16))
    lse = flash_attn.attention_lse_plain(q, k)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attn.flash_attention_backward(q, k, v, q, lse, g)


# -- the backward kernels' plans ----------------------------------------------


def _live(Sq, Sk, causal, window):
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    return ok


PLAN_CASES = [(4096, 4096, True, None), (8192, 8192, True, 4096),
              (1500, 1500, False, None), (448, 1500, False, None),
              (1, 1500, False, None), (100, 37, True, 5),
              (300, 130, False, 70), (130, 64, True, None),
              (65, 200, True, 1), (64, 64, False, 64)]

# the backward kernels' tile plans: bf16 at D = 16, 64, 128, 256 (DP 64,
# 64, 128, 256) and the fp32 kernels' (64 x 64 tiles in d-chunks of 64
# columns at every D; accumulators DP = 64, 256, 256, 256 wide)
PLANS = {f"bf16-D{D}": flash_attn.bwd_tile_plan(D) for D in (16, 64, 128, 256)}
PLANS["fp32"] = flash_attn.bwd_tile_plan(64, bf16=False)
PLANS.update({f"fp32-D{D}": flash_attn.bwd_tile_plan(D, bf16=False)
              for D in (144, 192, 256)})


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("Sq,Sk,causal,window", PLAN_CASES)
def test_dq_plan_covers_every_live_pair_once(Sq, Sk, causal, window, plan):
    """Each q tile's kv tiles, in order, cover every live pair of its rows
    exactly once (tiles are disjoint, so once is at most once)."""
    bq, bk = PLANS[plan].dq_bq, PLANS[plan].dq_bk
    cover = np.zeros((Sq, Sk), np.uint8)
    for qt in range(-(-Sq // bq)):
        tiles = list(flash_attn.dq_kv_tile_range(qt, Sq, Sk, causal, window,
                                                 bq, bk))
        assert tiles == sorted(set(tiles))
        for kt in tiles:
            cover[qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk] += 1
    live = _live(Sq, Sk, causal, window)
    assert (cover[live] == 1).all()
    assert cover.max() <= 1


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("Sq,Sk,causal,window", PLAN_CASES)
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 4), (4, 1)])
def test_dkdv_plan_covers_every_live_pair_once(Sq, Sk, causal, window, Hq,
                                               Hkv, plan):
    """Each (kv head, kv tile) block sums the G q heads h = g Hkv + hk in
    order g = 0 .. G - 1 and, for each, its q tiles in order: every live
    (q head, q, k) triple exactly once, each q head through the kv head
    h % Hkv.  The tiles do not depend on the head, so one cover of the
    tiles stands for every head that visits them."""
    bq, bk = PLANS[plan].kv_bq, PLANS[plan].kv_bk
    tiles = []
    cover = np.zeros((Sq, Sk), np.uint8)
    for kt in range(-(-Sk // bk)):
        qts = list(flash_attn.q_tile_range(kt, Sq, Sk, causal, window, bq,
                                           bk))
        assert qts == sorted(set(qts))
        for qt in qts:
            cover[qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk] += 1
            tiles.append((kt, qt))
    live = _live(Sq, Sk, causal, window)
    assert (cover[live] == 1).all() and cover.max() <= 1
    seen = {h: 0 for h in range(Hq)}
    for hk in range(Hkv):
        heads = flash_attn.dkdv_heads(hk, Hq, Hkv)
        assert heads == sorted(heads) and all(h % Hkv == hk for h in heads)
        for h in heads:
            seen[h] += 1
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
def test_bwd_smem_fits_a_block(bf16):
    """Both kernels' shared memory fits Hopper's 227 KB a block at every D
    they take, bf16 and fp32 up to 256 (the library checks these numbers
    when it loads)."""
    assert flash_attn.BWD_MAX_D[bf16] == 256
    for D in range(16, flash_attn.BWD_MAX_D[bf16] + 1, 16):
        for kernel in ("dq", "dkdv"):
            assert flash_attn.bwd_smem_bytes(kernel, D, bf16) <= 232_448


# -- the fp32 kernels' dK/dV splits, partials and scratch ---------------------

SPLIT_SMS = (132, 16, 1)


def _splits_cover(B, Sq, Sk, Hq, Hkv, causal, window, off, sms):
    """The fp32 dK/dV blocks' steps, split by split in the finish kernel's
    order (split 0 first), checked against the unsplit steps; returns the
    cover [Hq, Sq, Sk] of the live-pair tiles they visit and the splits."""
    t = flash_attn.F32_TILE
    splits = flash_attn.dkdv_splits(B, Sq, Sk, Hq, Hkv, causal, window, off,
                                    sms)
    cover = np.zeros((Hq, Sq, Sk), np.uint8)
    for kt in range(-(-Sk // t)):
        tiles = list(flash_attn.q_tile_range(kt, Sq, Sk, causal, window, t, t,
                                             off))
        for hk in range(Hkv):
            parts = [flash_attn.dkdv_steps(kt, s, splits, Sq, Sk, Hq, Hkv,
                                           hk, causal, window, off)
                     for s in range(splits)]
            # the finish kernel adds the partials in split order: their steps
            # in that order are the unsplit block's, each once
            assert [st for part in parts for st in part] == [
                (h, qt) for h in flash_attn.dkdv_heads(hk, Hq, Hkv)
                for qt in tiles]
            for h, qt in (st for part in parts for st in part):
                cover[h, qt * t:(qt + 1) * t, kt * t:(kt + 1) * t] += 1
    return cover, splits


@pytest.mark.parametrize("sms", SPLIT_SMS)
@pytest.mark.parametrize("Sq,Sk,causal,window", PLAN_CASES)
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 4), (8, 1)])
def test_fp32_dkdv_splits_sum_every_step_once(Sq, Sk, causal, window, Hq,
                                              Hkv, sms):
    """The fp32 dK/dV kernel at B = 2 on ``sms`` SMs: each kv tile's (q
    head, q tile) steps cut into ``dkdv_splits`` ranges, summed split by
    split into partials that the finish kernel adds in split order -- the
    unsplit block's steps in its order, each once -- covering every live
    (q head, q, k) triple exactly once; one range when the (kv tile, kv
    head, batch) grid fills two waves, else at most F32_MAX_WAVES waves of
    blocks and one step a range."""
    B, t = 2, flash_attn.F32_TILE
    cover, splits = _splits_cover(B, Sq, Sk, Hq, Hkv, causal, window, 0, sms)
    live = _live(Sq, Sk, causal, window)
    assert (cover[:, live] == 1).all() and cover.max() <= 1
    blocks = B * Hkv * -(-Sk // t)
    assert splits >= 1
    if blocks >= 2 * sms:
        assert splits == 1
    else:
        assert splits <= max(1, flash_attn.F32_MAX_WAVES * sms // blocks)


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 400), st.integers(0, 400), st.booleans(),
       st.one_of(st.none(), st.integers(1, 500)), st.integers(0, 10 ** 6),
       st.sampled_from(SPLIT_SMS), st.sampled_from([(4, 2), (3, 1), (2, 2)]))
def test_fp32_dkdv_splits_cover_every_live_pair_at_offsets(
        Sq, extra, causal, window, pick, sms, heads):
    """At any q offset (q_offset + Sq <= Sk under the causal mask) the split
    dK/dV blocks and the finish's order cover every live triple of the
    shifted mask exactly once."""
    Sk = Sq + extra
    off = pick % (extra + 1) if causal else pick % 1000
    Hq, Hkv = heads
    cover, _ = _splits_cover(1, Sq, Sk, Hq, Hkv, causal, window, off, sms)
    live = _live_at(Sq, Sk, causal, window, off)
    assert (cover[:, live] == 1).all() and cover.max() <= 1


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
def test_bwd_scratch_holds_the_rows_and_the_partials(bf16):
    """The scratch: L and delta [2, B, Hq, rows], rows Sq padded to a
    multiple of 128 (so that a tile's 64 rows always load whole), then on
    the fp32 route with splits > 1 partial dK and dV [splits, B, Sk, Hkv,
    D] each; bf16 never splits."""
    for Sq in (1, 64, 127, 128, 129, 2048):
        rows = flash_attn.bwd_scratch_rows(Sq, bf16)
        assert rows % 128 == 0 and Sq <= rows < Sq + 128
        for splits in (1, 2, 5):
            B, Sk, Hq, Hkv, D = 2, 300, 8, 2, 144
            got = flash_attn.bwd_scratch_floats(B, Sq, Sk, Hq, Hkv, D, bf16,
                                                splits)
            part = 0 if bf16 or splits == 1 else 2 * splits * B * Sk * Hkv * D
            assert got == 2 * B * Hq * rows + part


def test_fp32_plan_streams_64_by_64_tiles_in_64_column_chunks():
    """Every D takes the same fp32 tiles: 64 q rows by 64 keys, rings of
    four stages of 64-column chunks, each two TMA boxes of 32 fp32 columns
    (128 bytes: the widest box the 128-byte swizzle takes), the
    accumulators DP wide; dQ keeps its q tile's Q and dO whole, so its
    shared memory grows with DP and still fits a block."""
    assert flash_attn.F32_CHUNK == 2 * flash_attn.F32_BOX == 64
    assert 4 * flash_attn.F32_BOX == 128
    for D in range(16, 257, 16):
        p = flash_attn.bwd_tile_plan(D, bf16=False)
        assert (p.dq_bq, p.dq_bk, p.kv_bq, p.kv_bk) == (64, 64, 64, 64)
        assert p.chunk == flash_attn.F32_CHUNK and p.dp >= D
        assert (p.dq_stages, p.kv_stages) == (4, 4)
        resident = 2 * p.dp * 64 * 4
        assert flash_attn.bwd_smem_bytes("dq", D, False) \
            - flash_attn.bwd_smem_bytes("dq", 16, False) \
            == resident - 2 * 64 * 64 * 4


# -- the fp32 kernels' split-TF32 arithmetic, emulated ------------------------

BWD_F32_REL = 1e-5             # chip_smoke.py's bar for an fp32 launch


def _f32_emulated(q, k, v, out, lse, dout, causal, window, q_offset, sms):
    """The fp32 backward kernels' arithmetic on CPU tensors in their tile
    order: delta = rowsum(dO o O); per 64 x 64 tile S and dP in split TF32,
    P = exp2(S scale log2(e) - lse log2(e)) masked, dS = P o (dP - delta),
    P and dS split once as operands of dQ += dS K (kv tiles in order) and
    dV += P^T dO, dK += dS^T Q (each split's steps in order into its
    partial, the partials added in split order, then dK scaled).  Returns
    fp32 (dq, dk, dv)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    t = flash_attn.F32_TILE
    scale = np.float32(1.0 / math.sqrt(D))
    sl2 = np.float32(scale * np.float32(LOG2E))
    L = (lse.float() * np.float32(LOG2E)).permute(0, 2, 1)      # [B, Sq, Hq]
    delta = (dout * out).sum(-1)
    live = torch.from_numpy(_live_at(Sq, Sk, causal, window, q_offset))

    def p_ds(b, h, rows, keys):
        hk = h % Hkv
        s = _mm3(q[b, rows, h], k[b, keys, hk].T)
        p = torch.where(live[rows][:, keys],
                        torch.exp2(s * sl2 - L[b, rows, h][:, None]), 0.0)
        dp = _mm3(dout[b, rows, h], v[b, keys, hk].T)
        return p, p * (dp - delta[b, rows, h][:, None])

    dq = torch.zeros(B, Sq, Hq, D)
    for b in range(B):
        for h in range(Hq):
            for qt in range(-(-Sq // t)):
                rows = slice(qt * t, min(qt * t + t, Sq))
                for kt in flash_attn.dq_kv_tile_range(qt, Sq, Sk, causal,
                                                      window, t, t, q_offset):
                    keys = slice(kt * t, min(kt * t + t, Sk))
                    dq[b, rows, h] += _mm3(p_ds(b, h, rows, keys)[1],
                                           k[b, keys, h % Hkv])
    splits = flash_attn.dkdv_splits(B, Sq, Sk, Hq, Hkv, causal, window,
                                    q_offset, sms)
    pdk = torch.zeros(splits, B, Sk, Hkv, D)
    pdv = torch.zeros(splits, B, Sk, Hkv, D)
    for b in range(B):
        for hk in range(Hkv):
            for kt in range(-(-Sk // t)):
                keys = slice(kt * t, min(kt * t + t, Sk))
                for s in range(splits):
                    for h, qt in flash_attn.dkdv_steps(
                            kt, s, splits, Sq, Sk, Hq, Hkv, hk, causal,
                            window, q_offset):
                        rows = slice(qt * t, min(qt * t + t, Sq))
                        p, ds = p_ds(b, h, rows, keys)
                        pdv[s, b, keys, hk] += _mm3(p.T, dout[b, rows, h])
                        pdk[s, b, keys, hk] += _mm3(ds.T, q[b, rows, h])
    dk, dv = pdk[0], pdv[0]
    for s in range(1, splits):
        dk, dv = dk + pdk[s], dv + pdv[s]
    return dq * scale, dk * scale, dv


# (B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, sms): the fp32 rows'
# kinds (causal MQA, GQA non-causal) at D = 64, 144, 256, a window at an
# offset; sms small enough that the dK/dV blocks split, or not (1)
F32_EMULATED = {
    "D64_mqa": (1, 150, 150, 4, 1, 64, True, None, 0, 132),
    "D144_gqa": (1, 130, 130, 4, 2, 144, False, None, 0, 132),
    "D256_mqa": (1, 192, 192, 2, 1, 256, True, None, 0, 1),
    "D128_offset": (1, 100, 230, 4, 2, 128, True, 60, 100, 132),
}


@pytest.mark.parametrize("case", list(F32_EMULATED))
def test_fp32_split_tf32_emulated_within_half_the_bar(case):
    """The emulated fp32 kernels (:func:`_f32_emulated`: every operand, P and
    dS split as the kernels split them) from the plain forward's output and
    lse: each gradient's relative L2 error against the plain backward in
    fp32 on the same inputs, and against ``jax.grad`` of the reference's
    ``attention_blockwise`` in fp32, at most half of chip_smoke's bar
    (BWD_F32_REL): split TF32 can meet it."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, off, sms = F32_EMULATED[case]
    q, k, v, g = (torch.from_numpy(a)
                  for a in _inputs(B, Sq, Sk, Hq, Hkv, D, seed=7))
    kw = dict(causal=causal, window=window, q_offset=off)
    out = A.attention_blockwise(q, k, v, **kw)
    lse = flash_attn.attention_lse_plain(q, k, **kw)
    got = _f32_emulated(q, k, v, out, lse, g, causal, window, off, sms)
    exp = flash_attn.flash_attention_backward_plain(q, k, v, out, lse, g,
                                                    **kw)
    for a, e, name in zip(got, exp, ("dq", "dk", "dv")):
        assert _rel(a.numpy(), e.numpy()) <= 0.5 * BWD_F32_REL, name

    def jloss(q_, k_, v_):
        o = JA.attention_blockwise(q_, k_, v_, causal=causal, window=window,
                                   q_offset=off)
        return jnp.sum(o * g.numpy())

    jexp = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    for a, e, name in zip(got, jexp, ("dq", "dk", "dv")):
        assert _rel(a.numpy(), np.asarray(e)) <= 0.5 * BWD_F32_REL, name


# -- the bf16 kernels' rounding points, emulated ------------------------------

LOG2E = 1.4426950408889634
BWD_BF16_REL = 2.0 ** -7       # chip_smoke.py's bar for a bf16 launch


def _bf(x):
    return x.to(torch.bfloat16).float()


def _hi_lo(x):
    hi = _bf(x)
    return hi + _bf(x - hi)


def _bwd_emulated(q, k, v, out, lse, dout, causal, window):
    """The bf16 backward kernels' arithmetic on CPU tensors, in their tile
    order: bf16 inputs, fp32 products, P = exp2(S scale log2(e) - lse
    log2(e)) masked, P rounded to bf16 for dV's product, dS carried as a
    bf16 pair hi + lo (~16 bits) into dQ's and dK's, fp32 sums over the
    tiles in the kernels' order, the outputs rounded to bf16.  Returns
    fp32 (dq, dk, dv) holding bf16 values."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    plan = flash_attn.bwd_tile_plan(D)
    scale = 1.0 / math.sqrt(D)
    sl2 = np.float32(scale * LOG2E)
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, dout))
    L = (lse.float() * np.float32(LOG2E)).permute(0, 2, 1)      # [B, Sq, Hq]
    delta = (gf * of).sum(-1)                                   # [B, Sq, Hq]
    live = torch.from_numpy(_live(Sq, Sk, causal, window))

    def p_ds(b, h, rows, keys):
        hk = h % Hkv
        s = qf[b, rows, h] @ kf[b, keys, hk].T
        p = torch.exp2(s * sl2 - L[b, rows, h][:, None])
        p = torch.where(live[rows][:, keys], p, 0.0)
        dp = gf[b, rows, h] @ vf[b, keys, hk].T
        return p, p * (dp - delta[b, rows, h][:, None])

    dq = torch.zeros(B, Sq, Hq, D)
    for b in range(B):
        for h in range(Hq):
            for qt in range(-(-Sq // plan.dq_bq)):
                rows = slice(qt * plan.dq_bq, min((qt + 1) * plan.dq_bq, Sq))
                for kt in flash_attn.dq_kv_tile_range(
                        qt, Sq, Sk, causal, window, plan.dq_bq, plan.dq_bk):
                    keys = slice(kt * plan.dq_bk,
                                 min((kt + 1) * plan.dq_bk, Sk))
                    _, ds = p_ds(b, h, rows, keys)
                    dq[b, rows, h] += _hi_lo(ds) @ kf[b, keys, h % Hkv]
    dk, dv = torch.zeros(B, Sk, Hkv, D), torch.zeros(B, Sk, Hkv, D)
    for b in range(B):
        for hk in range(Hkv):
            for kt in range(-(-Sk // plan.kv_bk)):
                keys = slice(kt * plan.kv_bk, min((kt + 1) * plan.kv_bk, Sk))
                for h in flash_attn.dkdv_heads(hk, Hq, Hkv):
                    for qt in flash_attn.q_tile_range(
                            kt, Sq, Sk, causal, window, plan.kv_bq,
                            plan.kv_bk):
                        rows = slice(qt * plan.kv_bq,
                                     min((qt + 1) * plan.kv_bq, Sq))
                        p, ds = p_ds(b, h, rows, keys)
                        dv[b, keys, hk] += _bf(p).T @ gf[b, rows, h]
                        dk[b, keys, hk] += _hi_lo(ds).T @ qf[b, rows, h]
    return _bf(dq * scale), _bf(dk * scale), _bf(dv)


# (B, Sq, Sk, Hq, Hkv, D, causal, window)
ROUNDING_CASES = {
    "D64_gqa4": (1, 192, 192, 4, 1, 64, True, None),
    "D128_window": (1, 160, 160, 2, 2, 128, True, 70),
    "D256_mqa": (1, 192, 192, 2, 1, 256, True, None),
}


@pytest.mark.parametrize("case", list(ROUNDING_CASES))
def test_bf16_rounding_emulated_within_half_the_bar(case):
    """The emulated kernels (:func:`_bwd_emulated`) from the forward's bf16
    output and fp32 lse: each gradient's relative L2 error against the
    plain backward in fp32 on the same inputs at most half of chip_smoke's
    bar (2^-7), and against ``jax.grad`` of the reference's
    ``attention_blockwise`` in bf16 within the file's bf16 bar (2^-6)."""
    B, Sq, Sk, Hq, Hkv, D, causal, window = ROUNDING_CASES[case]
    q, k, v, g = _inputs(B, Sq, Sk, Hq, Hkv, D, seed=5)
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v, g))
    out = _bf(A.attention_reference(tq.float(), tk.float(), tv.float(),
                                    causal=causal, window=window))
    lse = flash_attn.attention_lse_plain(tq, tk, causal=causal,
                                         window=window)
    got = _bwd_emulated(tq, tk, tv, out, lse, tg, causal, window)
    exp = flash_attn.flash_attention_backward_plain(
        tq, tk, tv, out, lse, tg, causal=causal, window=window)
    for a, e, name in zip(got, exp, ("dq", "dk", "dv")):
        assert _rel(a.numpy(), e.numpy()) <= 0.5 * BWD_BF16_REL, name

    def jloss(q_, k_, v_):
        o = JA.attention_blockwise(q_, k_, v_, causal=causal, window=window)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(tg.float()))

    jexp = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv)))
    for a, e in zip(got, jexp):
        assert _rel(a.numpy(), np.asarray(e, np.float32)) \
            <= REL["bfloat16"]


# -- the causal q offset (context-parallel attention) -------------------------

# (B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset): a block of the
# sequence against the whole K and V
OFFSETS = {
    "second_half": (1, 48, 96, 4, 2, 16, True, None, 48),
    "middle_window": (2, 40, 130, 4, 1, 16, True, 30, 50),
    "last_block_mqa": (1, 33, 99, 2, 1, 32, True, None, 66),
    "noncausal_window": (1, 50, 100, 2, 2, 16, False, 20, 25),
}


@pytest.mark.parametrize("case", list(OFFSETS))
def test_cpu_gradients_with_a_q_offset_match_jax_grad(case):
    """The CPU route at an offset (``attention_blockwise(q_offset=)``)
    against ``jax.grad`` of the reference's at the same offset, fp32 at
    1e-5; and the plain backward at the offset against autograd of
    ``attention_reference`` in float64 at 1e-5."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, off = OFFSETS[case]
    q, k, v, g = _inputs(B, Sq, Sk, Hq, Hkv, D, seed=2)

    def jloss(q_, k_, v_):
        o = JA.attention_blockwise(q_, k_, v_, causal=causal, window=window,
                                   q_offset=off, kv_block=32)
        return jnp.sum(o * g)

    exp = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash_attn.flash_attention(tq, tk, tv, causal=causal, window=window,
                                   q_offset=off)
    (o * torch.from_numpy(g)).sum().backward()
    for got, e in zip((tq.grad, tk.grad, tv.grad), exp):
        assert _rel(got.numpy(), np.asarray(e)) <= 1e-5
    qd, kd, vd, gd = (torch.from_numpy(a).double() for a in (q, k, v, g))
    qr, kr, vr = (t.clone().requires_grad_() for t in (qd, kd, vd))
    od = A.attention_reference(qr, kr, vr, causal=causal, window=window,
                               q_offset=off)
    auto = torch.autograd.grad(od, (qr, kr, vr), gd)
    lse = flash_attn.attention_lse_plain(qd, kd, causal=causal, window=window,
                                         q_offset=off)
    plain = flash_attn.flash_attention_backward_plain(
        qd, kd, vd, od.detach(), lse, gd, causal=causal, window=window,
        kv_block=32, q_offset=off)
    for a, e in zip(plain, auto):
        assert _rel(a.numpy(), e.numpy()) <= 1e-5


# (B, Sq, Sk, Hq, Hkv, causal, window, q_offset) at the fp32 kernels' wide
# heads, D in (144, 256)
WIDE = {
    "causal_gqa": (1, 80, 80, 4, 2, True, None, 0),
    "window": (1, 90, 90, 4, 2, True, 30, 0),
    "q_offset": (1, 40, 100, 4, 2, True, None, 60),
}


@pytest.mark.parametrize("D", [144, 256])
@pytest.mark.parametrize("case", list(WIDE))
def test_plain_backward_at_wide_heads_matches_jax_grad(case, D):
    """The plain backward in fp32 (the fp32 kernels' oracle on the card) at
    D > 128, from the plain forward's output and lse, against ``jax.grad``
    of the reference's ``attention_blockwise`` in fp32: relative L2 of
    each gradient within REL["float32"] (1e-5)."""
    B, Sq, Sk, Hq, Hkv, causal, window, off = WIDE[case]
    q, k, v, g = _inputs(B, Sq, Sk, Hq, Hkv, D, seed=5)

    def jloss(q_, k_, v_):
        o = JA.attention_blockwise(q_, k_, v_, causal=causal, window=window,
                                   q_offset=off, kv_block=32)
        return jnp.sum(o * g)

    exp = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    kw = dict(causal=causal, window=window, q_offset=off)
    out = A.attention_blockwise(tq, tk, tv, **kw)
    lse = flash_attn.attention_lse_plain(tq, tk, **kw)
    got = flash_attn.flash_attention_backward_plain(tq, tk, tv, out, lse, tg,
                                                    **kw)
    for a, e in zip(got, exp):
        assert a.dtype == torch.float32
        assert _rel(a.numpy(), np.asarray(e)) <= REL["float32"]


def test_an_offset_past_the_keys_is_refused():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 8, 16, 2, 2, 16))
    for off in (-1, 9):
        with pytest.raises(ValueError, match="q_offset"):
            flash_attn.flash_attention(q, k, v, q_offset=off)
    # at offset 0 a causal Sq > Sk stays what it was: rows past Sk read
    # every key
    assert flash_attn.flash_attention(k, q, q).shape == k.shape


def _old_dq_kv_range(qt, Sq, Sk, causal, window, bq, bk):
    """``dq_kv_tile_range`` as it was before the offset (verbatim)."""
    q0 = qt * bq
    q_last = min(q0 + bq, Sq) - 1
    end = -(-Sk // bk)
    if causal:
        end = min(end, q_last // bk + 1)
    begin = 0
    if window:
        lo = q0 - window - bk + 2
        if lo > 0:
            begin = -(-lo // bk)
    return range(begin, max(end, begin))


def _old_q_range(kt, Sq, Sk, causal, window, bq, bk):
    """``q_tile_range`` as it was before the offset (verbatim)."""
    k0 = kt * bk
    k_last = min(k0 + bk, Sk) - 1
    end = -(-Sq // bq)
    if window:
        end = min(end, (k_last + window - 1) // bq + 1)
    begin = k0 // bq if causal else 0
    return range(begin, max(end, begin))


def _old_kv_tile_range(qt, Sq, Sk, causal, window, D):
    """``kv_tile_range`` (the forward's) as it was before the offset."""
    bk = flash_attn.tile_plan(D)[1]
    q0 = qt * flash_attn.BQ
    end = -(-Sk // bk)
    if causal:
        end = min(end, (min(q0 + flash_attn.BQ, Sq) - 1) // bk + 1)
    begin = 0
    if window:
        lo = q0 - window - bk + 2
        if lo > 0:
            begin = -(-lo // bk)
    return range(begin, max(end, begin))


_shapes = st.tuples(st.integers(1, 700), st.integers(1, 700), st.booleans(),
                    st.one_of(st.none(), st.integers(1, 800)))


@settings(max_examples=150, deadline=None)
@given(_shapes, st.sampled_from(sorted(PLANS)), st.sampled_from([64, 128,
                                                                   256]))
def test_plans_at_offset_zero_are_the_plans_before_the_offset(shape, plan, D):
    """Every mirrored tile range at q_offset = 0 (the default) is the range
    the kernels had before the offset, for any shape: the mirrors are
    checked against the library at load, so the kernels' tiles at offset 0
    are today's."""
    Sq, Sk, causal, window = shape
    p = PLANS[plan]
    for qt in range(-(-Sq // p.dq_bq)):
        assert flash_attn.dq_kv_tile_range(
            qt, Sq, Sk, causal, window, p.dq_bq, p.dq_bk, 0) == \
            _old_dq_kv_range(qt, Sq, Sk, causal, window, p.dq_bq, p.dq_bk)
    for kt in range(-(-Sk // p.kv_bk)):
        assert flash_attn.q_tile_range(
            kt, Sq, Sk, causal, window, p.kv_bq, p.kv_bk, 0) == \
            _old_q_range(kt, Sq, Sk, causal, window, p.kv_bq, p.kv_bk)
    for qt in range(-(-Sq // flash_attn.BQ)):
        assert flash_attn.kv_tile_range(qt, Sq, Sk, causal, window, D, 0) \
            == _old_kv_tile_range(qt, Sq, Sk, causal, window, D)


def _live_at(Sq, Sk, causal, window, off):
    qp = off + np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    return ok


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 600), st.integers(0, 600), st.booleans(),
       st.one_of(st.none(), st.integers(1, 700)), st.integers(0, 10 ** 6),
       st.sampled_from(sorted(PLANS)))
def test_offset_plans_cover_every_live_pair_once(Sq, extra, causal, window,
                                                 pick, plan):
    """At any offset (q_offset + Sq <= Sk under the causal mask), the dQ
    kernel's kv tiles and the dK/dV kernel's q tiles each cover every live
    pair of the shifted mask exactly once, the forward's kv tiles cover it
    with no tile wholly masked, and ``live_pairs`` counts it."""
    Sk = Sq + extra
    off = pick % (extra + 1) if causal else pick % 1000
    p = PLANS[plan]
    live = _live_at(Sq, Sk, causal, window, off)
    assert flash_attn.live_pairs(Sq, Sk, causal, window, off) == live.sum()
    cover = np.zeros((Sq, Sk), np.uint8)
    for qt in range(-(-Sq // p.dq_bq)):
        for kt in flash_attn.dq_kv_tile_range(qt, Sq, Sk, causal, window,
                                              p.dq_bq, p.dq_bk, off):
            cover[qt * p.dq_bq:(qt + 1) * p.dq_bq,
                  kt * p.dq_bk:(kt + 1) * p.dq_bk] += 1
    assert (cover[live] == 1).all() and cover.max() <= 1
    cover = np.zeros((Sq, Sk), np.uint8)
    for kt in range(-(-Sk // p.kv_bk)):
        for qt in flash_attn.q_tile_range(kt, Sq, Sk, causal, window,
                                          p.kv_bq, p.kv_bk, off):
            cover[qt * p.kv_bq:(qt + 1) * p.kv_bq,
                  kt * p.kv_bk:(kt + 1) * p.kv_bk] += 1
    assert (cover[live] == 1).all() and cover.max() <= 1
    D = (64, 128, 256)[pick % 3]
    bq, bk = flash_attn.BQ, flash_attn.tile_plan(D)[1]
    seen = np.zeros((Sq, Sk), bool)
    for qt in range(-(-Sq // bq)):
        rows = slice(qt * bq, min(qt * bq + bq, Sq))
        for kt in flash_attn.kv_tile_range(qt, Sq, Sk, causal, window, D,
                                           off):
            cols = slice(kt * bk, min(kt * bk + bk, Sk))
            # a tile is wholly masked only for rows with no live key at all
            # (past the keys' window without the causal mask, as at offset 0)
            assert live[rows, cols].any() or not live[rows].any()
            seen[rows, cols] = True
    assert not (live & ~seen).any()
