"""The fp32 forward kernel of ``flash_attention`` (``flash_attn_f32_kernel``
in ``csrc/flash_attn.cu``) on the CPU: its plan, mirrored in
``kernels/flash_attn.py`` (``f32_tile_plan``, ``f32_smem_bytes``,
``f32_splits``, ``f32_split_range``, ``f32_scratch_floats``), checked
against the mask in numpy; and its arithmetic emulated on CPU tensors in
its tile and split order.

The plan: each split's kv-tile ranges cover every tile of its q tile's
range exactly once and in order, those ranges cover every live (q, k)
pair of each q tile once (causal, windowed, at a q offset, GQA), the
plan splits only where the (q tile, q head, batch) grid fills less than
two waves, and a block's shared memory fits 227 KB at every D.

The emulation (:func:`_f32_fwd_emulated`): S = Q K^T and P V in split
TF32 (``tests/_torch_tf32.py``), a fresh accumulator per 64-column chunk
of each kv tile added in fp32, the online softmax in exp2 units with the
masked-row quirk (a row with no live key yet gets weight 1 a key), and
the split plan's merge in split order.  Bars: ``out`` within half of
chip_smoke's ATTN_F32_TOL, 2e-5 (1 + |exp|), of the plain version
(``attention_blockwise``) in fp32 and of the reference (the Pallas kernel
in interpret mode; ``attention_blockwise`` of the JAX package at a q
offset, which the Pallas kernel does not take); ``lse`` within half of
LSE_TOL, 2e-5 (1 + |exp|), of ``attention_lse_plain`` (split TF32's
products carry ~2^-22 of each term; fp32's rounding of the sums the
rest).  The emulated ``out`` and ``lse`` fed to the fp32 backward's
emulation give gradients within half of its bar (BWD_F32_REL, relative
L2) of the plain backward on the plain forward's.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

import _torch_parity  # noqa: E402,F401  (one torch thread per worker)
from _torch_tf32 import _mm3  # noqa: E402
from repro.kernels import flash_attn as JK  # noqa: E402
from repro.nn import attention as JA  # noqa: E402
from repro_torch.kernels import flash_attn  # noqa: E402
from repro_torch.nn import attention as A  # noqa: E402
from test_torch_flash_bwd import _f32_emulated, _rel  # noqa: E402

ATTN_F32_TOL = 2e-5            # chip_smoke.py's bar for an fp32 launch
LSE_TOL = 2e-5                 # the lse's bar: |d| <= LSE_TOL (1 + |exp|)
BWD_F32_REL = 1e-5             # chip_smoke.py's bar for an fp32 backward
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
NEG = -1e30                    # the kernels' mask fill


def _live(Sq, Sk, causal, window, off):
    qp = off + np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    return ok


# -- the plan -----------------------------------------------------------------


@pytest.mark.parametrize("short", [False, True], ids=["long", "short"])
def test_f32_plan_fits_a_block_at_every_d(short):
    """128 q rows over 64-key tiles in 64-column chunks at every D, O DMAX
    wide; steps of 64 keys through four stages, or of 32 through eight in
    the long plan at DMAX = 256 (64 KB of ring either way), P V in passes
    of four n8 tiles there; Q whole, the ring and the exchange fit 227
    KB."""
    for D in range(16, 257, 16):
        p = flash_attn.f32_tile_plan(D, short)
        wide = p.dmax == 256
        assert (p.bq, p.tile, p.chunk) == (128, 64, 64)
        assert p.dmax >= D and p.dmax in (64, 128, 256)
        assert (p.step, p.stages) == ((32, 8) if wide and not short
                                      else (64, 4))
        assert p.stages * p.step == 256
        assert p.pass_tiles == (4 if wide else 8)
        assert flash_attn.f32_smem_bytes(D, short) <= 232448
        assert flash_attn.f32_smem_bytes(D, short) \
            - flash_attn.f32_smem_bytes(16, short) \
            == 4 * 128 * (p.dmax - 64) + 8 * 2 * (p.stages - 4)


# (Sq, Sk, causal, window, q_offset)
PLAN_CASES = [(1500, 1500, False, None, 0), (448, 1500, False, None, 0),
              (1, 1500, False, None, 0), (2048, 2048, True, None, 0),
              (100, 37, True, 5, 0), (300, 130, False, 70, 0),
              (130, 64, True, None, 0), (65, 200, True, 1, 0),
              (17, 1500, True, None, 1483), (100, 300, True, 70, 137),
              (300, 130, False, 70, 45), (128, 128, False, 10, 72),
              (1, 1, False, None, 0)]


def _cover(B, Sq, Sk, Hq, Hkv, causal, window, off, sms):
    """Every split's range in order is its q tile's range, once; the q
    tiles' ranges hold every live pair of their rows once."""
    splits = flash_attn.f32_splits(B, Sq, Sk, Hq, Hkv, causal, window, off,
                                   sms)
    nq = -(-Sq // 128)
    if B * Hq * nq >= 2 * sms:
        assert splits == 1
    assert splits >= 1
    live = _live(Sq, Sk, causal, window, off)
    seen = np.zeros((Sq, -(-Sk // 64) * 64), np.int64)
    longest = 0
    for qt in range(nq):
        whole = flash_attn.dq_kv_tile_range(qt, Sq, Sk, causal, window, 128,
                                            64, off)
        longest = max(longest, len(whole))
        tiles = [kt for s in range(splits)
                 for kt in flash_attn.f32_split_range(qt, s, splits, Sq, Sk,
                                                      causal, window, off)]
        assert tiles == list(whole)
        for kt in tiles:
            seen[qt * 128:qt * 128 + 128, kt * 64:kt * 64 + 64] += 1
    assert splits <= max(longest, 1)
    assert (seen[:, :Sk][live] == 1).all()
    return splits


@pytest.mark.parametrize("sms", [132, 16, 1])
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 4), (16, 16)])
@pytest.mark.parametrize("Sq,Sk,causal,window,off", PLAN_CASES)
def test_f32_splits_cover_every_tile_once_in_order(Sq, Sk, causal, window,
                                                   off, Hq, Hkv, sms):
    _cover(2, Sq, Sk, Hq, Hkv, causal, window, off, sms)


def test_f32_splits_at_whispers_shapes():
    """One split where the grid fills two waves of 132 SMs (the encoder,
    the cross attention), eight at the decode step: 1024 blocks of three
    64-key tiles of 1500 keys; the scratch holds every split's O, m and
    l."""
    sp = lambda Sq: flash_attn.f32_splits(8, Sq, 1500, 16, 16, False, None,
                                          0, 132)
    assert (sp(1500), sp(448), sp(1)) == (1, 1, 8)
    assert [len(flash_attn.f32_split_range(0, s, 8, 1, 1500, False, None))
            for s in range(8)] == [3] * 8
    assert flash_attn.f32_scratch_floats(8, 1, 16, 64, 8) == 8 * 128 * 66
    assert flash_attn.f32_scratch_floats(8, 448, 16, 64, 1) == 0


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 400), st.integers(0, 400), st.booleans(),
       st.sampled_from([None, 1, 7, 64, 150]), st.integers(0, 300),
       st.sampled_from([(1, 1, 1), (2, 4, 2), (1, 3, 1)]),
       st.sampled_from([132, 16, 2, 1]))
def test_f32_splits_cover_every_live_pair_at_offsets(Sq, extra, causal,
                                                     window, off, bh, sms):
    B, Hq, Hkv = bh
    Sk = Sq + extra if causal else max(extra, 1)
    if causal and off + Sq > Sk:
        off = Sk - Sq
    _cover(B, Sq, Sk, Hq, Hkv, causal, window, off, sms)


# -- the arithmetic, emulated ---------------------------------------------------


def _f32_fwd_emulated(q, k, v, causal, window, off, sms):
    """The fp32 forward kernel's arithmetic on CPU tensors: per (batch, q
    head, q tile of 128 rows, split) the split's 64-key tiles in order, each
    in steps of the plan's keys (32 in the long plan at DMAX = 256); S =
    Q K^T in split TF32, each 64-column chunk a fresh accumulator added in
    fp32; masked scores out of the max, exp2 units, a masked key's weight
    exp2(-1e30 - m) (1 while the row has no live key); O = O corr + P V,
    each chunk's P V a fresh accumulator; then, with splits, each row's
    splits merged in split order.  Returns (out, lse [B, Hq, Sq])."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    plan = flash_attn.f32_tile_plan(D, Sq <= flash_attn.F32_SHORT)
    BQ, BK, C = 128, plan.step, 64
    sl2 = torch.tensor(1.0 / math.sqrt(D) * LOG2E, dtype=torch.float32)
    splits = flash_attn.f32_splits(B, Sq, Sk, Hq, Hkv, causal, window, off,
                                   sms)
    live = torch.from_numpy(_live(Sq, -(-Sk // 64) * 64, causal, window, off))
    live[:, Sk:] = False
    pad = -(-Sk // 64) * 64 - Sk
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    neg = torch.tensor(NEG)
    out = torch.zeros(B, Sq, Hq, D)
    lse = torch.zeros(B, Hq, Sq)
    for b in range(B):
        for h in range(Hq):
            hk = h % Hkv
            for qt in range(-(-Sq // BQ)):
                rows = slice(qt * BQ, min(qt * BQ + BQ, Sq))
                qb = q[b, rows, h]
                n = qb.shape[0]
                parts = []
                for s in range(splits):
                    m = torch.full((n,), NEG)
                    l = torch.zeros(n)
                    o = torch.zeros(n, D)
                    for js in (kt * 64 // BK + u for kt in
                               flash_attn.f32_split_range(qt, s, splits, Sq,
                                                          Sk, causal, window,
                                                          off)
                               for u in range(64 // BK)):
                        keys = slice(js * BK, js * BK + BK)
                        kb, vb = kp[b, keys, hk], vp[b, keys, hk]
                        sc = torch.zeros(n, BK)
                        for c in range(0, D, C):
                            sc = sc + _mm3(qb[:, c:c + C], kb[:, c:c + C].T)
                        ok = live[rows, keys]
                        mx = torch.where(ok, sc, -torch.inf).amax(1)
                        mt = torch.where(torch.isinf(mx), neg, mx * sl2)
                        m_new = torch.maximum(m, mt)
                        corr = torch.exp2(m - m_new)
                        p = torch.where(ok, torch.exp2(sc * sl2 - m_new[:, None]),
                                        torch.exp2(neg - m_new)[:, None])
                        l = l * corr + p.sum(1)
                        for c in range(0, D, C):
                            o[:, c:c + C] = o[:, c:c + C] * corr[:, None] \
                                + _mm3(p, vb[:, c:c + C])
                        m = m_new
                    parts.append((m, l, o))
                if splits > 1:
                    mt = parts[0][0]
                    for m_, _, _ in parts[1:]:
                        mt = torch.maximum(mt, m_)
                    l = torch.zeros(n)
                    o = torch.zeros(n, D)
                    for m_, l_, o_ in parts:
                        w = torch.exp2(m_ - mt)
                        l = l + w * l_
                        o = o + w[:, None] * o_
                    m = mt
                den = torch.clamp(l, min=1e-30)
                out[b, rows, h] = o / den[:, None]
                lse[b, h, rows] = torch.where(
                    m == NEG, neg, (m + torch.log2(den)) * LN2)
    return out, lse


# (B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, sms): D = 64, 144,
# 256; a decode step's one query, split (the short plan, as at D = 256 at
# an offset); rows with no live key, unsplit (one kv tile) and split (two,
# each row's live keys in one of them, rows 65.. in neither); a window at
# an offset, split
FWD_CASES = {
    "D64_decode_split": (2, 1, 300, 4, 4, 64, False, None, 0, 132),
    "D144_gqa_causal": (1, 130, 130, 4, 2, 144, True, None, 0, 1),
    "D256_mqa_split": (1, 150, 150, 2, 1, 256, True, None, 0, 132),
    "no_live_key": (1, 100, 64, 2, 2, 64, False, 1, 0, 1),
    "no_live_key_split": (1, 128, 128, 2, 2, 64, False, 10, 72, 132),
    "window_offset": (1, 100, 300, 4, 2, 128, True, 60, 150, 132),
    "D256_short_offset": (1, 16, 200, 2, 1, 256, True, None, 184, 132),
}


def _divisor(n):
    """The largest block of at most 128 that divides n: the Pallas kernel
    in interpret mode reads a ragged last block past the array."""
    return max(d for d in range(1, min(n, 128) + 1) if n % d == 0)


def _case_inputs(case, seed=3):
    B, Sq, Sk, Hq, Hkv, D = FWD_CASES[case][:6]
    g = np.random.default_rng(seed)
    return [g.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                      (B, Sq, Hq, D))]


def _ratio(got, exp, tol):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float((np.abs(got - exp) / (tol * (1 + np.abs(exp)))).max())


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_fp32_forward_emulated_within_half_the_bar(case):
    """The emulated kernel's out within half of ATTN_F32_TOL of the plain
    version and of the reference, its lse within half of LSE_TOL of
    ``attention_lse_plain``; the case splits (or not) as named."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, off, sms = FWD_CASES[case]
    qn, kn, vn, _ = _case_inputs(case)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    splits = flash_attn.f32_splits(B, Sq, Sk, Hq, Hkv, causal, window, off,
                                   sms)
    assert (splits > 1) == case.endswith(("split", "offset")), splits
    out, lse = _f32_fwd_emulated(q, k, v, causal, window, off, sms)
    kw = dict(causal=causal, window=window, q_offset=off)
    exp = A.attention_blockwise(q, k, v, **kw)
    assert _ratio(out, exp, ATTN_F32_TOL) <= 0.5
    assert _ratio(lse, flash_attn.attention_lse_plain(q, k, **kw),
                  LSE_TOL) <= 0.5
    if off:
        ref = JA.attention_blockwise(jnp.asarray(qn), jnp.asarray(kn),
                                     jnp.asarray(vn), **kw)
    else:
        ref = JK.flash_attention(jnp.asarray(qn), jnp.asarray(kn),
                                 jnp.asarray(vn), causal=causal,
                                 window=window, bq=_divisor(Sq),
                                 bk=_divisor(Sk), interpret=True)
    assert _ratio(out, np.asarray(ref), ATTN_F32_TOL) <= 0.5
    if case.startswith("no_live_key"):
        dead = ~_live(Sq, Sk, causal, window, off).any(1)
        assert dead.any()
        assert (lse[:, :, dead] == NEG).all()


@pytest.mark.parametrize("case", ["D144_gqa_causal", "D256_mqa_split",
                                  "window_offset"])
def test_fp32_forward_emulated_feeds_the_backward_within_half_its_bar(case):
    """The emulated forward's out and lse into the fp32 backward's
    emulation: dq, dk, dv within half of BWD_F32_REL of the plain backward
    on the plain forward's out and lse."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, off, sms = FWD_CASES[case]
    q, k, v, g = (torch.from_numpy(a) for a in _case_inputs(case))
    kw = dict(causal=causal, window=window, q_offset=off)
    out, lse = _f32_fwd_emulated(q, k, v, causal, window, off, sms)
    got = _f32_emulated(q, k, v, out, lse, g, causal, window, off, sms)
    exp = flash_attn.flash_attention_backward_plain(
        q, k, v, A.attention_blockwise(q, k, v, **kw),
        flash_attn.attention_lse_plain(q, k, **kw), g, **kw)
    for a, e, name in zip(got, exp, ("dq", "dk", "dv")):
        assert _rel(a.numpy(), e.numpy()) <= 0.5 * BWD_F32_REL, name
