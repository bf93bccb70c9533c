"""The bf16 attention kernel's tile plan and its rounding of the softmax
weights, checked on the CPU.

``repro_torch.kernels.flash_attn`` mirrors the plan of the bf16 kernel of
``csrc/flash_attn.cu`` in Python (``tile_plan``, ``kv_tile_range``,
``q_tile_order``; the wrapper checks at load time that the library agrees).
Here, in numpy: every (q, k) pair the mask keeps lies in a kv tile that its
q tile visits, no visited tile is wholly masked, the kept pairs sum to
``flash_attn.live_pairs`` (the count behind the kernel's bound), and the
blocks take the q tiles with the most kv tiles first.

Then the kernel's arithmetic is emulated in plain torch: kv tiles of BK
keys, fp32 scores scaled by scale * log2(e), masked to -1e30, an online
max and sum with exp2, the weights rounded for the PV product as the
kernel rounds them, the output rounded to bf16.  It is scored with
chip_smoke.py's bar for bf16 attention against the plain version in fp32
on the same inputs: |d| <= 2^-7 |exp| + 2^-8 mean |exp|.  The output's own
bf16 rounding is at most 2^-8 |exp|, half the bar, so the kernel's split
of the weights (hi = bf16(p), lo = bf16(p - hi)) must stay <= 0.5; plain
bf16 weights, as ``attention_blockwise`` rounds them, break the bar (> 1)
on the same inputs.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attn  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402

torch.set_num_threads(1)


PLAN_CASES = [
    # Sq, Sk, causal, window, D
    (8192, 8192, True, 4096, 64),      # the prefill's call
    (1000, 1000, True, 300, 64),       # ragged, window not a tile multiple
    (200, 200, True, None, 80),
    (192, 192, True, None, 256),
    (128, 128, True, 64, 128),
    (1024, 1024, True, 64, 64),
    (777, 777, True, 129, 128),
    (96, 300, False, None, 64),        # Sq != Sk, no mask
    (300, 96, False, None, 80),
    (640, 700, False, 200, 256),       # window without causality
]


@pytest.mark.parametrize("D,plan", [(64, (64, 128, 4)), (80, (128, 64, 4)),
                                    (128, (128, 64, 4)), (256, (256, 64, 2)),
                                    (16, (64, 128, 4)), (192, (256, 64, 2))])
def test_tile_plan(D, plan):
    assert flash_attn.tile_plan(D) == plan


@pytest.mark.parametrize("Sq,Sk,causal,window,D", PLAN_CASES)
def test_visited_tiles_cover_the_mask_exactly(Sq, Sk, causal, window, D):
    bq, bk = flash_attn.BQ, flash_attn.tile_plan(D)[1]
    qpos = np.arange(Sq)[:, None]
    kpos = np.arange(Sk)[None, :]
    keep = np.ones((Sq, Sk), bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    visited = np.zeros((Sq, Sk), bool)
    nq = -(-Sq // bq)
    for qt in range(nq):
        rows = slice(qt * bq, min(qt * bq + bq, Sq))
        tiles = flash_attn.kv_tile_range(qt, Sq, Sk, causal, window, D)
        assert tiles.stop <= -(-Sk // bk)
        for kt in tiles:
            cols = slice(kt * bk, min(kt * bk + bk, Sk))
            assert keep[rows, cols].any(), (qt, kt)   # never wholly masked
            visited[rows, cols] = True
    assert not (keep & ~visited).any()                # every kept pair seen
    assert keep.sum() == flash_attn.live_pairs(Sq, Sk, causal, window)


@pytest.mark.parametrize("Sq,Sk,causal,window,D", PLAN_CASES)
def test_q_tiles_run_longest_first(Sq, Sk, causal, window, D):
    """A permutation of the q tiles along which the number of kv tiles
    never grows (a ragged last q tile, shorter, is left out)."""
    order = flash_attn.q_tile_order(Sq, causal)
    nq = -(-Sq // flash_attn.BQ)
    assert sorted(order) == list(range(nq))
    full = [qt for qt in order if (qt + 1) * flash_attn.BQ <= Sq]
    n = [len(flash_attn.kv_tile_range(qt, Sq, Sk, causal, window, D))
         for qt in full]
    assert n == sorted(n, reverse=True)


@pytest.mark.parametrize("B,Hq,Sq,Sk,D,causal", [
    (2, 32, 8192, 8192, 64, True),     # the prefill: 12 pairs a group
    (1, 4, 200, 200, 80, True),
    (3, 5, 96, 300, 64, False),
    (2, 3, 1 << 16, 1 << 16, 256, True),   # one pair a group
])
def test_block_order_groups_heads_for_l2(B, Hq, Sq, Sk, D, causal):
    """Every (q tile, head, batch) once; the pairs of a group share their
    kv tiles' bytes within HEAD_GROUP_BYTES, and inside a group the q
    tiles follow q_tile_order."""
    order = flash_attn.block_order(B, Hq, Sq, Sk, D, causal)
    nq = -(-Sq // flash_attn.BQ)
    assert sorted(order) == sorted((qt, h, b) for qt in range(nq)
                                   for h in range(Hq) for b in range(B))
    g = flash_attn.head_group(Sk, D, B * Hq)
    assert g == 1 or g * 4 * Sk * D <= flash_attn.HEAD_GROUP_BYTES
    for start in range(0, B * Hq, g):
        size = min(g, B * Hq - start)
        block = order[start * nq:(start + size) * nq]
        assert {h + Hq * b for _, h, b in block} == set(
            range(start, start + size))
        assert [qt for qt, _, _ in block[::size]] == \
            flash_attn.q_tile_order(Sq, causal)


def _emulate(q, k, v, window, split):
    """The bf16 kernel's arithmetic on [B, S, H, D] bf16 inputs (MHA,
    causal), in fp32; ``split`` is how the weights enter the PV product:
    "hi_lo" as bf16(p) + bf16(p - bf16(p)), "bf16" as bf16(p)."""
    B, S, H, D = q.shape
    bk = flash_attn.tile_plan(D)[1]
    qf, kf, vf = (t.float() for t in (q, k, v))
    sl2 = 1.0 / math.sqrt(D) * math.log2(math.e)
    pos = torch.arange(S)
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, D))
    for k0 in range(0, S, bk):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + bk]) * sl2
        kp = pos[k0:k0 + bk]
        ok = (kp[None, :] <= pos[:, None]) & (kp[None, :] > pos[:, None]
                                              - window)
        s = torch.where(ok, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi = p.bfloat16().float()
        pw = hi + (p - hi).bfloat16().float() if split == "hi_lo" else hi
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", pw, vf[:, k0:k0 + bk])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).bfloat16()


def _ratio(got, exp):
    d = (got.float() - exp).abs()
    allow = 2.0 ** -7 * exp.abs() + 2.0 ** -8 * exp.abs().mean()
    return float((d / allow).max())


def test_weight_split_holds_the_bf16_bar():
    g = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(g.standard_normal((1, 2048, 4, 64),
                                                  dtype=np.float32)
                                ).bfloat16() for _ in range(3))
    window = 1024
    exp = tattn.attention_blockwise(q.float(), k.float(), v.float(),
                                    window=window)
    hi_lo = _ratio(_emulate(q, k, v, window, "hi_lo"), exp)
    plain = _ratio(_emulate(q, k, v, window, "bf16"), exp)
    assert hi_lo <= 0.5, hi_lo
    assert plain > 1.0, plain          # bf16 weights would fail the bar

