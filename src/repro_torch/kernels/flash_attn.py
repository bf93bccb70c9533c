"""Wrapper of the CUDA attention kernels (``csrc/flash_attn.cu``).

    flash_attention(q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], *, causal=True,
                    window=None, scale=None, bq=128, bk=128, q_offset=0)
        -> [B, Sq, Hq, D]

Causal, sliding-window or full (``causal=False``) GQA softmax attention
(q head h reads kv head ``h % Hkv``), Sq and Sk free -- whisper's encoder,
its cross attention and each decode step's one query take the last two --,
the function of the Pallas kernel
``repro.kernels.flash_attn.flash_attention``.  ``bq``/``bk`` are accepted
for that signature; the kernels use their own tiles (:func:`tile_plan`).
Query row i sits at position ``q_offset + i`` for the causal and window
tests, k and v at 0 .. Sk - 1 (``attention_blockwise(q_offset=)``):
context-parallel attention runs a rank's block of the sequence against
the whole K and V.  ``q_offset >= 0``, and a causal call at an offset
needs ``q_offset + Sq <= Sk`` (at offset 0 a causal Sq > Sk stays allowed,
its rows past Sk reading every key); ``q_offset = 0`` gives the kernels'
bits without it.

A tensor on the CPU goes to the plain version,
``repro_torch.nn.attention.attention_blockwise``; a CUDA tensor launches
a kernel or raises -- there is no fallback.  Launches are counted in
:data:`LAUNCHES`, and by kernel in :data:`ROUTES`.  Inputs are bf16 or
fp32 (all three alike), read through their strides; D must be contiguous,
a multiple of 16 and at most 256 on a card.  The output has q's dtype.

bf16 inputs go to the tensor-core kernel (``wgmma``, tiles loaded by
TMA).  It needs 16-byte aligned base pointers and B, S and H strides that
are multiples of 8 elements, and it carries the softmax weights into the
PV product as a bf16 pair (hi + lo, ~16 bits), where the plain version
rounds them to bf16.  Its tile plan and launch order are mirrored here
(:func:`tile_plan`, :func:`kv_tile_range` with the offset,
:func:`block_order`) and checked against the library when it is loaded.
fp32 inputs go to the fp32 kernel (``f32_tf32x3``): both products on the
tensor cores in split TF32 (three ``mma.sync`` TF32 products a product,
lo hi + hi lo + hi hi; P kept in registers as the second product's
operand), 128 q rows a block over kv tiles of 64 keys streamed by TMA in
d-chunks of 64 columns (at Sq <= F32_SHORT, a decode step, each warp
takes 8 keys of a step for the 16 rows), and on a card whose grid would
fill less than two waves each block's kv tiles cut into
:func:`f32_splits` ranges, merged in split order by a finish kernel.
Any strides work: q, k or v off TMA's rules (:func:`_tma_ok_f32`) are
copied once (``ROUTES["f32_copy"]``).  Its plans are mirrored here
(:func:`f32_tile_plan`,
:func:`f32_smem_bytes`, :func:`f32_splits`, :func:`f32_split_range`,
:func:`f32_scratch_floats`) and checked against the library when it is
loaded.

Training: on CUDA tensors with grad enabled and an input that requires
it, ``flash_attention`` is a ``torch.autograd.Function``
(:class:`FlashAttentionFn`): the forward kernel also writes each row's
log-sum-exp (``lse [B, Hq, Sq]`` fp32), and the backward is
:func:`flash_attention_backward`, three launches of the CUDA C++ kernels
of ``csrc/flash_attn_bwd.cu`` (``delta = rowsum(dO o O)``, dQ a q tile,
dK and dV a kv tile), counted in :data:`LAUNCHES` once a call and by
route in :data:`ROUTES`: bf16 on the tensor cores (``wgmma``, TMA-fed
tiles, P rounded to bf16 for dV's product, dS carried as a bf16 hi + lo
pair into dQ's and dK's), fp32 on the tensor cores in split TF32
(``bwd_f32_tf32x3``: three ``mma.sync`` TF32 products a product, lo hi +
hi lo + hi hi, 64 x 64 tiles streamed by TMA in d-chunks of 64 columns,
dQ's own Q and dO kept whole, the dK/dV blocks' steps cut into
:func:`dkdv_splits` ranges on a card whose grid would fill less than two
waves, their partials summed in order by a finish kernel; q, k, v or
dout off TMA's rules copied once); both take D a multiple of 16 up to
256.  Their plans are mirrored here (:func:`bwd_tile_plan`,
:func:`bwd_smem_bytes`, :func:`dkdv_heads`, :func:`dkdv_splits`,
:func:`dkdv_steps`, :func:`bwd_scratch_rows`, :func:`bwd_scratch_floats`,
and :func:`dq_kv_tile_range` and :func:`q_tile_range`, whose tiles count
the rows at their positions ``q_offset + i``) and checked against the
library when it is loaded, the tile ranges at offsets 0 and above.
:func:`flash_attention_backward_plain` is their plain version in fp32
(the tests' and chip_smoke.py's oracle; no path that runs on a card calls
it).  On the CPU, gradients come from autograd through
``attention_blockwise``.

Fake tensors (``torch._subclasses.fake_tensor``: shapes without storage,
what ``repro_torch.launch.dryrun`` runs a step on) have no data for any
route to compute on: the forward and the backward then return outputs of
the real route's shapes, dtypes and scratch, launch nothing, count
nothing in :data:`LAUNCHES` or :data:`ROUTES`, and add the kernel's flops
(:func:`attention_flops`) to :data:`FAKE_FLOPS`.  Real CPU and CUDA
tensors never take that branch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch import obs
from repro_torch.kernels.clg_stats import _launch, _route, sm_count
from repro_torch.nn.attention import NEG_INF, _fold_gqa, attention_blockwise

Tensor = torch.Tensor

LAUNCHES = {"flash_attention": 0, "flash_attention_backward": 0}
# launches by kernel; f32_copy counts the fp32 forward's copies of a q, k
# or v that breaks its TMA rule (once a call), bwd_dout_copy the
# backward's copies of a dout that breaks its kernels' layout rule,
# bwd_f32_copy the fp32 backward's copies of a q, k or v that breaks it
ROUTES = {"bf16_wgmma": 0, "f32_tf32x3": 0, "f32_copy": 0,
          "bwd_bf16_wgmma": 0, "bwd_f32_tf32x3": 0, "bwd_dout_copy": 0,
          "bwd_f32_copy": 0}
# flops of the kernels' work on fake tensors (module docstring), by kernel
FAKE_FLOPS = {"flash_attention": 0, "flash_attention_backward": 0}
FAKE_SMS = 132                   # an H100's SMs: the fake backward's plan

MAX_D = 256                      # flash_attn_max_d() in flash_attn.cu
DTYPES = (torch.float32, torch.bfloat16)
BQ = 128                         # q rows per block of the bf16 kernel


BWD_MAX_D = {True: 256, False: 256}   # the backward's D by bf16 (else fp32)


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES, FAKE_FLOPS):
        for k in counts:
            counts[k] = 0


def live_pairs(Sq: int, Sk: int, causal: bool = True,
               window: Optional[int] = None, q_offset: int = 0) -> int:
    """The (q, k) pairs the mask keeps: query i at position q_offset + i
    reads the keys 0 .. Sk - 1 up to its own position (causal) and above
    position - window (with a window)."""
    pos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(pos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_flops(B: int, Sq: int, Sk: int, Hq: int, D: int,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, backward: bool = False) -> int:
    """The flops of a call over its live pairs (PERF.md's bound of rows 9
    and 9b): the forward's two products, 4 D a pair, or the backward's
    five, 10 D a pair, for each (batch, q head)."""
    per = 10 if backward else 4
    return per * D * live_pairs(Sq, Sk, causal, window, q_offset) * B * Hq


HEAD_GROUP_BYTES = 24 << 20      # kHeadGroupBytes in flash_attn.cu


def tile_plan(D: int) -> Tuple[int, int, int]:
    """(DP, BK, STAGES) of the bf16 kernel for head dimension ``D``: D
    padded to DP in {64, 128, 256}, BK keys per kv tile, STAGES tiles in
    the shared-memory ring (``Plan`` in flash_attn.cu)."""
    dp = 64 if D <= 64 else 128 if D <= 128 else 256
    return dp, (128 if dp == 64 else 64), (2 if dp == 256 else 4)


def head_group(Sk: int, D: int, pairs: int) -> int:
    """(head, batch) pairs whose K and V (4·Sk·D bytes each) fit in
    HEAD_GROUP_BYTES of L2: the bf16 kernel launches them together."""
    per = 4 * Sk * D
    g = HEAD_GROUP_BYTES // per if per else pairs
    return max(1, min(g, pairs))


def kv_tile_range(qt: int, Sq: int, Sk: int, causal: bool,
                  window: Optional[int], D: int, q_offset: int = 0) -> range:
    """The kv tiles q tile ``qt`` of the bf16 kernel visits: those not
    wholly above the diagonal (causal) nor wholly below the window, at the
    rows' positions ``q_offset + i``."""
    bk = tile_plan(D)[1]
    q0 = q_offset + qt * BQ
    end = -(-Sk // bk)
    if causal:
        end = min(end, (q_offset + min(qt * BQ + BQ, Sq) - 1) // bk + 1)
    begin = 0
    if window:
        lo = q0 - window - bk + 2             # k0 + bk - 1 > q0 - window
        if lo > 0:
            begin = -(-lo // bk)
    return range(begin, max(end, begin))


def q_tile_order(Sq: int, causal: bool) -> List[int]:
    """The order in which the bf16 kernel's blocks take the q tiles of a
    head, longest first: with a causal mask the last q tile has the most
    kv tiles; without one the window (if any) gives the first the most."""
    nq = -(-Sq // BQ)
    return list(range(nq - 1, -1, -1)) if causal else list(range(nq))


def block_order(B: int, Hq: int, Sq: int, Sk: int, D: int,
                causal: bool) -> List[Tuple[int, int, int]]:
    """(q tile, head, batch) of each block of the bf16 kernel, by block
    index: groups of :func:`head_group` (head, batch) pairs in turn, inside
    a group the q tiles in :func:`q_tile_order`, the group's pairs
    innermost."""
    pairs = Hq * B
    g = head_group(Sk, D, pairs)
    order = []
    for g0 in range(0, pairs, g):
        for qt in q_tile_order(Sq, causal):
            for pair in range(g0, min(g0 + g, pairs)):
                order.append((qt, pair % Hq, pair // Hq))
    return order


class BwdPlan(NamedTuple):
    """Tiles of the backward kernels at one head dimension
    (``flash_bwd_plan`` in flash_attn_bwd.cu)."""
    dp: int             # D padded (bf16), the accumulators' width (fp32)
    dq_bq: int          # q rows a dQ block
    dq_bk: int          # keys a kv tile of the dQ kernel
    dq_stages: int      # its ring's stages
    kv_bq: int          # q rows a q tile of the dK/dV kernel
    kv_bk: int          # keys a dK/dV block
    kv_stages: int      # its ring's stages
    col_groups: int     # dK/dV's warpgroups (bf16) or accumulate warps
                        # (fp32) split the columns (2) or keys (1)
    chunk: int          # columns a stage holds (bf16: the whole DP)


F32_TILE, F32_BOX = 64, 32       # kT, kBox: the fp32 kernels' tile, TMA box
F32_CHUNK = 2 * F32_BOX          # kDC: columns of a d-chunk
F32_STAGES = 4                   # kStages: the rings' stages


def bwd_tile_plan(D: int, bf16: bool = True) -> BwdPlan:
    """The backward kernels' tiles at head dimension ``D``: bf16 pads D to
    DP in {64, 128, 256}, dQ blocks of 128 q rows over kv tiles of 64 keys
    (32 at DP = 256, so that two stages fit beside Q and dO), dK/dV blocks
    of 128 keys (64 a warpgroup) over q tiles of 64 rows, or at DP = 256
    of 64 keys with the columns split over the two warpgroups; fp32 tiles
    of 64 q rows by 64 keys at every D (DP, the accumulators' width, in
    {64, 128, 256}), streamed in d-chunks of 64 columns (two TMA boxes)
    through a ring of four stages."""
    dp = 64 if D <= 64 else 128 if D <= 128 else 256
    if not bf16:
        t = F32_TILE
        return BwdPlan(dp, t, t, F32_STAGES, t, t, F32_STAGES, 2, F32_CHUNK)
    if dp == 256:
        return BwdPlan(dp, 128, 32, 2, 64, 64, 2, 2, dp)
    return BwdPlan(dp, 128, 64, 4, 64, 128, 4, 1, dp)


def dq_kv_tile_range(qt: int, Sq: int, Sk: int, causal: bool,
                     window: Optional[int], bq: int, bk: int,
                     q_offset: int = 0) -> range:
    """The kv tiles (of ``bk`` keys) the dQ kernel's block for q tile
    ``qt`` (``bq`` rows, row i at position ``q_offset + i``) reads, in
    order: those not wholly above the diagonal of its last row nor wholly
    below the window of its first."""
    q0 = q_offset + qt * bq
    q_last = q_offset + min(qt * bq + bq, Sq) - 1
    end = -(-Sk // bk)
    if causal:
        end = min(end, q_last // bk + 1)
    begin = 0
    if window:
        lo = q0 - window - bk + 2             # k0 + bk - 1 > q0 - window
        if lo > 0:
            begin = -(-lo // bk)
    return range(begin, max(end, begin))


def q_tile_range(kt: int, Sq: int, Sk: int, causal: bool,
                 window: Optional[int], bq: int, bk: int,
                 q_offset: int = 0) -> range:
    """The q tiles (of ``bq`` rows, row i at position ``q_offset + i``) the
    dK/dV kernel's block for kv tile ``kt`` (``bk`` keys) visits for each q
    head, in order: those not wholly above the diagonal (causal) nor past
    the window of its last key."""
    k0 = kt * bk
    k_last = min(k0 + bk, Sk) - 1
    end = -(-Sq // bq)
    if window:
        last = k_last + window - 1 - q_offset     # the last row reading it
        end = min(end, last // bq + 1 if last >= 0 else 0)
    begin = max(k0 - q_offset, 0) // bq if causal else 0
    return range(begin, max(end, begin))


def dkdv_heads(hk: int, Hq: int, Hkv: int) -> List[int]:
    """The q heads the dK/dV kernel's block of kv head ``hk`` sums, in its
    order: h = g Hkv + hk for g = 0 .. G - 1 (the G-major fold)."""
    return [g * Hkv + hk for g in range(Hq // Hkv)]


F32_MAX_WAVES = 4                # kMaxWaves: dK/dV blocks after the split


def dkdv_splits(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, causal: bool,
                window: Optional[int], q_offset: int, sms: int) -> int:
    """Ranges the fp32 dK/dV kernel cuts each block's steps into
    (``dkdv_splits`` in the source, checked against the library when it
    loads): 1 when the (kv tile, kv head, batch) grid fills two waves of
    ``sms`` SMs, one block an SM; else enough to bring the longest block's
    steps (:func:`dkdv_steps`) down to the mean steps an SM, at most
    F32_MAX_WAVES waves of blocks and one step a range."""
    t = F32_TILE
    nkt = -(-Sk // t)
    blocks = B * Hkv * nkt
    if blocks >= 2 * sms:
        return 1
    G = Hq // Hkv
    steps = [G * len(q_tile_range(kt, Sq, Sk, causal, window, t, t,
                                  q_offset)) for kt in range(nkt)]
    total = B * Hkv * sum(steps)
    if total == 0:
        return 1
    s = min(-(-(max(steps) * sms) // total), F32_MAX_WAVES * sms // blocks,
            max(steps))
    return max(s, 1)


def dkdv_steps(kt: int, split: int, splits: int, Sq: int, Sk: int, Hq: int,
               Hkv: int, hk: int, causal: bool, window: Optional[int],
               q_offset: int = 0) -> List[Tuple[int, int]]:
    """The (q head, q tile) steps, in order, of the fp32 dK/dV block of kv
    head ``hk``, kv tile ``kt`` and split ``split``: the kv tile's steps --
    the heads of :func:`dkdv_heads` in order, each its
    :func:`q_tile_range` in order -- cut into ``splits`` contiguous ranges,
    split s holding steps s n // splits .. (s + 1) n // splits - 1."""
    t = F32_TILE
    tiles = list(q_tile_range(kt, Sq, Sk, causal, window, t, t, q_offset))
    steps = [(h, qt) for h in dkdv_heads(hk, Hq, Hkv) for qt in tiles]
    n = len(steps)
    return steps[split * n // splits:(split + 1) * n // splits]


def bwd_smem_bytes(kernel: str, D: int, bf16: bool = True) -> int:
    """Shared memory of a block of ``"dq"`` or ``"dkdv"`` at head dim D:
    bf16, 1 KB of alignment, the resident tiles, the ring's stages (with
    their L and delta rows) and the mbarriers; fp32, 1 KB of alignment,
    dQ's resident Q and dO (DP columns each), the ring's stages of d-chunks
    (TMA boxes of [64][32] floats: dQ two, dK/dV four), the rows' L and
    delta (dQ once, dK/dV in two slots), 64 x 64 operands in fragment
    order, hi and lo: dS (dQ), P^T and dS^T (dK/dV), and the
    mbarriers."""
    p = bwd_tile_plan(D, bf16)
    if not bf16:
        t, st = F32_TILE, F32_STAGES
        n = 2 if kernel == "dq" else 4
        resident = 2 * p.dp * t if kernel == "dq" else 0
        stage = (2 if kernel == "dq" else 4) * t * F32_BOX
        return (1024 + 4 * (resident + st * stage + n * t + n * t * t)
                + 16 * st + 8)
    if kernel == "dq":
        return (1024 + 4 * p.dq_bq * p.dp + 4 * p.dq_stages * p.dq_bk * p.dp
                + 8 * p.dq_bq + 8 * (2 * p.dq_stages + 1))
    return (1024 + 4 * p.kv_bk * p.dp
            + p.kv_stages * (4 * p.kv_bq * p.dp + 8 * p.kv_bq)
            + 8 * (2 * p.kv_stages + 1))


def bwd_scratch_rows(Sq: int, bf16: bool) -> int:
    """Rows of the backward's L (lse log2(e)) and delta arrays, [2, B, Hq,
    rows] fp32 at the head of its scratch: Sq padded to a multiple of 128,
    both routes."""
    return -(-Sq // 128) * 128


def bwd_scratch_floats(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
                       bf16: bool, splits: int = 1) -> int:
    """Floats of the backward's scratch: L and delta (:func:`bwd_scratch_rows`
    rows), then on the fp32 route with ``splits`` > 1
    (:func:`dkdv_splits`) the dK/dV blocks' partial dK and dV, [splits, B,
    Sk, Hkv, D] each."""
    rows = 2 * B * Hq * bwd_scratch_rows(Sq, bf16)
    return rows + (2 * splits * B * Sk * Hkv * D
                   if not bf16 and splits > 1 else 0)


class F32Plan(NamedTuple):
    """The fp32 forward kernel's plan at one head dimension, long or short
    (``flash_attn_f32_plan`` in flash_attn.cu)."""
    dmax: int           # O's width: D rounded up to 64, 128 or 256
    bq: int             # q rows a block (8 warps)
    tile: int           # keys a kv tile: the unit of the ranges and splits
    step: int           # keys a step: the softmax's unit, a chunk's rows
    stages: int         # the ring's stages (64 KB of chunks)
    chunk: int          # columns of a d-chunk (two TMA boxes)
    pass_tiles: int     # n8 tiles a pass of P V


F32_BQ = 128                     # kF32BQ: the fp32 forward's q rows a block
F32_SHORT = 16                   # kF32Short: Sq at most this, the short plan
F32_SPLIT_BLOCKS = 8             # kF32SplitBlocks: blocks an SM when split
F32_RED = 2 * 8 * 16 + 8 * 16 + 16   # kF32Red: the short plan's exchange


def f32_tile_plan(D: int, short: bool = False) -> F32Plan:
    """The fp32 forward's plan at head dimension ``D``: blocks of 128 q
    rows (8 warps) over kv tiles of 64 keys, each streamed in steps of 64
    keys (32 in the long plan at DMAX = 256, where O takes 128 registers a
    thread), a step as d-chunks of 64 columns through a ring of 64 KB (4
    stages, or 8 of 32-key chunks); O DMAX wide, its P V in passes of 8 n8
    tiles (4 at DMAX = 256).  The short plan (``Sq <= F32_SHORT``): every
    warp on rows 0-15, warp w the keys 8 w .. 8 w + 7 of a step."""
    dmax = 64 if D <= 64 else 128 if D <= 128 else 256
    step = 32 if dmax == 256 and not short else F32_TILE
    return F32Plan(dmax, F32_BQ, F32_TILE, step, 4 * F32_TILE // step,
                   F32_CHUNK, 4 if dmax == 256 else 8)


def f32_smem_bytes(D: int, short: bool = False) -> int:
    """Shared memory of an fp32 forward block: 1 KB of alignment, Q (128
    rows x DMAX fp32; the short plan's warps' O once the loop is done), the
    ring's stages (two TMA boxes of [step][32] fp32 each), the short plan's
    exchange (F32_RED floats) and the mbarriers (full and empty a stage,
    Q's)."""
    p = f32_tile_plan(D, short)
    return (1024 + 4 * (p.bq * p.dmax + p.stages * 2 * p.step * F32_BOX
                        + F32_RED) + 8 * (2 * p.stages + 1))


@functools.lru_cache(maxsize=256)
def f32_splits(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, causal: bool,
               window: Optional[int], q_offset: int, sms: int) -> int:
    """Ranges the fp32 forward cuts each (q tile, q head, batch) block's kv
    tiles into (``f32_splits`` in the source): 1 when those blocks fill two
    waves of ``sms`` SMs, one block an SM; else F32_SPLIT_BLOCKS blocks an
    SM, at most the longest block's tiles (:func:`dq_kv_tile_range` at 128
    rows by 64 keys)."""
    nq = -(-Sq // F32_BQ)
    blocks = B * Hq * nq
    if blocks <= 0 or blocks >= 2 * sms:
        return 1
    longest = max(len(dq_kv_tile_range(qt, Sq, Sk, causal, window, F32_BQ,
                                       F32_TILE, q_offset))
                  for qt in range(nq))
    return max(1, min(F32_SPLIT_BLOCKS * sms // blocks, longest))


def f32_split_range(qt: int, split: int, splits: int, Sq: int, Sk: int,
                    causal: bool, window: Optional[int],
                    q_offset: int = 0) -> range:
    """The kv tiles (of 64 keys) split ``split`` of ``splits`` of the fp32
    forward's q tile ``qt`` (128 rows) reads, in order: the q tile's range
    [kb, kb + n) cut at kb + s n // splits."""
    r = dq_kv_tile_range(qt, Sq, Sk, causal, window, F32_BQ, F32_TILE,
                         q_offset)
    n = len(r)
    return range(r.start + split * n // splits,
                 r.start + (split + 1) * n // splits)


def f32_scratch_floats(B: int, Sq: int, Hq: int, D: int, splits: int) -> int:
    """Floats of the fp32 forward's scratch: with ``splits`` > 1 each
    split's unnormalised O [splits, B, Hq, Sq, D], then its m and l
    [splits, B, Hq, Sq] each; none with one."""
    return splits * B * Hq * Sq * (D + 2) if splits > 1 else 0


# (Sq, Sk, causal, window, q_offset) at which the load-time check compares
# the library's tile ranges with the mirrors above
_RANGE_CASES = ((4096, 4096, 1, 0, 0), (448, 1500, 0, 0, 0),
                (8192, 8192, 1, 4096, 0), (100, 37, 1, 5, 0),
                (1, 1500, 0, 0, 0), (300, 130, 0, 70, 0),
                (1024, 4096, 1, 0, 3072), (2048, 8192, 1, 1024, 2048),
                (100, 300, 1, 70, 137), (300, 130, 0, 70, 45),
                (683, 2049, 1, 0, 1366))


# (B, Hq, Hkv, D, sms) at which it compares the dK/dV splits and the
# scratch's floats, at each of the cases above
_SPLIT_CASES = ((2, 8, 1, 256, 132), (2, 8, 2, 144, 132), (1, 4, 4, 64, 132),
                (2, 32, 8, 64, 132), (3, 6, 2, 128, 7))


def _bwd_lib():
    from repro_torch.kernels import build

    lib = build.load("flash_attn_bwd")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attn_bwd_launch.argtypes = ([p] * 10 + [i] * 6 + [ll] * 15
                                              + [ctypes.c_float, i, i, i, i,
                                                 i, p])
        lib.flash_attn_bwd_launch.restype = i
        lib.flash_bwd_max_d.argtypes = [i]
        lib.flash_bwd_max_d.restype = i
        lib.flash_bwd_plan.argtypes = [i, i, ctypes.POINTER(i)]
        lib.flash_bwd_plan.restype = None
        for fn in (lib.flash_bwd_dq_kv_range, lib.flash_bwd_q_range):
            fn.argtypes = [i] * 8 + [ctypes.POINTER(i)]
            fn.restype = None
        lib.flash_bwd_smem.argtypes = [i, i, i]
        lib.flash_bwd_smem.restype = ll
        lib.flash_bwd_scratch_rows.argtypes = [i, i]
        lib.flash_bwd_scratch_rows.restype = i
        lib.flash_bwd_dkdv_splits.argtypes = [i] * 9
        lib.flash_bwd_dkdv_splits.restype = i
        lib.flash_bwd_scratch_floats.argtypes = [i] * 8
        lib.flash_bwd_scratch_floats.restype = ll
        got = (i * 9)()
        for bf16 in (True, False):
            if lib.flash_bwd_max_d(int(bf16)) != BWD_MAX_D[bf16]:
                raise RuntimeError("flash_attn_bwd.cu and flash_attn.py "
                                   "disagree on the backward's largest D")
            tiles = set()
            for D in range(16, BWD_MAX_D[bf16] + 1, 16):
                plan = bwd_tile_plan(D, bf16)
                lib.flash_bwd_plan(D, int(bf16), got)
                if tuple(got) != plan:
                    raise RuntimeError("flash_attn_bwd.cu and flash_attn.py "
                                       f"disagree on the backward's tile "
                                       f"plan at D = {D}, bf16 = {bf16}")
                for kernel, which in (("dq", 0), ("dkdv", 1)):
                    if lib.flash_bwd_smem(which, D, int(bf16)) \
                            != bwd_smem_bytes(kernel, D, bf16):
                        raise RuntimeError(
                            "flash_attn_bwd.cu and flash_attn.py disagree "
                            f"on {kernel}'s shared memory at D = {D}, "
                            f"bf16 = {bf16}")
                tiles.add((plan.dq_bq, plan.dq_bk, plan.kv_bq, plan.kv_bk))
            for Sq, Sk, causal, window, off in _RANGE_CASES:
                if lib.flash_bwd_scratch_rows(Sq, int(bf16)) \
                        != bwd_scratch_rows(Sq, bf16):
                    raise RuntimeError("flash_attn_bwd.cu and flash_attn.py "
                                       "disagree on the scratch rows")
                for B, Hq, Hkv, D, sms in _SPLIT_CASES:
                    sp = dkdv_splits(B, Sq, Sk, Hq, Hkv, bool(causal),
                                     window, off, sms)
                    if lib.flash_bwd_dkdv_splits(B, Sq, Sk, Hq, Hkv, causal,
                                                 window, off, sms) != sp \
                            or lib.flash_bwd_scratch_floats(
                                B, Sq, Sk, Hq, Hkv, D, int(bf16), sp) \
                            != bwd_scratch_floats(B, Sq, Sk, Hq, Hkv, D,
                                                  bf16, sp):
                        raise RuntimeError(
                            "flash_attn_bwd.cu and flash_attn.py disagree "
                            "on the dK/dV splits or the scratch")
                for dq_bq, dq_bk, kv_bq, kv_bk in tiles:
                    for qt in range(-(-Sq // dq_bq)):
                        lib.flash_bwd_dq_kv_range(qt, dq_bq, dq_bk, Sq, Sk,
                                                  causal, window, off, got)
                        r = dq_kv_tile_range(qt, Sq, Sk, bool(causal),
                                             window, dq_bq, dq_bk, off)
                        if (got[0], got[1]) != (r.start, r.stop):
                            raise RuntimeError(
                                "flash_attn_bwd.cu and flash_attn.py "
                                "disagree on dQ's kv tiles")
                    for kt in range(-(-Sk // kv_bk)):
                        lib.flash_bwd_q_range(kt, kv_bq, kv_bk, Sq, Sk,
                                              causal, window, off, got)
                        r = q_tile_range(kt, Sq, Sk, bool(causal), window,
                                         kv_bq, kv_bk, off)
                        if (got[0], got[1]) != (r.start, r.stop):
                            raise RuntimeError(
                                "flash_attn_bwd.cu and flash_attn.py "
                                "disagree on dK/dV's q tiles")
        lib._typed = True
    return lib


def _lib():
    from repro_torch.kernels import build

    lib = build.load("flash_attn")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        head = [p] * 5 + [i] * 6 + [ll] * 9 + [ctypes.c_float, i, i, i]
        lib.flash_attn_bf16_launch.argtypes = head + [p]
        lib.flash_attn_f32_launch.argtypes = head + [p, i, p]
        for fn in (lib.flash_attn_f32_launch, lib.flash_attn_bf16_launch):
            fn.restype = i
        lib.flash_attn_f32_plan.argtypes = [i, i, ctypes.POINTER(i)]
        lib.flash_attn_f32_plan.restype = None
        lib.flash_attn_f32_short_rows.argtypes = []
        lib.flash_attn_f32_short_rows.restype = i
        lib.flash_attn_f32_smem.argtypes = [i, i]
        lib.flash_attn_f32_smem.restype = ll
        lib.flash_attn_f32_splits.argtypes = [i] * 9
        lib.flash_attn_f32_splits.restype = i
        lib.flash_attn_f32_split_range.argtypes = [i] * 8 + [ctypes.POINTER(i)]
        lib.flash_attn_f32_split_range.restype = None
        lib.flash_attn_f32_scratch_floats.argtypes = [i] * 5
        lib.flash_attn_f32_scratch_floats.restype = ll
        lib.flash_attn_max_d.argtypes = []
        lib.flash_attn_max_d.restype = i
        lib.flash_attn_bf16_plan.argtypes = [i, ctypes.POINTER(i)]
        lib.flash_attn_bf16_plan.restype = None
        lib.flash_attn_head_group.argtypes = [i, i, i]
        lib.flash_attn_head_group.restype = i
        if lib.flash_attn_max_d() != MAX_D:
            raise RuntimeError("flash_attn.cu and flash_attn.py disagree on "
                               "the largest head dimension")
        for D in range(16, MAX_D + 1, 16):
            plan = (i * 3)()
            lib.flash_attn_bf16_plan(D, plan)
            if tuple(plan) != tile_plan(D):
                raise RuntimeError("flash_attn.cu and flash_attn.py disagree "
                                   f"on the tile plan at D = {D}")
        for Sk, D, pairs in ((8192, 64, 64), (1, 16, 3), (1 << 20, 256, 8)):
            if lib.flash_attn_head_group(Sk, D, pairs) != head_group(Sk, D,
                                                                     pairs):
                raise RuntimeError("flash_attn.cu and flash_attn.py disagree "
                                   "on the head groups")
        _check_f32_plans(lib)
        lib._typed = True
    return lib


def _check_f32_plans(lib) -> None:
    """The fp32 forward's plans in the library against the mirrors: the
    short plan's rows, both plans and their shared memory at every D, and
    at each of _RANGE_CASES x _SPLIT_CASES the splits, every split's
    kv-tile range and the scratch."""
    got = (ctypes.c_int * 7)()
    if lib.flash_attn_f32_short_rows() != F32_SHORT:
        raise RuntimeError("flash_attn.cu and flash_attn.py disagree on the "
                           "fp32 short plan's rows")
    for D in range(16, MAX_D + 1, 16):
        for short in (False, True):
            lib.flash_attn_f32_plan(D, int(short), got)
            if tuple(got) != f32_tile_plan(D, short) \
                    or lib.flash_attn_f32_smem(D, int(short)) \
                    != f32_smem_bytes(D, short):
                raise RuntimeError("flash_attn.cu and flash_attn.py disagree "
                                   f"on the fp32 plan at D = {D}, short = "
                                   f"{short}")
    for Sq, Sk, causal, window, off in _RANGE_CASES:
        for B, Hq, Hkv, D, sms in _SPLIT_CASES:
            sp = f32_splits(B, Sq, Sk, Hq, Hkv, bool(causal), window, off,
                            sms)
            if lib.flash_attn_f32_splits(B, Sq, Sk, Hq, Hkv, causal, window,
                                         off, sms) != sp \
                    or lib.flash_attn_f32_scratch_floats(B, Sq, Hq, D, sp) \
                    != f32_scratch_floats(B, Sq, Hq, D, sp):
                raise RuntimeError("flash_attn.cu and flash_attn.py disagree "
                                   "on the fp32 splits or scratch")
            for qt in range(-(-Sq // F32_BQ)):
                for split in range(sp):
                    lib.flash_attn_f32_split_range(qt, split, sp, Sq, Sk,
                                                   causal, window, off, got)
                    r = f32_split_range(qt, split, sp, Sq, Sk, bool(causal),
                                        window, off)
                    if (got[0], got[1]) != (r.start, r.stop):
                        raise RuntimeError(
                            "flash_attn.cu and flash_attn.py disagree on the "
                            "fp32 kv tiles of a split")


def _check(q: Tensor, k: Tensor, v: Tensor, window: Optional[int],
           causal: bool = True, q_offset: int = 0) -> None:
    name = "flash_attention"
    for what, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {what} must be a torch.Tensor")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name}: q, k and v must share a dtype among "
                            f"{DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name}: {what} must be [B, S, H, D], got "
                             f"shape {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, expected "
                             f"{q.device}")
    B, _, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or k.shape[2] < 1 or Hq % k.shape[2]:
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} k{tuple(k.shape)}"
                         f" v{tuple(v.shape)} disagree")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1 or None")
    if q_offset < 0 or (causal and q_offset
                        and q_offset + q.shape[1] > k.shape[1]):
        raise ValueError(f"{name}: q_offset {q_offset} must be >= 0, and a "
                         f"causal mask at an offset needs q_offset + Sq <= Sk "
                         f"(Sq = {q.shape[1]}, Sk = {k.shape[1]})")


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, bq: int = 128,
                    bk: int = 128, q_offset: int = 0) -> Tensor:
    """Softmax attention of ``q`` over ``k``/``v``, causal and/or within a
    sliding window of ``window`` positions, query i at position
    ``q_offset + i``; differentiable (module docstring)."""
    with obs.span("kernel.flash_attention"):
        name = "flash_attention"
        _check(q, k, v, window, causal, q_offset)
        dev = q.device
        if not _route(name, dev):
            return attention_blockwise(q, k, v, causal=causal, window=window,
                                       scale=scale, q_offset=q_offset)
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            _bwd_check_d(name, q.shape[3], q.dtype == torch.bfloat16)
            return FlashAttentionFn.apply(q, k, v, causal, window, scale,
                                          q_offset)
        return _forward(q, k, v, causal, window, scale, False, q_offset)[0]


def _tma_ok(t: Tensor) -> bool:
    """TMA's rules for a bf16 kernel's input: a 16-byte aligned base and
    B, S and H strides that are multiples of 8 elements (D contiguous); a
    fake tensor has no address, only its strides."""
    return t.stride(3) == 1 and (is_fake(t) or t.data_ptr() % 16 == 0) \
        and not any(st % 8 for st in t.stride()[:3])


def _tma_ok_f32(t: Tensor) -> bool:
    """The fp32 kernels' TMA rules: a 16-byte aligned base and B, S and H
    strides that are multiples of 4 elements (D contiguous)."""
    return t.stride(3) == 1 and (is_fake(t) or t.data_ptr() % 16 == 0) \
        and not any(st % 4 for st in t.stride()[:3])


def _bwd_check_d(name: str, D: int, bf16: bool) -> None:
    if D % 16 or D > BWD_MAX_D[bf16]:
        raise NotImplementedError(
            f"{name}: the {'bf16' if bf16 else 'fp32'} backward kernels take "
            f"D a multiple of 16 up to {BWD_MAX_D[bf16]}, got {D}")


def _forward(q: Tensor, k: Tensor, v: Tensor, causal: bool,
             window: Optional[int], scale: Optional[float],
             with_lse: bool, q_offset: int = 0
             ) -> Tuple[Tensor, Optional[Tensor]]:
    """One launch of the forward kernel on CUDA tensors: (out, lse [B, Hq,
    Sq] fp32 when ``with_lse``, else None); on fake tensors no launch
    (module docstring)."""
    name = "flash_attention"
    dev = q.device
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if D % 16 or D > MAX_D:
        raise ValueError(f"{name}: the kernel takes D a multiple of 16 up to "
                         f"{MAX_D}, got {D}")
    for what, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {what} must be contiguous in D")
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        for what, t in (("q", q), ("k", k), ("v", v)):
            if not _tma_ok(t):
                raise ValueError(f"{name}: the bf16 kernel needs {what} "
                                 f"16-byte aligned with B, S and H strides "
                                 f"multiples of 8, got strides {t.stride()}")
    scale = scale or 1.0 / math.sqrt(D)
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev) \
        if with_lse else None
    if is_fake(q):              # shapes alone: nothing to compute on
        FAKE_FLOPS[name] += attention_flops(B, Sq, Sk, Hq, D, causal, window,
                                            q_offset)
        return out, lse
    if out.numel() == 0 or Sk == 0:
        if lse is not None:
            lse.fill_(NEG_INF)
        return out.zero_(), lse
    lib = _lib()
    tail = []
    if not bf16:
        if not all(map(_tma_ok_f32, (q, k, v))):
            # the fp32 kernel reads q, k and v by TMA: any other strides
            # cost one copy
            q, k, v = (t if _tma_ok_f32(t) else t.contiguous()
                       for t in (q, k, v))
            ROUTES["f32_copy"] += 1
        sms = sm_count(dev)
        splits = f32_splits(B, Sq, Sk, Hq, Hkv, causal, window, q_offset,
                            sms)
        n = f32_scratch_floats(B, Sq, Hq, D, splits)
        scratch = torch.empty((n,), dtype=torch.float32, device=dev) \
            if n else None
        tail = [None if scratch is None else scratch.data_ptr(), sms]
    launch = lib.flash_attn_bf16_launch if bf16 else lib.flash_attn_f32_launch
    _launch(LAUNCHES, name, dev, launch, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Sq, Sk, Hq, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale),
            int(causal), int(window or 0), int(q_offset), *tail)
    ROUTES["bf16_wgmma" if bf16 else "f32_tf32x3"] += 1
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` on CUDA tensors with a gradient: the forward
    kernel with ``lse``, the backward kernels of ``csrc/flash_attn_bwd.cu``
    (:func:`flash_attention_backward`).  Saves q, k, v, the output and
    ``lse``, and the offset."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset=0):
        out, lse = _forward(q, k, v, causal, window, scale, True, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        ctx.q_offset = q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # a module-level lookup, so that wrappers of the function see it
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout, causal=ctx.causal, window=ctx.window,
            scale=ctx.scale, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None, None


def flash_attention_backward(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                             lse: Tensor, dout: Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None,
                             q_offset: int = 0
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) of ``flash_attention`` on CUDA tensors: ``out`` and
    ``lse`` are the forward kernel's (at the same ``q_offset``), ``dout``
    the output's gradient.  One call launches the three backward kernels
    (one count in :data:`LAUNCHES`, one in :data:`ROUTES` by route); the
    gradients have q's dtype.  q, k, v and out must meet the route's layout
    rule (:func:`_tma_ok` for bf16, D contiguous for fp32); a dout that does
    not meet the route's TMA rule is copied once
    (``ROUTES["bwd_dout_copy"]``), and on the fp32 route so are q, k and v
    (:func:`_tma_ok_f32`; ``ROUTES["bwd_f32_copy"]``, once a call).  On
    fake tensors no launch (module docstring)."""
    with obs.span("kernel.flash_attention_backward"):
        return _backward(q, k, v, out, lse, dout, causal, window, scale,
                         q_offset)


def _backward(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor,
              dout: Tensor, causal: bool, window: Optional[int],
              scale: Optional[float], q_offset: int
              ) -> Tuple[Tensor, Tensor, Tensor]:
    name = "flash_attention_backward"
    _check(q, k, v, window, causal, q_offset)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: takes CUDA tensors (on the CPU, autograd "
                         f"differentiates attention_blockwise)")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    _bwd_check_d(name, D, bf16)
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype \
            or tuple(lse.shape) != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: out{tuple(out.shape)} {out.dtype}, dout"
                         f"{tuple(dout.shape)} {dout.dtype}, lse"
                         f"{tuple(lse.shape)} {lse.dtype} disagree with q"
                         f"{tuple(q.shape)} {q.dtype}")
    layout_ok = _tma_ok if bf16 else _tma_ok_f32
    for what, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1 or (bf16 and not layout_ok(t)):
            raise ValueError(f"{name}: {what} must be contiguous in D"
                             + (", 16-byte aligned, with B, S and H strides "
                                "multiples of 8" if bf16 else "")
                             + f", got strides {t.stride()}")
    fake = is_fake(q)
    if not bf16 and not all(map(layout_ok, (q, k, v))):
        # the fp32 kernels read q, k and v by TMA too: any other strides
        # cost one copy
        q, k, v = (t if layout_ok(t) else t.contiguous() for t in (q, k, v))
        ROUTES["bwd_f32_copy"] += not fake
    if not layout_ok(dout):           # autograd may hand over any view
        dout = dout.clone(memory_format=torch.contiguous_format)
        ROUTES["bwd_dout_copy"] += not fake
    lse = lse.contiguous()
    scale = scale or 1.0 / math.sqrt(D)
    dq = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Sk, Hkv, D), dtype=q.dtype, device=dev)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or Sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    sms = FAKE_SMS if fake else sm_count(dev)
    splits = 1 if bf16 else dkdv_splits(B, Sq, Sk, Hq, Hkv, causal, window,
                                        q_offset, sms)
    scratch = torch.empty((bwd_scratch_floats(B, Sq, Sk, Hq, Hkv, D, bf16,
                                              splits),),
                          dtype=torch.float32, device=dev)
    if fake:                    # shapes alone: nothing to compute on
        FAKE_FLOPS[name] += attention_flops(B, Sq, Sk, Hq, D, causal, window,
                                            q_offset, backward=True)
        return dq, dk, dv
    _launch(LAUNCHES, name, dev, _bwd_lib().flash_attn_bwd_launch,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, Hq, Hkv,
            D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], *dout.stride()[:3], float(scale), int(causal),
            int(window or 0), int(q_offset), int(bf16), sms)
    ROUTES["bwd_bf16_wgmma" if bf16 else "bwd_f32_tf32x3"] += 1
    return dq, dk, dv


def _live(Sq: int, lo: int, hi: int, causal: bool, window: Optional[int],
          device, q_offset: int = 0) -> Tensor:
    """[Sq, hi - lo] mask of the live (q, k) pairs for keys lo..hi-1, query
    i at position ``q_offset + i``."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(lo, hi, device=device)[None, :]
    ok = torch.ones((Sq, hi - lo), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window:
        ok = ok & (kpos > qpos - window)
    return ok


def attention_lse_plain(q: Tensor, k: Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None,
                        kv_block: int = 1024, q_offset: int = 0) -> Tensor:
    """Each row's log-sum-exp of its scaled live scores, fp32 [B, Hq, Sq]
    (what the forward kernel writes as ``lse``); NEG_INF for a row with no
    live key."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale or 1.0 / math.sqrt(D)
    qf = _fold_gqa(q.float(), Hkv)
    parts = []
    for lo in range(0, Sk, kv_block):
        kb = k[:, lo:lo + kv_block].float()
        s = torch.einsum("bqghd,bkhd->bqghk", qf, kb) * scale
        ok = _live(Sq, lo, lo + kb.shape[1], causal, window, q.device,
                   q_offset)
        parts.append(torch.where(ok[None, :, None, None, :], s,
                                 -torch.inf).logsumexp(-1))
    lse = torch.stack(parts, -1).logsumexp(-1) if parts else \
        torch.full((B, Sq, Hq // Hkv, Hkv), -torch.inf, device=q.device)
    lse = torch.where(torch.isfinite(lse), lse, NEG_INF)
    return lse.reshape(B, Sq, Hq).permute(0, 2, 1).contiguous()


def flash_attention_backward_plain(q: Tensor, k: Tensor, v: Tensor,
                                   out: Tensor, lse: Tensor, dout: Tensor, *,
                                   causal: bool = True,
                                   window: Optional[int] = None,
                                   scale: Optional[float] = None,
                                   kv_block: int = 1024, q_offset: int = 0
                                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward kernels' function in plain PyTorch, in fp32, over kv
    blocks: P = exp(S scale - lse) on live pairs (0 elsewhere), delta =
    rowsum(dout o out), dS = P o (dout V^T - delta), dq = scale dS K,
    dk = scale dS^T q, dv = P^T dout.  Returns fp32 (dq, dk, dv)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale or 1.0 / math.sqrt(D)
    qf, of, gf = (_fold_gqa(t.float(), Hkv) for t in (q, out, dout))
    L = lse.float().permute(0, 2, 1).reshape(B, Sq, G, Hkv)[..., None]
    delta = (gf * of).sum(-1)[..., None]                  # [B,Sq,G,Hkv,1]
    dq = torch.zeros_like(qf)
    dk, dv = [], []
    for lo in range(0, Sk, kv_block):
        kb, vb = k[:, lo:lo + kv_block].float(), v[:, lo:lo + kv_block].float()
        s = torch.einsum("bqghd,bkhd->bqghk", qf, kb) * scale
        ok = _live(Sq, lo, lo + kb.shape[1], causal, window, q.device,
                   q_offset)
        p = torch.where(ok[None, :, None, None, :], torch.exp(s - L), 0.0)
        dp = torch.einsum("bqghd,bkhd->bqghk", gf, vb)
        ds = p * (dp - delta)
        dq += torch.einsum("bqghk,bkhd->bqghd", ds, kb) * scale
        dk.append(torch.einsum("bqghk,bqghd->bkhd", ds, qf) * scale)
        dv.append(torch.einsum("bqghk,bqghd->bkhd", p, gf))
    empty = torch.zeros((B, 0, Hkv, D), device=q.device)
    return (dq.reshape(B, Sq, Hq, D), torch.cat(dk, 1) if dk else empty,
            torch.cat(dv, 1) if dv else empty)
