"""Wrapper of the CUDA attention kernels (``csrc/flash_attn.cu``).

    flash_attention(q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], *, causal=True,
                    window=None, scale=None, bq=128, bk=128) -> [B, Sq, Hq, D]

Causal, sliding-window or full (``causal=False``) GQA softmax attention
(q head h reads kv head ``h % Hkv``), Sq and Sk free -- whisper's encoder,
its cross attention and each decode step's one query take the last two --,
the function of the Pallas kernel
``repro.kernels.flash_attn.flash_attention``.  ``bq``/``bk`` are accepted
for that signature; the kernels use their own tiles (:func:`tile_plan`).

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
(:func:`tile_plan`, :func:`kv_tile_range`, :func:`block_order`) and
checked against the library when it is loaded.
fp32 inputs go to the fp32 CUDA-core kernel (any strides), which keeps
the weights in fp32.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels.clg_stats import _launch, _route
from repro_torch.nn.attention import attention_blockwise

Tensor = torch.Tensor

LAUNCHES = {"flash_attention": 0}
ROUTES = {"bf16_wgmma": 0, "f32_fma": 0}   # launches by kernel

MAX_D = 256                      # flash_attn_max_d() in flash_attn.cu
DTYPES = (torch.float32, torch.bfloat16)
BQ = 128                         # q rows per block of the bf16 kernel


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for k in counts:
            counts[k] = 0


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
                  window: Optional[int], D: int) -> range:
    """The kv tiles q tile ``qt`` of the bf16 kernel visits: those not
    wholly above the diagonal (causal) nor wholly below the window."""
    bk = tile_plan(D)[1]
    q0 = qt * BQ
    end = -(-Sk // bk)
    if causal:
        end = min(end, (min(q0 + BQ, Sq) - 1) // bk + 1)
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


def _lib():
    from repro_torch.kernels import build

    lib = build.load("flash_attn")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.flash_attn_f32_launch, lib.flash_attn_bf16_launch):
            fn.argtypes = ([p, p, p, p] + [i] * 6 + [ll] * 9
                           + [ctypes.c_float, i, i, p])
            fn.restype = i
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
        lib._typed = True
    return lib


def _check(q: Tensor, k: Tensor, v: Tensor, window: Optional[int]) -> None:
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


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, bq: int = 128,
                    bk: int = 128) -> Tensor:
    """Softmax attention of ``q`` over ``k``/``v``, causal and/or within a
    sliding window of ``window`` positions."""
    name = "flash_attention"
    _check(q, k, v, window)
    dev = q.device
    if not _route(name, dev):
        return attention_blockwise(q, k, v, causal=causal, window=window,
                                   scale=scale)
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
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(f"{name}: the bf16 kernel needs {what} "
                                 f"16-byte aligned with B, S and H strides "
                                 f"multiples of 8, got strides {t.stride()}")
    scale = scale or 1.0 / math.sqrt(D)
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    lib = _lib()
    launch = lib.flash_attn_bf16_launch if bf16 else lib.flash_attn_f32_launch
    _launch(LAUNCHES, name, dev, launch, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, Sq, Sk, Hq, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale),
            int(causal), int(window or 0))
    ROUTES["bf16_wgmma" if bf16 else "f32_fma"] += 1
    return out
