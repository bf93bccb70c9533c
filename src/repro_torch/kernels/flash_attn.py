"""Wrapper of the CUDA attention kernel (``csrc/flash_attn.cu``).

    flash_attention(q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], *, causal=True,
                    window=None, scale=None, bq=128, bk=128) -> [B, Sq, Hq, D]

Causal and sliding-window GQA softmax attention (q head h reads kv head
``h % Hkv``), the function of the Pallas kernel
``repro.kernels.flash_attn.flash_attention``.  ``bq``/``bk`` are accepted
for that signature; the kernel uses its own tiles (64 q rows, 64 keys).

A tensor on the CPU goes to the plain version,
``repro_torch.nn.attention.attention_blockwise``; a CUDA tensor launches
the kernel or raises -- there is no fallback.  Launches are counted in
:data:`LAUNCHES`.  Inputs are bf16 or fp32 (all three alike) and are read
through their strides; D must be contiguous, a multiple of 16 and at most
256 on a card.  The output has q's dtype.  The kernel keeps the softmax
weights in fp32 for the PV product, where the plain version rounds them
to v's dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.clg_stats import _route
from repro_torch.nn.attention import attention_blockwise

Tensor = torch.Tensor

LAUNCHES = {"flash_attention": 0}

MAX_D = 256                      # flash_attn_max_d() in flash_attn.cu
DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from repro_torch.kernels import build

    lib = build.load("flash_attn")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attn_launch.argtypes = ([p, p, p, p] + [i] * 7 + [ll] * 9
                                          + [ctypes.c_float, i, i, p])
        lib.flash_attn_launch.restype = i
        lib.flash_attn_max_d.argtypes = []
        lib.flash_attn_max_d.restype = i
        if lib.flash_attn_max_d() != MAX_D:
            raise RuntimeError("flash_attn.cu and flash_attn.py disagree on "
                               "the largest head dimension")
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
    scale = scale or 1.0 / math.sqrt(D)
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), B, Sq, Sk, Hq, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(causal), int(window or 0), stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1
    return out
