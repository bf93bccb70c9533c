"""Wrapper of the CUDA SSD chunk-pass kernel (``csrc/ssd_scan.cu``).

    ssd_scan(x [b, S, H, P], dt [b, S, H], A [H], B/C [b, S, G, N], chunk)
        -> (y [b, S, H, P], h_final [b, H, P, N])

The Mamba2 SSD scan of the Pallas kernel ``repro.kernels.ssd_scan.ssd_scan``
(head h reads B/C group ``h // (H / G)``; ``S % chunk == 0``).

A tensor on the CPU goes to the plain version,
``repro_torch.nn.ssm.ssd_chunked``; a CUDA tensor launches the kernel or
raises -- there is no fallback.  Launches are counted in :data:`LAUNCHES`.
Inputs are fp32, read through their strides with the last dim contiguous.
Limits on a card (raised as ``ValueError``): chunk <= 128, N <= 128 and P a
multiple of 16 (the kernel's shared-memory tiles).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.clg_stats import _route
from repro_torch.nn.ssm import ssd_chunked

Tensor = torch.Tensor

LAUNCHES = {"ssd_scan": 0}

MAX_CHUNK = 128                  # kMaxL in ssd_scan.cu
MAX_N = 128                      # kMaxN
P_BLOCK = 16                     # kPB: columns of P per block


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from repro_torch.kernels import build

    lib = build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_scan_launch.argtypes = [p] * 7 + [i] * 7 + [ll] * 12 + [p]
        lib.ssd_scan_launch.restype = i
        for fn in (lib.ssd_scan_max_chunk, lib.ssd_scan_max_state):
            fn.argtypes = []
            fn.restype = i
        if (lib.ssd_scan_max_chunk(), lib.ssd_scan_max_state()) \
                != (MAX_CHUNK, MAX_N):
            raise RuntimeError("ssd_scan.cu and ssd_scan.py disagree on the "
                               "largest chunk or state")
        lib._typed = True
    return lib


def _check(x, dt, A, B, C, chunk) -> None:
    name = "ssd_scan"
    for what, t, nd in (("x", x, 4), ("dt", dt, 3), ("A", A, 1), ("B", B, 4),
                        ("C", C, 4)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {what} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be torch.float32, got "
                            f"{t.dtype}")
        if t.dim() != nd:
            raise ValueError(f"{name}: {what} must have {nd} dims, got shape "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name}: {what} is on {t.device}, expected "
                             f"{x.device}")
    b, S, H, _ = x.shape
    G = B.shape[2]
    if tuple(dt.shape) != (b, S, H) or tuple(A.shape) != (H,) \
            or B.shape != C.shape or B.shape[:2] != (b, S) or G < 1 \
            or H % G:
        raise ValueError(f"{name}: shapes x{tuple(x.shape)} dt"
                         f"{tuple(dt.shape)} A{tuple(A.shape)} B"
                         f"{tuple(B.shape)} C{tuple(C.shape)} disagree")
    if chunk < 1 or S % chunk:
        raise ValueError(f"{name}: S={S} is not a multiple of chunk={chunk}")


def ssd_scan(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
             chunk: int) -> Tuple[Tensor, Tensor]:
    """The SSD scan over chunks of ``chunk`` steps; returns ``y`` and the
    final state (fp32)."""
    name = "ssd_scan"
    _check(x, dt, A, B, C, chunk)
    dev = x.device
    if not _route(name, dev):
        return ssd_chunked(x, dt, A, B, C, chunk)
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if chunk > MAX_CHUNK or N > MAX_N or P % P_BLOCK:
        raise ValueError(f"{name}: the kernel takes chunk <= {MAX_CHUNK}, "
                         f"N <= {MAX_N} and P a multiple of {P_BLOCK}; got "
                         f"chunk={chunk}, N={N}, P={P}")
    for what, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {what} must be contiguous in its last "
                             f"dim")
    A = A.contiguous()
    y = torch.empty((b, S, H, P), dtype=torch.float32, device=dev)
    hfin = torch.empty((b, H, P, N), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, hfin.zero_()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), hfin.data_ptr(), b, S, H, P, G, N,
            chunk, *x.stride()[:3], *dt.stride(), *B.stride()[:3],
            *C.stride()[:3], stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1
    return y, hfin
