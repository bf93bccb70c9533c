"""Wrapper of the CUDA SSD scan (``csrc/ssd_scan.cu``).

    ssd_scan(x [b, S, H, P], dt [b, S, H], A [H], B/C [b, S, G, N], chunk)
        -> (y [b, S, H, P], h_final [b, H, P, N])

The Mamba2 SSD scan of the Pallas kernel ``repro.kernels.ssd_scan.ssd_scan``
(head h reads B/C group ``h // (H / G)``; ``S % chunk == 0``).

A tensor on the CPU goes to the plain version,
``repro_torch.nn.ssm.ssd_chunked`` (differentiable by autograd); a CUDA
tensor launches the kernels or raises -- there is no fallback.  The
kernels have no backward yet: on CUDA tensors with grad enabled and an
input that requires it the wrapper raises ``NotImplementedError`` (their
outputs would carry no gradient).  One call issues the four launches of the
chunk-parallel split (chunk states, C B^T once per group, the state pass,
the outputs; see the source's header) and counts one in :data:`LAUNCHES`.
The wrapper allocates their scratch: the states ``[b, S/chunk, H, P, N]``
(134 MB at zamba2-1.2b's prefill of 2 x 8192 tokens), C B^T
``[b, S/chunk, G, LP, LP]`` with LP = chunk rounded up to 16, and the
chunks' decays ``[b, H, S/chunk]``.
Inputs are fp32, read through their strides with the last dim contiguous.
Limits on a card (raised as ``ValueError``): chunk <= 128, N <= 128 and P a
multiple of 16 (the kernels' shared-memory tiles).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.clg_stats import _launch, _route
from repro_torch.nn.ssm import ssd_chunked

Tensor = torch.Tensor

LAUNCHES = {"ssd_scan": 0}

MAX_CHUNK = 128                  # kMaxL in ssd_scan.cu
MAX_N = 128                      # kMaxN
P_MULTIPLE = 16                  # P in m16 row bands of the states' product
ROWS, COLS = 64, 64              # kRows, kCols: a block's product tile
KERNELS = ("states", "cb", "out")   # the three kernels with shared memory


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(kernel: str, chunk: int, N: int) -> int:
    """Shared memory of one block of ``kernel`` (``StatesLayout``,
    ``CbLayout``, ``OutLayout`` in the source), checked against the library
    when it loads."""
    LP, NP = _round_up(chunk, 16), _round_up(N, 8)
    ld_row, ldk = COLS + 8, NP + 4
    if kernel == "states":            # dt, cum, decay; x and B
        words = 3 * LP + 2 * LP * ld_row
    elif kernel == "cb":              # C rows, B rows
        words = (ROWS + _round_up(LP, COLS)) * ldk
    else:                             # C B^T, C; two teams' dt, cum,
        words = ROWS * (LP + 4) + ROWS * ldk + 2 * (   # column factors,
            2 * LP + ROWS // 16 * LP + LP * ld_row + COLS * ldk)  # x, h_prev
    return 4 * words


def scratch_shapes(b: int, S: int, H: int, P: int, G: int, N: int,
                   chunk: int):
    """Shapes of the states, C B^T and decay buffers of one call."""
    nc, LP = S // chunk, _round_up(chunk, 16)
    return (b, nc, H, P, N), (b, nc, G, LP, LP), (b, H, nc)


def _lib():
    from repro_torch.kernels import build

    lib = build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_scan_launch.argtypes = [p] * 10 + [i] * 7 + [ll] * 12 + [p]
        lib.ssd_scan_launch.restype = i
        for fn in (lib.ssd_scan_max_chunk, lib.ssd_scan_max_state):
            fn.argtypes = []
            fn.restype = i
        lib.ssd_scan_smem_bytes.argtypes = [i, i, i]
        lib.ssd_scan_smem_bytes.restype = ll
        lib.ssd_scan_blocks_per_sm.argtypes = [i, i, i]
        lib.ssd_scan_blocks_per_sm.restype = i
        if (lib.ssd_scan_max_chunk(), lib.ssd_scan_max_state()) \
                != (MAX_CHUNK, MAX_N):
            raise RuntimeError("ssd_scan.cu and ssd_scan.py disagree on the "
                               "largest chunk or state")
        for chunk, N in ((128, 64), (30, 24), (90, 128)):
            for k, kernel in enumerate(KERNELS):
                if lib.ssd_scan_smem_bytes(k, chunk, N) \
                        != smem_bytes(kernel, chunk, N):
                    raise RuntimeError("ssd_scan.cu and ssd_scan.py disagree "
                                       f"on the {kernel} kernel's shared "
                                       "memory")
        lib._typed = True
    return lib


def blocks_per_sm(chunk: int, N: int) -> dict:
    """Blocks of each tile kernel that one SM of the current card holds
    at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = _lib()
    return {kernel: lib.ssd_scan_blocks_per_sm(k, chunk, N)
            for k, kernel in enumerate(KERNELS)}


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
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B, C)):
        raise NotImplementedError(
            f"{name}: the CUDA kernels have no backward yet (ROADMAP Queue 1 "
            f"item 26: the ssd_scan backward kernel); training the ssm and "
            f"hybrid families runs on the CPU until then")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if chunk > MAX_CHUNK or N > MAX_N or P % P_MULTIPLE:
        raise ValueError(f"{name}: the kernel takes chunk <= {MAX_CHUNK}, "
                         f"N <= {MAX_N} and P a multiple of {P_MULTIPLE}; "
                         f"got chunk={chunk}, N={N}, P={P}")
    for what, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {what} must be contiguous in its last "
                             f"dim")
    A = A.contiguous()
    opts = dict(dtype=torch.float32, device=dev)
    y = torch.empty((b, S, H, P), **opts)
    hfin = torch.empty((b, H, P, N), **opts)
    if y.numel() == 0:
        return y, hfin.zero_()
    states, cb, dec = (torch.empty(s, **opts)
                       for s in scratch_shapes(b, S, H, P, G, N, chunk))
    _launch(LAUNCHES, name, dev, _lib().ssd_scan_launch, x.data_ptr(),
            dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), hfin.data_ptr(), states.data_ptr(), cb.data_ptr(),
            dec.data_ptr(), b, S, H, P, G, N, chunk, *x.stride()[:3],
            *dt.stride(), *B.stride()[:3], *C.stride()[:3])
    return y, hfin
