"""Wrapper of the CUDA SSD scan (``csrc/ssd_scan.cu``) and its backward
(``csrc/ssd_scan_bwd.cu``).

    ssd_scan(x [b, S, H, P], dt [b, S, H], A [H], B/C [b, S, G, N], chunk)
        -> (y [b, S, H, P], h_final [b, H, P, N])

The Mamba2 SSD scan of the Pallas kernel ``repro.kernels.ssd_scan.ssd_scan``
(head h reads B/C group ``h // (H / G)``; ``S % chunk == 0``).

A tensor on the CPU goes to the plain version,
``repro_torch.nn.ssm.ssd_chunked`` (differentiable by autograd); a CUDA
tensor launches the kernels or raises -- there is no fallback.  One call
issues the four launches of the chunk-parallel split (chunk states, C B^T
once per group, the state pass, the outputs; see the source's header) and
counts one in :data:`LAUNCHES`.
The wrapper allocates their scratch: the states ``[b, S/chunk, H, P, N]``
(134 MB at zamba2-1.2b's prefill of 2 x 8192 tokens), C B^T
``[b, S/chunk, G, LP, LP]`` with LP = chunk rounded up to 16, and the
chunks' decays ``[b, H, S/chunk]``.
Inputs are fp32, read through their strides with the last dim contiguous.
Limits on a card (raised as ``ValueError``): chunk <= 128, N <= 128 and P a
multiple of 16 (the kernels' shared-memory tiles).

Training: on CUDA tensors with grad enabled and an input that requires it,
``ssd_scan`` goes through :class:`SsdScanFn`, whose forward launches the
four kernels and saves only the inputs, and whose backward is
:func:`ssd_scan_backward`: the forward's kernels 1-3 once more (the
states before each chunk, C B^T, the chunks' decays; counted under
``ssd_scan_backward``, not ``ssd_scan``), then the six backward kernels,
one count in :data:`LAUNCHES` a call; P must be a multiple of 16 up to 64
there.  The backward's scratch beside the recomputation's: g like the
states, cum ``[b, H, S]`` (written by the dstates kernel, read by dx and
dB/dC), q and s ``[b, H, S]``, W's row and column sums off the diagonal
``[ranks, b, H, S]`` (a share from each block of a dB/dC cluster), and
the dB/dC kernel's partials ``[slices, b, S, G, N]`` twice (4.2 MB each
at zamba2-1.2b's training call, 2 slices), summed in slice order by the
last kernel.  The dB/dC kernel is a cluster of :func:`dbc_ranks` 512-thread
blocks a (slice of a group's heads, group, chunk, batch) -- one at N <=
64, two above, each rank forming its half of L ⊙ D once a head and owning
half of the N columns --; :func:`bwd_slices` picks the slices from the
card's SM count (``clg_stats.sm_count``).  The dx kernel is a 256-thread
block a (heads_per_block heads, 64 rows, chunk, batch), two an SM at N <=
64.  Both issue a head's next tile as soon as a phase has read the
current one (see the source's header).  The backward's plain version,
:func:`ssd_scan_backward_plain`, writes the gradients out as explicit
formulas; the tests and ``chip_smoke.py`` hold the kernels to it.  The
backward's shared memory and plan are mirrored here
(:func:`bwd_smem_bytes`, :func:`heads_per_block`, :func:`bwd_state_warps`,
:func:`bwd_slices`, :func:`bwd_grids`; :func:`dbc_ranks` through them)
and checked against the library when it loads.

Fake tensors (``torch._subclasses.fake_tensor``: shapes without storage,
what ``repro_torch.launch.dryrun`` runs a step on) have no data for any
route to compute on: the forward and the backward then return outputs of
the real route's shapes with its scratch, launch nothing, count nothing in
:data:`LAUNCHES` or :data:`ROUTES`, and add the kernels' flops
(:func:`ssd_flops`, :func:`ssd_bwd_flops`) to :data:`FAKE_FLOPS`, the
backward's slices planned for :data:`FAKE_SMS` SMs.  Real CPU and CUDA
tensors never take that branch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch import obs
from repro_torch.kernels.clg_stats import _launch, _route, sm_count
from repro_torch.nn.ssm import ssd_chunked

Tensor = torch.Tensor

LAUNCHES = {"ssd_scan": 0, "ssd_scan_backward": 0}
# a dy whose last dim is not contiguous, copied before the backward
ROUTES = {"bwd_dy_copy": 0}
# flops of the kernels' work on fake tensors (module docstring), by kernel
FAKE_FLOPS = {"ssd_scan": 0, "ssd_scan_backward": 0}
FAKE_SMS = 132                   # an H100's SMs: the fake backward's plan

MAX_CHUNK = 128                  # kMaxL in ssd_scan.cu
MAX_N = 128                      # kMaxN
P_MULTIPLE = 16                  # P in m16 row bands of the states' product
ROWS, COLS = 64, 64              # kRows, kCols: a block's product tile
KERNELS = ("states", "cb", "out")   # the three kernels with shared memory
BWD_KERNELS = ("dstates", "dx", "dbc")   # the backward's, likewise
BWD_MAX_P = 64                   # ssd_scan_bwd_max_p(): one 64-column tile
MAX_HEADS = 16                   # kMaxHeads: heads a dx block walks through
DBC_RP, DBC_CP = 17, 9           # kRp, kCp: row strides of W's partial sums


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES, FAKE_FLOPS):
        for k in counts:
            counts[k] = 0


def ssd_flops(b: int, S: int, H: int, P: int, G: int, N: int,
              chunk: int) -> int:
    """The forward's flops (PERF.md's bound of row 10): per (batch, head,
    chunk) (C B^T o decay) @ x dt over the T = l (l + 1) / 2 pairs j <= i,
    the chunk state and C @ h_prev^T; C B^T once per (batch, group,
    chunk)."""
    nc, tri = S // chunk, chunk * (chunk + 1) // 2
    return b * H * nc * (2 * tri * P + 4 * chunk * N * P) \
        + b * G * nc * 2 * tri * N


def ssd_bwd_flops(b: int, S: int, H: int, P: int, G: int, N: int,
                  chunk: int) -> int:
    """The backward's flops (PERF.md's bound of row 10b), its multiply-adds
    2 each: per (batch, head, chunk) 5 l P N (the chunk states, the pull on
    h_prev, dxd's, dB's and dC's carried-state parts) + 2 T P (dxd's intra
    part) + 2 T N (L o D times B and C), T = l (l + 1) / 2; C B^T once per
    (batch, group, chunk), T N."""
    l = chunk
    nc, T = S // l, l * (l + 1) // 2
    return 2 * (b * H * nc * (5 * l * P * N + 2 * T * P + 2 * T * N)
                + b * G * nc * T * N)


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
        lib.ssd_scan_states_launch.argtypes = [p] * 9 + [i] * 7 + [ll] * 12 \
            + [p]
        lib.ssd_scan_states_launch.restype = i
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


def bwd_smem_bytes(kernel: str, chunk: int, N: int) -> int:
    """Shared memory of one block of the backward's ``kernel``
    (``DstatesLayout``, ``DxLayout``, ``DbcLayout`` in
    ``csrc/ssd_scan_bwd.cu``), checked against the library when it
    loads."""
    LP, NP = _round_up(chunk, 16), _round_up(N, 8)
    ld_row = COLS + 8
    if kernel == "dstates":           # dt, cum, exp(cum); dy and C
        words = 3 * LP + 2 * LP * ld_row
    elif kernel == "dx":              # C B^T's columns, B's and C's rows,
        ldk = NP + 4                  # two heads' dt and cum, column
        words = LP * ld_row + 2 * ROWS * ldk + 4 * LP + ROWS // 16 * LP \
            + ROWS * ld_row + BWD_MAX_P * ldk + ROWS * 6  # factors, half
        # of dy's rows, g or h_prev, the row dots of two halves
    else:                             # S, x and dy, g and h_prev of a
        ldh = _round_up(dbc_rank_cols(N), 32) + 4   # rank's columns, K at
        units = LP // 16 * (LP // 16 + 1)   # a rank's units of D, two
        if dbc_ranks(N) == 2:
            units -= units // 2
        words = LP * (LP + 8) + 2 * LP * (BWD_MAX_P + 8) \
            + 2 * BWD_MAX_P * ldh + units * 128 + 4 * LP \
            + (DBC_RP + DBC_CP) * LP   # heads' dt and cum, W's row sums by
        # column tile and column sums by row band
    return 4 * words


def dbc_ranks(N: int) -> int:
    """Blocks of a dB/dC cluster (``dbc_ranks`` in the source): one at
    N <= 64, where a block holds the sums of every column, else two, each
    with half of the columns and half of D's tiles."""
    return 1 if N <= 64 else 2


def dbc_rank_cols(N: int) -> int:
    """Columns of dB and dC a block of a dB/dC cluster owns: N over the
    ranks rounded up to 8 (rank 1 from there to N)."""
    r = dbc_ranks(N)
    return _round_up(-(-N // r), 8)


def heads_per_block(H: int, G: int) -> int:
    """Heads a forward output block or a backward dx block walks through:
    the largest power of two <= MAX_HEADS dividing H / G."""
    rep = H // G
    return min(rep & -rep, MAX_HEADS)


def bwd_state_warps(P: int, N: int) -> int:
    """Warp sums of g_c ⊙ (state after chunk c) a (batch, head, chunk):
    one a warp of the backward state pass, 128 entries."""
    return -(-(P * N // 4) // 32)


def bwd_slices(b: int, S: int, H: int, G: int, N: int, chunk: int,
               sms: int) -> int:
    """Slices of a group's heads in the dB/dC kernel (``bwd_slices`` in the
    source, checked against the library when it loads): the count s from 2
    (1 when a group has one head) to H / G whose blocks -- dbc_ranks(N) s G
    S / chunk b, one an SM -- take the fewest waves over ``sms`` SMs times
    the heads of the longest slice plus one (its last products); the
    smallest such s.  Slice k holds heads k rep / s .. (k + 1) rep / s of
    each group (rep = H / G)."""
    rep = H // G
    units = dbc_ranks(N) * G * (S // chunk) * b
    best, cost = 1, None
    for s in range(min(2, rep), rep + 1):
        c = -(-(units * s) // sms) * (-(-rep // s) + 1)
        if cost is None or c < cost:
            best, cost = s, c
    return best


def bwd_grids(b: int, S: int, H: int, P: int, G: int, N: int, chunk: int,
              slices: int) -> dict:
    """Grid (x, y, z) of each backward kernel as ``ssd_scan_bwd_launch``
    sets it (``bwd_grid`` in the source, checked against the library when
    it loads): dstates a (head, chunk, batch); the state pass 256
    four-entry chains of a (batch, head); dx (heads_per_block heads, 64
    rows j of a chunk, batch); dB / dC (rank, slice, group; chunk; batch),
    clusters of dbc_ranks(N) ranks; the finish a warp per (batch, head,
    chunk); the sums a thread per element of dB (and per head of dA)."""
    nc, nrb = S // chunk, -(-_round_up(chunk, 16) // ROWS)
    return {"dstates": (H, nc, b),
            "state_pass": (-(-(P * N // 4) // 256), b * H, 1),
            "dx": (H // heads_per_block(H, G), nc * nrb, b),
            "dbc": (dbc_ranks(N) * slices * G, nc, b),
            "finish": (-(-(b * H * nc * 32) // 256), 1, 1),
            "sums": (-(-max(b * S * G * N, H) // 256), 1, 1)}


def _bwd_lib():
    from repro_torch.kernels import build

    lib = build.load("ssd_scan_bwd")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_scan_bwd_launch.argtypes = [p] * 26 + [i] * 8 + [ll] * 15 \
            + [p]
        lib.ssd_scan_bwd_launch.restype = i
        lib.ssd_scan_bwd_max_p.argtypes = []
        lib.ssd_scan_bwd_max_p.restype = i
        for fn in (lib.ssd_scan_bwd_state_warps,
                   lib.ssd_scan_bwd_heads_per_block):
            fn.argtypes = [i, i]
            fn.restype = i
        lib.ssd_scan_bwd_slices.argtypes = [i] * 7
        lib.ssd_scan_bwd_slices.restype = i
        lib.ssd_scan_bwd_smem_bytes.argtypes = [i, i, i]
        lib.ssd_scan_bwd_smem_bytes.restype = ll
        lib.ssd_scan_bwd_blocks_per_sm.argtypes = [i, i, i]
        lib.ssd_scan_bwd_blocks_per_sm.restype = i
        if lib.ssd_scan_bwd_max_p() != BWD_MAX_P:
            raise RuntimeError("ssd_scan_bwd.cu and ssd_scan.py disagree on "
                               "the largest head dimension")
        for chunk, N in ((128, 64), (128, 128), (30, 24), (90, 7)):
            for k, kernel in enumerate(BWD_KERNELS):
                if lib.ssd_scan_bwd_smem_bytes(k, chunk, N) \
                        != bwd_smem_bytes(kernel, chunk, N):
                    raise RuntimeError("ssd_scan_bwd.cu and ssd_scan.py "
                                       f"disagree on the {kernel} kernel's "
                                       "shared memory")
        for H, G in ((64, 1), (4, 2), (96, 3), (6, 6)):
            if lib.ssd_scan_bwd_heads_per_block(H, G) \
                    != heads_per_block(H, G):
                raise RuntimeError("ssd_scan_bwd.cu and ssd_scan.py disagree "
                                   "on the heads a dx block walks")
        for P, N in ((64, 64), (64, 128), (16, 7), (32, 24)):
            if lib.ssd_scan_bwd_state_warps(P, N) != bwd_state_warps(P, N):
                raise RuntimeError("ssd_scan_bwd.cu and ssd_scan.py disagree "
                                   "on the state pass's warp sums")
        lib.ssd_scan_bwd_grid.argtypes = [i] * 9 + [ctypes.POINTER(i)]
        lib.ssd_scan_bwd_grid.restype = None
        for shape in ((2, 4096, 64, 64, 1, 64, 128),
                      (2, 4096, 64, 64, 1, 128, 128), (1, 90, 6, 16, 3, 7, 30),
                      (2, 192, 24, 48, 2, 24, 64), (1, 256, 8, 16, 8, 96, 64)):
            b, S, H, _, G, N, chunk = shape
            for sms in (132, 114):
                slices = bwd_slices(b, S, H, G, N, chunk, sms)
                if lib.ssd_scan_bwd_slices(b, S, H, G, N, chunk, sms) \
                        != slices:
                    raise RuntimeError("ssd_scan_bwd.cu and ssd_scan.py "
                                       "disagree on the dB/dC slices")
                for k, got in enumerate(bwd_grids(*shape, slices).values()):
                    xyz = (i * 3)()
                    lib.ssd_scan_bwd_grid(k, *shape, slices, xyz)
                    if tuple(xyz) != got:
                        raise RuntimeError("ssd_scan_bwd.cu and ssd_scan.py "
                                           "disagree on a backward grid")
        lib._typed = True
    return lib


def bwd_blocks_per_sm(chunk: int, N: int) -> dict:
    """Blocks of each backward tile kernel that one SM of the current card
    holds at once."""
    lib = _bwd_lib()
    return {kernel: lib.ssd_scan_bwd_blocks_per_sm(k, chunk, N)
            for k, kernel in enumerate(BWD_KERNELS)}


def _check(x, dt, A, B, C, chunk, name="ssd_scan") -> None:
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


def _card_limits(name, x, B, C, chunk, max_p=None) -> None:
    P, N = x.shape[3], B.shape[3]
    if chunk > MAX_CHUNK or N > MAX_N or P % P_MULTIPLE \
            or (max_p is not None and P > max_p):
        raise ValueError(f"{name}: the kernels take chunk <= {MAX_CHUNK}, "
                         f"N <= {MAX_N} and P a multiple of {P_MULTIPLE}"
                         + (f" up to {max_p}" if max_p else "")
                         + f"; got chunk={chunk}, N={N}, P={P}")
    for what, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {what} must be contiguous in its last "
                             f"dim")


def _forward(counts, x, dt, A, B, C, chunk, outputs=True):
    """The forward kernels on CUDA tensors: (y, hfin, states -- the state
    before each chunk after the state pass --, cb, dec); one launch counted
    in ``counts`` (None: counted by the caller).  ``outputs`` False runs
    kernels 1-3 alone and returns y None (the backward's recomputation).
    On fake tensors no launch (module docstring)."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    dev = x.device
    A = A.contiguous()
    opts = dict(dtype=torch.float32, device=dev)
    y = torch.empty((b, S, H, P), **opts) if outputs else None
    hfin = torch.empty((b, H, P, N), **opts)
    states, cb, dec = (torch.empty(s, **opts)
                       for s in scratch_shapes(b, S, H, P, G, N, chunk))
    if is_fake(x):              # shapes alone: nothing to compute on
        if counts is not None:
            FAKE_FLOPS["ssd_scan"] += ssd_flops(b, S, H, P, G, N, chunk)
        return y, hfin, states, cb, dec
    if x.numel() == 0:
        return y, hfin.zero_(), states, cb, dec
    lib = _lib()
    ptrs = [x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr()] + ([y.data_ptr()] if outputs else []) \
        + [hfin.data_ptr(), states.data_ptr(), cb.data_ptr(), dec.data_ptr()]
    _launch(counts, "ssd_scan", dev,
            lib.ssd_scan_launch if outputs else lib.ssd_scan_states_launch,
            *ptrs, b, S, H, P, G, N, chunk, *x.stride()[:3], *dt.stride(),
            *B.stride()[:3], *C.stride()[:3])
    return y, hfin, states, cb, dec


def ssd_scan(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
             chunk: int) -> Tuple[Tensor, Tensor]:
    """The SSD scan over chunks of ``chunk`` steps; returns ``y`` and the
    final state (fp32); differentiable (module docstring)."""
    with obs.span("kernel.ssd_scan"):
        name = "ssd_scan"
        _check(x, dt, A, B, C, chunk)
        if not _route(name, x.device):
            return ssd_chunked(x, dt, A, B, C, chunk)
        grad = torch.is_grad_enabled() and any(t.requires_grad
                                               for t in (x, dt, A, B, C))
        _card_limits(name, x, B, C, chunk, BWD_MAX_P if grad else None)
        if grad:
            return SsdScanFn.apply(x, dt, A, B, C, chunk)
        return _forward(LAUNCHES, x, dt, A, B, C, chunk)[:2]


class SsdScanFn(torch.autograd.Function):
    """``ssd_scan`` on CUDA tensors with a gradient: the four forward
    kernels, then :func:`ssd_scan_backward`.  Saves the inputs only; the
    final state's gradient is None when the loss does not reach it
    (``apply_mamba2`` drops the state), and the kernels take it as zero."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, hfin = _forward(LAUNCHES, x, dt, A, B, C, chunk)[:2]
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)    # an unused output's grad: None
        return y, hfin

    @staticmethod
    def backward(ctx, dy, dhfin):
        x, dt, A, B, C = ctx.saved_tensors
        if dy is None:                # hfin alone reached the loss
            dy = torch.zeros_like(x)
        # a module-level lookup, so that wrappers of the function see it
        grads = ssd_scan_backward(x, dt, A, B, C, dy, dhfin, ctx.chunk)
        return (*grads, None)


def ssd_scan_backward(x: Tensor, dt: Tensor, A: Tensor, B: Tensor,
                      C: Tensor, dy: Tensor, dhfin: Optional[Tensor],
                      chunk: int
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(dx, ddt, dA, dB, dC) of ``ssd_scan`` on CUDA tensors, from the
    output's gradient ``dy`` [b, S, H, P] and the final state's ``dhfin``
    [b, H, P, N] (None: zero).  One call runs the forward's kernels 1-3
    again and launches the six backward kernels; one count in
    :data:`LAUNCHES`.  A ``dy`` whose last dim is not contiguous is copied
    once (``ROUTES["bwd_dy_copy"]``).  The gradients are fp32 and
    contiguous.  On fake tensors no launch (module docstring)."""
    with obs.span("kernel.ssd_scan_backward"):
        return _backward(x, dt, A, B, C, dy, dhfin, chunk)


def _backward(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
              dy: Tensor, dhfin: Optional[Tensor], chunk: int
              ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    name = "ssd_scan_backward"
    _check(x, dt, A, B, C, chunk, name)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: takes CUDA tensors (on the CPU, autograd "
                         f"differentiates ssd_chunked)")
    _card_limits(name, x, B, C, chunk, BWD_MAX_P)
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if tuple(dy.shape) != (b, S, H, P) or dy.dtype != torch.float32 \
            or dy.device != dev:
        raise ValueError(f"{name}: dy{tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device} disagrees with x{tuple(x.shape)}")
    fake = is_fake(x)
    if dhfin is not None:
        if tuple(dhfin.shape) != (b, H, P, N) \
                or dhfin.dtype != torch.float32 or dhfin.device != dev:
            raise ValueError(f"{name}: dhfin{tuple(dhfin.shape)} "
                             f"{dhfin.dtype} on {dhfin.device}, expected "
                             f"[{b}, {H}, {P}, {N}] fp32")
        dhfin = dhfin.contiguous()
        if not fake and dhfin.data_ptr() % 16:   # read as float4
            dhfin = dhfin.clone()
    if dy.stride(3) != 1:             # autograd may hand over any view
        dy = dy.clone(memory_format=torch.contiguous_format)
        ROUTES["bwd_dy_copy"] += not fake
    opts = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, S, H, P), **opts)
    ddt = torch.empty((b, S, H), **opts)
    dA = torch.empty((H,), **opts)
    dB = torch.empty((b, S, G, N), **opts)
    dC = torch.empty((b, S, G, N), **opts)
    if dx.numel() == 0:
        return dx, ddt, dA.zero_(), dB.zero_(), dC.zero_()
    A = A.contiguous()
    _, hfin, hprev, cb, dec = _forward(None, x, dt, A, B, C, chunk, False)
    nc = S // chunk
    slices = bwd_slices(b, S, H, G, N, chunk,
                        FAKE_SMS if fake else sm_count(dev))
    gst = torch.empty_like(hprev)
    lastp = torch.empty((b, H, nc, bwd_state_warps(P, N)), **opts)
    cum = torch.empty((b, H, S), **opts)
    q, sdot = (torch.empty((b, H, S), **opts) for _ in range(2))
    wrow, wcol = (torch.empty((dbc_ranks(N), b, H, S), **opts)
                  for _ in range(2))
    pdB, pdC = (torch.empty((slices, b, S, G, N), **opts) for _ in range(2))
    dap = torch.empty((b, nc, H), **opts)
    if fake:                    # shapes alone: nothing to compute on
        FAKE_FLOPS[name] += ssd_bwd_flops(b, S, H, P, G, N, chunk)
        return dx, ddt, dA, dB, dC
    _launch(LAUNCHES, name, dev, _bwd_lib().ssd_scan_bwd_launch,
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(),
            None if dhfin is None else dhfin.data_ptr(), hfin.data_ptr(),
            hprev.data_ptr(), cb.data_ptr(), dec.data_ptr(), gst.data_ptr(),
            lastp.data_ptr(), cum.data_ptr(), q.data_ptr(), sdot.data_ptr(),
            wrow.data_ptr(), wcol.data_ptr(), pdB.data_ptr(), pdC.data_ptr(),
            dap.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), b, S, H, P, G, N, chunk, slices,
            *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
            *dy.stride()[:3])
    return dx, ddt, dA, dB, dC


def ssd_scan_backward_plain(x: Tensor, dt: Tensor, A: Tensor, B: Tensor,
                            C: Tensor, dy: Tensor, dhfin: Optional[Tensor],
                            chunk: int
                            ) -> Tuple[Tensor, Tensor, Tensor, Tensor,
                                       Tensor]:
    """The backward's function in plain PyTorch, in the inputs' dtype, as
    explicit formulas.  Per (batch, head h, chunk), positions i, j: a =
    -A_h dt, cum its cumulative sum, tot = cum_{l-1}, xd_j = x_j dt_j, K_ij
    = C_i . B_j (h's group), L_ij = exp(cum_i - cum_j)[j <= i], hp the state
    before the chunk; the reverse state pass g_{nc-1} = dhfin, g_{c-1} =
    exp(tot_c) g_c + sum_i exp(cum_i) dy_i C_i^T; with D_ij = dy_i . xd_j,
    W = K L D:
        dxd_j  = sum_i K_ij L_ij dy_i + exp(tot - cum_j) g B_j
        dC_i   = sum_j L_ij D_ij B_j + exp(cum_i) hp^T dy_i
        dB_j   = sum_i L_ij D_ij C_i + exp(tot - cum_j) g^T xd_j
        dcum_k = sum_j W_kj - sum_i W_ik + exp(cum_k) dy_k . (hp C_k)
                 - exp(tot - cum_k) xd_k . (g B_k)
                 (+ sum g ⊙ state after the chunk at k = l - 1)
    then da the suffix sums of dcum within the chunk, dx = dt dxd, ddt =
    x . dxd - A da, dA = -sum dt da, and dB, dC summed over each group's
    heads."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, rep, l = S // chunk, H // G, chunk
    f = lambda t: t.reshape(b, nc, l, *t.shape[2:])
    cum = torch.cumsum(f(dt * -A), 2)                     # [b, nc, l, H]
    tot = cum[:, :, -1]                                    # [b, nc, H]
    xd = f(x * dt[..., None])                              # [b,nc,l,H,P]
    dyc = f(dy)
    Bh = f(B).repeat_interleave(rep, 3)                    # [b,nc,l,H,N]
    Ch = f(C).repeat_interleave(rep, 3)
    keep = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    Lm = torch.where(keep[None, None, :, :, None],
                     torch.exp(cum[:, :, :, None] - cum[:, :, None]), 0.0)
    K = torch.einsum("bnihe,bnjhe->bnijh", Ch, Bh)         # [b,nc,i,j,H]
    ecum = torch.exp(cum)
    w = torch.exp(tot[:, :, None] - cum)                   # [b, nc, l, H]
    # the forward's states: hp before each chunk, the state after it
    states = torch.einsum("bnlh,bnlhe,bnlhp->bnhpe", w, Bh, xd)
    h = torch.zeros((b, H, P, N), dtype=x.dtype, device=x.device)
    hp = []
    for c in range(nc):
        hp.append(h)
        h = h * torch.exp(tot[:, c])[..., None, None] + states[:, c]
    hp = torch.stack(hp, 1)                                # [b,nc,H,P,N]
    after = torch.cat([hp[:, 1:], h[:, None]], 1)
    # the reverse state pass
    pull = torch.einsum("bnlh,bnlhp,bnlhe->bnhpe", ecum, dyc, Ch)
    run = torch.zeros_like(h) if dhfin is None else dhfin.to(x.dtype)
    g = [None] * nc
    for c in reversed(range(nc)):
        g[c] = run
        run = run * torch.exp(tot[:, c])[..., None, None] + pull[:, c]
    g = torch.stack(g, 1)                                  # [b,nc,H,P,N]
    D = torch.einsum("bnihp,bnjhp->bnijh", dyc, xd)
    LD = Lm * D
    W = K * LD
    gB = torch.einsum("bnhpe,bnjhe->bnjhp", g, Bh)         # g B_j
    hC = torch.einsum("bnhpe,bnihe->bnihp", hp, Ch)        # hp C_i
    dxd = torch.einsum("bnijh,bnihp->bnjhp", K * Lm, dyc) + w[..., None] * gB
    dCh = torch.einsum("bnijh,bnjhe->bnihe", LD, Bh) \
        + ecum[..., None] * torch.einsum("bnhpe,bnihp->bnihe", hp, dyc)
    dBh = torch.einsum("bnijh,bnihe->bnjhe", LD, Ch) \
        + w[..., None] * torch.einsum("bnhpe,bnjhp->bnjhe", g, xd)
    dcum = W.sum(3) - W.sum(2) + ecum * (dyc * hC).sum(-1) \
        - w * (xd * gB).sum(-1)
    last = (g * after).sum((-1, -2))                       # [b, nc, H]
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + last[:, :, None]],
                     2)
    da = dcum.flip(2).cumsum(2).flip(2).reshape(b, S, H)
    dxd = dxd.reshape(b, S, H, P)
    dx = dt[..., None] * dxd
    ddt = (x * dxd).sum(-1) - A * da
    dA = -(dt * da).sum((0, 1))
    group = lambda t: t.reshape(b, S, G, rep, N).sum(3)
    return dx, ddt, dA, group(dBh.reshape(b, S, H, N)), \
        group(dCh.reshape(b, S, H, N))
