"""Wrappers of the CUDA factor-algebra kernels (``csrc/factor_ops.cu``).

The four public functions compute what the Pallas kernels of
``repro.kernels.factor_ops`` compute, with the same signatures:

    log_product(a [B,M,N], b [B,N])            -> [B,M,N]
    log_marginalize(x [B,M,N])                 -> [B,M]   (-inf-safe)
    evidence_select(x [B,M,N], idx [B] int)    -> [B,M]
    cg_weak_marg(logw [B,M,N], mu [B,M,N,n], sigma [B,M,N,n,n])
                                               -> ([B,M], [B,M,n], [B,M,n,n])

A tensor on the CPU goes to the plain PyTorch version (``kernels.ref``); a
CUDA tensor launches the kernel or raises -- there is no fallback.  Each
wrapper counts its launches in :data:`LAUNCHES`.  Inputs must be float32
(``idx`` any integer type) and contiguous on a card; ``evidence_select``
reads an int32 or int64 ``idx`` in place through its stride (another
integer type is cast to int32 first).

``cg_weak_marg`` takes any number n of continuous dimensions: a group of
lanes owns a row and walks its covariance in blocks of entries
(:func:`weak_plan`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.clg_stats import (_check, _launch, _pow2_at_least,
                                          _route, sm_count)

Tensor = torch.Tensor

LAUNCHES = {"log_product": 0, "log_marginalize": 0, "evidence_select": 0,
            "cg_weak_marg": 0}

THREADS = 256                 # kThreads in factor_ops.cu: 8 warps a block
SHORT_N = 128                 # kShortN: longest row a lane group takes
WARPS_PER_SM = 64             # kWarpsPerSm: resident warps that fill an SM
MAX_EPL = 8                   # kMaxEpl: cg_weak_marg's entries a lane a block


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from repro_torch.kernels import build

    lib = build.load("factor_ops")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.log_product_launch.argtypes = [p, p, p, ll, ll, i, p]
        lib.log_marginalize_launch.argtypes = [p, p, ll, i, p]
        lib.log_marginalize_plan.argtypes = [ll, i, i, i, ctypes.POINTER(i)]
        lib.evidence_select_launch.argtypes = [p, p, i, ll, p, ll, ll, ll,
                                               p]
        lib.cg_weak_marg_launch.argtypes = [p, p, p, p, p, p, ll, i, i, p]
        lib.cg_weak_marg_plan.argtypes = [ll, i, i, ctypes.POINTER(i)]
        for fn in (lib.log_product_launch, lib.log_marginalize_launch,
                   lib.log_marginalize_plan, lib.evidence_select_launch,
                   lib.cg_weak_marg_launch, lib.cg_weak_marg_plan):
            fn.restype = i
        lib.log_marginalize_blocks_per_sm.argtypes = [i, i, i]
        lib.log_marginalize_blocks_per_sm.restype = i
        out = (i * 3)()
        for n in (0, 1, 2, 3, 4, 5, 6, 9, 12, 16, 17, 40, 100):
            for rows in (1, 64, 1024, 16384, 1 << 20):
                for sms in (132, 114):
                    lib.cg_weak_marg_plan(rows, n, sms, out)
                    if tuple(out) != weak_plan(rows, n, sms):
                        raise RuntimeError(
                            f"factor_ops.cu and factor_ops.py disagree on "
                            f"the cg_weak_marg plan of {rows} rows, n = {n}, "
                            f"{sms} SMs")
        out = (i * 6)()
        for N in (1, 3, 4, 16, 17, 128, 129, 700, 4096, 16384):
            for rows in (1, 1000, 1 << 20):
                for aligned in (False, True):
                    for sms in (132, 114):
                        lib.log_marginalize_plan(rows, N, aligned, sms, out)
                        if tuple(out) != lse_plan(rows, N, aligned, sms):
                            raise RuntimeError(
                                f"factor_ops.cu and factor_ops.py disagree "
                                f"on the log_marginalize plan of {rows} rows "
                                f"of {N}, aligned {aligned}, {sms} SMs")
        lib._typed = True
    return lib


def log_product(a: Tensor, b: Tensor) -> Tensor:
    """Log-space factor product of ``a [B, M, N]`` with a sepset factor
    ``b [B, N]`` broadcast over M."""
    name = "log_product"
    dev = a.device
    _check(name, a, "a", torch.float32, 3, dev)
    _check(name, b, "b", torch.float32, 2, dev)
    B, M, N = a.shape
    if tuple(b.shape) != (B, N):
        raise ValueError(f"{name}: shapes a{tuple(a.shape)} b{tuple(b.shape)}"
                         f" disagree")
    if not _route(name, dev):
        return ref.log_product_ref(a, b)
    out = torch.empty_like(a)
    if out.numel():
        _launch(LAUNCHES, name, dev, _lib().log_product_launch,
                a.data_ptr(), b.data_ptr(), out.data_ptr(), B, M, N)
    return out


class LsePlan(NamedTuple):
    """How ``log_marginalize`` reads rows of N floats (``factor_ops.cu``
    mirrors it).  A chunk is V floats; a row team is W warps of G lanes
    (W > 1 only with G = 32); lane ``sub`` of team warp ``w`` takes, in
    round q < rounds, chunks ``((q * C + j) * W + w) * G + sub`` (j < C)
    of each of RPG rows."""
    V: int
    G: int
    W: int
    C: int
    RPG: int
    rounds: int


def lse_plan(rows: int, N: int, aligned: bool, sms: int) -> LsePlan:
    """The plan of ``log_marginalize`` for ``rows`` rows of N >= 1 floats
    on a card of ``sms`` SMs; ``aligned``: the base is 16-byte aligned.
    16-byte loads (V = 4) where N % 4 == 0 and the base is aligned.  Short
    rows (N <= SHORT_N): G lanes cover a row in one round, C <= 4 chunks a
    lane, RPG = 4 rows a lane group (64 bytes a thread in flight) where
    the rows fill a block on every SM, else 1 (few rows finish sooner
    spread over more SMs).  Long
    rows: warps of 32 lanes, 64 bytes a lane a round, and up to 8 warps a
    row while the rows alone do not fill the card's WARPS_PER_SM warps an
    SM and a team's round is shorter than the row.  The launch computes the
    same plan in C (checked when the library loads)."""
    V = 4 if aligned and N % 4 == 0 else 1
    if N <= SHORT_N:
        G = _pow2_at_least(-(-N // 4))            # <= 32
        C = 1 if V == 4 else _pow2_at_least(-(-N // G))
        RPG = 4 if rows >= THREADS // G * 4 * sms else 1
        return LsePlan(V=V, G=G, W=1, C=C, RPG=RPG, rounds=1)
    C = (min(4, _pow2_at_least(-(-N // 128))) if V == 4
         else min(16, _pow2_at_least(-(-N // 32))))
    W = 1
    while W < 8 and rows * W < sms * WARPS_PER_SM and W * 32 * C * V < N:
        W *= 2
    return LsePlan(V=V, G=32, W=W, C=C, RPG=1,
                   rounds=-(-N // (32 * W * C * V)))


def lse_plan_of(x: Tensor) -> LsePlan:
    """The plan ``log_marginalize`` takes for ``x [B, M, N]`` on its card."""
    B, M, N = x.shape
    return lse_plan(B * M, N, x.data_ptr() % 16 == 0, sm_count(x.device))


def lse_rows_per_block(p: LsePlan) -> int:
    """Rows a block of THREADS threads reduces."""
    return (THREADS // 32 // p.W) * p.RPG * (32 // p.G)


def log_marginalize_blocks_per_sm(p: LsePlan) -> int:
    """Resident blocks an SM of the plan's kernel, from the card's occupancy
    query (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return _lib().log_marginalize_blocks_per_sm(p.V, p.C, p.RPG)


def log_marginalize(x: Tensor) -> Tensor:
    """logsumexp over the last axis of ``x [B, M, N]`` -> ``[B, M]``; an
    all ``-inf`` row gives ``-inf``."""
    name = "log_marginalize"
    dev = x.device
    _check(name, x, "x", torch.float32, 3, dev)
    if not _route(name, dev):
        return ref.log_marginalize_ref(x)
    B, M, N = x.shape
    if N == 0:
        raise ValueError(f"{name}: needs N >= 1, got shape {tuple(x.shape)}")
    out = torch.empty((B, M), dtype=torch.float32, device=dev)
    if out.numel():                  # the plan (lse_plan) is taken in C
        _launch(LAUNCHES, name, dev, _lib().log_marginalize_launch,
                x.data_ptr(), out.data_ptr(), B * M, N)
    return out


def evidence_select(x: Tensor, idx: Tensor) -> Tensor:
    """``out[b, m] = x[b, m, idx[b]]``; an index outside [0, N) gives
    ``-inf``."""
    name = "evidence_select"
    dev = x.device
    _check(name, x, "x", torch.float32, 3, dev)
    if not isinstance(idx, torch.Tensor) or idx.is_floating_point() \
            or idx.is_complex():
        raise TypeError(f"{name}: idx must be an integer tensor")
    B, M, N = x.shape
    if tuple(idx.shape) != (B,) or idx.device != dev:
        raise ValueError(f"{name}: idx must have shape ({B},) on {dev}, got "
                         f"{tuple(idx.shape)} on {idx.device}")
    if not _route(name, dev):
        return ref.evidence_select_ref(x, idx)
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.to(torch.int32)
    out = torch.empty((B, M), dtype=torch.float32, device=dev)
    if out.numel():
        if N == 0:
            raise ValueError(f"{name}: the kernel needs N >= 1, got shape "
                             f"{tuple(x.shape)}")
        _launch(LAUNCHES, name, dev, _lib().evidence_select_launch,
                x.data_ptr(), idx.data_ptr(), idx.element_size(),
                idx.stride(0), out.data_ptr(), B, M, N)
    return out


class WeakPlan(NamedTuple):
    """How ``cg_weak_marg`` reads rows of a mixture in n dimensions
    (``factor_ops.cu`` mirrors it): a group of G lanes a row (32 / G rows a
    warp); lane ``sub`` owns, in each block of G * EPL covariance entries
    from e0, the entries e0 + sub + G t (t < EPL), and the lanes of row 0's
    entries write the mean; blocks of ``threads`` threads."""
    G: int
    EPL: int
    threads: int


def weak_plan(rows: int, n: int, sms: int) -> WeakPlan:
    """The plan of ``cg_weak_marg`` for ``rows`` rows of n >= 0 dimensions
    on a card of ``sms`` SMs.  G is the power of two >= min(n^2, 32), EPL
    the power of two >= n^2 / G, at most MAX_EPL (a larger n loops over
    blocks of entries); blocks of THREADS threads, halved down to a warp
    while the grid would not give every SM a block.  The launch computes
    the same plan in C (checked when the library loads)."""
    nn = n * n
    G = _pow2_at_least(min(nn, 32))
    EPL = min(MAX_EPL, _pow2_at_least(-(-nn // G)))
    threads = THREADS
    while threads > 32 and -(-rows * G // threads) < sms:
        threads //= 2
    return WeakPlan(G=G, EPL=EPL, threads=threads)


def cg_weak_marg(logw: Tensor, mu: Tensor, sigma: Tensor
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """Moment-matching weak marginal: collapse the mixture axis N.

    ``logw [B, M, N]``, ``mu [B, M, N, n]``, ``sigma [B, M, N, n, n]`` ->
    ``(logp [B, M], mu [B, M, n], sigma [B, M, n, n])``: each (b, m) row
    becomes the single Gaussian with the mixture's mass, mean and
    covariance.  ``-inf`` weights are inert; a dead row gives (-inf, 0, I).
    """
    name = "cg_weak_marg"
    dev = logw.device
    _check(name, logw, "logw", torch.float32, 3, dev)
    _check(name, mu, "mu", torch.float32, 4, dev)
    _check(name, sigma, "sigma", torch.float32, 5, dev)
    B, M, N = logw.shape
    n = mu.shape[-1]
    if (tuple(mu.shape) != (B, M, N, n)
            or tuple(sigma.shape) != (B, M, N, n, n)):
        raise ValueError(f"{name}: shapes logw{tuple(logw.shape)} "
                         f"mu{tuple(mu.shape)} sigma{tuple(sigma.shape)} "
                         f"disagree")
    if not _route(name, dev):
        return ref.cg_weak_marg_ref(logw, mu, sigma)
    opts = dict(dtype=torch.float32, device=dev)
    p = torch.empty((B, M), **opts)
    mh = torch.empty((B, M, n), **opts)
    sh = torch.empty((B, M, n, n), **opts)
    if p.numel():                    # the plan (weak_plan) is taken in C
        _launch(LAUNCHES, name, dev, _lib().cg_weak_marg_launch,
                logw.data_ptr(), mu.data_ptr(), sigma.data_ptr(),
                p.data_ptr(), mh.data_ptr(), sh.data_ptr(), B * M, N, n)
    return p, mh, sh
