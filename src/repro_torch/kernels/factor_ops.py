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

Limit (raised as ``ValueError``): ``cg_weak_marg`` keeps the mean and
covariance of a row in registers, for n <= 8 continuous dimensions.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.clg_stats import _check, _launch, _route

Tensor = torch.Tensor

LAUNCHES = {"log_product": 0, "log_marginalize": 0, "evidence_select": 0,
            "cg_weak_marg": 0}

MAX_N = 8                     # kMaxN in factor_ops.cu


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from repro_torch.kernels import build

    lib = build.load("factor_ops")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.log_product_launch.argtypes = [p, p, p, ll, ll, i, p]
        lib.log_marginalize_launch.argtypes = [p, p, ll, i, i, p]
        lib.evidence_select_launch.argtypes = [p, p, i, ll, p, ll, ll, ll,
                                               p]
        lib.cg_weak_marg_launch.argtypes = [p, p, p, p, p, p, ll, i, i, p]
        for fn in (lib.log_product_launch, lib.log_marginalize_launch,
                   lib.evidence_select_launch, lib.cg_weak_marg_launch):
            fn.restype = i
        lib.factor_ops_max_n.argtypes = []
        lib.factor_ops_max_n.restype = i
        if lib.factor_ops_max_n() != MAX_N:
            raise RuntimeError("factor_ops.cu and factor_ops.py disagree on "
                               "the largest n of cg_weak_marg")
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


def lanes_for(N: int) -> int:
    """Lanes per row of ``log_marginalize``: the power of two >= N/4, at
    most 32 (each lane sums about four elements or more)."""
    G = 1
    while G < min(-(-N // 4), 32):
        G *= 2
    return G


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
    if out.numel():
        _launch(LAUNCHES, name, dev, _lib().log_marginalize_launch,
                x.data_ptr(), out.data_ptr(), B * M, N, lanes_for(N))
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
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{name}: n = {n} continuous dimensions; the kernel "
                         f"holds 1 <= n <= {MAX_N} in registers")
    opts = dict(dtype=torch.float32, device=dev)
    p = torch.empty((B, M), **opts)
    mh = torch.empty((B, M, n), **opts)
    sh = torch.empty((B, M, n, n), **opts)
    if p.numel():
        _launch(LAUNCHES, name, dev, _lib().cg_weak_marg_launch,
                logw.data_ptr(), mu.data_ptr(), sigma.data_ptr(),
                p.data_ptr(), mh.data_ptr(), sh.data_ptr(), B * M, N, n)
    return p, mh, sh
