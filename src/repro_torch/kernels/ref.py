"""Plain PyTorch versions of the hand-written kernels, one for one with
``repro.kernels.ref`` (the allclose targets of ``kernels.clg_stats``,
``kernels.factor_ops``, ``kernels.family_counts``, ``kernels.flash_attn``
and ``kernels.ssd_scan``)."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.nn.attention import attention_reference
from repro_torch.nn.ssm import ssd_chunked

Tensor = torch.Tensor


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """Oracle for kernels.flash_attn.flash_attention."""
    return attention_reference(q, k, v, causal=causal, window=window,
                               scale=scale)


def ssd_scan_ref(x, dt, A, B, C, chunk):
    """Oracle for kernels.ssd_scan.ssd_scan."""
    return ssd_chunked(x, dt, A, B, C, chunk)


def clg_suffstats_ref(d: Tensor, y: Tensor, r: Tensor
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """d: [N, F, D], y: [N, F], r: [N, K] -> sxx [F,K,D,D], sxy [F,K,D],
    syy [F,K]."""
    sxx = torch.einsum("nfd,nfe,nk->fkde", d, d, r)
    sxy = torch.einsum("nfd,nf,nk->fkd", d, y, r)
    syy = torch.einsum("nf,nf,nk->fk", y, y, r)
    return sxx, sxy, syy


def clg_suffstats_latent_ref(obs: Tensor, h_mean: Tensor, y: Tensor,
                             r: Tensor, s_hh: Tensor
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """The moments over the component-major design d[n,f,k] = [obs, E[h|z=k]]
    with the E[hh^T|z=k] = S_k + E[h]E[h]^T covariance correction."""
    F = obs.shape[1]
    sxx_oo = torch.einsum("nfa,nfb,nk->fkab", obs, obs, r)
    sxx_oh = torch.einsum("nfa,nkl,nk->fkal", obs, h_mean, r)
    sxx_hh = (torch.einsum("nkl,nkm,nk->klm", h_mean, h_mean, r)
              + r.sum(0)[:, None, None] * s_hh)               # [K, L, L]
    sxx_hh = sxx_hh[None].expand((F,) + tuple(sxx_hh.shape))
    top = torch.cat([sxx_oo, sxx_oh], dim=-1)
    bot = torch.cat([sxx_oh.transpose(-1, -2), sxx_hh], dim=-1)
    sxx = torch.cat([top, bot], dim=-2)
    sxy = torch.cat(
        [torch.einsum("nfa,nf,nk->fka", obs, y, r),
         torch.einsum("nkl,nf,nk->fkl", h_mean, y, r)], dim=-1)
    syy = torch.einsum("nf,nf,nk->fk", y, y, r)
    return sxx, sxy, syy


def one_hot_cmp(xd: Tensor, C: int, dtype=torch.float32) -> Tensor:
    """[..., C] one-hot by comparison with ``arange(C)``: a category outside
    [0, C) (the -1 that padded instances carry) gives a zero row, as
    ``jax.nn.one_hot`` does (``F.one_hot`` would raise)."""
    cols = torch.arange(C, device=xd.device, dtype=xd.dtype)
    return (xd[..., None] == cols).to(dtype)


def clg_disc_counts_ref(xd: Tensor, r: Tensor, C: int) -> Tensor:
    """xd: [N, Fd] int, r: [N, K] -> disc [Fd, K, C]."""
    return torch.einsum("nfc,nk->fkc", one_hot_cmp(xd, C, r.dtype), r)


# -- family counts of structure learning (``kernels.family_counts``) ---------


FAMILY_CHUNK = 1 << 24        # (instance, family) pairs per chunk


def family_counts_ref(xd: Tensor, strides: Tensor, w: Tensor, C: int
                      ) -> Tensor:
    """counts[m, c] = sum_n w[n] [code(n, m) == c] with the mixed-radix code
    ``code = xd @ strides.T``; a code outside [0, C) counts nothing.

    The codes come from a float64 product (exact for these integers; CUDA
    has no integer matmul) and the histogram from ``index_add_``, a chunk
    of instances and families at a time: the [N, M, C] one-hot of the JAX
    package's oracle would not fit memory at real widths.  Out-of-range
    codes go to one extra bin that is dropped.  The bins accumulate in
    float64 and are rounded to float32 once: a float32 bin fed one weight
    at a time drifts by ~1e-5 relative over 2^18 weights, more than the
    kernel it is the yardstick of; 0/1 weights give exact integers
    either way."""
    N = xd.shape[0]
    M = strides.shape[0]
    flat = torch.zeros(M * C + 1, dtype=torch.float64, device=w.device)
    if N == 0 or M == 0:
        return flat[:-1].view(M, C).to(w.dtype)
    s64 = strides.to(torch.float64).T                         # [Fd, M]
    nc = min(N, FAMILY_CHUNK)
    mc = max(1, FAMILY_CHUNK // nc)
    for n0 in range(0, N, nc):
        x64 = xd[n0:n0 + nc].to(torch.float64)
        wc = w[n0:n0 + nc].to(torch.float64)
        for m0 in range(0, M, mc):
            m1 = min(M, m0 + mc)
            code = (x64 @ s64[:, m0:m1]).to(torch.int64)     # [nc, mb]
            ok = (code >= 0) & (code < C)
            base = torch.arange(m0, m1, device=xd.device) * C
            idx = torch.where(ok, code + base, M * C)
            flat.index_add_(0, idx.reshape(-1),
                            wc[:, None].expand(idx.shape).reshape(-1))
    return flat[:-1].view(M, C).to(w.dtype)


# -- factor algebra of the junction tree (``kernels.factor_ops``) ------------


NEG_INF = float("-inf")


def log_product_ref(a: Tensor, b: Tensor) -> Tensor:
    """a [B, M, N] + b [B, N] broadcast over M (log-space product)."""
    return a + b[:, None, :]


def log_marginalize_ref(x: Tensor) -> Tensor:
    """logsumexp over the last axis of x [B, M, N] -> [B, M], centred on
    the row max only where it is finite: an all ``-inf`` row gives
    ``-inf``, not NaN."""
    m = x.amax(-1)
    ms = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.exp(x - ms[..., None]).sum(-1)
    return torch.where(s > 0, ms + torch.log(s.clamp_min(1e-37)),
                       torch.full_like(s, NEG_INF))


def evidence_select_ref(x: Tensor, idx: Tensor) -> Tensor:
    """out[b, m] = x[b, m, idx[b]]; an index outside [0, N) gives ``-inf``
    (the Pallas kernel's mask)."""
    B, M, N = x.shape
    idx = idx.to(torch.int64)
    ok = (idx >= 0) & (idx < N)
    safe = torch.where(ok, idx, torch.zeros_like(idx))
    out = torch.gather(x, 2, safe[:, None, None].expand(B, M, 1))[..., 0]
    return torch.where(ok[:, None], out, torch.full_like(out, NEG_INF))


def cg_weak_marg_ref(logw: Tensor, mu: Tensor, sigma: Tensor
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Moment-matched weak marginal: collapse the mixture axis N of
    logw [B, M, N], mu [B, M, N, n], sigma [B, M, N, n, n] to one Gaussian
    per (b, m) with the mixture's mass, mean and covariance.  ``-inf``
    weights are inert; a row with no live weight gives (-inf, 0, I)."""
    n = mu.shape[-1]
    lse = log_marginalize_ref(logw)                           # [B, M]
    safe = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    w = torch.exp(logw - safe[..., None])                     # -inf -> 0
    mu_hat = (w[..., None] * mu).sum(-2)
    second = (w[..., None, None]
              * (sigma + mu[..., :, None] * mu[..., None, :])).sum(-3)
    sigma_hat = second - mu_hat[..., :, None] * mu_hat[..., None, :]
    dead = torch.isneginf(lse)
    eye = torch.eye(n, dtype=sigma.dtype, device=sigma.device)
    mu_hat = torch.where(dead[..., None], torch.zeros_like(mu_hat), mu_hat)
    sigma_hat = torch.where(dead[..., None, None], eye, sigma_hat)
    return lse, mu_hat, sigma_hat
