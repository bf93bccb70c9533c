"""Plain PyTorch versions of the suff-stats kernels, one for one with
``repro.kernels.ref`` (the allclose targets of ``kernels.clg_stats``)."""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


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
