"""Streaming variational Bayes optimizer for neural networks (counterpart
of ``repro.bayes.vb_optimizer``).

A mean-field Gaussian posterior q(w) = N(m, diag(1/p)) over every weight,
updated with natural-gradient (Variational Online Newton) steps from
minibatch gradients; ``chain_prior`` turns the posterior into the next
prior (the paper's Eq. 3, tempered on drift); ``sample_params`` draws a
weight sample; ``posterior_kl`` is the stream ELBO's global penalty.

Trees are ordered dicts of fp32 tensors keyed by the LM's parameter names.
``vb_init`` takes the model's own parameter tensors as the mean (the
forward reads them), and ``vb_update`` writes the mean and the Fisher
proxy in place: at full width each tree is tens of GB.  ``posterior_kl``
computes each leaf's precision as it goes instead of a whole tree of them.
``sample_params`` draws from an explicit ``torch.Generator``; its draws
cannot match ``jax.random``'s.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.sharding import collectives as C
from repro_torch.train.optimizer import clip_scale

Tensor = torch.Tensor
Tensors = Dict[str, Tensor]


class VBState(NamedTuple):
    mean: Tensors        # m -- also the params used in the forward pass
    fisher: Tensors      # s -- EMA of squared gradients (no bias corr)
    prior_mean: Tensors  # chained prior (Eq. 3)
    prior_prec: Tensors
    step: int


def vb_init(params: Tensors, *, prior_prec: float = 1.0) -> VBState:
    """The mean is ``params`` itself (fp32 tensors, not copied)."""
    for k, p in params.items():
        if p.dtype != torch.float32:
            raise TypeError(f"vb_init: {k} is {p.dtype}, the posterior mean "
                            f"is held in fp32")
    return VBState(
        mean=dict(params),
        fisher={k: torch.zeros_like(p) for k, p in params.items()},
        prior_mean={k: p.detach().clone() for k, p in params.items()},
        prior_prec={k: torch.full_like(p, prior_prec)
                    for k, p in params.items()},
        step=0)


@torch.no_grad()
def vb_update(state: VBState, grads: Tensors, *, n_total: float,
              lr: float = 0.1, rho: float = 0.05, damping: float = 0.1,
              clip_norm: float = 1.0, mesh=None) -> VBState:
    """One VON natural-gradient step from minibatch MEAN gradients:

        s_t = (1 - rho) s + rho g^2,  s_hat = s_t / (1 - (1 - rho)^t)
        m_t = m - lr (g + (p0/N)(m - m0)) / (s_hat + p0/N + damping)

    with g clipped to a global norm of ``clip_norm`` (on a ``mesh``, of
    the whole tree the blocks belong to).  Writes the mean and the Fisher
    proxy in place."""
    step = state.step + 1
    scale = clip_scale(grads, clip_norm, state.mean, mesh)
    bias = 1.0 - (1.0 - rho) ** step
    for k, m in state.mean.items():
        g = grads[k].float() * scale
        s = state.fisher[k]
        s.mul_(1 - rho).add_(rho * g * g)
        lam0 = state.prior_prec[k] / n_total
        denom = s / bias + lam0 + damping
        m.copy_(m - lr * (g + lam0 * (m - state.prior_mean[k])) / denom)
    return state._replace(step=step)


def _prec(s: Tensor, p0: Tensor, step: int, n_total: float,
          damping: float) -> Tensor:
    bias = 1.0 - 0.95 ** max(step, 1)
    return n_total * (s / bias + damping) + p0


@torch.no_grad()
def posterior_prec(state: VBState, n_total: float,
                   damping: float = 0.1) -> Tensors:
    """p = N (s_hat + damping) + p0 -- the implied posterior precision (the
    bias correction with the reference's fixed 0.95)."""
    return {k: _prec(s, state.prior_prec[k], state.step, n_total, damping)
            for k, s in state.fisher.items()}


@torch.no_grad()
def chain_prior(state: VBState, n_total: float, *,
                temper: float = 1.0) -> VBState:
    """Eq. 3: posterior -> prior for the next data block; ``temper`` < 1 is
    the forgetting factor applied on drift (power prior)."""
    return state._replace(
        prior_mean={k: m.detach().clone() for k, m in state.mean.items()},
        prior_prec={k: temper * p for k, p in
                    posterior_prec(state, n_total).items()})


@torch.no_grad()
def sample_params(state: VBState, gen: torch.Generator,
                  n_total: float) -> Tensors:
    """w ~ q(w), drawn leaf by leaf from ``gen`` (on the mean's device)."""
    out = {}
    for k, m in state.mean.items():
        p = _prec(state.fisher[k], state.prior_prec[k], state.step, n_total,
                  0.1)
        eps = torch.randn(m.shape, generator=gen, device=m.device,
                          dtype=m.dtype)
        out[k] = m + eps / torch.sqrt(torch.clamp(p, min=1e-8))
    return out


@torch.no_grad()
def posterior_kl(state: VBState, n_total: float, mesh=None) -> Tensor:
    """KL(q || chained prior), a 0-dim tensor on the mean's device (on a
    ``mesh``, of the whole tree the blocks belong to)."""
    kls = {}
    for k, m in state.mean.items():
        p0, m0 = state.prior_prec[k], state.prior_mean[k]
        p = _prec(state.fisher[k], p0, state.step, n_total, 0.1)
        kls[k] = 0.5 * torch.sum(p0 / p - 1.0 + torch.log(p / p0)
                                 + p0 * (m - m0) ** 2)
    if mesh is not None:
        return C.sharded_sum(kls, state.mean, mesh)
    total = None
    for kl in kls.values():
        total = kl if total is None else total + kl
    return total
