"""Factored Frontier (Murphy & Weiss) -- approximate inference in dynamic BNs
(counterpart of ``repro.core.factored_frontier``).

Paper §2.2: "Versions of these methods for dynamic models are supported by
means of the Factored Frontier algorithm".

FF for discrete 2-timeslice BNs with C parallel hidden chains (factorial HMM
structure) and per-chain observations:

    belief b_t(x) ~= prod_c b_t^c(x_c)          (factored frontier assumption)
    predict:  b'^c = sum_{parents} T^c(x_c | pa) prod b^pa
    correct:  b^c  ∝ b'^c * l^c_t(x_c)

For a single chain (C = 1) FF is EXACT filtering (the HMM forward
algorithm).  Where the reference takes one sequence and its callers ``vmap``
it, every function here takes a leading batch axis B; the time recursion is
a Python loop over T whose steps read nothing back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor


class Factorial2TBN(NamedTuple):
    """C independent chains coupled only through the likelihood terms.

    init:  [C, S]        initial distribution per chain
    trans: [C, S, S]     p(x_t = j | x_{t-1} = i) per chain
    The observation model is supplied per step as log-likelihood tensors
    loglik[:, t]: [B, C, S] (chain-factored likelihoods -- the FF
    approximation point).
    """

    init: Tensor
    trans: Tensor


def _ones_mask(loglik: Tensor) -> Tensor:
    return torch.ones(loglik.shape[:2], dtype=loglik.dtype,
                      device=loglik.device)


def factored_frontier_filter(model: Factorial2TBN, loglik: Tensor,
                             mask: Optional[Tensor] = None
                             ) -> Tuple[Tensor, Tensor]:
    """loglik: [B, T, C, S].  Returns (beliefs [B, T, C, S], loglik_lb
    [B, T]).

    ``mask`` ([B, T], optional) marks which steps carry evidence.  Padded
    steps (``mask[b, t] == 0``) HOLD the belief -- no transition is applied
    and the loglik lower bound contribution is 0 -- matching the
    ragged-sequence semantics of ``pgm_models.dynamic.forward_backward``.
    The padded frames' loglik values are never read (``where``-gated
    before use), so garbage/NaN padding cannot corrupt the marginals."""
    if mask is None:
        mask = _ones_mask(loglik)
    B, T, C, S = loglik.shape
    belief = model.init.expand(B, C, S)
    beliefs, lls = [], []
    for t in range(T):
        m_t = mask[:, t] > 0                                   # [B]
        ll_t = torch.where(m_t[:, None, None], loglik[:, t], 0.0)
        # predict (per chain, independent transition)
        pred = torch.einsum("bcs,cst->bct", belief, model.trans)
        # correct
        mx = ll_t.amax(-1, keepdim=True)
        post = pred * torch.exp(ll_t - mx)
        norm = post.sum(-1, keepdim=True)
        post = post / torch.clamp(norm, min=1e-30)
        ll = (torch.log(torch.clamp(norm[..., 0], min=1e-30))
              + mx[..., 0]).sum(-1)
        belief = torch.where(m_t[:, None, None], post, belief)
        beliefs.append(belief)
        lls.append(torch.where(m_t, ll, 0.0))
    return torch.stack(beliefs, 1), torch.stack(lls, 1)


def factored_frontier_smooth(model: Factorial2TBN, loglik: Tensor,
                             mask: Optional[Tensor] = None) -> Tensor:
    """Factored gamma smoothing (forward-backward with the FF assumption),
    [B, T, C, S].

    ``mask`` ([B, T], optional): padded steps hold both the filtered belief
    and the backward message (see :func:`factored_frontier_filter`)."""
    if mask is None:
        mask = _ones_mask(loglik)
    beliefs, _ = factored_frontier_filter(model, loglik, mask)
    B, T, C, S = loglik.shape
    ones = torch.ones_like(model.init).expand(B, C, S)
    bnext = ones
    back = [ones]
    for t in range(T - 1, 0, -1):
        m_t = mask[:, t] > 0
        ll_t = torch.where(m_t[:, None, None], loglik[:, t], 0.0)
        # backward variable per chain
        msg = torch.einsum(
            "cst,bct->bcs", model.trans,
            bnext * torch.exp(ll_t - ll_t.amax(-1, keepdim=True)))
        msg = msg / torch.clamp(msg.sum(-1, keepdim=True), min=1e-30)
        bnext = torch.where(m_t[:, None, None], msg, bnext)
        back.append(bnext)
    gamma = beliefs * torch.stack(back[::-1], 1)
    return gamma / torch.clamp(gamma.sum(-1, keepdim=True), min=1e-30)


def predictive_posterior(model: Factorial2TBN, belief: Tensor,
                         horizon: int) -> Tensor:
    """Paper Code Fragment 14: getPredictivePosterior(var, h) -- roll the
    transition forward ``horizon`` steps with no evidence.  belief
    [B, C, S] -> [B, C, S]."""
    for _ in range(horizon):
        belief = torch.einsum("bcs,cst->bct", belief, model.trans)
    return belief


# -- convenience: exact HMM forward for the C = 1 oracle ---------------------


def hmm_forward(init: Tensor, trans: Tensor, loglik: Tensor
                ) -> Tuple[Tensor, Tensor]:
    """Exact forward filtering. init [S], trans [S, S], loglik [B, T, S]
    -> (beliefs [B, T, S], loglik_lb [B, T])."""
    model = Factorial2TBN(init=init[None], trans=trans[None])
    beliefs, ll = factored_frontier_filter(model, loglik[:, :, None, :])
    return beliefs[:, :, 0], ll
