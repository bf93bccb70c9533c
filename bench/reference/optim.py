"""Plain PyTorch reference of the training jobs' optimizers, from the
hyperparameters a traffic file states.

* AdamW: a global-norm clip of the float32 gradients, bias-corrected
  moments, decoupled weight decay, a cosine schedule with linear warmup.
* Streaming VB (Variational Online Newton): the Fisher proxy
  s <- (1 - rho) s + rho g^2, the mean
  m <- m - lr (g + (p0 / N)(m - m0)) / (s / (1 - (1 - rho)^t) + p0 / N +
  damping), with the Page-Hinkley drift monitor on the loss whose firing
  tempers the chained prior (the paper's Eq. 3).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

Tensor = torch.Tensor
Tensors = Dict[str, Tensor]


def clipped(grads: Tensors, clip_norm: float) -> Tensors:
    norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values()))
    scale = min(1.0, clip_norm / max(float(norm), 1e-9))
    return {k: g * scale for k, g in grads.items()}


def cosine_lr(step: int, lr: float, warmup: int, total: int) -> float:
    w = min(step / max(warmup, 1), 1.0)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return lr * w * 0.5 * (1 + math.cos(math.pi * prog))


class AdamW:
    def __init__(self, params: Tensors, hp: dict, schedule: dict):
        self.p, self.hp, self.schedule = params, hp, schedule
        self.m = {k: torch.zeros_like(t) for k, t in params.items()}
        self.v = {k: torch.zeros_like(t) for k, t in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Tensors, loss: float) -> None:
        hp = self.hp
        self.t += 1
        b1, b2 = hp["b1"], hp["b2"]
        lr = cosine_lr(self.t, **self.schedule)
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in clipped(grads, hp["clip_norm"]).items():
            m, v, p = self.m[k], self.v[k], self.p[k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            delta = (m / c1) / (torch.sqrt(v / c2) + hp["eps"]) \
                + hp["weight_decay"] * p
            p.sub_(lr * delta)

    def first_grads(self) -> Tensors:
        """The gradient the first step used, from its first moment."""
        return {k: m / (1 - self.hp["b1"]) for k, m in self.m.items()}


class StreamingVB:
    def __init__(self, params: Tensors, hp: dict, lr: float):
        self.m, self.hp, self.lr = params, hp, lr
        self.s = {k: torch.zeros_like(t) for k, t in params.items()}
        self.m0 = {k: t.clone() for k, t in params.items()}
        self.p0 = {k: torch.full_like(t, hp["prior_prec"])
                   for k, t in params.items()}
        self.t = 0
        # Page-Hinkley statistics on the score -loss
        self.ph_mean = self.ph_cum = self.ph_min = 0.0
        self.ph_t = 0

    def _drifted(self, loss: float) -> bool:
        score = -loss
        self.ph_t += 1
        self.ph_mean += (score - self.ph_mean) / self.ph_t
        self.ph_cum += self.ph_mean - score - self.hp["ph_delta"]
        self.ph_min = min(self.ph_min, self.ph_cum)
        return self.ph_cum - self.ph_min > self.hp["drift_threshold"]

    @torch.no_grad()
    def step(self, grads: Tensors, loss: float) -> None:
        hp = self.hp
        self.t += 1
        rho, n = hp["rho"], hp["n_total"]
        bias = 1.0 - (1.0 - rho) ** self.t
        for k, g in clipped(grads, hp["clip_norm"]).items():
            s, m = self.s[k], self.m[k]
            s.mul_(1 - rho).add_(rho * g * g)
            lam0 = self.p0[k] / n
            m.sub_(self.lr * (g + lam0 * (m - self.m0[k]))
                   / (s / bias + lam0 + hp["damping"]))
        if self._drifted(loss):
            corr = 1.0 - hp["prec_bias_base"] ** max(self.t, 1)
            for k in self.m:
                self.p0[k] = hp["drift_temper"] * (
                    n * (self.s[k] / corr + hp["damping"]) + self.p0[k])
                self.m0[k] = self.m[k].clone()

    def first_grads(self) -> Tensors:
        """|g| of the first step from the Fisher proxy s = rho g^2 (the
        norms agree; the signs are not needed)."""
        return {k: torch.sqrt(s / self.hp["rho"]) for k, s in self.s.items()}
