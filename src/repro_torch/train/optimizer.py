"""Hand-rolled optimizers (counterpart of ``repro.train.optimizer``):
AdamW with a global-norm clip and the cosine schedule with warmup, and SGD
with momentum.

Parameters, gradients and moments are ordered dicts of tensors keyed by
the LM's parameter names (``dict(lm.named_parameters())``).  Unlike the
reference's pure functions, the updates write the parameters and the
moments in place and return them: at full width they are tens of GB, and
a second copy would not fit beside them.  The arithmetic is the
reference's, in fp32, with no host synchronisation (the clip scale stays
on the device).  On a mesh (``mesh``) the trees are this rank's blocks
(each parameter's ``shard_spec``): the global norm sums each block's
squares over the axes that split it, and counts a replicated parameter
once (``collectives.sharded_sum``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.sharding import collectives as C

Tensor = torch.Tensor
Tensors = Dict[str, Tensor]


def global_norm(grads: Tensors, params: Tensors = None, mesh=None) -> Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares; on a
    ``mesh`` the leaves are blocks of ``params``' parameters."""
    sq = {k: torch.sum(torch.square(g.float())) for k, g in grads.items()}
    if mesh is None:
        return torch.sqrt(sum(sq.values()))
    return torch.sqrt(C.sharded_sum(sq, params, mesh))


def clip_scale(grads: Tensors, clip_norm: float, params: Tensors = None,
               mesh=None) -> Tensor:
    """min(1, clip_norm / max(|g|, 1e-9)), a 0-dim device tensor."""
    return torch.clamp(clip_norm / torch.clamp(
        global_norm(grads, params, mesh), min=1e-9), max=1.0)


class AdamWState(NamedTuple):
    m: Tensors
    v: Tensors
    step: int


def adamw_init(params: Tensors) -> AdamWState:
    z = {k: torch.zeros_like(p, dtype=torch.float32)
         for k, p in params.items()}
    return AdamWState(m=z, v={k: t.clone() for k, t in z.items()}, step=0)


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[int], float]:
    def lr(step):
        w = min(step / max(warmup, 1), 1.0)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * w * 0.5 * (1 + math.cos(math.pi * prog))

    return lr


@torch.no_grad()
def adamw_update(params: Tensors, grads: Tensors, state: AdamWState, *,
                 lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 clip_norm=1.0, mesh=None) -> Tuple[Tensors, AdamWState]:
    """One AdamW step (fp32 global-norm clip, bias correction, decoupled
    weight decay); ``params``, ``state.m`` and ``state.v`` are updated in
    place and returned."""
    step = state.step + 1
    scale = clip_scale(grads, clip_norm, params, mesh)
    lr = lr_fn(step)
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    for k, p in params.items():
        g = grads[k].float() * scale
        m, v = state.m[k], state.v[k]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m / c1) / (torch.sqrt(v / c2) + eps)
        delta.add_(p.float(), alpha=weight_decay)
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(m=state.m, v=state.v, step=step)


class SGDState(NamedTuple):
    mom: Tensors
    step: int


def sgd_init(params: Tensors) -> SGDState:
    return SGDState(mom={k: torch.zeros_like(p, dtype=torch.float32)
                         for k, p in params.items()}, step=0)


@torch.no_grad()
def sgd_update(params: Tensors, grads: Tensors, state: SGDState, *,
               lr=1e-2, momentum=0.9) -> Tuple[Tensors, SGDState]:
    """mom = momentum mom + g; p -= lr mom (in place, as adamw_update)."""
    for k, p in params.items():
        m = state.mom[k]
        m.mul_(momentum).add_(grads[k].float())
        p.copy_(p.float() - lr * m)
    return params, SGDState(mom=state.mom, step=state.step + 1)
