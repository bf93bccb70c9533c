"""Mixture-of-experts layer (counterpart of ``repro.nn.moe``), on one device.

Routing: top-k softmax gating in fp32 with capacity-based dispatch
(GShard-style, drop on overflow), index based: no ``[T, E, C]`` one-hot is
formed.  The rank of a (token, k) pair inside its expert counts the pairs
before it in the flat order ``t * K + k`` (a cumulative sum), so a token's
second choice ranks after its first and before the next token's first; a
pair whose rank reaches the capacity ``cap`` is dropped.

Weight layout: the JAX package's expert-parallel layout at one shard,
``[1, E, d, ff]`` (:func:`ep_split` with ``s = 1``), so that
``repro_torch.convert`` takes the reference's arrays as they are.  The
expert products are bf16 batched matmuls: the JAX package leaves them to
XLA einsums (``repro/nn/moe.py:143-145``), and mixture-of-experts has no
Pallas kernel to port.

Fixed order, no atomics: kept pairs own distinct slots of the expert
buffer, which is written by one ``index_put_`` (dropped pairs all go to one
spare row that is thrown away); the combine reads each pair's row back and
sums a token's K contributions, in the order k = 0..K-1 (``flat_t`` is
sorted), so two runs give the same bits.  Nothing reads back to the host:
``cap`` is fixed by the number of tokens.

Not ported: ``apply_moe(mesh=...)``, the ``shard_map`` expert-parallel path
(ROADMAP Queue 1 item 15, sharding), raises.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as Fnn

from repro_torch.configs.base import MoEConfig
from repro_torch.nn.layers import he_init

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def ep_split(w: Tensor, s: int) -> Tensor:
    """[E, d, ff] canonical -> EP layout [s, E_loc, d, ff_loc]."""
    E, d, ff = w.shape
    if E >= s:
        if E % s:
            raise ValueError(f"{E} experts do not split over {s} shards")
        return w.reshape(s, E // s, d, ff)
    if s % E:
        raise ValueError(f"{s} shards do not split {E} experts")
    k = s // E
    return w.reshape(E, d, k, ff // k).permute(0, 2, 1, 3).reshape(
        s, 1, d, ff // k)


def ep_split_down(w: Tensor, s: int) -> Tensor:
    """[E, ff, d] -> [s, E_loc, ff_loc, d]."""
    E, ff, d = w.shape
    if E >= s:
        return w.reshape(s, E // s, ff, d)
    k = s // E
    return w.reshape(s, 1, ff // k, d)


def init_moe(gen: torch.Generator, d: int, ff: int, cfg: MoEConfig,
             dtype=torch.float32) -> Params:
    """The router in fp32, the experts in ``dtype``, in the EP layout at one
    shard."""
    E = cfg.n_experts
    return {"router": he_init(gen, (d, E), d, torch.float32),
            "w_gate": ep_split(he_init(gen, (E, d, ff), d, dtype), 1),
            "w_up": ep_split(he_init(gen, (E, d, ff), d, dtype), 1),
            "w_down": ep_split_down(he_init(gen, (E, ff, d), ff, dtype), 1)}


class MoEAux(NamedTuple):
    load_balance: Tensor   # scalar aux loss (Switch-style)
    router_z: Tensor       # router z-loss
    expert_load: Tensor    # [E] fraction of tokens whose first choice is e


def _top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k``: the k largest, descending, the lower index first
    among equal values (a stable sort; ``torch.topk`` leaves ties open)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router_w: Tensor, x: Tensor, cfg: MoEConfig
           ) -> Tuple[Tensor, Tensor, MoEAux]:
    """x: [T, d] -> (gates [T, K], expert idx [T, K], aux), in fp32."""
    logits = x.float() @ router_w.float()                    # [T, E]
    probs = torch.softmax(logits, -1)
    gate, idx = _top_k(probs, cfg.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # Switch aux: E * sum_e (frac tokens to e) * (mean prob of e)
    frac = Fnn.one_hot(idx[:, 0], cfg.n_experts).float().mean(0)
    lb = cfg.n_experts * (frac * probs.mean(0)).sum()
    zl = (torch.logsumexp(logits, -1) ** 2).mean()
    return gate, idx, MoEAux(load_balance=lb, router_z=zl, expert_load=frac)


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert holds: ceil(T K cf / E), rounded up to a multiple of
    8, at least 8."""
    cap = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                        / cfg.n_experts))
    return max(8, ((cap + 7) // 8) * 8)


def ranks(flat_e: Tensor, n_experts: int) -> Tensor:
    """[T * K] expert ids in flat (token, k) order -> each pair's rank among
    the pairs routed to its expert (0 for the first)."""
    oh = Fnn.one_hot(flat_e, n_experts)                        # [T*K, E]
    return (oh.cumsum(0) - 1).gather(1, flat_e[:, None])[:, 0]


def _dispatch_compute(params: Params, x2: Tensor, cfg: MoEConfig
                      ) -> Tuple[Tensor, MoEAux]:
    """x2: [T, d] -> (y [T, d] in fp32, aux)."""
    T, d = x2.shape
    E, K = cfg.n_experts, cfg.top_k
    bf = torch.bfloat16
    wg, wu, wd = params["w_gate"][0], params["w_up"][0], params["w_down"][0]

    gate, idx, aux = _route(params["router"], x2, cfg)
    flat_e = idx.reshape(-1)                                   # [T*K]
    flat_g = gate.reshape(-1)
    pos = ranks(flat_e, E)
    cap = capacity(T, cfg)
    keep = pos < cap
    slot = flat_e * cap + torch.clamp(pos, max=cap - 1)        # [T*K]

    buf = torch.zeros((E * cap + 1, d), dtype=bf, device=x2.device)
    buf[torch.where(keep, slot, E * cap)] = \
        x2.to(bf).repeat_interleave(K, 0)
    buf = buf[:E * cap].view(E, cap, d)

    h_g = Fnn.silu(torch.bmm(buf, wg.to(bf)))                  # [E, cap, ff]
    h_u = torch.bmm(buf, wu.to(bf))
    out_buf = torch.bmm(h_g * h_u, wd.to(bf)).view(E * cap, d)

    contrib = out_buf[slot].float() * (flat_g * keep)[:, None]
    return contrib.view(T, K, d).sum(1), aux


def apply_moe(params: Params, x: Tensor, cfg: MoEConfig, mesh=None
              ) -> Tuple[Tensor, MoEAux]:
    """x: [B, S, d] -> (y [B, S, d] in x's dtype, aux)."""
    if mesh is not None:
        raise NotImplementedError(
            "apply_moe(mesh=...): the expert-parallel path is not ported; "
            "the port runs on one device (sharding is ROADMAP Queue 1 "
            "item 15)")
    B, S, d = x.shape
    y, aux = _dispatch_compute(params, x.reshape(B * S, d), cfg)
    return y.reshape(B, S, d).to(x.dtype), aux
