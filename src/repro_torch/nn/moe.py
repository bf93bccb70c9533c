"""Mixture-of-experts layer (counterpart of ``repro.nn.moe``).

Routing: top-k softmax gating in fp32 with capacity-based dispatch
(GShard-style, drop on overflow), index based: no ``[T, E, C]`` one-hot is
formed.  The rank of a (token, k) pair inside its expert counts the pairs
before it in the flat order ``t * K + k`` (a cumulative sum), so a token's
second choice ranks after its first and before the next token's first; a
pair whose rank reaches the capacity ``cap`` is dropped.

Weight layout: the JAX package's expert-parallel layout ``[s, E_loc, d,
ff_loc]`` (:func:`ep_split`; ``s = 1`` on one device), so that
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

Expert parallelism (``apply_moe(mesh=)``, and ``moe_layer`` inside a
sharded model): activations are replicated over ``model``, so each model
rank routes all of its data shard's tokens and keeps the pairs bound for
its ``E_loc`` experts (or, when E < s, its ff slice of the one expert it
holds part of); no all-to-all.  The partial outputs are summed over
``model`` in bf16, as the reference's ``psum`` does, and the aux terms are
averaged over the data shards.  Capacity comes from the rank's own token
count, so a data-split batch drops pairs as the reference's mesh route
does, not as one device would.  Without expert parallelism (pure FSDP,
``Shardings(moe_ep=False)``) on a data-split batch, the dispatch keeps the
global semantics: each pair's rank counts the pairs of the shards before
it (one gather of [E] counts), capacity comes from the global token count
and the aux terms from global means.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as Fnn

from repro_torch.configs.base import MoEConfig
from repro_torch.nn.layers import he_init
from repro_torch.sharding import collectives as C

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


def ep_merge(w: Tensor, n_experts: int) -> Tensor:
    """EP layout [s, E_loc, d, ff_loc] -> canonical [E, d, ff]."""
    s, E_loc, d, ffl = w.shape
    if s * E_loc == n_experts:
        return w.reshape(n_experts, d, ffl)
    k = s // n_experts
    return w.reshape(n_experts, k, d, ffl).permute(0, 2, 1, 3).reshape(
        n_experts, d, k * ffl)


def ep_merge_down(w: Tensor, n_experts: int) -> Tensor:
    """[s, E_loc, ff_loc, d] -> [E, ff, d]."""
    s, E_loc, ffl, d = w.shape
    return w.reshape(n_experts, -1, d)


def relayout(p: Params, n_experts: int, s: int) -> Params:
    """A layer's expert weights in the layout of ``s`` shards."""
    out = dict(p)
    for k in ("w_gate", "w_up"):
        out[k] = ep_split(ep_merge(p[k], n_experts), s)
    out["w_down"] = ep_split_down(ep_merge_down(p["w_down"], n_experts), s)
    return out


def init_moe(gen: torch.Generator, d: int, ff: int, cfg: MoEConfig,
             dtype=torch.float32, ep_shards: int = 1) -> Params:
    """The router in fp32, the experts in ``dtype``, in the EP layout of
    ``ep_shards`` shards (the same draws at every ``ep_shards``)."""
    E = cfg.n_experts
    return {"router": he_init(gen, (d, E), d, torch.float32),
            "w_gate": ep_split(he_init(gen, (E, d, ff), d, dtype), ep_shards),
            "w_up": ep_split(he_init(gen, (E, d, ff), d, dtype), ep_shards),
            "w_down": ep_split_down(he_init(gen, (E, ff, d), ff, dtype),
                                    ep_shards)}


class MoEAux(NamedTuple):
    load_balance: Tensor   # scalar aux loss (Switch-style)
    router_z: Tensor       # router z-loss
    expert_load: Tensor    # [E] fraction of tokens whose first choice is e


def _top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k``: the k largest, descending, the lower index first
    among equal values (a stable sort; ``torch.topk`` leaves ties open)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router_w: Tensor, x: Tensor, cfg: MoEConfig, sh=None
           ) -> Tuple[Tensor, Tensor, MoEAux]:
    """x: [T, d] -> (gates [T, K], expert idx [T, K], aux), in fp32.  With
    ``sh``, the aux terms are the means over every data shard's tokens
    (the global batch's)."""
    logits = x.float() @ router_w.float()                    # [T, E]
    probs = torch.softmax(logits, -1)
    gate, idx = _top_k(probs, cfg.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # Switch aux: E * sum_e (frac tokens to e) * (mean prob of e)
    top1 = Fnn.one_hot(idx[:, 0], cfg.n_experts).float()
    lse2 = torch.logsumexp(logits, -1) ** 2
    if sh is None:
        frac, pmean, zl = top1.mean(0), probs.mean(0), lse2.mean()
    else:
        n = x.shape[0] * C.data_size(sh)
        frac = C.sum_over_data(top1.sum(0), sh) / n
        pmean = C.sum_over_data(probs.sum(0), sh) / n
        zl = C.sum_over_data(lse2.sum(), sh) / n
    lb = cfg.n_experts * (frac * pmean).sum()
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


def _dispatch_compute(params: Params, x2: Tensor, cfg: MoEConfig,
                      sidx: int = 0, s: int = 1, sh=None,
                      global_ranks: bool = False) -> Tuple[Tensor, MoEAux]:
    """x2: [T, d] -> (y [T, d] in fp32, aux).  ``sidx`` / ``s``: this
    rank's expert shard and the shards (the weights are its block,
    [1, E_loc, d, ff_loc]); y is then its PARTIAL output.  ``sh`` with
    ``s > 1``: x2 and the gates enter the expert-split region through
    ``copy_to_model``.  ``global_ranks``: the pairs rank after those of the
    data shards before this one and capacity counts every shard's tokens
    (the dispatch of the global batch)."""
    T, d = x2.shape
    E, K = cfg.n_experts, cfg.top_k
    bf = torch.bfloat16
    wg, wu, wd = params["w_gate"][0], params["w_up"][0], params["w_down"][0]
    E_loc = wg.shape[0]

    gate, idx, aux = _route(params["router"], x2, cfg, sh) if global_ranks \
        else _route(params["router"], x2, cfg)
    if s > 1:
        x2, gate = C.copy_to_model(x2, sh), C.copy_to_model(gate, sh)
    flat_e = idx.reshape(-1)                                   # [T*K]
    flat_g = gate.reshape(-1)
    pos = ranks(flat_e, E)
    cap = capacity(T, cfg)
    if global_ranks:
        counts = Fnn.one_hot(flat_e, E).sum(0)[None]           # [1, E]
        every = C.gather_dim(counts, 0, sh.mesh, tuple(sh.data_axes))
        i = C.axes_index(sh.mesh, sh.data_axes)
        pos = pos + every[:i].sum(0)[flat_e]
        cap = capacity(T * every.shape[0], cfg)
    keep = pos < cap
    if s == 1:
        mine, local_e = keep, flat_e
    elif E >= s:           # whole experts sidx E_loc .. (sidx + 1) E_loc - 1
        local_e = flat_e - sidx * E_loc
        mine = keep & (local_e >= 0) & (local_e < E_loc)
        local_e = torch.clamp(local_e, 0, E_loc - 1)
    else:                  # expert e split over shards e s/E .. (e+1) s/E - 1
        owner = flat_e * (s // E)
        mine = keep & (sidx >= owner) & (sidx < owner + s // E)
        local_e = torch.zeros_like(flat_e)
    slot = local_e * cap + torch.clamp(pos, max=cap - 1)       # [T*K]

    buf = torch.zeros((E_loc * cap + 1, d), dtype=bf, device=x2.device)
    buf[torch.where(mine, slot, E_loc * cap)] = \
        x2.to(bf).repeat_interleave(K, 0)
    buf = buf[:E_loc * cap].view(E_loc, cap, d)

    h_g = Fnn.silu(torch.bmm(buf, wg.to(bf)))                  # [E, cap, ff]
    h_u = torch.bmm(buf, wu.to(bf))
    out_buf = torch.bmm(h_g * h_u, wd.to(bf)).view(E_loc * cap, d)

    contrib = out_buf[slot].float() * (flat_g * mine)[:, None]
    return contrib.view(T, K, d).sum(1), aux


def moe_layer(params: Params, x: Tensor, cfg: MoEConfig, sh=None
              ) -> Tuple[Tensor, MoEAux]:
    """The layer on this rank's activations x [B, S, d] of a sharded
    model's forward (``sh``, a ``transformer.Shardings``): expert parallel
    when ``sh.moe_ep`` (y rounded to bf16 and summed over ``model``; the
    aux terms averaged over the data shards), else the global batch's
    dispatch over the data shards; the mesh-free layer without a mesh."""
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    if sh is None or sh.mesh is None:
        if params["w_gate"].shape[0] != 1:
            raise ValueError(
                f"experts in the layout of {params['w_gate'].shape[0]} "
                f"shards run on a mesh; gather_params or "
                f"transformer.with_ep_shards(lm, 1) gives one device's")
        y, aux = _dispatch_compute(params, x2, cfg)
        return y.reshape(B, S, d).to(x.dtype), aux
    if not sh.moe_ep:
        y, aux = _dispatch_compute(params, x2, cfg, sh=sh,
                                   global_ranks=C.data_size(sh) > 1)
        return y.reshape(B, S, d).to(x.dtype), aux
    if sh.model_axis in sh.data_axes:
        raise ValueError(
            f"moe_ep on a model axis {sh.model_axis!r} that splits the data "
            f"(pure FSDP) would sum the outputs of different rows; pass "
            f"Shardings(moe_ep=False)")
    s = C.axis_size(sh.mesh, sh.model_axis)
    if params["w_gate"].shape[0] != 1:
        raise ValueError("moe_layer takes this rank's expert block "
                         "[1, E_loc, d, ff_loc] (sharding.shard_params)")
    y, aux = _dispatch_compute(params, x2, cfg, C.tp_rank(sh), s, sh)
    # bf16 sum over model, as the reference's psum: half the link bytes
    y = C.reduce_from_model(y.to(torch.bfloat16), sh)
    aux = MoEAux(*(C.mean_over_data(a, sh) for a in aux))
    return y.reshape(B, S, d).to(x.dtype), aux


def apply_moe(params: Params, x: Tensor, cfg: MoEConfig, mesh=None,
              model_axis: str = "model",
              data_axes: Tuple[str, ...] = ("data",)
              ) -> Tuple[Tensor, MoEAux]:
    """x: [B, S, d] -> (y [B, S, d] in x's dtype, aux).

    With ``mesh`` (a ``DeviceMesh`` with ``model_axis`` and ``data_axes``),
    expert parallel: every rank passes the same x and the expert weights
    whole in the EP layout of s = the model axis's size ([s, E_loc, d,
    ff_loc]), as the reference's ``shard_map`` takes them; each rank runs
    its expert block on its block of x's rows over the data axes (all rows
    when B does not divide) and returns the whole y and the aux terms,
    replicated."""
    if mesh is None:
        return moe_layer(params, x, cfg)
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.nn.transformer import Shardings

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")

    sh = Shardings(mesh=mesh, data_axes=tuple(data_axes),
                   model_axis=model_axis)
    s = C.axis_size(mesh, model_axis)
    if params["w_gate"].shape[0] != s:
        raise ValueError(f"experts in the layout of "
                         f"{params['w_gate'].shape[0]} shards on a model "
                         f"axis of {s} ranks")
    j = mesh.get_local_rank(model_axis)
    params = {k: (v if k == "router" else v[j:j + 1])
              for k, v in params.items()}
    y, aux = moe_layer(params, C.data_block(x, sh), cfg, sh)
    if C.batch_split(x.shape[0], sh):
        y = C.gather_dim(y, 0, mesh, tuple(data_axes))
    return y, aux
