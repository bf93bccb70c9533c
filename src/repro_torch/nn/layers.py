"""Common layers: norms, embeddings, RoPE, learned positions, gated MLPs
(counterpart of ``repro.nn.layers``).

Dtype policy (the JAX package's): parameters live in ``param_dtype`` (fp32
by default); matmuls run in bf16; normalization statistics and softmax run
in fp32.  ``embed`` returns bf16, so the residual stream is bf16;
``rmsnorm`` returns its input's dtype.

A parameter group is a mapping of names to tensors (a plain ``dict`` or an
``nn.ParameterDict``); the names are the JAX package's, so weights carry
across key for key.  The initialisers draw from a ``torch.Generator`` on its
device; :data:`META_GEN` in its place gives the same tensors' shapes on the
``meta`` device, with no memory (``sharding.param_shapes``).

Mesh paths (``sh``, a ``transformer.Shardings``): ``embed`` and ``unembed``
are vocab-parallel when the table's vocabulary is split over ``model`` (a
lookup zeroes the ids of other ranks' rows and the rows are summed over
``model``; ``unembed`` gives this rank's vocabulary columns), and ``mlp``
is ff-parallel when its weights are split.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
import torch.nn.functional as Fnn
from torch import nn

from repro_torch.sharding import collectives as C

Tensor = torch.Tensor
Params = Mapping[str, Tensor]


class _MetaGen:
    """Stands in for a generator: the initialisers give ``meta`` tensors."""

    device = torch.device("meta")


META_GEN = _MetaGen()


def randn(gen, shape, dtype=torch.float32) -> Tensor:
    """Standard normal draws from ``gen`` on its device (``meta``: none)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def he_init(gen: torch.Generator, shape, fan_in: int,
            dtype=torch.float32) -> Tensor:
    """Normal(0, 1/fan_in) on the generator's device."""
    return randn(gen, shape, dtype) * (1.0 / math.sqrt(fan_in))


def param_dict(tensors: Dict[str, Tensor]) -> nn.ParameterDict:
    """An ``nn.ParameterDict`` of frozen parameters (a model is made
    trainable as a whole: ``transformer.init_model(trainable=True)``)."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


# -- RMSNorm -------------------------------------------------------------------


def init_rmsnorm(d: int, device=None, dtype=torch.float32
                 ) -> Dict[str, Tensor]:
    return {"scale": torch.ones(d, device=device, dtype=dtype)}


def rmsnorm(p: Params, x: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


# -- LayerNorm (whisper) ---------------------------------------------------------


def init_layernorm(d: int, device=None, dtype=torch.float32
                   ) -> Dict[str, Tensor]:
    return {"scale": torch.ones(d, device=device, dtype=dtype),
            "bias": torch.zeros(d, device=device, dtype=dtype)}


def layernorm(p: Params, x: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)


# -- Embedding -------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32) -> Dict[str, Tensor]:
    return {"table": randn(gen, (vocab, d), dtype) * 0.02}


def embed(p: Params, ids: Tensor, compute_dtype=torch.bfloat16,
          sh=None) -> Tensor:
    table = p["table"]
    if sh is None or not C.tp_split(table, 0, sh):
        return table.to(compute_dtype)[ids]
    n = table.shape[0]                       # this rank's rows of the vocab
    local = ids - C.tp_rank(sh) * n
    mine = (local >= 0) & (local < n)
    rows = table.to(compute_dtype)[torch.where(mine, local, 0)]
    return C.reduce_from_model(torch.where(mine[..., None], rows, 0), sh)


def unembed(p: Params, x: Tensor, sh=None) -> Tensor:
    """Logits in fp32 (a bf16 product, as the JAX package rounds it); on a
    vocab-split table, this rank's columns."""
    xb = x.to(torch.bfloat16)
    if sh is not None and C.tp_split(p["table"], 0, sh):
        xb = C.copy_to_model(xb, sh)
    return (xb @ p["table"].to(torch.bfloat16).T).float()


# -- RoPE -------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=device,
                                         dtype=torch.float32) / head_dim))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: [..., S, H, D]; positions: [..., S] (broadcastable).  Rotates the
    two halves of D (not interleaved pairs)."""
    D = x.shape[-1]
    freqs = rope_frequencies(D, theta, x.device)              # [D/2]
    angles = positions[..., None].float() * freqs              # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                      # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# -- learned absolute positions (whisper) -------------------------------------------


def init_pos_embedding(gen: torch.Generator, max_len: int, d: int,
                       dtype=torch.float32) -> Dict[str, Tensor]:
    return {"pos": randn(gen, (max_len, d), dtype) * 0.01}


def add_pos(p: Params, x: Tensor, offset: int = 0) -> Tensor:
    """x [..., S, d] plus rows offset..offset+S-1 of the table; the start is
    clamped so that the rows lie in the table, as ``dynamic_slice`` clamps
    it in the JAX package."""
    S, n = x.shape[-2], p["pos"].shape[0]
    start = min(max(offset, 0), n - S)
    return x + p["pos"][start:start + S].to(x.dtype)


# -- MLPs ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, ff: int, kind: str,
             dtype=torch.float32) -> Dict[str, Tensor]:
    if kind in ("swiglu", "geglu"):
        return {"w_gate": he_init(gen, (d, ff), d, dtype),
                "w_up": he_init(gen, (d, ff), d, dtype),
                "w_down": he_init(gen, (ff, d), ff, dtype)}
    return {   # plain gelu (whisper)
        "w_up": he_init(gen, (d, ff), d, dtype),
        "b_up": torch.zeros(ff, device=gen.device, dtype=dtype),
        "w_down": he_init(gen, (ff, d), ff, dtype),
        "b_down": torch.zeros(d, device=gen.device, dtype=dtype)}


def _gelu_tanh(v: Tensor) -> Tensor:
    return Fnn.gelu(v, approximate="tanh")


def mlp(p: Params, x: Tensor, kind: str, sh=None) -> Tensor:
    """On ff-split weights (``sh``), the partial products of ``w_down`` are
    summed over ``model`` in bf16 before ``b_down`` is added."""
    bf = torch.bfloat16
    xb = x.to(bf)
    tp = sh is not None and C.tp_split(p["w_up"], 1, sh)
    if tp:
        xb = C.copy_to_model(xb, sh)
    if kind in ("swiglu", "geglu"):
        act = Fnn.silu if kind == "swiglu" else _gelu_tanh
        g = act(xb @ p["w_gate"].to(bf))
        u = xb @ p["w_up"].to(bf)
        y = (g * u) @ p["w_down"].to(bf)
        return (C.reduce_from_model(y, sh) if tp else y).to(x.dtype)
    h = _gelu_tanh(xb @ p["w_up"].to(bf) + p["b_up"].to(bf))
    if tp:
        y = C.reduce_from_model(h @ p["w_down"].to(bf), sh)
        return (y + p["b_down"].to(bf)).to(x.dtype)
    return (h @ p["w_down"].to(bf) + p["b_down"].to(bf)).to(x.dtype)
