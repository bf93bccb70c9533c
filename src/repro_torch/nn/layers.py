"""Common layers: norms, embeddings, RoPE, learned positions, gated MLPs
(counterpart of ``repro.nn.layers``).

Dtype policy (the JAX package's): parameters live in ``param_dtype`` (fp32
by default); matmuls run in bf16; normalization statistics and softmax run
in fp32.  ``embed`` returns bf16, so the residual stream is bf16;
``rmsnorm`` returns its input's dtype.

A parameter group is a mapping of names to tensors (a plain ``dict`` or an
``nn.ParameterDict``); the names are the JAX package's, so weights carry
across key for key.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
import torch.nn.functional as Fnn
from torch import nn

Tensor = torch.Tensor
Params = Mapping[str, Tensor]


def he_init(gen: torch.Generator, shape, fan_in: int,
            dtype=torch.float32) -> Tensor:
    """Normal(0, 1/fan_in) on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype) * (1.0 / math.sqrt(fan_in))


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
    return {"table": torch.randn((vocab, d), generator=gen,
                                 device=gen.device, dtype=dtype) * 0.02}


def embed(p: Params, ids: Tensor, compute_dtype=torch.bfloat16) -> Tensor:
    return p["table"].to(compute_dtype)[ids]


def unembed(p: Params, x: Tensor) -> Tensor:
    """Logits in fp32 (a bf16 product, as the JAX package rounds it)."""
    return (x.to(torch.bfloat16)
            @ p["table"].to(torch.bfloat16).T).float()


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
    return {"pos": torch.randn((max_len, d), generator=gen, device=gen.device,
                               dtype=dtype) * 0.01}


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


def mlp(p: Params, x: Tensor, kind: str) -> Tensor:
    bf = torch.bfloat16
    xb = x.to(bf)
    if kind in ("swiglu", "geglu"):
        act = Fnn.silu if kind == "swiglu" else _gelu_tanh
        g = act(xb @ p["w_gate"].to(bf))
        u = xb @ p["w_up"].to(bf)
        return ((g * u) @ p["w_down"].to(bf)).to(x.dtype)
    h = _gelu_tanh(xb @ p["w_up"].to(bf) + p["b_up"].to(bf))
    return (h @ p["w_down"].to(bf) + p["b_down"].to(bf)).to(x.dtype)
