"""Seeded weights of a configuration, made on the device in one draw.

``layout(cfg)`` lists every parameter of the configuration's family --
name, shape and how it starts -- in a fixed order; ``make(cfg, seed,
device)`` draws one float32 buffer of standard normals from a
``torch.Generator`` seeded with ``seed`` on ``device`` (one call), scales
each random leaf's slice in place and fills the constant ones, and
returns the leaves as views of that buffer.  The same seed gives the same
weights on the same device: the program and the reference are handed the
same values.  Names are the program's parameter names.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], tuple]


def _dense_groups(p: str, cfg: dict) -> List[Leaf]:
    d, H, Hk = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    hd, ff = cfg["head_dim"], cfg["intermediate_size"]
    normal = lambda fan_in: ("normal", 1.0 / math.sqrt(fan_in))  # noqa: E731
    return [(p + "ln1.scale", (d,), ("ones",)),
            (p + "attn.wq", (d, H, hd), normal(d)),
            (p + "attn.wk", (d, Hk, hd), normal(d)),
            (p + "attn.wv", (d, Hk, hd), normal(d)),
            (p + "attn.wo", (H, hd, d), normal(H * hd)),
            (p + "ln2.scale", (d,), ("ones",)),
            (p + "mlp.w_gate", (d, ff), normal(d)),
            (p + "mlp.w_up", (d, ff), normal(d)),
            (p + "mlp.w_down", (ff, d), normal(ff))]


def _mamba_groups(p: str, cfg: dict) -> List[Leaf]:
    d, s = cfg["hidden_size"], cfg["ssm"]
    d_in = s["expand"] * d
    H, GN, W = d_in // s["head_dim"], s["n_groups"] * s["state_dim"], \
        s["conv_width"]
    normal = lambda fan_in: ("normal", 1.0 / math.sqrt(fan_in))  # noqa: E731
    m = p + "mamba."
    return [(p + "ln.scale", (d,), ("ones",)),
            (m + "w_z", (d, d_in), normal(d)),
            (m + "w_x", (d, d_in), normal(d)),
            (m + "w_B", (d, GN), normal(d)),
            (m + "w_C", (d, GN), normal(d)),
            (m + "w_dt", (d, H), normal(d)),
            (m + "conv_x", (W, d_in), normal(W)),
            (m + "conv_b_x", (d_in,), ("zeros",)),
            (m + "conv_bc", (W, 2 * GN), normal(W)),
            (m + "conv_b_bc", (2 * GN,), ("zeros",)),
            (m + "A_log", (H,), ("log_linspace", 1.0, 16.0)),
            (m + "D", (H,), ("ones",)),
            (m + "dt_bias", (H,), ("const", math.log(math.expm1(0.01)))),
            (m + "norm_scale", (d_in,), ("ones",)),
            (m + "w_out", (d_in, d), normal(d_in))]


def layout(cfg: dict) -> List[Leaf]:
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    leaves: List[Leaf] = [("embed.table", (V, d), ("normal", 0.02))]
    if cfg["arch"] == "dense":
        for i in range(cfg["num_hidden_layers"]):
            leaves += _dense_groups(f"blocks.{i}.", cfg)
    elif cfg["arch"] in ("ssm", "hybrid"):
        for i in range(cfg["num_hidden_layers"]):
            leaves += _mamba_groups(f"blocks.{i}.", cfg)
        if cfg["arch"] == "hybrid":
            leaves += _dense_groups("shared_attn.", cfg)
    else:
        raise ValueError(f"unknown family {cfg['arch']!r}")
    leaves.append(("final_norm.scale", (d,), ("ones",)))
    if not cfg["tie_word_embeddings"]:
        leaves.append(("lm_head.table", (V, d), ("normal", 1.0 / math.sqrt(d))))
    return leaves


def n_params(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in layout(cfg))


@torch.no_grad()
def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} on ``device``, views of one buffer."""
    leaves = layout(cfg)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    out, off = {}, 0
    for name, shape, init in leaves:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        kind = init[0]
        if kind == "normal":
            t.mul_(init[1])
        elif kind == "ones":
            t.fill_(1.0)
        elif kind == "zeros":
            t.zero_()
        elif kind == "const":
            t.fill_(init[1])
        elif kind == "log_linspace":
            t.copy_(torch.log(torch.linspace(init[1], init[2], n,
                                             device=device)))
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
        out[name] = t
    return out
