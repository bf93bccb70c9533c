"""What every traffic kind (``bench/traffic/<kind>.py``) shares: the
program's model built from a configuration file around the seeded
weights, and waiting on and freeing the card.
"""

from __future__ import annotations

import gc
from typing import Dict

import torch


def port_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig, SSMConfig

    s = cfg.get("ssm")
    ssm = None if s is None else SSMConfig(
        state_dim=s["state_dim"], head_dim=s["head_dim"],
        n_groups=s["n_groups"], expand=s["expand"],
        conv_width=s["conv_width"], chunk=s["chunk"])
    return ModelConfig(
        name=cfg["port"]["name"], arch_type=cfg["port"]["arch_type"],
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        head_dim=cfg["head_dim"], mlp=cfg["port"]["mlp"],
        rope_theta=cfg["rope_theta"], sliding_window=cfg.get("sliding_window"),
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], ssm=ssm,
        hybrid_attn_every=cfg.get("hybrid_attn_every", 0),
        source=cfg["source"])


def port_model(cfg: dict, w: Dict[str, torch.Tensor], trainable: bool):
    """The program's ``LM`` holding the tensors ``w`` (no copy)."""
    from repro_torch.nn import layers as L
    from repro_torch.nn import transformer as T

    taken = set()

    def place(name, t):
        if name not in w or tuple(w[name].shape) != tuple(t.shape):
            raise ValueError(f"the program's parameter {name} "
                             f"{tuple(t.shape)} is not in the layout of "
                             f"{cfg['name']}")
        taken.add(name)
        return w[name]

    lm = T.init_model(L.META_GEN, port_config(cfg), trainable=trainable,
                      place=place)
    if taken != set(w):
        raise ValueError(f"the layout's {sorted(set(w) - taken)[:3]} are not "
                         f"the program's parameters")
    return lm


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def leaf_norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))
