"""Tiny configurations of the families the yardstick covers beyond the
benchmark's own configuration files (a Mamba2 stack, and the port's
zamba2-style hybrid), in a configuration file's keys, for the tests."""

from bench import spec
from bench.run import tiny

_SSM = {"state_dim": 16, "head_dim": 16, "n_groups": 1, "expand": 2,
        "conv_width": 4, "chunk": 16}


def config(family: str) -> dict:
    """``dense`` is granite-3-2b's file at its tiny sizes; ``ssm`` and
    ``hybrid`` are built on it."""
    cfg = tiny(spec.load_json(spec.BENCH / "configs" / "granite-3-2b.json"))
    if family == "dense":
        return cfg
    cfg.update(name=f"{family}-tiny", arch=family, ssm=dict(_SSM),
               tie_word_embeddings=False)
    if family == "ssm":
        cfg.update(num_attention_heads=0, num_key_value_heads=0, head_dim=0,
                   intermediate_size=0, hybrid_attn_every=0,
                   port={"name": "ssm-tiny", "arch_type": "ssm",
                         "mlp": "none"})
    else:
        cfg.update(num_key_value_heads=4, hidden_act="gelu_tanh",
                   mlp="geglu", sliding_window=48, hybrid_attn_every=1,
                   port={"name": "hybrid-tiny", "arch_type": "hybrid",
                         "mlp": "geglu"})
    return cfg
