"""Operations and bytes of the port's hand-kernel calls and of a model's
work, from shapes (frozen copies of the program's ``flash_attn.
live_pairs`` / ``attention_flops`` and ``ssd_scan.ssd_flops`` /
``ssd_bwd_flops``; bytes count each input read once and each output
written once).  Model flops leave out recomputation: a training step is
three times its forward (the backward's products are twice the
forward's)."""

from __future__ import annotations

from typing import Optional

F32, BF16 = 4, 2


def live_pairs(Sq: int, Sk: int, causal: bool = True,
               window: Optional[int] = None, q_offset: int = 0) -> int:
    """The (q, k) pairs the mask keeps: query i at position q_offset + i
    reads keys up to its own position (causal) and above position -
    window (with a window)."""
    total = 0
    for i in range(Sq):
        pos = q_offset + i
        hi = min(pos, Sk - 1) if causal else Sk - 1
        lo = max(pos - window + 1, 0) if window else 0
        total += max(hi - lo + 1, 0)
    return total


def attention_flops(B: int, Sq: int, Sk: int, Hq: int, D: int,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, backward: bool = False) -> int:
    """The forward's two products, 4 D a live pair, or the backward's
    five (S recomputed, dP, dV, dQ, dK), 10 D a pair, per (batch, q
    head)."""
    per = 10 if backward else 4
    return per * D * live_pairs(Sq, Sk, causal, window, q_offset) * B * Hq


def attention_bytes(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
                    elem: int, backward: bool = False,
                    with_lse: bool = True) -> int:
    """Forward: q, k, v read, the output (and, for a backward to come, its
    log-sum-exp in fp32) written.  Backward: q, k, v, the output, its
    gradient and the log-sum-exp read, dq, dk, dv written."""
    q, kv = B * Sq * Hq * D * elem, B * Sk * Hkv * D * elem
    lse = B * Hq * Sq * F32 if with_lse or backward else 0
    if backward:
        return (3 * q + 2 * kv + lse) + (q + 2 * kv)
    return (q + 2 * kv) + (q + lse)


def ssd_flops(b: int, S: int, H: int, P: int, G: int, N: int,
              chunk: int) -> int:
    """The forward's flops: per (batch, head, chunk) (C B^T o decay) @ x
    dt over the T = l (l + 1) / 2 pairs j <= i, the chunk state and C @
    h_prev^T; C B^T once per (batch, group, chunk)."""
    nc, tri = S // chunk, chunk * (chunk + 1) // 2
    return b * H * nc * (2 * tri * P + 4 * chunk * N * P) \
        + b * G * nc * 2 * tri * N


def ssd_bwd_flops(b: int, S: int, H: int, P: int, G: int, N: int,
                  chunk: int) -> int:
    """The backward's flops, multiply-adds 2 each: per (batch, head,
    chunk) 5 l P N + 2 T P + 2 T N, T = l (l + 1) / 2; C B^T once per
    (batch, group, chunk), T N."""
    l = chunk
    nc, T = S // l, l * (l + 1) // 2
    return 2 * (b * H * nc * (5 * l * P * N + 2 * T * P + 2 * T * N)
                + b * G * nc * T * N)


def ssd_bytes(b: int, S: int, H: int, P: int, G: int, N: int,
              backward: bool = False) -> int:
    """float32 throughout.  Forward: x, dt, A, B, C read, y and the final
    state written.  Backward: x, dt, A, B, C and dy read, dx, ddt, dA, dB,
    dC written."""
    x, dt, bc, st = b * S * H * P, b * S * H, b * S * G * N, b * H * P * N
    if backward:
        return F32 * ((2 * x + dt + H + 2 * bc) + (x + dt + H + 2 * bc))
    return F32 * ((x + dt + H + 2 * bc) + (x + st))


def matmul_params(cfg: dict) -> int:
    """Weights that enter a product for each token, counted at every call
    (the hybrid's shared block at each invocation); the head's product
    counts, the embedding's lookup does not."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    H, Hk, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    attn = d * H * hd * 2 + 2 * d * Hk * hd
    mlp = 3 * d * cfg["intermediate_size"]
    L = cfg["num_hidden_layers"]
    if cfg["arch"] == "dense":
        return L * (attn + mlp) + V * d
    s = cfg["ssm"]
    d_in = s["expand"] * d
    mamba = d * (2 * d_in + 2 * s["n_groups"] * s["state_dim"]
                 + d_in // s["head_dim"]) + d_in * d
    return L * mamba + attention_calls(cfg) * (attn + mlp) + V * d


def attention_calls(cfg: dict) -> int:
    """Calls of an attention block a forward: every layer's (dense), the
    shared block's after every ``hybrid_attn_every`` Mamba2 blocks
    (hybrid), none (ssm, or a hybrid whose shared block is never
    called)."""
    if cfg["arch"] == "dense":
        return cfg["num_hidden_layers"]
    every = cfg.get("hybrid_attn_every", 0) if cfg["arch"] == "hybrid" else 0
    return cfg["num_hidden_layers"] // every if every else 0


def forward_flops(cfg: dict, B: int, S: int) -> int:
    """Model flops of one forward over [B, S] tokens: 2 N a token, the
    attention's products over live pairs, the SSD scan's own work."""
    total = 2 * matmul_params(cfg) * B * S
    if attention_calls(cfg):
        total += attention_calls(cfg) * attention_flops(
            B, S, S, cfg["num_attention_heads"], cfg["head_dim"], True,
            cfg.get("sliding_window"))
    if cfg["arch"] in ("ssm", "hybrid"):
        s = cfg["ssm"]
        d_in = s["expand"] * cfg["hidden_size"]
        total += cfg["num_hidden_layers"] * ssd_flops(
            B, S, d_in // s["head_dim"], s["head_dim"], s["n_groups"],
            s["state_dim"], min(s["chunk"], S))
    return total


def train_step_flops(cfg: dict, B: int, S: int) -> int:
    """Model flops of a training step: forward and backward, 3 forwards;
    remat's recomputation is not model work."""
    return 3 * forward_flops(cfg, B, S)
