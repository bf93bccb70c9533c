"""ModelConfig — the selectable-architecture config system (a copy of
``repro.configs.base``, kept here so that the port imports nothing of the
JAX package).

One ``ModelConfig`` instance per architecture lives in
``repro_torch/configs/<id>.py``; ``repro_torch.configs.get_config(name)``
resolves them, and every config supports ``.reduced()`` for CPU smoke tests
(2 layers, d_model <= 512, <= 4 experts).

Input shapes (the 4 assigned): ``INPUT_SHAPES`` below.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128      # N
    head_dim: int = 64        # P
    n_groups: int = 1         # B/C groups
    expand: int = 2           # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128          # SSD chunk length


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Audio/VLM frontends are STUBS: input_specs() provides precomputed
    frame/patch embeddings of shape [B, enc_len, d_model]."""

    n_layers: int
    enc_len: int              # e.g. 1500 mel frames for whisper


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    mlp: str = "swiglu"       # swiglu | geglu | gelu
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    # hybrid (zamba2-style): attention block shared + inserted every k blocks
    hybrid_attn_every: int = 0
    source: str = ""          # citation

    @property
    def head_dim_(self) -> int:
        if self.n_heads == 0:  # attention-free (pure SSM)
            return 0
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode (see DESIGN.md §decode coverage)."""
        return self.arch_type in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None and self.arch_type == "audio"

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd = self.head_dim_
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        if self.moe:
            mlp = 3 * d * ff * self.moe.n_experts + d * self.moe.n_experts
        elif self.mlp in ("swiglu", "geglu"):
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        if self.arch_type == "ssm":
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            blk = d * (2 * d_in + 2 * s.n_groups * s.state_dim + nh) \
                + d_in * d + s.conv_width * (d_in + 2 * s.n_groups * s.state_dim)
            return emb + L * (blk + 2 * d)
        if self.arch_type == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            mamba_blk = d * (2 * d_in + 2 * s.n_groups * s.state_dim + nh) \
                + d_in * d
            # the attention+MLP block is parameter-SHARED (zamba2): counted once
            return emb + L * (mamba_blk + 2 * d) + attn + mlp + 2 * d
        enc = 0
        if self.encoder:
            enc = self.encoder.n_layers * (2 * attn + mlp + 4 * d)
        return emb + L * (attn + mlp + 2 * d) + enc

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.moe:
            return self.n_params()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        total = self.n_params()
        dense_share = total - L * 3 * d * ff * self.moe.n_experts
        return dense_share + L * 3 * d * ff * self.moe.top_k

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        hd = min(self.head_dim_, 64)
        repl = dict(
            n_layers=2,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            sliding_window=64 if self.sliding_window else None,
        )
        if self.moe:
            repl["moe"] = MoEConfig(
                n_experts=min(self.moe.n_experts, 4), top_k=self.moe.top_k,
                capacity_factor=self.moe.capacity_factor)
        if self.ssm:
            repl["ssm"] = SSMConfig(
                state_dim=min(self.ssm.state_dim, 32),
                head_dim=32, n_groups=1, expand=2, conv_width=4, chunk=32)
        if self.encoder:
            repl["encoder"] = EncoderConfig(n_layers=2, enc_len=64)
        if self.hybrid_attn_every:
            repl["hybrid_attn_every"] = 2
        return dataclasses.replace(self, **repl)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def reduced(self) -> "InputShape":
        return InputShape(self.name, min(self.seq_len, 128),
                          min(self.global_batch, 4), self.kind)


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
