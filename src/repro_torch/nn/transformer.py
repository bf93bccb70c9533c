"""Model assembly: embeddings -> blocks -> head (counterpart of
``repro.nn.transformer``) for the dense / vlm, ssm and hybrid (zamba2)
families, prefill (``forward``) and one-token decode (``decode_step``).

Parameters are an :class:`LM`: nested ``nn.ModuleDict``/``nn.ParameterDict``
keyed as the JAX package's parameter tree, with the stacked ``[L]`` axis of
``blocks`` unstacked into an ``nn.ModuleList`` (``blocks.3.mamba.w_z``);
:func:`repro_torch.convert.lm_params_from_numpy` carries a JAX tree across.
The zamba2 hybrid invokes one parameter-shared attention block
(``shared_attn``) after every ``hybrid_attn_every`` Mamba blocks.

``backend=None`` follows the device: ``"cuda"`` runs the hand-written
kernels (``flash_attention`` in ``attention_block``, ``ssd_scan`` in
``apply_mamba2``), ``"einsum"`` their plain versions; ``"einsum"`` on a card
only when named.  Decode runs no kernel.

One device, no sharding: ``forward(mesh=...)`` raises.  Not ported yet
(ROADMAP Queue 1 item 15): the ``moe`` and ``audio`` families raise
``NotImplementedError``.  ``jax.checkpoint`` (remat) has no meaning for
inference and is dropped.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch import nn

from repro_torch import device as devmod
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attn
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as L
from repro_torch.nn import ssm as ssm_lib

Tensor = torch.Tensor
Params = Any          # an LM (or any tree of mappings with the same keys)

_NOT_PORTED = {"moe": "ROADMAP Queue 1 item 15 (nn/moe.py, mixture of "
                      "experts)",
               "audio": "ROADMAP Queue 1 item 15 (whisper's encoder and "
                        "cross attention)"}
ARCH_TYPES = ("dense", "vlm", "ssm", "hybrid")


def check_arch(cfg: ModelConfig) -> None:
    if cfg.arch_type in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: arch type {cfg.arch_type!r} is not ported yet: "
            f"{_NOT_PORTED[cfg.arch_type]}")
    if cfg.arch_type not in ARCH_TYPES:
        raise ValueError(f"unknown arch type {cfg.arch_type!r}")


def _backend(backend: Optional[str], x: Tensor) -> str:
    return devmod.check_backend(backend or devmod.default_backend(x.device),
                                x.device)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32) -> Dict[str, Tensor]:
    d, hd = cfg.d_model, cfg.head_dim_
    return {"wq": L.he_init(gen, (d, cfg.n_heads, hd), d, dtype),
            "wk": L.he_init(gen, (d, cfg.n_kv_heads, hd), d, dtype),
            "wv": L.he_init(gen, (d, cfg.n_kv_heads, hd), d, dtype),
            "wo": L.he_init(gen, (cfg.n_heads, hd, d), cfg.n_heads * hd,
                            dtype)}


def _qkv(p, x: Tensor):
    bf = torch.bfloat16
    xb = x.to(bf)
    return tuple(torch.einsum("bsd,dhk->bshk", xb, p[w].to(bf))
                 for w in ("wq", "wk", "wv"))


def _out_proj(p, o: Tensor, like: Tensor) -> Tensor:
    bf = torch.bfloat16
    return torch.einsum("bshk,hkd->bsd", o.to(bf), p["wo"].to(bf)
                        ).to(like.dtype)


def attention_block(p, x: Tensor, cfg: ModelConfig, *, causal: bool = True,
                    positions: Optional[Tensor] = None,
                    window: Optional[int] = None,
                    backend: Optional[str] = None) -> Tensor:
    """Full-sequence attention (prefill). x: [B, S, d]."""
    backend = _backend(backend, x)
    S = x.shape[1]
    q, k, v = _qkv(p, x)
    if cfg.rope_theta:
        pos = positions if positions is not None else \
            torch.arange(S, device=x.device)[None]
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    fn = flash_attn.flash_attention if backend == "cuda" \
        else attn.attention_blockwise
    o = fn(q, k, v, causal=causal, window=window)
    return _out_proj(p, o, x)


def attention_block_decode(p, x: Tensor, cache: attn.KVCache,
                           cfg: ModelConfig, window: Optional[int] = None):
    """One-token decode. x: [B, 1, d] -> (out, cache written in place)."""
    q, k, v = _qkv(p, x)
    if cfg.rope_theta:
        pos = torch.full((1, 1), cache.length, device=x.device)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    cache = attn.cache_update(cache, k.to(cache.k.dtype), v.to(cache.v.dtype))
    o = attn.attention_decode(q, cache, window=window)
    return _out_proj(p, o, x), cache


# ---------------------------------------------------------------------------
# per-layer blocks
# ---------------------------------------------------------------------------


def dense_block(p, x: Tensor, cfg: ModelConfig,
                backend: Optional[str] = None) -> Tensor:
    h = attention_block(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                        window=cfg.sliding_window, backend=backend)
    x = x + h
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.mlp)


def mamba_block(p, x: Tensor, cfg: ModelConfig,
                backend: Optional[str] = None) -> Tensor:
    return x + ssm_lib.apply_mamba2(p["mamba"],
                                    L.rmsnorm(p["ln"], x, cfg.norm_eps),
                                    cfg.d_model, cfg.ssm, cfg.norm_eps,
                                    backend=backend)


class _Block(nn.ModuleDict):
    """A layer's parameter groups (``nn.ParameterDict`` each, frozen)."""

    def __init__(self, cfg: ModelConfig, groups: Dict[str, Dict[str, Tensor]]):
        super().__init__({k: L.param_dict(v) for k, v in groups.items()})
        self.cfg = cfg


class DenseBlock(_Block):
    """ln1 -> attention -> ln2 -> MLP (keys ``ln1``, ``attn``, ``ln2``,
    ``mlp``)."""

    def forward(self, x: Tensor, backend: Optional[str] = None) -> Tensor:
        return dense_block(self, x, self.cfg, backend)


class MambaBlock(_Block):
    """ln -> Mamba2 (keys ``ln``, ``mamba``)."""

    def forward(self, x: Tensor, backend: Optional[str] = None) -> Tensor:
        return mamba_block(self, x, self.cfg, backend)


def init_dense_block(gen: torch.Generator, cfg: ModelConfig,
                     dtype=torch.float32) -> DenseBlock:
    return DenseBlock(cfg, {
        "ln1": L.init_rmsnorm(cfg.d_model, gen.device, dtype),
        "attn": init_attention(gen, cfg, dtype),
        "ln2": L.init_rmsnorm(cfg.d_model, gen.device, dtype),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype)})


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig,
                     dtype=torch.float32) -> MambaBlock:
    return MambaBlock(cfg, {
        "ln": L.init_rmsnorm(cfg.d_model, gen.device, dtype),
        "mamba": ssm_lib.init_mamba2(gen, cfg.d_model, cfg.ssm, dtype)})


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


class LM(nn.ModuleDict):
    """One model's parameters: ``embed``, ``blocks`` (one module per layer),
    ``shared_attn`` (hybrid), ``final_norm`` and ``lm_head`` (unless the
    embeddings are tied).  Calling it runs :func:`forward`."""

    def __init__(self, cfg: ModelConfig, embed: Dict[str, Tensor],
                 blocks: List[nn.Module], final_norm: Dict[str, Tensor],
                 lm_head: Optional[Dict[str, Tensor]] = None,
                 shared_attn: Optional[DenseBlock] = None):
        mods = {"embed": L.param_dict(embed), "blocks": nn.ModuleList(blocks),
                "final_norm": L.param_dict(final_norm)}
        if shared_attn is not None:
            mods["shared_attn"] = shared_attn
        if lm_head is not None:
            mods["lm_head"] = L.param_dict(lm_head)
        super().__init__(mods)
        self.cfg = cfg

    def forward(self, tokens: Tensor, backend: Optional[str] = None
                ) -> "ForwardOut":
        return forward(self, tokens, self.cfg, backend=backend)


def init_model(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> LM:
    """Random weights from ``gen``, on ``gen``'s device."""
    check_arch(cfg)
    embed = L.init_embedding(gen, cfg.vocab, cfg.d_model, dtype)
    if cfg.arch_type in ("dense", "vlm"):
        blocks = [init_dense_block(gen, cfg, dtype)
                  for _ in range(cfg.n_layers)]
    else:
        blocks = [init_mamba_block(gen, cfg, dtype)
                  for _ in range(cfg.n_layers)]
    shared = init_dense_block(gen, cfg, dtype) \
        if cfg.arch_type == "hybrid" else None
    head = None if cfg.tie_embeddings else {
        "table": L.he_init(gen, (cfg.vocab, cfg.d_model), cfg.d_model, dtype)}
    return LM(cfg, embed, blocks, L.init_rmsnorm(cfg.d_model, gen.device,
                                                 dtype),
              lm_head=head, shared_attn=shared)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


class ForwardOut(NamedTuple):
    logits: Tensor
    moe_aux: Tensor   # scalar: 0 (no mixture-of-experts family is ported)


def forward(params: Params, tokens: Tensor, cfg: ModelConfig, *,
            backend: Optional[str] = None, mesh=None) -> ForwardOut:
    """tokens: [B, S] integer ids -> logits [B, S, V] (fp32)."""
    check_arch(cfg)
    if mesh is not None:
        raise NotImplementedError("forward(mesh=...): the port runs on one "
                                  "device (sharding is ROADMAP Queue 1 "
                                  "item 15)")
    x = L.embed(params["embed"], tokens)
    backend = _backend(backend, x)
    if cfg.arch_type == "hybrid":
        x = _hybrid_forward(params, x, cfg, backend)
    else:
        block = dense_block if cfg.arch_type in ("dense", "vlm") \
            else mamba_block
        for p in params["blocks"]:
            x = block(p, x, cfg, backend)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return ForwardOut(logits=L.unembed(head, x),
                      moe_aux=torch.zeros((), device=x.device))


def _hybrid_forward(params: Params, x: Tensor, cfg: ModelConfig,
                    backend: str) -> Tensor:
    """zamba2: the Mamba stack with the SHARED attention block after every
    ``hybrid_attn_every`` blocks."""
    k = cfg.hybrid_attn_every
    for i, p in enumerate(params["blocks"]):
        x = mamba_block(p, x, cfg, backend)
        if (i + 1) % k == 0:
            x = dense_block(params["shared_attn"], x, cfg, backend)
    return x


# ---------------------------------------------------------------------------
# decode: ONE new token against per-layer caches
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    """Per-layer recurrent state, one entry per layer (or per shared-block
    invocation)."""

    kv: Optional[List[attn.KVCache]]           # attention caches
    ssm: Optional[List[ssm_lib.SSMState]]      # mamba states
    shared_kv: Optional[List[attn.KVCache]]    # zamba shared-block caches


def init_decode_state(params: Params, cfg: ModelConfig, batch: int,
                      capacity: int, dtype=torch.bfloat16) -> DecodeState:
    """capacity = KV budget (the hybrid's shared caches hold at most the
    sliding window)."""
    check_arch(cfg)
    dev = params["embed"]["table"].device
    hd = cfg.head_dim_ if cfg.n_heads else 0
    kv = ssm = shared = None
    if cfg.arch_type in ("dense", "vlm"):
        kv = [attn.init_kv_cache(batch, capacity, cfg.n_kv_heads, hd, dtype,
                                 dev) for _ in range(cfg.n_layers)]
    else:
        ssm = [ssm_lib.init_ssm_state(batch, cfg.d_model, cfg.ssm,
                                      torch.float32, dev)
               for _ in range(cfg.n_layers)]
    if cfg.arch_type == "hybrid":
        cap = min(capacity, cfg.sliding_window or capacity)
        shared = [attn.init_kv_cache(batch, cap, cfg.n_kv_heads, hd, dtype,
                                     dev)
                  for _ in range(cfg.n_layers // cfg.hybrid_attn_every)]
    return DecodeState(kv=kv, ssm=ssm, shared_kv=shared)


def _dense_decode(p, x: Tensor, cache: attn.KVCache, cfg: ModelConfig):
    a, cache = attention_block_decode(p["attn"],
                                      L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                      cache, cfg, window=cfg.sliding_window)
    x = x + a
    x = x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.mlp)
    return x, cache


def _mamba_decode(p, x: Tensor, st: ssm_lib.SSMState, cfg: ModelConfig):
    y, st = ssm_lib.ssd_decode_step(p["mamba"],
                                    L.rmsnorm(p["ln"], x, cfg.norm_eps), st,
                                    cfg.d_model, cfg.ssm, cfg.norm_eps)
    return x + y, st


def decode_step(params: Params, state: DecodeState, token: Tensor,
                cfg: ModelConfig):
    """token: [B, 1] ids -> (logits [B, 1, V], new state).  KV caches are
    written in place (see ``attention.cache_update``)."""
    check_arch(cfg)
    x = L.embed(params["embed"], token)
    if cfg.arch_type in ("dense", "vlm"):
        kv = []
        for p, cache in zip(params["blocks"], state.kv):
            x, cache = _dense_decode(p, x, cache, cfg)
            kv.append(cache)
        state = state._replace(kv=kv)
    else:
        k = cfg.hybrid_attn_every
        ssm, shared = [], []
        for i, (p, st) in enumerate(zip(params["blocks"], state.ssm)):
            x, st = _mamba_decode(p, x, st, cfg)
            ssm.append(st)
            if cfg.arch_type == "hybrid" and (i + 1) % k == 0:
                x, cache = _dense_decode(params["shared_attn"], x,
                                         state.shared_kv[len(shared)], cfg)
                shared.append(cache)
        state = state._replace(ssm=ssm,
                               shared_kv=shared if shared else None)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(head, x), state
