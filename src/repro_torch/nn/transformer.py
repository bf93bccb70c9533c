"""Model assembly: embeddings -> blocks -> head (counterpart of
``repro.nn.transformer``) for all six families -- dense / vlm, moe, ssm,
hybrid (zamba2) and audio (whisper) --, prefill (``forward``) and one-token
decode (``decode_step``).

Parameters are an :class:`LM`: nested ``nn.ModuleDict``/``nn.ParameterDict``
keyed as the JAX package's parameter tree, with the stacked ``[L]`` axis of
``blocks`` (and whisper's ``enc_blocks``) unstacked into an
``nn.ModuleList`` (``blocks.3.mamba.w_z``);
:func:`repro_torch.convert.lm_params_from_numpy` carries a JAX tree across.
The zamba2 hybrid invokes one parameter-shared attention block
(``shared_attn``) after every ``hybrid_attn_every`` Mamba blocks.  The
mixture-of-experts blocks (``MoEBlock``, ``repro_torch.nn.moe``) add their
router losses to ``ForwardOut.moe_aux``.  Whisper runs a bidirectional
encoder over ``enc_input`` frame embeddings, then a causal decoder whose
blocks cross-attend to the encoder's output.

``backend=None`` follows the device: ``"cuda"`` runs the hand-written
kernels (``flash_attention`` in ``attention_block`` and
``cross_attention_block``, ``ssd_scan`` in ``apply_mamba2``), ``"einsum"``
their plain versions; ``"einsum"`` on a card only when named.
``decode_step`` takes the same rule: its one kernel call is whisper's cross
attention (one query against the cached encoder K/V); self-attention
against the KV caches and the Mamba2 step are plain.

One device, no sharding: ``forward(mesh=...)`` and ``apply_moe(mesh=...)``
raise (ROADMAP Queue 1 item 15).

Training: ``init_model(trainable=True)`` (and
``convert.lm_params_from_numpy(trainable=True)``) gives parameters that
require grad; serving keeps them frozen.  ``forward(remat=True)``, the
reference's default, wraps each block -- the dense / moe / Mamba stacks,
the hybrid's shared block, whisper's encoder and decoder blocks -- in
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` when grad is
enabled and the block's input requires it (``jax.checkpoint`` in the
reference): the block's activations are recomputed in the backward, and
the values and gradients are the bits of ``remat=False``.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import device as devmod
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attn
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as L
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import ssm as ssm_lib

Tensor = torch.Tensor
Params = Any          # an LM (or any tree of mappings with the same keys)

ARCH_TYPES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def check_arch(cfg: ModelConfig) -> None:
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
    o = _attend(backend)(q, k, v, causal=causal, window=window)
    return _out_proj(p, o, x)


def _attend(backend: str):
    return flash_attn.flash_attention if backend == "cuda" \
        else attn.attention_blockwise


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


def cross_attention_block(p, x: Tensor, enc_k: Tensor, enc_v: Tensor,
                          backend: Optional[str] = None) -> Tensor:
    """Decoder cross attention against the encoder's K/V (whisper):
    non-causal, Sq != Sk; the kernel on ``"cuda"``, in prefill and in
    decode (Sq = 1)."""
    backend = _backend(backend, x)
    bf = torch.bfloat16
    q = torch.einsum("bsd,dhk->bshk", x.to(bf), p["wq"].to(bf))
    o = _attend(backend)(q, enc_k, enc_v, causal=False)
    return _out_proj(p, o, x)


def encoder_kv(p, enc_out: Tensor) -> Tuple[Tensor, Tensor]:
    """A decoder layer's cross-attention K and V of the encoder output."""
    bf = torch.bfloat16
    eb = enc_out.to(bf)
    return tuple(torch.einsum("bsd,dhk->bshk", eb, p[w].to(bf))
                 for w in ("wk", "wv"))


# ---------------------------------------------------------------------------
# per-layer blocks
# ---------------------------------------------------------------------------


def dense_block(p, x: Tensor, cfg: ModelConfig,
                backend: Optional[str] = None) -> Tensor:
    h = attention_block(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                        window=cfg.sliding_window, backend=backend)
    x = x + h
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.mlp)


def moe_block(p, x: Tensor, cfg: ModelConfig, backend: Optional[str] = None
              ) -> Tuple[Tensor, moe_lib.MoEAux]:
    h = attention_block(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                        window=cfg.sliding_window, backend=backend)
    x = x + h
    y, aux = moe_lib.apply_moe(p["moe"], L.rmsnorm(p["ln2"], x, cfg.norm_eps),
                               cfg.moe)
    return x + y.to(x.dtype), aux


def encoder_block(p, x: Tensor, cfg: ModelConfig,
                  backend: Optional[str] = None) -> Tensor:
    """Whisper's encoder layer: bidirectional self-attention, then the
    MLP."""
    a = attention_block(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                        causal=False, backend=backend)
    x = x + a
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.mlp)


def decoder_block(p, x: Tensor, enc_out: Tensor, cfg: ModelConfig,
                  backend: Optional[str] = None) -> Tensor:
    """Whisper's decoder layer: causal self-attention, cross attention to
    ``enc_out``, then the MLP."""
    eps = cfg.norm_eps
    a = attention_block(p["attn"], L.rmsnorm(p["ln1"], x, eps), cfg,
                        causal=True, backend=backend)
    x = x + a
    ek, ev = encoder_kv(p["xattn"], enc_out)
    x = x + cross_attention_block(p["xattn"], L.rmsnorm(p["ln_x"], x, eps),
                                  ek, ev, backend)
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, eps), cfg.mlp)


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


class MoEBlock(_Block):
    """ln1 -> attention -> ln2 -> mixture of experts (keys ``ln1``,
    ``attn``, ``ln2``, ``moe``); returns (x, aux)."""

    def forward(self, x: Tensor, backend: Optional[str] = None):
        return moe_block(self, x, self.cfg, backend)


class EncoderBlock(_Block):
    """Whisper's encoder layer: a dense block's keys, non-causal."""

    def forward(self, x: Tensor, backend: Optional[str] = None) -> Tensor:
        return encoder_block(self, x, self.cfg, backend)


class DecoderBlock(_Block):
    """Whisper's decoder layer: a dense block's keys plus ``ln_x`` and
    ``xattn`` (cross attention)."""

    def forward(self, x: Tensor, enc_out: Tensor,
                backend: Optional[str] = None) -> Tensor:
        return decoder_block(self, x, enc_out, self.cfg, backend)


class MambaBlock(_Block):
    """ln -> Mamba2 (keys ``ln``, ``mamba``)."""

    def forward(self, x: Tensor, backend: Optional[str] = None) -> Tensor:
        return mamba_block(self, x, self.cfg, backend)


def _dense_groups(gen: torch.Generator, cfg: ModelConfig, dtype):
    return {"ln1": L.init_rmsnorm(cfg.d_model, gen.device, dtype),
            "attn": init_attention(gen, cfg, dtype),
            "ln2": L.init_rmsnorm(cfg.d_model, gen.device, dtype),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype)}


def init_dense_block(gen: torch.Generator, cfg: ModelConfig,
                     dtype=torch.float32) -> DenseBlock:
    return DenseBlock(cfg, _dense_groups(gen, cfg, dtype))


def init_moe_block(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32) -> MoEBlock:
    return MoEBlock(cfg, {
        "ln1": L.init_rmsnorm(cfg.d_model, gen.device, dtype),
        "attn": init_attention(gen, cfg, dtype),
        "ln2": L.init_rmsnorm(cfg.d_model, gen.device, dtype),
        "moe": moe_lib.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.moe, dtype)})


def init_encoder_block(gen: torch.Generator, cfg: ModelConfig,
                       dtype=torch.float32) -> EncoderBlock:
    return EncoderBlock(cfg, _dense_groups(gen, cfg, dtype))


def init_decoder_block(gen: torch.Generator, cfg: ModelConfig,
                       dtype=torch.float32) -> DecoderBlock:
    groups = _dense_groups(gen, cfg, dtype)
    groups["ln_x"] = L.init_rmsnorm(cfg.d_model, gen.device, dtype)
    groups["xattn"] = init_attention(gen, cfg, dtype)
    return DecoderBlock(cfg, groups)


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
    ``shared_attn`` (hybrid), ``enc_pos``, ``dec_pos`` and ``enc_blocks``
    (audio), ``final_norm`` and ``lm_head`` (unless the embeddings are
    tied).  Calling it runs :func:`forward`."""

    def __init__(self, cfg: ModelConfig, embed: Dict[str, Tensor],
                 blocks: List[nn.Module], final_norm: Dict[str, Tensor],
                 lm_head: Optional[Dict[str, Tensor]] = None,
                 shared_attn: Optional[DenseBlock] = None,
                 enc_pos: Optional[Dict[str, Tensor]] = None,
                 dec_pos: Optional[Dict[str, Tensor]] = None,
                 enc_blocks: Optional[List[EncoderBlock]] = None):
        mods = {"embed": L.param_dict(embed), "blocks": nn.ModuleList(blocks),
                "final_norm": L.param_dict(final_norm)}
        if shared_attn is not None:
            mods["shared_attn"] = shared_attn
        if lm_head is not None:
            mods["lm_head"] = L.param_dict(lm_head)
        if enc_blocks is not None:
            mods.update(enc_pos=L.param_dict(enc_pos),
                        dec_pos=L.param_dict(dec_pos),
                        enc_blocks=nn.ModuleList(enc_blocks))
        super().__init__(mods)
        self.cfg = cfg

    def forward(self, tokens: Tensor, backend: Optional[str] = None,
                enc_input: Optional[Tensor] = None,
                remat: bool = True) -> "ForwardOut":
        return forward(self, tokens, self.cfg, backend=backend,
                       enc_input=enc_input, remat=remat)


_BLOCK_INIT = {"dense": init_dense_block, "vlm": init_dense_block,
               "moe": init_moe_block, "ssm": init_mamba_block,
               "hybrid": init_mamba_block, "audio": init_decoder_block}


def init_model(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32, *, trainable: bool = False) -> LM:
    """Random weights from ``gen``, on ``gen``'s device; frozen unless
    ``trainable``."""
    check_arch(cfg)
    d = cfg.d_model
    embed = L.init_embedding(gen, cfg.vocab, d, dtype)
    blocks = [_BLOCK_INIT[cfg.arch_type](gen, cfg, dtype)
              for _ in range(cfg.n_layers)]
    shared = init_dense_block(gen, cfg, dtype) \
        if cfg.arch_type == "hybrid" else None
    audio = {}
    if cfg.arch_type == "audio":
        audio = dict(
            enc_pos=L.init_pos_embedding(gen, cfg.encoder.enc_len, d, dtype),
            dec_pos=L.init_pos_embedding(gen, 1 << 16, d, dtype),
            enc_blocks=[init_encoder_block(gen, cfg, dtype)
                        for _ in range(cfg.encoder.n_layers)])
    head = None if cfg.tie_embeddings else {
        "table": L.he_init(gen, (cfg.vocab, d), d, dtype)}
    return LM(cfg, embed, blocks, L.init_rmsnorm(d, gen.device, dtype),
              lm_head=head, shared_attn=shared, **audio
              ).requires_grad_(trainable)


def params_tree(params: LM) -> Dict[str, Any]:
    """The JAX package's parameter tree of ``params``: nested dicts of fp32
    numpy arrays on the host, the per-layer modules (``blocks``,
    ``enc_blocks``) stacked on a leading ``[L]`` axis -- the inverse of
    ``convert.lm_params_from_numpy``, and what ``train.checkpoint.save``
    writes for the reference's ``repro.train.checkpoint.load``."""
    def host(t):
        return t.detach().float().cpu().numpy()

    def group(mod):
        return {g: {k: host(v) for k, v in leaves.items()}
                for g, leaves in mod.items()}

    tree: Dict[str, Any] = {}
    for key, mod in params.items():
        if key in ("blocks", "enc_blocks"):
            layers = [group(b) for b in mod]
            tree[key] = {g: {k: np.stack([layer[g][k] for layer in layers])
                             for k in leaves}
                         for g, leaves in layers[0].items()}
        elif key == "shared_attn":
            tree[key] = group(mod)
        else:
            tree[key] = {k: host(v) for k, v in mod.items()}
    return tree


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


class ForwardOut(NamedTuple):
    logits: Tensor
    moe_aux: Tensor   # scalar: summed load-balance + z losses (0 if n/a)


def _run(block, remat: bool, p, x: Tensor, *rest):
    """``block(p, x, *rest)``, recomputed in the backward (checkpointed)
    when ``remat`` and grad is enabled and the block input ``x`` requires
    it."""
    if remat and torch.is_grad_enabled() and x.requires_grad:
        return checkpoint(block, p, x, *rest, use_reentrant=False)
    return block(p, x, *rest)


def forward(params: Params, tokens: Tensor, cfg: ModelConfig, *,
            backend: Optional[str] = None, mesh=None,
            enc_input: Optional[Tensor] = None,
            remat: bool = True) -> ForwardOut:
    """tokens: [B, S] integer ids -> logits [B, S, V] (fp32).  enc_input:
    [B, enc_len, d] frame embeddings (audio).  ``remat``: module
    docstring."""
    check_arch(cfg)
    if mesh is not None:
        raise NotImplementedError("forward(mesh=...): the port runs on one "
                                  "device (sharding is ROADMAP Queue 1 "
                                  "item 15)")
    x = L.embed(params["embed"], tokens)
    backend = _backend(backend, x)
    aux = torch.zeros((), device=x.device)
    if cfg.arch_type == "hybrid":
        x = _hybrid_forward(params, x, cfg, backend, remat)
    elif cfg.arch_type == "moe":
        lb, z = [], []
        for p in params["blocks"]:
            x, a = _run(moe_block, remat, p, x, cfg, backend)
            lb.append(a.load_balance)
            z.append(a.router_z)
        aux = torch.stack(lb).sum() + (0.001 * torch.stack(z)).sum()
    elif cfg.arch_type == "audio":
        x = _audio_forward(params, x, cfg, enc_input, backend, remat)
    else:
        block = dense_block if cfg.arch_type in ("dense", "vlm") \
            else mamba_block
        for p in params["blocks"]:
            x = _run(block, remat, p, x, cfg, backend)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return ForwardOut(logits=L.unembed(head, x), moe_aux=aux)


def _hybrid_forward(params: Params, x: Tensor, cfg: ModelConfig,
                    backend: str, remat: bool = False) -> Tensor:
    """zamba2: the Mamba stack with the SHARED attention block after every
    ``hybrid_attn_every`` blocks."""
    k = cfg.hybrid_attn_every
    for i, p in enumerate(params["blocks"]):
        x = _run(mamba_block, remat, p, x, cfg, backend)
        if (i + 1) % k == 0:
            x = _run(dense_block, remat, params["shared_attn"], x, cfg,
                     backend)
    return x


def encode(params: Params, enc_input: Optional[Tensor], cfg: ModelConfig,
           backend: Optional[str] = None, remat: bool = False) -> Tensor:
    """Whisper's encoder: ``enc_input`` [B, enc_len, d] frame embeddings (in
    bf16) plus the learned positions through the bidirectional blocks."""
    if enc_input is None:
        raise ValueError(f"{cfg.name}: the audio family needs enc_input, "
                         f"[B, enc_len, d] frame embeddings")
    e = L.add_pos(params["enc_pos"], enc_input.to(torch.bfloat16))
    for p in params["enc_blocks"]:
        e = _run(encoder_block, remat, p, e, cfg, backend)
    return e


def _audio_forward(params: Params, x: Tensor, cfg: ModelConfig,
                   enc_input: Optional[Tensor], backend: str,
                   remat: bool = False) -> Tensor:
    """whisper: the encoder over ``enc_input``, then the causal decoder with
    cross attention (decoder positions 0..S-1)."""
    e = encode(params, enc_input, cfg, backend, remat)
    x = L.add_pos(params["dec_pos"], x)
    for p in params["blocks"]:
        x = _run(decoder_block, remat, p, x, e, cfg, backend)
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
    enc_kv: Optional[List[Tuple[Tensor, Tensor]]] = None   # whisper cross K/V


def init_decode_state(params: Params, cfg: ModelConfig, batch: int,
                      capacity: int, dtype=torch.bfloat16, *,
                      enc_input: Optional[Tensor] = None,
                      backend: Optional[str] = None) -> DecodeState:
    """capacity = KV budget (the hybrid's shared caches hold at most the
    sliding window).  Audio: the encoder runs once over ``enc_input`` (on
    ``backend``, as in :func:`forward`) and each decoder layer's cross K/V
    is cached; without ``enc_input`` it raises ``ValueError``."""
    check_arch(cfg)
    dev = params["embed"]["table"].device
    hd = cfg.head_dim_ if cfg.n_heads else 0
    kv = ssm = shared = enc_kv = None
    if cfg.arch_type in ("dense", "vlm", "moe", "audio"):
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
    if cfg.arch_type == "audio":
        if enc_input is not None:
            backend = _backend(backend, enc_input)
        e = encode(params, enc_input, cfg, backend)
        enc_kv = [encoder_kv(p["xattn"], e) for p in params["blocks"]]
    return DecodeState(kv=kv, ssm=ssm, shared_kv=shared, enc_kv=enc_kv)


def _dense_decode(p, x: Tensor, cache: attn.KVCache, cfg: ModelConfig):
    a, cache = attention_block_decode(p["attn"],
                                      L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                      cache, cfg, window=cfg.sliding_window)
    x = x + a
    hn = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.arch_type == "moe":
        y, _ = moe_lib.apply_moe(p["moe"], hn, cfg.moe)
        return x + y.to(x.dtype), cache
    return x + L.mlp(p["mlp"], hn, cfg.mlp), cache


def _decoder_decode(p, x: Tensor, cache: attn.KVCache, ek: Tensor,
                    ev: Tensor, cfg: ModelConfig, backend: str):
    eps = cfg.norm_eps
    a, cache = attention_block_decode(p["attn"], L.rmsnorm(p["ln1"], x, eps),
                                      cache, cfg)
    x = x + a
    x = x + cross_attention_block(p["xattn"], L.rmsnorm(p["ln_x"], x, eps),
                                  ek, ev, backend)
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, eps), cfg.mlp), cache


def _mamba_decode(p, x: Tensor, st: ssm_lib.SSMState, cfg: ModelConfig):
    y, st = ssm_lib.ssd_decode_step(p["mamba"],
                                    L.rmsnorm(p["ln"], x, cfg.norm_eps), st,
                                    cfg.d_model, cfg.ssm, cfg.norm_eps)
    return x + y, st


def decode_step(params: Params, state: DecodeState, token: Tensor,
                cfg: ModelConfig, backend: Optional[str] = None):
    """token: [B, 1] ids -> (logits [B, 1, V], new state).  KV caches are
    written in place (see ``attention.cache_update``).  Whisper adds decoder
    position row 0 at every step, as the JAX package's decode does (its
    ``forward`` adds rows 0..S-1)."""
    check_arch(cfg)
    x = L.embed(params["embed"], token)
    backend = _backend(backend, x)
    if cfg.arch_type in ("dense", "vlm", "moe"):
        kv = []
        for p, cache in zip(params["blocks"], state.kv):
            x, cache = _dense_decode(p, x, cache, cfg)
            kv.append(cache)
        state = state._replace(kv=kv)
    elif cfg.arch_type == "audio":
        x = L.add_pos(params["dec_pos"], x, 0)
        kv = []
        for p, cache, (ek, ev) in zip(params["blocks"], state.kv,
                                      state.enc_kv):
            x, cache = _decoder_decode(p, x, cache, ek, ev, cfg, backend)
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
