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

Mesh paths: ``forward``, ``init_decode_state`` and ``decode_step`` take a
:class:`Shardings` (``sh``) over a ``torch.distributed`` ``DeviceMesh``
with dims ``("data", "model")``; one process a rank, explicit SPMD (the
reference lets GSPMD place the collectives behind its pins; the port calls
``repro_torch.sharding.collectives`` where GSPMD would insert them).  The
parameters are this rank's blocks under ``sharding.param_specs``
(``sharding.shard_params`` / ``sharding.init_sharded``); every rank passes
the same global tokens and computes on its block of rows over the data
axes (all rows when the batch does not divide).  A block gathers its FSDP
weights on entry (again in the recomputation under remat); attention runs
this rank's q heads against the kv heads they read, the MLP its ff slice,
Mamba2 its heads, mixture-of-experts its experts, the head its vocabulary
columns.  ``forward`` returns this rank's block of the logits (rows of its
data shard, columns of its vocabulary shard; :func:`gather_logits` makes
them whole); ``decode_step`` returns every row and column, with the KV
caches' sequence split over ``model`` (``attention.attention_decode_ctx_
parallel``).  ``Shardings(attn_seq_shard=True)`` -- the q heads do not
divide over ``model``, so ``fix_spec`` replicates ``wq`` and ``wo`` --
splits full-sequence attention over the sequence instead (context
parallel): model rank r computes q for its block of S / m positions, k
and v over the whole sequence, ``flash_attention(q_offset=r S / m)``, its
block through ``wo``, and the blocks are gathered over ``model``
(:func:`attention_block`).

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

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import device as devmod
from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attn
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as L
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import ssm as ssm_lib
from repro_torch.sharding import collectives as C

Tensor = torch.Tensor
Params = Any          # an LM (or any tree of mappings with the same keys)

ARCH_TYPES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def check_arch(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ARCH_TYPES:
        raise ValueError(f"unknown arch type {cfg.arch_type!r}")


def _backend(backend: Optional[str], x: Tensor) -> str:
    return devmod.check_backend(backend or devmod.default_backend(x.device),
                                x.device)


@dataclasses.dataclass(frozen=True, eq=False)
class Shardings:
    """Mesh context of the mesh paths; ``mesh=None`` runs on one device.

    ``mesh``: a ``DeviceMesh`` naming ``data_axes`` and ``model_axis``.
    ``model_axis`` in ``data_axes`` is pure FSDP (``train_fsdp``: tokens
    over every rank, no tensor parallelism).  The weights' layout decides
    which heads a rank runs (the reference's ``shard_heads`` pins only its
    activations), and decode always splits the cache's sequence over
    ``model``.  ``attn_seq_shard``: full-sequence attention split over the
    sequence on ``model`` (the q heads do not divide over it; the attention
    weights must be replicated there).  ``moe_ep``: expert parallel mixture
    of experts (False
    under pure FSDP: the experts are gathered and the dispatch is the
    global batch's; ``moe_layer`` refuses it there)."""

    mesh: Any = None
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    attn_seq_shard: bool = False
    moe_ep: bool = True


NO_SHARD = Shardings(mesh=None)


def _seq_shard(p, S: int, sh: Shardings) -> bool:
    """Whether full-sequence attention takes the context-parallel route
    (``sh.attn_seq_shard`` on a model axis of more than one rank); raises
    where it cannot: head-split attention weights, or a sequence that
    does not divide over the model axis."""
    m = C.tp_size(sh)
    if not sh.attn_seq_shard or m == 1:
        return False
    split = [w for w, d in (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0))
             if C.tp_split(p[w], d, sh)]
    if split:
        raise ValueError(
            f"Shardings(attn_seq_shard=True) splits attention over the "
            f"sequence, so every model rank needs the whole attention "
            f"weights; {split} are split by head over {sh.model_axis!r} (the "
            f"route is for q heads that do not divide over it, whose "
            f"weights fix_spec replicates)")
    if S % m:
        raise ValueError(f"Shardings(attn_seq_shard=True): a sequence of {S} "
                         f"positions does not split over {m} model ranks")
    return True


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


def _qkv(p, x: Tensor, sh: Shardings = NO_SHARD):
    """q, k, v of x; on head-split weights q holds this rank's heads and
    x, k and v enter the split region through ``copy_to_model``."""
    bf = torch.bfloat16
    xb = x.to(bf)
    if not C.tp_split(p["wq"], 1, sh):
        return tuple(torch.einsum("bsd,dhk->bshk", xb, p[w].to(bf))
                     for w in ("wq", "wk", "wv"))
    q = torch.einsum("bsd,dhk->bshk", C.copy_to_model(xb, sh),
                     p["wq"].to(bf))
    k, v = (C.copy_to_model(torch.einsum("bsd,dhk->bshk", xb, p[w].to(bf)),
                            sh) for w in ("wk", "wv"))
    return q, k, v


def _local_kv(q: Tensor, k: Tensor, v: Tensor, sh: Shardings):
    """The kv heads this rank's q heads read.  Global q head g reads kv head
    g % Hkv; on model rank j, local head i is g = j Hq_loc + i: with Hq_loc
    a multiple of Hkv every kv head is read as i % Hkv, and with Hkv a
    multiple of Hq_loc (zamba2's and whisper's Hq = Hkv) the slice from
    (j Hq_loc) % Hkv; any other split would read the wrong kv head."""
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hq % Hkv == 0:
        return k, v
    if Hkv % Hq:
        raise ValueError(f"{Hq} q heads a rank and {Hkv} kv heads: a rank's "
                         f"heads read kv heads h % {Hkv} of no one slice")
    o = (C.tp_rank(sh) * Hq) % Hkv
    return k[:, :, o:o + Hq], v[:, :, o:o + Hq]


def _out_proj(p, o: Tensor, like: Tensor, sh: Shardings = NO_SHARD
              ) -> Tensor:
    bf = torch.bfloat16
    out = torch.einsum("bshk,hkd->bsd", o.to(bf), p["wo"].to(bf))
    if C.tp_split(p["wo"], 0, sh):     # partial sums over the heads, in bf16
        out = C.reduce_from_model(out, sh)
    return out.to(like.dtype)


def attention_block(p, x: Tensor, cfg: ModelConfig, *, causal: bool = True,
                    positions: Optional[Tensor] = None,
                    window: Optional[int] = None,
                    backend: Optional[str] = None,
                    sh: Shardings = NO_SHARD) -> Tensor:
    """Full-sequence attention (prefill). x: [B, S, d].  With
    ``sh.attn_seq_shard`` on a model axis of m > 1 ranks, context parallel
    (:func:`_attention_seq_shard`)."""
    backend = _backend(backend, x)
    S = x.shape[1]
    if _seq_shard(p, S, sh):
        return _attention_seq_shard(p, x, cfg, causal, positions, window,
                                    backend, sh)
    q, k, v = _qkv(p, x, sh)
    if cfg.rope_theta:
        pos = positions if positions is not None else \
            torch.arange(S, device=x.device)[None]
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    k, v = _local_kv(q, k, v, sh)
    o = _attend(backend)(q, k, v, causal=causal, window=window)
    return _out_proj(p, o, x, sh)


def _attention_seq_shard(p, x: Tensor, cfg: ModelConfig, causal: bool,
                         positions: Optional[Tensor], window: Optional[int],
                         backend: str, sh: Shardings) -> Tensor:
    """Attention split over the sequence on ``model``: rank r's q for its
    block of n = S / m positions (RoPE at r n .. r n + n - 1) against k and v
    of the whole sequence, ``q_offset = r n``, its block through ``wo``, the
    blocks gathered over ``model``.  The weights are replicated over
    ``model`` but each rank's gradient covers its block alone, so ``wq``,
    ``wo``, k and v enter through ``copy_to_model`` (their gradients summed
    over ``model``: ``wk``'s and ``wv``'s through k's and v's); x's block
    enters through ``split_to_model`` (the blocks' gradients gathered)."""
    bf = torch.bfloat16
    S = x.shape[1]
    n = S // C.tp_size(sh)
    off = C.tp_rank(sh) * n
    xb = x.to(bf)
    wq, wo = (C.copy_to_model(p[w], sh).to(bf) for w in ("wq", "wo"))
    q = torch.einsum("bsd,dhk->bshk", C.split_to_model(xb, 1, sh), wq)
    k, v = (C.copy_to_model(torch.einsum("bsd,dhk->bshk", xb, p[w].to(bf)),
                            sh) for w in ("wk", "wv"))
    if cfg.rope_theta:
        pos = positions if positions is not None else \
            torch.arange(S, device=x.device)[None]
        q = L.apply_rope(q, pos[:, off:off + n], cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    o = _attend(backend)(q, k, v, causal=causal, window=window, q_offset=off)
    out = torch.einsum("bshk,hkd->bsd", o.to(bf), wo)
    return C.gather_from_model(out, 1, sh).to(x.dtype)


def _attend(backend: str):
    return flash_attn.flash_attention if backend == "cuda" \
        else attn.attention_blockwise


def attention_block_decode(p, x: Tensor, cache: attn.KVCache,
                           cfg: ModelConfig, window: Optional[int] = None,
                           sh: Shardings = NO_SHARD):
    """One-token decode. x: [B, 1, d] -> (out, cache written in place).
    On a model axis of more than one rank the cache holds this rank's
    slice of the ring (context parallel): the q heads are gathered whole,
    the combined output split by head again for ``wo``."""
    q, k, v = _qkv(p, x, sh)
    if cfg.rope_theta:
        pos = torch.full((1, 1), cache.length, device=x.device)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    k, v = k.to(cache.k.dtype), v.to(cache.v.dtype)
    if C.tp_size(sh) == 1:
        cache = attn.cache_update(cache, k, v)
        return _out_proj(p, attn.attention_decode(q, cache, window=window),
                         x, sh), cache
    heads = C.tp_split(p["wq"], 1, sh)
    n = q.shape[2]
    if heads:
        q = C.gather_dim(q, 2, sh.mesh, (sh.model_axis,))
    cache = attn.cache_update_ctx_parallel(cache, k, v, sh)
    o = attn.attention_decode_ctx_parallel(q, cache, sh, window=window)
    if heads:
        o = o[:, :, C.tp_rank(sh) * n:(C.tp_rank(sh) + 1) * n]
    return _out_proj(p, o, x, sh), cache


def cross_attention_block(p, x: Tensor, enc_k: Tensor, enc_v: Tensor,
                          backend: Optional[str] = None,
                          sh: Shardings = NO_SHARD) -> Tensor:
    """Decoder cross attention against the encoder's K/V (whisper):
    non-causal, Sq != Sk; the kernel on ``"cuda"``, in prefill and in
    decode (Sq = 1)."""
    backend = _backend(backend, x)
    bf = torch.bfloat16
    xb = x.to(bf)
    if C.tp_split(p["wq"], 1, sh):
        xb, enc_k, enc_v = (C.copy_to_model(t, sh) for t in (xb, enc_k,
                                                              enc_v))
    q = torch.einsum("bsd,dhk->bshk", xb, p["wq"].to(bf))
    enc_k, enc_v = _local_kv(q, enc_k, enc_v, sh)
    o = _attend(backend)(q, enc_k, enc_v, causal=False)
    return _out_proj(p, o, x, sh)


def encoder_kv(p, enc_out: Tensor) -> Tuple[Tensor, Tensor]:
    """A decoder layer's cross-attention K and V of the encoder output."""
    bf = torch.bfloat16
    eb = enc_out.to(bf)
    return tuple(torch.einsum("bsd,dhk->bshk", eb, p[w].to(bf))
                 for w in ("wk", "wv"))


# ---------------------------------------------------------------------------
# per-layer blocks
# ---------------------------------------------------------------------------


# Each block gathers its FSDP-split weights first (``gather_fsdp``: a no-op
# without a mesh or when no weight of the block is split over data).


def dense_block(p, x: Tensor, cfg: ModelConfig,
                backend: Optional[str] = None,
                sh: Shardings = NO_SHARD) -> Tensor:
    p = C.gather_fsdp(p, sh)
    with obs.span("lm.attn"):
        x = x + attention_block(p["attn"], L.rmsnorm(p["ln1"], x,
                                                     cfg.norm_eps), cfg,
                                window=cfg.sliding_window, backend=backend,
                                sh=sh)
    with obs.span("lm.mlp"):
        return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps),
                         cfg.mlp, sh)


def moe_block(p, x: Tensor, cfg: ModelConfig, backend: Optional[str] = None,
              sh: Shardings = NO_SHARD) -> Tuple[Tensor, moe_lib.MoEAux]:
    p = C.gather_fsdp(p, sh)
    h = attention_block(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                        window=cfg.sliding_window, backend=backend, sh=sh)
    x = x + h
    y, aux = moe_lib.moe_layer(p["moe"],
                               L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.moe,
                               sh)
    return x + y.to(x.dtype), aux


def encoder_block(p, x: Tensor, cfg: ModelConfig,
                  backend: Optional[str] = None,
                  sh: Shardings = NO_SHARD) -> Tensor:
    """Whisper's encoder layer: bidirectional self-attention, then the
    MLP."""
    p = C.gather_fsdp(p, sh)
    a = attention_block(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                        causal=False, backend=backend, sh=sh)
    x = x + a
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.mlp,
                     sh)


def decoder_block(p, x: Tensor, enc_out: Tensor, cfg: ModelConfig,
                  backend: Optional[str] = None,
                  sh: Shardings = NO_SHARD) -> Tensor:
    """Whisper's decoder layer: causal self-attention, cross attention to
    ``enc_out``, then the MLP."""
    p = C.gather_fsdp(p, sh)
    eps = cfg.norm_eps
    a = attention_block(p["attn"], L.rmsnorm(p["ln1"], x, eps), cfg,
                        causal=True, backend=backend, sh=sh)
    x = x + a
    ek, ev = encoder_kv(p["xattn"], enc_out)
    x = x + cross_attention_block(p["xattn"], L.rmsnorm(p["ln_x"], x, eps),
                                  ek, ev, backend, sh)
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, eps), cfg.mlp, sh)


def mamba_block(p, x: Tensor, cfg: ModelConfig,
                backend: Optional[str] = None,
                sh: Shardings = NO_SHARD) -> Tensor:
    p = C.gather_fsdp(p, sh)
    return x + ssm_lib.apply_mamba2(p["mamba"],
                                    L.rmsnorm(p["ln"], x, cfg.norm_eps),
                                    cfg.d_model, cfg.ssm, cfg.norm_eps,
                                    backend=backend, sh=sh)


class _Block(nn.ModuleDict):
    """A layer's parameter groups (``nn.ParameterDict`` each, frozen)."""

    def __init__(self, cfg: ModelConfig, groups: Dict[str, Dict[str, Tensor]]):
        super().__init__({k: L.param_dict(v) for k, v in groups.items()})
        self.cfg = cfg


class DenseBlock(_Block):
    """ln1 -> attention -> ln2 -> MLP (keys ``ln1``, ``attn``, ``ln2``,
    ``mlp``)."""

    def forward(self, x: Tensor, backend: Optional[str] = None,
                sh: Shardings = NO_SHARD) -> Tensor:
        return dense_block(self, x, self.cfg, backend, sh)


class MoEBlock(_Block):
    """ln1 -> attention -> ln2 -> mixture of experts (keys ``ln1``,
    ``attn``, ``ln2``, ``moe``); returns (x, aux)."""

    def forward(self, x: Tensor, backend: Optional[str] = None,
                sh: Shardings = NO_SHARD):
        return moe_block(self, x, self.cfg, backend, sh)


class EncoderBlock(_Block):
    """Whisper's encoder layer: a dense block's keys, non-causal."""

    def forward(self, x: Tensor, backend: Optional[str] = None,
                sh: Shardings = NO_SHARD) -> Tensor:
        return encoder_block(self, x, self.cfg, backend, sh)


class DecoderBlock(_Block):
    """Whisper's decoder layer: a dense block's keys plus ``ln_x`` and
    ``xattn`` (cross attention)."""

    def forward(self, x: Tensor, enc_out: Tensor,
                backend: Optional[str] = None,
                sh: Shardings = NO_SHARD) -> Tensor:
        return decoder_block(self, x, enc_out, self.cfg, backend, sh)


class MambaBlock(_Block):
    """ln -> Mamba2 (keys ``ln``, ``mamba``)."""

    def forward(self, x: Tensor, backend: Optional[str] = None,
                sh: Shardings = NO_SHARD) -> Tensor:
        return mamba_block(self, x, self.cfg, backend, sh)


def _dense_groups(gen: torch.Generator, cfg: ModelConfig, dtype):
    return {"ln1": L.init_rmsnorm(cfg.d_model, gen.device, dtype),
            "attn": init_attention(gen, cfg, dtype),
            "ln2": L.init_rmsnorm(cfg.d_model, gen.device, dtype),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype)}


def init_dense_block(gen: torch.Generator, cfg: ModelConfig,
                     dtype=torch.float32) -> DenseBlock:
    return DenseBlock(cfg, _dense_groups(gen, cfg, dtype))


def init_moe_block(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32, ep_shards: int = 1) -> MoEBlock:
    return MoEBlock(cfg, {
        "ln1": L.init_rmsnorm(cfg.d_model, gen.device, dtype),
        "attn": init_attention(gen, cfg, dtype),
        "ln2": L.init_rmsnorm(cfg.d_model, gen.device, dtype),
        "moe": moe_lib.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.moe, dtype,
                                ep_shards)})


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
                remat: bool = True, sh: Shardings = NO_SHARD
                ) -> "ForwardOut":
        return forward(self, tokens, self.cfg, sh, backend=backend,
                       enc_input=enc_input, remat=remat)


_BLOCK_INIT = {"dense": init_dense_block, "vlm": init_dense_block,
               "moe": init_moe_block, "ssm": init_mamba_block,
               "hybrid": init_mamba_block, "audio": init_decoder_block}


def _placed(mod: nn.Module, prefix: str, place) -> nn.Module:
    """``mod`` with each parameter replaced by ``place(name, tensor)``."""
    if place is not None:
        for name, t in list(mod.named_parameters()):
            group, leaf = name.rsplit(".", 1)
            mod.get_submodule(group)[leaf] = nn.Parameter(
                place(f"{prefix}.{name}", t.data), requires_grad=False)
    return mod


def _placed_dict(d: Dict[str, Tensor], prefix: str, place):
    if place is None:
        return d
    return {k: place(f"{prefix}.{k}", v) for k, v in d.items()}


def init_model(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32, *, trainable: bool = False,
               ep_shards: int = 1,
               place: Optional[Callable[[str, Tensor], Tensor]] = None
               ) -> LM:
    """Random weights from ``gen``, on ``gen``'s device; frozen unless
    ``trainable``.  ``ep_shards``: the experts' EP layout (the same draws at
    every value).  ``place(name, tensor)``, if given, replaces each
    parameter as soon as its layer is drawn (``sharding.init_sharded``
    keeps this rank's block, so the whole model is never held at once);
    ``gen`` may be ``layers.META_GEN`` (shapes alone)."""
    check_arch(cfg)
    d = cfg.d_model
    embed = _placed_dict(L.init_embedding(gen, cfg.vocab, d, dtype), "embed",
                         place)
    init = _BLOCK_INIT[cfg.arch_type]
    kw = {"ep_shards": ep_shards} if cfg.arch_type == "moe" else {}
    blocks = [_placed(init(gen, cfg, dtype, **kw), f"blocks.{i}", place)
              for i in range(cfg.n_layers)]
    shared = _placed(init_dense_block(gen, cfg, dtype), "shared_attn", place) \
        if cfg.arch_type == "hybrid" else None
    audio = {}
    if cfg.arch_type == "audio":
        audio = dict(
            enc_pos=_placed_dict(L.init_pos_embedding(
                gen, cfg.encoder.enc_len, d, dtype), "enc_pos", place),
            dec_pos=_placed_dict(L.init_pos_embedding(gen, 1 << 16, d, dtype),
                                 "dec_pos", place),
            enc_blocks=[_placed(init_encoder_block(gen, cfg, dtype),
                                f"enc_blocks.{i}", place)
                        for i in range(cfg.encoder.n_layers)])
    head = None if cfg.tie_embeddings else _placed_dict(
        {"table": L.he_init(gen, (cfg.vocab, d), d, dtype)}, "lm_head", place)
    return LM(cfg, embed, blocks,
              _placed_dict(L.init_rmsnorm(d, gen.device, dtype), "final_norm",
                           place),
              lm_head=head, shared_attn=shared, **audio
              ).requires_grad_(trainable)


def with_ep_shards(params: LM, s: int) -> LM:
    """``params`` with each layer's experts relaid, in place, to the EP
    layout of ``s`` shards (``moe.relayout``); other families as they
    are."""
    if params.cfg.arch_type == "moe":
        for blk in params["blocks"]:
            moe = blk["moe"]
            new = moe_lib.relayout(dict(moe.items()), params.cfg.moe.n_experts,
                                   s)
            for k in ("w_gate", "w_up", "w_down"):
                moe[k] = nn.Parameter(new[k].detach(),
                                      requires_grad=moe[k].requires_grad)
    return params


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


def _run(block, remat: bool, p, x: Tensor, *rest, **attrs):
    """``block(p, x, *rest)``, recomputed in the backward (checkpointed)
    when ``remat`` and grad is enabled and the block input ``x`` requires
    it; an ``lm.block`` span, its backward (the recomputation included) an
    ``lm.block.backward`` span, both with ``attrs`` (the block's index)."""
    with obs.span("lm.block", **attrs):
        bw = obs.backward_span("lm.block.backward", x, **attrs)
        x = bw.closes(x)
        if remat and torch.is_grad_enabled() and x.requires_grad:
            out = checkpoint(block, p, x, *rest, use_reentrant=False)
        else:
            out = block(p, x, *rest)
        if isinstance(out, tuple):              # a mixture's (x, aux)
            return (bw.opens(out[0]), *out[1:])
        return bw.opens(out)


def _head(params: Params, cfg: ModelConfig, sh: Shardings):
    return C.gather_fsdp(params["embed"] if cfg.tie_embeddings
                         else params["lm_head"], sh)


def forward(params: Params, tokens: Tensor, cfg: ModelConfig,
            sh: Shardings = NO_SHARD, *, backend: Optional[str] = None,
            enc_input: Optional[Tensor] = None,
            remat: bool = True) -> ForwardOut:
    """tokens: [B, S] integer ids -> logits [B, S, V] (fp32).  enc_input:
    [B, enc_len, d] frame embeddings (audio).  ``remat``: module
    docstring.  ``sh``: every rank passes the same tokens; the logits are
    this rank's block (module docstring).  Spans: ``lm.forward``, in it
    ``lm.embed``, the blocks' (:func:`_run`) and ``lm.head`` (the final
    norm and the unembedding; its backward ``lm.head.backward``)."""
    check_arch(cfg)
    with obs.span("lm.forward"):
        tokens = C.data_block(tokens, sh)
        if enc_input is not None:
            enc_input = C.data_block(enc_input, sh)
        with obs.span("lm.embed"):
            x = L.embed(C.gather_fsdp(params["embed"], sh), tokens, sh=sh)
        backend = _backend(backend, x)
        aux = torch.zeros((), device=x.device)
        if cfg.arch_type == "hybrid":
            x = _hybrid_forward(params, x, cfg, backend, remat, sh)
        elif cfg.arch_type == "moe":
            lb, z = [], []
            for i, p in enumerate(params["blocks"]):
                x, a = _run(moe_block, remat, p, x, cfg, backend, sh,
                            index=i)
                lb.append(a.load_balance)
                z.append(a.router_z)
            aux = torch.stack(lb).sum() + (0.001 * torch.stack(z)).sum()
        elif cfg.arch_type == "audio":
            x = _audio_forward(params, x, cfg, enc_input, backend, remat, sh)
        else:
            block = dense_block if cfg.arch_type in ("dense", "vlm") \
                else mamba_block
            for i, p in enumerate(params["blocks"]):
                x = _run(block, remat, p, x, cfg, backend, sh, index=i)
        bw = obs.backward_span("lm.head.backward", x)
        x = bw.closes(x)
        with obs.span("lm.head"):
            x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
            logits = L.unembed(_head(params, cfg, sh), x, sh)
        return ForwardOut(logits=bw.opens(logits), moe_aux=aux)


def gather_logits(params: Params, logits: Tensor, cfg: ModelConfig,
                  sh: Shardings, batch: int) -> Tensor:
    """The whole [batch, ..., V] logits from every rank's block of them
    (``forward``'s under ``sh``; ``batch`` the global rows)."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if C.tp_split(head["table"], 0, sh):
        logits = C.gather_dim(logits, logits.dim() - 1, sh.mesh,
                              (sh.model_axis,))
    if C.batch_split(batch, sh):
        logits = C.gather_dim(logits, 0, sh.mesh, tuple(sh.data_axes))
    return logits


def _hybrid_forward(params: Params, x: Tensor, cfg: ModelConfig,
                    backend: str, remat: bool = False,
                    sh: Shardings = NO_SHARD) -> Tensor:
    """zamba2: the Mamba stack with the SHARED attention block after every
    ``hybrid_attn_every`` blocks."""
    k = cfg.hybrid_attn_every
    for i, p in enumerate(params["blocks"]):
        x = _run(mamba_block, remat, p, x, cfg, backend, sh)
        if (i + 1) % k == 0:
            x = _run(dense_block, remat, params["shared_attn"], x, cfg,
                     backend, sh)
    return x


def encode(params: Params, enc_input: Optional[Tensor], cfg: ModelConfig,
           backend: Optional[str] = None, remat: bool = False,
           sh: Shardings = NO_SHARD) -> Tensor:
    """Whisper's encoder: ``enc_input`` [B, enc_len, d] frame embeddings (in
    bf16) plus the learned positions through the bidirectional blocks."""
    if enc_input is None:
        raise ValueError(f"{cfg.name}: the audio family needs enc_input, "
                         f"[B, enc_len, d] frame embeddings")
    e = L.add_pos(C.gather_fsdp(params["enc_pos"], sh),
                  enc_input.to(torch.bfloat16))
    for p in params["enc_blocks"]:
        e = _run(encoder_block, remat, p, e, cfg, backend, sh)
    return e


def _audio_forward(params: Params, x: Tensor, cfg: ModelConfig,
                   enc_input: Optional[Tensor], backend: str,
                   remat: bool = False, sh: Shardings = NO_SHARD) -> Tensor:
    """whisper: the encoder over ``enc_input``, then the causal decoder with
    cross attention (decoder positions 0..S-1)."""
    e = encode(params, enc_input, cfg, backend, remat, sh)
    x = L.add_pos(C.gather_fsdp(params["dec_pos"], sh), x)
    for p in params["blocks"]:
        x = _run(decoder_block, remat, p, x, e, cfg, backend, sh)
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
                      backend: Optional[str] = None,
                      sh: Shardings = NO_SHARD) -> DecodeState:
    """capacity = KV budget (the hybrid's shared caches hold at most the
    sliding window).  Audio: the encoder runs once over ``enc_input`` (on
    ``backend``, as in :func:`forward`) and each decoder layer's cross K/V
    is cached; without ``enc_input`` it raises ``ValueError``.  ``sh``:
    this rank's rows of the batch, its C / s slots of each ring (the
    capacity must divide by the model size) and its heads of each SSM
    state (``sharding.decode_state_specs``)."""
    check_arch(cfg)
    dev = params["embed"]["table"].device
    hd = cfg.head_dim_ if cfg.n_heads else 0
    s = C.tp_size(sh)
    rows = batch // C.data_size(sh) if C.batch_split(batch, sh) else batch

    def slots(cap):
        if cap % s:
            raise ValueError(f"a KV capacity of {cap} does not split over "
                             f"{s} model ranks")
        return cap // s

    kv = ssm = shared = enc_kv = None
    if cfg.arch_type in ("dense", "vlm", "moe", "audio"):
        kv = [attn.init_kv_cache(rows, slots(capacity), cfg.n_kv_heads, hd,
                                 dtype, dev) for _ in range(cfg.n_layers)]
    else:
        split = s if C.tp_split(params["blocks"][0]["mamba"]["w_x"], 1,
                                sh) else 1
        ssm = [ssm_lib.init_ssm_state(rows, cfg.d_model, cfg.ssm,
                                      torch.float32, dev, split)
               for _ in range(cfg.n_layers)]
    if cfg.arch_type == "hybrid":
        cap = min(capacity, cfg.sliding_window or capacity)
        shared = [attn.init_kv_cache(rows, slots(cap), cfg.n_kv_heads, hd,
                                     dtype, dev)
                  for _ in range(cfg.n_layers // cfg.hybrid_attn_every)]
    if cfg.arch_type == "audio":
        if enc_input is not None:
            backend = _backend(backend, enc_input)
            enc_input = C.data_block(enc_input, sh)
        e = encode(params, enc_input, cfg, backend, sh=sh)
        enc_kv = [encoder_kv(C.gather_fsdp(p["xattn"], sh), e)
                  for p in params["blocks"]]
    return DecodeState(kv=kv, ssm=ssm, shared_kv=shared, enc_kv=enc_kv)


def _dense_decode(p, x: Tensor, cache: attn.KVCache, cfg: ModelConfig,
                  sh: Shardings = NO_SHARD):
    p = C.gather_fsdp(p, sh)
    a, cache = attention_block_decode(p["attn"],
                                      L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                      cache, cfg, window=cfg.sliding_window,
                                      sh=sh)
    x = x + a
    hn = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.arch_type == "moe":
        y, _ = moe_lib.moe_layer(p["moe"], hn, cfg.moe, sh)
        return x + y.to(x.dtype), cache
    return x + L.mlp(p["mlp"], hn, cfg.mlp, sh), cache


def _decoder_decode(p, x: Tensor, cache: attn.KVCache, ek: Tensor,
                    ev: Tensor, cfg: ModelConfig, backend: str,
                    sh: Shardings = NO_SHARD):
    p = C.gather_fsdp(p, sh)
    eps = cfg.norm_eps
    a, cache = attention_block_decode(p["attn"], L.rmsnorm(p["ln1"], x, eps),
                                      cache, cfg, sh=sh)
    x = x + a
    x = x + cross_attention_block(p["xattn"], L.rmsnorm(p["ln_x"], x, eps),
                                  ek, ev, backend, sh)
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, eps), cfg.mlp,
                     sh), cache


def _mamba_decode(p, x: Tensor, st: ssm_lib.SSMState, cfg: ModelConfig,
                  sh: Shardings = NO_SHARD):
    p = C.gather_fsdp(p, sh)
    y, st = ssm_lib.ssd_decode_step(p["mamba"],
                                    L.rmsnorm(p["ln"], x, cfg.norm_eps), st,
                                    cfg.d_model, cfg.ssm, cfg.norm_eps, sh)
    return x + y, st


def decode_step(params: Params, state: DecodeState, token: Tensor,
                cfg: ModelConfig, backend: Optional[str] = None,
                sh: Shardings = NO_SHARD):
    """token: [B, 1] ids -> (logits [B, 1, V], new state).  KV caches are
    written in place (see ``attention.cache_update``).  Whisper adds decoder
    position row 0 at every step, as the JAX package's decode does (its
    ``forward`` adds rows 0..S-1).  ``sh``: every rank passes the same
    tokens and gets every row and column of the logits."""
    check_arch(cfg)
    B = token.shape[0]
    x = L.embed(C.gather_fsdp(params["embed"], sh), C.data_block(token, sh),
                sh=sh)
    backend = _backend(backend, x)
    if cfg.arch_type in ("dense", "vlm", "moe"):
        kv = []
        for p, cache in zip(params["blocks"], state.kv):
            x, cache = _dense_decode(p, x, cache, cfg, sh)
            kv.append(cache)
        state = state._replace(kv=kv)
    elif cfg.arch_type == "audio":
        x = L.add_pos(C.gather_fsdp(params["dec_pos"], sh), x, 0)
        kv = []
        for p, cache, (ek, ev) in zip(params["blocks"], state.kv,
                                      state.enc_kv):
            x, cache = _decoder_decode(p, x, cache, ek, ev, cfg, backend, sh)
            kv.append(cache)
        state = state._replace(kv=kv)
    else:
        k = cfg.hybrid_attn_every
        ssm, shared = [], []
        for i, (p, st) in enumerate(zip(params["blocks"], state.ssm)):
            x, st = _mamba_decode(p, x, st, cfg, sh)
            ssm.append(st)
            if cfg.arch_type == "hybrid" and (i + 1) % k == 0:
                x, cache = _dense_decode(params["shared_attn"], x,
                                         state.shared_kv[len(shared)], cfg,
                                         sh)
                shared.append(cache)
        state = state._replace(ssm=ssm,
                               shared_kv=shared if shared else None)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(_head(params, cfg, sh), x, sh)
    if sh.mesh is not None:
        logits = gather_logits(params, logits, cfg, sh, B)
    return logits, state
