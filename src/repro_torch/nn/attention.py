"""GQA/MQA attention with causal + sliding-window masking (counterpart of
``repro.nn.attention``).

* ``attention_reference`` -- O(S^2)-memory oracle (tests, tiny shapes).
* ``attention_blockwise`` -- a loop over KV blocks with a running-softmax
  accumulator (the flash recurrence in plain PyTorch): the plain version of
  the CUDA kernel ``repro_torch.kernels.flash_attn.flash_attention``.
* ``attention_decode`` -- one query token against a ring-buffer KV cache.
* ``attention_decode_ctx_parallel`` / ``cache_update_ctx_parallel`` -- the
  same with the cache's SEQUENCE dim split over the ``model`` axis of a
  mesh (flash-decode / context parallelism): each rank scores the query
  against its slice of the ring, and the partial softmax accumulators are
  combined with one ``all_reduce(MAX)`` of the row maxima and one
  ``all_reduce(SUM)`` of the rescaled sums and outputs.

All paths take q:[B,S,Hq,D], k/v:[B,S,Hkv,D] and return [B,S,Hq,D]; GQA
folds q-head groups onto kv heads G-major (q head h reads kv head
``h % Hkv``), by reshape, with no materialised repeat.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.sharding import collectives as C

Tensor = torch.Tensor

NEG_INF = -1e30


def _fold_gqa(q: Tensor, n_kv: int) -> Tensor:
    """[B,S,Hq,D] -> [B,S,G,Hkv,D] with G = Hq // Hkv (G-major fold: q head
    h uses kv head h % Hkv)."""
    B, S, Hq, D = q.shape
    return q.reshape(B, S, Hq // n_kv, n_kv, D)


def _mask_bias(sq: int, sk: int, q_offset: int, causal: bool,
               window: Optional[int], device=None) -> Tensor:
    """[sq, sk] additive mask; q position i is q_offset + i."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    return torch.where(ok, 0.0, NEG_INF).float()


def attention_reference(q, k, v, *, causal=True, window=None, q_offset=0,
                        scale=None):
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale or 1.0 / math.sqrt(D)
    qg = _fold_gqa(q, Hkv)                                  # [B,Sq,G,Hkv,D]
    logits = torch.einsum("bqghd,bkhd->bghqk", qg.float(), k.float()) * scale
    logits = logits + _mask_bias(Sq, Sk, q_offset, causal, window, q.device)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bghqk,bkhd->bqghd", w, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def attention_blockwise(q, k, v, *, causal=True, window=None, q_offset=0,
                        scale=None, kv_block: int = 1024):
    """Streaming-softmax attention over KV blocks; peak memory
    O(Sq * kv_block).

    As in the JAX package, q is scaled in its own dtype, the logits and the
    accumulator are fp32 sums of the operands' products, and ``p`` is
    rounded to v's dtype before the PV product."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale or 1.0 / math.sqrt(D)
    kv_block = min(kv_block, Sk)
    nblk = (Sk + kv_block - 1) // kv_block
    qg = (_fold_gqa(q, Hkv)
          * torch.tensor(scale, dtype=q.dtype, device=q.device)).float()
    qpos = q_offset + torch.arange(Sq, device=q.device)
    G = Hq // Hkv
    m = torch.full((B, Sq, G, Hkv), NEG_INF, device=q.device)
    l = torch.zeros((B, Sq, G, Hkv), device=q.device)
    acc = torch.zeros((B, Sq, G, Hkv, D), device=q.device)
    for i in range(nblk):
        lo = i * kv_block
        kblk = k[:, lo:lo + kv_block].float()
        vblk = v[:, lo:lo + kv_block]
        kpos = lo + torch.arange(kblk.shape[1], device=q.device)
        logits = torch.einsum("bqghd,bkhd->bqghk", qg, kblk)
        ok = torch.ones((Sq, kpos.shape[0]), dtype=torch.bool,
                        device=q.device)           # the last block is ragged
        if causal:
            ok = ok & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            ok = ok & (kpos[None, :] > qpos[:, None] - window)
        logits = logits + torch.where(ok, 0.0, NEG_INF)[None, :, None, None, :]
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqghk,bkhd->bqghd", p.to(vblk.dtype).float(), vblk.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# decode: one token vs KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: Tensor             # [B, C, Hkv, D]  (C = cache capacity; ring for SWA)
    v: Tensor             # [B, C, Hkv, D]
    length: int           # tokens written so far (absolute)


def init_kv_cache(batch: int, capacity: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, capacity, n_kv, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, capacity, n_kv, head_dim), dtype=dtype,
                      device=device),
        length=0)


def cache_update(cache: KVCache, k_new: Tensor, v_new: Tensor) -> KVCache:
    """Append one token (ring-buffer write: pos = length mod capacity).

    Writes into ``cache.k``/``cache.v`` in place (the JAX package copies):
    a cache holds the whole context, and one token's write should not copy
    it.  The returned cache shares the storage of the one passed in."""
    pos = cache.length % cache.k.shape[1]
    cache.k[:, pos:pos + 1] = k_new
    cache.v[:, pos:pos + 1] = v_new
    return KVCache(k=cache.k, v=cache.v, length=cache.length + 1)


def attention_decode(q, cache: KVCache, *, window=None, scale=None):
    """q: [B, 1, Hq, D] vs the ring-buffer cache. Returns [B, 1, Hq, D].

    Slot s holds the latest absolute position p(s) = s + C * floor(...);
    slots that are empty or outside the sliding window are masked."""
    B, _, Hq, D = q.shape
    C, Hkv = cache.k.shape[1], cache.k.shape[2]
    scale = scale or 1.0 / math.sqrt(D)
    qg = _fold_gqa(q, Hkv) * torch.tensor(scale, dtype=q.dtype,
                                          device=q.device)
    logits = torch.einsum("bqghd,bkhd->bqghk",
                          qg.to(cache.k.dtype).float(), cache.k.float())
    L = cache.length
    slots = torch.arange(C, device=q.device)
    wraps = torch.div(L - 1 - slots, C, rounding_mode="floor")
    abs_pos = slots + wraps * C
    valid = (abs_pos >= 0) & (abs_pos < L)
    if window is not None:
        valid = valid & (abs_pos > L - 1 - window)
    logits = logits + torch.where(valid, 0.0, NEG_INF)[None, None, None,
                                                       None, :]
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bqghk,bkhd->bqghd", w.to(cache.v.dtype).float(),
                       cache.v.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# context-parallel decode: the cache's sequence dim split over ``model``
# ---------------------------------------------------------------------------
#
# For GQA models with few KV heads (glm4: 2) a long decode cache cannot be
# split by head; its sequence is split instead.  Every model rank scores q
# against its C / s slots, then the partial accumulators are combined:
# one MAX of the [B, 1, G, Hkv] row maxima and one SUM of the rescaled
# sums and outputs -- a few KB against the cache bytes each rank reads.


def _decode_partial(q, k, v, abs_pos, length, window, scale):
    """Local flash-decode accumulators (m, l, acc). q: [B,1,Hq,D]; k/v:
    [B,C_loc,Hkv,D]; abs_pos: [C_loc] absolute position each local slot
    holds (negative: empty)."""
    Hkv = k.shape[2]
    qg = _fold_gqa(q, Hkv) * torch.tensor(scale, dtype=q.dtype,
                                          device=q.device)
    logits = torch.einsum("bqghd,bkhd->bqghk", qg.to(k.dtype).float(),
                          k.float())
    valid = (abs_pos >= 0) & (abs_pos < length)
    if window is not None:
        valid = valid & (abs_pos > length - 1 - window)
    logits = logits + torch.where(valid, 0.0, NEG_INF)[None, None, None,
                                                       None, :]
    m = logits.amax(-1)                                       # [B,1,G,Hkv]
    p = torch.exp(logits - m[..., None])
    acc = torch.einsum("bqghk,bkhd->bqghd", p.to(v.dtype).float(), v.float())
    return m, p.sum(-1), acc


def attention_decode_ctx_parallel(q, cache: KVCache, sh, *, window=None,
                                  scale=None):
    """q: [B, 1, Hq, D] (every head, replicated over ``model``) against this
    rank's slots of the ring, ``cache.k`` / ``cache.v`` [B, C / s, Hkv, D]
    (global slots j C/s .. (j + 1) C/s - 1 on model rank j); returns
    [B, 1, Hq, D], the same on every model rank."""
    B, _, Hq, D = q.shape
    C_loc = cache.k.shape[1]
    Ctot = C_loc * C.tp_size(sh)
    scale = scale or 1.0 / math.sqrt(D)
    L = cache.length
    slots = C.tp_rank(sh) * C_loc + torch.arange(C_loc, device=q.device)
    abs_pos = slots + torch.div(L - 1 - slots, Ctot,
                                rounding_mode="floor") * Ctot
    m, l, acc = _decode_partial(q, cache.k, cache.v, abs_pos, L, window,
                                scale)
    m_g = C.all_reduce_(m.clone(), sh.mesh, (sh.model_axis,), "max")
    corr = torch.exp(m - m_g)
    sums = torch.cat([(l * corr)[..., None], acc * corr[..., None]], -1)
    C.all_reduce_(sums, sh.mesh, (sh.model_axis,))
    out = sums[..., 1:] / torch.clamp(sums[..., :1], min=1e-30)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def cache_update_ctx_parallel(cache: KVCache, k_new: Tensor, v_new: Tensor,
                              sh) -> KVCache:
    """The ring write on a cache whose sequence is split over ``model``:
    slot ``length mod C`` is written, in place, by the rank that holds it
    alone; the others pass their slice through."""
    C_loc = cache.k.shape[1]
    pos = cache.length % (C_loc * C.tp_size(sh)) \
        - C.tp_rank(sh) * C_loc
    if 0 <= pos < C_loc:
        cache.k[:, pos:pos + 1] = k_new
        cache.v[:, pos:pos + 1] = v_new
    return KVCache(k=cache.k, v=cache.v, length=cache.length + 1)
