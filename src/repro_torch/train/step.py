"""The training step and its loss (counterpart of ``repro.train.step``).

``train_step``     an AdamW step (the throughput baseline);
``vb_train_step``  a streaming-VB (VON) step: the paper's technique as a
                   training mode (``--optimizer vb``);
``serve_step``     one decode step against the caches.

Gradients come from ``torch.autograd`` through ``transformer.forward(
remat=True)``: on ``"cuda"`` the attention's gradient is the backward
kernels' of ``kernels.flash_attn`` and the Mamba2 scan's those of
``kernels.ssd_scan`` (``ssd_scan_backward``), so every family trains on the
card; on ``"einsum"`` autograd differentiates the plain versions.  The
parameters are an ``LM`` built trainable (``init_model(trainable=True)``);
the states keep it beside the optimizer's trees, and the steps update its
tensors in place (``train.optimizer``).

On a mesh (``sh``, a ``transformer.Shardings``) the parameters and the
optimizer's trees are this rank's blocks (``sharding.shard_params`` /
``sharding.init_sharded``); every rank passes the same global batch and
takes its rows over the data axes.  The loss is the global batch's:
vocab-parallel where the head's vocabulary is split (the log-sum-exp's
max and sum all-reduced over ``model``), averaged over the data shards;
each gradient is summed over the data axes its parameter is replicated on
(``collectives.sync_grads``; the FSDP gathers' backward sums the others),
and the clip's global norm sums each block's squares over the axes that
split it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.bayes import vb_optimizer as vb
from repro_torch.configs.base import ModelConfig
from repro_torch.nn import transformer as T
from repro_torch.sharding import collectives as C
from repro_torch.train import optimizer as opt

Tensor = torch.Tensor


def lm_loss(logits: Tensor, labels: Tensor, mask: Optional[Tensor] = None,
            z_loss: float = 1e-4, *, sh: T.Shardings = T.NO_SHARD,
            vocab: Optional[int] = None) -> Tensor:
    """Next-token cross entropy with z-loss; logits fp32 [B, S, V].  On a
    mesh, ``logits`` and ``labels`` are this rank's rows; logits with fewer
    than ``vocab`` columns are its block of the vocabulary (split over
    ``model``).  The result is the global batch's loss on every rank."""
    labels = labels.long()
    if vocab is not None and logits.shape[-1] < vocab:
        n = logits.shape[-1]
        local = labels - C.tp_rank(sh) * n
        mine = (local >= 0) & (local < n)
        logz = C.vocab_logsumexp(logits, sh)
        gold = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])
        gold = C.reduce_from_model(torch.where(mine, gold[..., 0], 0.0), sh)
    else:
        logz = torch.logsumexp(logits, -1)                    # [B, S]
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    per_tok = (logz - gold) + z_loss * logz ** 2
    if mask is None:
        return C.mean_over_data(per_tok.mean(), sh)
    mask = mask.to(per_tok.dtype)
    num, den = (C.sum_over_data(t, sh) for t in ((per_tok * mask).sum(),
                                                 mask.sum()))
    return num / torch.clamp(den, min=1.0)


class TrainBatch(NamedTuple):
    tokens: Tensor                # [B, S] integer ids
    labels: Tensor                # [B, S] (shifted by the pipeline)
    enc_input: Optional[Tensor] = None   # audio stub embeddings


def named_params(params: T.LM) -> Dict[str, Tensor]:
    """The LM's parameters by name; raises if any is frozen."""
    named = dict(params.named_parameters())
    frozen = [k for k, p in named.items() if not p.requires_grad]
    if frozen:
        raise ValueError(f"{len(frozen)} parameters are frozen (e.g. "
                         f"{frozen[0]}): build the model with "
                         f"trainable=True")
    return named


class TrainState(NamedTuple):
    params: T.LM
    opt: opt.AdamWState
    step: int


def init_train_state(params: T.LM) -> TrainState:
    return TrainState(params=params, opt=opt.adamw_init(named_params(params)),
                      step=0)


def loss_fn(params: T.LM, batch: TrainBatch, cfg: ModelConfig,
            aux_weight: float = 0.01, backend: Optional[str] = None,
            remat: bool = True, sh: T.Shardings = T.NO_SHARD):
    """(loss + aux_weight moe_aux, (loss, moe_aux)) of ``forward(remat=)``;
    the loss is a ``train.loss`` span, its backward ``train.loss.backward``."""
    out = T.forward(params, batch.tokens, cfg, sh, backend=backend,
                    remat=remat, enc_input=batch.enc_input)
    bw = obs.backward_span("train.loss.backward", out.logits)
    with obs.span("train.loss"):
        loss = bw.opens(lm_loss(bw.closes(out.logits),
                                C.data_block(batch.labels, sh), sh=sh,
                                vocab=cfg.vocab))
    return loss + aux_weight * out.moe_aux, (loss, out.moe_aux)


def grads_of(params: T.LM, batch: TrainBatch, cfg: ModelConfig,
             backend: Optional[str] = None, sh: T.Shardings = T.NO_SHARD):
    """((total, (loss, aux)), {name: grad}) -- ``value_and_grad`` of
    :func:`loss_fn` (the gradients are not accumulated into ``.grad``);
    on a mesh each rank's gradients of its blocks of the global loss."""
    named = named_params(params)
    total, aux = loss_fn(params, batch, cfg, backend=backend, sh=sh)
    grads = torch.autograd.grad(total, list(named.values()),
                                allow_unused=True)
    # a parameter the loss does not reach gets zeros, as in JAX
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(named.items(), grads)}
    if sh.mesh is not None:
        grads = C.sync_grads(grads, named, sh)
    return (total.detach(), tuple(a.detach() for a in aux)), grads


def train_step(state: TrainState, batch: TrainBatch, cfg: ModelConfig,
               sh: T.Shardings = T.NO_SHARD, *,
               lr_fn=opt.cosine_schedule(3e-4, 100, 10_000)
               ) -> Tuple[TrainState, dict]:
    (total, (loss, aux)), grads = grads_of(state.params, batch, cfg, sh=sh)
    named = dict(state.params.named_parameters())
    with obs.span("train.update"):
        _, ostate = opt.adamw_update(named, grads, state.opt, lr_fn=lr_fn,
                                     mesh=sh.mesh)
    del grads
    return (TrainState(params=state.params, opt=ostate, step=state.step + 1),
            {"loss": loss, "moe_aux": aux, "total": total})


# -- streaming-VB training mode (the paper's technique) -----------------------


class VBTrainState(NamedTuple):
    params: T.LM          # its parameter tensors are vb.mean
    vb: vb.VBState
    step: int


def init_vb_state(params: T.LM, prior_prec: float = 1.0) -> VBTrainState:
    return VBTrainState(params=params,
                        vb=vb.vb_init(named_params(params),
                                      prior_prec=prior_prec), step=0)


def vb_train_step(state: VBTrainState, batch: TrainBatch, cfg: ModelConfig,
                  sh: T.Shardings = T.NO_SHARD, *, n_total: float = 1e6,
                  lr: float = 0.1) -> Tuple[VBTrainState, dict]:
    """One VON step: grads of the NLL at the posterior mean -> the
    natural-gradient posterior update and its KL (one ``train.update``
    span)."""
    (total, (loss, aux)), grads = grads_of(state.params, batch, cfg, sh=sh)
    with obs.span("train.update"):
        new_vb = vb.vb_update(state.vb, grads, n_total=n_total, lr=lr,
                              mesh=sh.mesh)
        del grads
        kl = vb.posterior_kl(new_vb, n_total, mesh=sh.mesh)
    return (VBTrainState(params=state.params, vb=new_vb, step=state.step + 1),
            {"loss": loss, "moe_aux": aux, "total": total, "kl": kl})


# -- serve step ---------------------------------------------------------------


def serve_step(params, state: T.DecodeState, token: Tensor, cfg: ModelConfig,
               backend: Optional[str] = None, sh: T.Shardings = T.NO_SHARD):
    """ONE new token against the KV/SSM caches -- the decode-shape unit."""
    return T.decode_step(params, state, token, cfg, backend, sh)
