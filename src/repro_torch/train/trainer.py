"""Trainer loop: checkpointing, eval, drift-aware streaming training
(counterpart of ``repro.train.trainer``).

AdamW or streaming-VB steps, periodic eval and checkpoint, and -- when the
drift monitor fires -- Eq.-3 prior chaining with tempering (the network
analogue of ``core.streaming.stream_update``'s drift response).  The
model, its optimizer state and the batches live on ``TrainerConfig.device``
(``None``: ``cuda:0``, raising without a card); checkpoints are the
parameters in the flat-key npz format of ``train.checkpoint``, which the
reference's ``repro.train.checkpoint.load`` reads.  On a mesh (``sh``) the
model is this rank's blocks, every rank feeds the same batches, and a
checkpoint is the gathered whole model, written by rank 0
(``checkpoint.save_lm``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch import obs
from repro_torch.bayes import vb_optimizer as vb
from repro_torch.bayes.drift import LossDriftMonitor
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn import transformer as T
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as opt
from repro_torch.train import step as ts


@dataclasses.dataclass
class TrainerConfig:
    optimizer: str = "adamw"          # adamw | vb
    lr: float = 3e-4
    steps: int = 1000
    warmup: int = 100
    n_total: float = 1e6              # stream scale for VB
    ckpt_path: Optional[str] = None
    ckpt_every: int = 500
    eval_every: int = 100
    drift_threshold: float = 5.0
    drift_temper: float = 0.3         # prior forgetting on drift (Eq. 3)
    log_every: int = 25
    device: DeviceLike = None         # None: cuda:0


class Trainer:
    def __init__(self, cfg: ModelConfig, params: T.LM, tcfg: TrainerConfig,
                 sh: T.Shardings = T.NO_SHARD):
        self.device = resolve_device(tcfg.device)
        if tcfg.optimizer not in ("adamw", "vb"):
            raise ValueError(f"unknown optimizer {tcfg.optimizer!r}")
        self.cfg, self.tcfg, self.sh = cfg, tcfg, sh
        params = params.to(self.device)
        self.monitor = LossDriftMonitor.create(tcfg.drift_threshold)
        self.history: list = []
        self.n_drifts = 0
        if tcfg.optimizer == "adamw":
            self.state = ts.init_train_state(params)
            self._lr_fn = opt.cosine_schedule(tcfg.lr, tcfg.warmup,
                                              tcfg.steps)
        else:
            self.state = ts.init_vb_state(params)

    def _step(self, state, batch):
        if self.tcfg.optimizer == "adamw":
            return ts.train_step(state, batch, self.cfg, self.sh,
                                 lr_fn=self._lr_fn)
        return ts.vb_train_step(state, batch, self.cfg, self.sh,
                                n_total=self.tcfg.n_total, lr=self.tcfg.lr)

    @property
    def params(self) -> T.LM:
        """The model (under VB its parameters are the posterior mean)."""
        return self.state.params

    def _on_drift(self):
        """Eq.-3 response: temper the chained prior so the model re-adapts
        (VB mode); AdamW mode just logs (no prior to chain)."""
        self.n_drifts += 1
        if self.tcfg.optimizer == "vb":
            new_vb = vb.chain_prior(self.state.vb, self.tcfg.n_total,
                                    temper=self.tcfg.drift_temper)
            self.state = self.state._replace(vb=new_vb)

    def _save(self):
        ck.save_lm(self.tcfg.ckpt_path, self.params, self.sh.mesh)

    def fit(self, batches: Iterator, eval_fn: Optional[Callable] = None
            ) -> dict:
        """Steps on ``batches``, each iteration a ``train.step`` span (attr
        ``step``, the trainer's count)."""
        t0 = time.time()
        tok_per_batch = None
        for i, batch in enumerate(batches):
            with obs.span("train.step", step=len(self.history)):
                if tok_per_batch is None:
                    tok_per_batch = int(np.prod(batch.tokens.shape))
                self.state, metrics = self._step(self.state, batch)
                loss = float(metrics["loss"])
                self.history.append(loss)
                self.monitor, drifted = self.monitor.observe(loss)
                drifted = bool(drifted)
                if drifted:
                    self._on_drift()
                if self.tcfg.log_every and i % self.tcfg.log_every == 0:
                    tps = tok_per_batch * (i + 1) / (time.time() - t0)
                    obs.log(f"[trainer] step={i:5d} loss={loss:.4f} "
                            f"tok/s={tps:,.0f}"
                            + (" DRIFT" if drifted else ""),
                            component="trainer", step=i, loss=loss,
                            tok_s=tps, drifted=drifted)
                if eval_fn and self.tcfg.eval_every \
                        and i and i % self.tcfg.eval_every == 0:
                    eval_fn(self.params, i)
                if self.tcfg.ckpt_path and self.tcfg.ckpt_every \
                        and i and i % self.tcfg.ckpt_every == 0:
                    self._save()
        if self.tcfg.ckpt_path:
            self._save()
        return {"final_loss": self.history[-1],
                "n_drifts": self.n_drifts,
                "steps": len(self.history)}
