"""The ``train`` traffic kind: ``repro_torch.train.trainer.Trainer.fit``
(AdamW or streaming VB), batches of the seeded corpus back to back.

Set-up builds the one trainer, drives it through the checked steps with
the window's own call and feed, and hands it to the window.  The check
compares those steps with the plain reference's:

    ``loss``    the largest relative gap of a step's loss;
    ``grad``    the worst leaf's gap between the norms of the first
                gradient as the optimizer took it, over the reference's
                norm of that leaf or of the median leaf, whichever is
                larger;
    ``change``  the same for the parameters' change over the checked
                steps, over the leaves whose reference gradient is not
                nought to rounding (at least a thousandth of the median
                leaf's).

``control`` puts the reference one precision step below (float8
products) in the program's place; ``FAULTS`` plants faults in the
reference (half of each batch left out).
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict, Optional

import torch

from bench import check, drive, feed, weights
from bench.reference import lm as ref
from bench.reference import optim as ref_opt


class Kind:
    """Set-up, the window, one profiled step, the outputs the check
    judges, and freeing the program's state."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.dev = cfg, traffic, seed, device
        self.tokens_per_unit = traffic["batch"] * traffic["seq"]

    def setup(self) -> None:
        from repro_torch.train.step import TrainBatch
        from repro_torch.train.trainer import Trainer, TrainerConfig

        cfg, tr = self.cfg, self.tr
        self.TrainBatch = TrainBatch
        w = weights.make(cfg, self.seed, self.dev)
        params = drive.port_model(cfg, w, trainable=True)
        del w
        opt = tr["optimizer"]
        hp = tr.get("vb", {})
        self.trainer = Trainer(drive.port_config(cfg), params, TrainerConfig(
            optimizer=opt, lr=tr["schedule"]["lr"],
            steps=tr["schedule"]["total"], warmup=tr["schedule"]["warmup"],
            n_total=hp.get("n_total", 1e6),
            drift_threshold=hp.get("drift_threshold", 5.0),
            drift_temper=hp.get("drift_temper", 0.3), ckpt_path=None,
            log_every=0, eval_every=0, device=self.dev))
        del params
        self.batches = feed.train_batches(tr, cfg["vocab_size"], self.seed,
                                          self.dev)
        self.first_grad: Dict[str, float] = {}
        n = tr["checked_steps"]

        def checked():
            for i in range(n):
                if i == 1:
                    self.first_grad = self._first_grad_norms()
                yield self.TrainBatch(*next(self.batches))

        self.trainer.fit(checked())
        self.losses = list(self.trainer.history[:n])
        self.params_after = {k: p.detach().to("cpu", copy=True) for k, p in
                             self.trainer.params.named_parameters()}

    def _first_grad_norms(self) -> Dict[str, float]:
        """Each leaf's norm of the gradient the optimizer took at step 1,
        from its state (AdamW: m = (1 - b1) g; VB: s = rho g^2)."""
        st = self.trainer.state
        if self.tr["optimizer"] == "adamw":
            b1 = self.tr["adamw"]["b1"]
            return {k: drive.leaf_norm(m) / (1 - b1)
                    for k, m in st.opt.m.items()}
        rho = self.tr["vb"]["rho"]
        return {k: math.sqrt(float(s.double().sum()) / rho)
                for k, s in st.vb.fisher.items()}

    def fill_checked(self) -> None:
        """Set-up has already driven every checked step."""

    def window(self, seconds: float) -> dict:
        n0 = len(self.trainer.history)
        t0 = time.perf_counter()
        deadline = t0 + seconds

        marks = []

        def timed():
            while True:
                marks.append(time.perf_counter())
                if marks[-1] >= deadline:
                    return
                yield self.TrainBatch(*next(self.batches))

        self.trainer.fit(timed())
        drive.sync(self.dev)
        t1 = time.perf_counter()
        losses = self.trainer.history[n0:]
        return {"seconds": t1 - t0, "units": len(losses),
                "tokens": len(losses) * self.tokens_per_unit,
                "failed": sum(1 for v in losses if not math.isfinite(v)),
                "unit_s": [b - a for a, b in zip(marks, marks[1:])]}

    def unit(self) -> None:
        self.trainer.fit(iter([self.TrainBatch(*next(self.batches))]))

    def outputs(self) -> dict:
        return {"losses": self.losses, "first_grad": self.first_grad,
                "params_after": self.params_after}

    def free(self) -> None:
        self.trainer = None
        self.batches = None
        drive.free_device()


def reference(cfg: dict, traffic: dict, seed: int, device,
              prec: str = "bf16", fault: Optional[str] = None) -> dict:
    """The reference's checked steps: losses, first-gradient norms and
    change norms by leaf."""
    dims = ref.Dims.of(cfg)
    n = traffic["checked_steps"]
    batches = feed.train_batches(traffic, cfg["vocab_size"], seed, device)
    w = weights.make(cfg, seed, device)
    if traffic["optimizer"] == "adamw":
        opt = ref_opt.AdamW(w, traffic["adamw"], traffic["schedule"])
    else:
        opt = ref_opt.StreamingVB(w, traffic["vb"],
                                  traffic["schedule"]["lr"])
    z_loss = traffic["z_loss"]
    losses, first = [], {}
    with ref.fp32_exact():
        for t in range(n):
            toks, labs = next(batches)
            if fault == "half_batch":
                toks, labs = toks[:toks.shape[0] // 2], labs[:labs.shape[0] // 2]
            loss, grads = ref.loss_and_grads(w, toks, labs, dims, z_loss,
                                             prec)
            losses.append(float(loss))
            opt.step(grads, float(loss))
            del grads
            if t == 0:
                first = {k: float(torch.linalg.vector_norm(g))
                         for k, g in opt.first_grads().items()}
    del opt
    drive.free_device()
    p0 = weights.make(cfg, seed, device)
    change = {k: float(torch.linalg.vector_norm(w[k] - p0[k])) for k in w}
    del w, p0
    drive.free_device()
    return {"losses": losses, "first_grad": first, "change": change}


def program_change(cfg: dict, seed: int, device,
                   params_after: Dict[str, torch.Tensor]) -> Dict[str, float]:
    p0 = weights.make(cfg, seed, device)
    out = {k: float(torch.linalg.vector_norm(
        params_after[k].to(device, torch.float32) - p0[k])) for k in p0}
    del p0
    drive.free_device()
    return out


def worst_leaves(prog: dict, refr: dict, n: int = 3) -> Dict[str, list]:
    """The ``n`` leaves with the largest gaps of ``grad`` and ``change``
    (their gap, the program's and the reference's norms), for the look at
    a reading."""
    out = {}
    for what, key in (("grad", "first_grad"), ("change", "change")):
        r, p = refr[key], prog[key]
        med = statistics.median(r.values())
        gaps = sorted(((abs(p[k] - r[k]) / max(r[k], med, 1e-30), k, p[k],
                        r[k]) for k in r), reverse=True)[:n]
        out[what] = [[k, g, pv, rv] for g, k, pv, rv in gaps]
    return out


def compare(prog: dict, refr: dict) -> Dict[str, float]:
    """``prog`` and ``refr``: losses, first_grad and change by leaf."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                    refr["losses"]))
    g_ref = refr["first_grad"]
    med = statistics.median(g_ref.values())
    moved = [k for k, v in g_ref.items() if v >= check.SMALL_GRAD * med]
    return {"loss": loss,
            "grad": check.norm_gap(prog["first_grad"], g_ref),
            "change": check.norm_gap(prog["change"], refr["change"], moved)}


def check_outputs(cfg: dict, traffic: dict, seed: int, device,
                  outputs: dict, look: Optional[dict] = None
                  ) -> Dict[str, float]:
    """The numbers of a run: the program's checked steps (``Kind.outputs``)
    against the reference's; ``look``, if given, gets the worst leaves."""
    prog = {"losses": outputs["losses"], "first_grad": outputs["first_grad"],
            "change": program_change(cfg, seed, device,
                                     outputs["params_after"])}
    refr = reference(cfg, traffic, seed, device)
    if look is not None:
        look.update(worst_leaves(prog, refr))
    return compare(prog, refr)


def control(cfg: dict, traffic: dict, seed: int, device
            ) -> Dict[str, float]:
    """The numbers of the reference in float8 products put in the
    program's place."""
    base = reference(cfg, traffic, seed, device)
    return compare(reference(cfg, traffic, seed, device, "fp8"), base)


def _half_batch(cfg: dict, traffic: dict, seed: int, device
                ) -> Dict[str, float]:
    base = reference(cfg, traffic, seed, device)
    return compare(reference(cfg, traffic, seed, device,
                             fault="half_batch"), base)


FAULTS = {"half_batch": _half_batch}
