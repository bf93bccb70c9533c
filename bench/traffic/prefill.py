"""The ``prefill`` traffic kind: ``repro_torch.nn.transformer.forward``
under ``no_grad`` on seeded prompts, calls back to back, each ending with
the first generated (greedy) token of each prompt read to the host.

Up to ``ahead_calls`` calls are in flight, as a server that pipelines its
batches keeps them: each call's tokens start back to the host as it is
launched and are waited for ``ahead_calls`` calls later, so the card is
not left idle at every call's end, and a short stall of the host is
covered by the work already sent.  At the window's close nothing more is
sent, every call sent is waited for and counted, and the clock is read
after that wait.

The check takes ``checked_calls`` calls drawn from the seed among the
window's first ``sample_from_first`` and compares, at every position of
each prompt (the served last one included):

    ``gap``     the widest gap by which the reference's logit of the
                program's greedy token lies below the reference's best.

``control`` judges the tokens of the reference in float8 products
instead of the program's.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from bench import drive, feed, weights
from bench.reference import lm as ref


class Kind:
    """Set-up, the window, one profiled call, the outputs the check
    judges, and freeing the program's state."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.dev = cfg, traffic, seed, device
        self.tokens_per_unit = traffic["batch"] * traffic["seq"]
        self.sampled = sampled_calls(traffic, seed)

    def setup(self) -> None:
        from repro_torch.nn import transformer as T

        self.T = T
        w = weights.make(self.cfg, self.seed, self.dev)
        self.params = drive.port_model(self.cfg, w, trainable=False)
        del w
        self.pcfg = drive.port_config(self.cfg)
        self.prompts = feed.prompts(self.tr, self.cfg["vocab_size"],
                                    self.seed)
        self.kept: Dict[int, tuple] = {}
        if self.dev.type == "cuda":     # the pinned blocks the calls in
            b = self.tr["batch"]        # flight take, in the host cache
            held = [torch.empty(n, dtype=torch.int64, pin_memory=True)
                    for n in (self.tokens_per_unit, b)
                    for _ in range(self.tr["ahead_calls"] + 2)]
            del held
        for _ in range(self.tr["warm_calls"]):
            self._finish(self._send(next(self.prompts)))
        drive.sync(self.dev)

    def _send(self, prompt: np.ndarray, keep: Optional[int] = None):
        """Launch one call; its served tokens (and, for a checked call,
        every position's greedy token) start back to the host."""
        cuda = self.dev.type == "cuda"
        toks = torch.from_numpy(prompt)
        toks = (toks.pin_memory() if cuda else toks).to(self.dev,
                                                        non_blocking=cuda)
        with torch.no_grad():
            logits = self.T.forward(self.params, toks, self.pcfg).logits
        served = logits[:, -1].argmax(-1).to("cpu", non_blocking=cuda)
        greedy = None if keep is None \
            else logits.argmax(-1).to("cpu", non_blocking=cuda)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record()
        return prompt, keep, served, greedy, done

    def _finish(self, sent) -> int:
        """Wait for a sent call's tokens on the host; 1 where a served
        token lies outside the vocabulary, else 0."""
        prompt, keep, served, greedy, done = sent
        if done is not None:
            done.synchronize()
        if keep is not None:
            self.kept[keep] = (prompt, greedy, served)
        return int(((served < 0) | (served >= self.cfg["vocab_size"])).any())

    def window(self, seconds: float, max_units: Optional[int] = None
               ) -> dict:
        ahead = self.tr["ahead_calls"] if self.dev.type == "cuda" else 1
        flight: deque = deque()
        n, failed = 0, 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        marks = [t0]
        while n != max_units and time.perf_counter() < deadline:
            if len(flight) == ahead:
                failed += self._finish(flight.popleft())
                marks.append(time.perf_counter())
            flight.append(self._send(next(self.prompts),
                                     n if n in self.sampled else None))
            n += 1
        while flight:
            failed += self._finish(flight.popleft())
            marks.append(time.perf_counter())
        return {"seconds": marks[-1] - t0, "units": n,
                "tokens": n * self.tokens_per_unit, "failed": failed,
                "unit_s": [b - a for a, b in zip(marks, marks[1:])]}

    def fill_checked(self) -> None:
        """The window's calls up to the last sampled one."""
        self.window(float("inf"), max(self.sampled) + 1)

    def unit(self) -> None:
        self._finish(self._send(next(self.prompts)))

    def outputs(self) -> dict:
        return {"kept": dict(self.kept)}

    def free(self) -> None:
        self.params = None
        drive.free_device()


def sampled_calls(traffic: dict, seed: int) -> set:
    rng = np.random.default_rng(seed + 3)
    return set(rng.choice(traffic["sample_from_first"],
                          traffic["checked_calls"], replace=False).tolist())


def reference_logits(cfg: dict, w, prompt, device, prec: str = "bf16"
                     ) -> torch.Tensor:
    with torch.no_grad(), ref.fp32_exact():
        toks = torch.as_tensor(prompt, device=device)
        return ref.logits(w, toks, ref.Dims.of(cfg), prec)


def widest_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    best = ref_logits.max(-1).values
    got = torch.gather(ref_logits, -1, tokens.to(ref_logits.device)[..., None]
                       )[..., 0]
    return float((best - got).max())


def gap(cfg: dict, seed: int, device, kept: dict, prec: str = "bf16"
        ) -> Dict[str, float]:
    """``gap`` over the ``kept`` calls: every position's greedy token, the
    served last one included; with ``prec`` below the configuration's the
    control's own tokens are judged instead of the program's."""
    if not kept:
        raise RuntimeError("no sampled call finished in the window")
    w = weights.make(cfg, seed, device)
    out = 0.0
    for prompt, tokens, served in kept.values():
        lg = reference_logits(cfg, w, prompt, device)
        if prec != "bf16":
            tokens = reference_logits(cfg, w, prompt, device, prec).argmax(-1)
            served = tokens[:, -1]
        if not torch.equal(tokens[:, -1].cpu(), served.cpu()):
            return {"gap": float("inf")}
        out = max(out, widest_gap(lg, tokens))
        del lg
    del w
    drive.free_device()
    return {"gap": out}


def check_outputs(cfg: dict, traffic: dict, seed: int, device,
                  outputs: dict, look: Optional[dict] = None
                  ) -> Dict[str, float]:
    """The numbers of a run: the sampled calls (``Kind.outputs``) against
    the reference (``look`` is not filled: a gap has no leaves)."""
    return gap(cfg, seed, device, outputs["kept"])


def control(cfg: dict, traffic: dict, seed: int, device
            ) -> Dict[str, float]:
    """``gap`` of the reference's float8 tokens on the prompts of the
    calls a run with ``seed`` samples."""
    sampled = sampled_calls(traffic, seed)
    prompts = feed.prompts(traffic, cfg["vocab_size"], seed)
    for _ in range(traffic["warm_calls"]):
        next(prompts)
    kept = {}
    for i in range(max(sampled) + 1):
        p = next(prompts)
        if i in sampled:
            kept[i] = (p, None, None)
    return gap(cfg, seed, device, kept, "fp8")


FAULTS: dict = {}
