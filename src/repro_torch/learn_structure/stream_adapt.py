"""Drift-triggered streaming structure adaptation (counterpart of
``repro.learn_structure.stream_adapt``).

An :class:`AdaptiveStructure` consumes a stream batch-by-batch and keeps a
bounded window of recent instances whose sufficient statistics feed the
scores ONLINE: each arriving chunk is reduced once
(``scores.structure_stats`` -- one ``family_counts`` call plus the
per-continuous-child regression moments, O(batch)), the per-chunk stats
ride along the window, and the conjugate CPD refit after every batch just
sums the stored chunk stats (``scores.cpds_from_stats``) -- no instance is
ever re-counted while the structure stands.

Drift: the mean per-instance log-likelihood of each *incoming* batch under
the *current* network runs through the Page-Hinkley machinery of
``core.streaming`` (``drift_init`` / ``drift_update``).  When the PH
statistic crosses the threshold the window shrinks to the post-drift batch
and the structure search re-runs (warm-started from the current structure
for the hill-climbing learner), so the graph itself adapts to concept
drift.

The learned network is always a plain ``BayesianNetwork`` with conjugate-
fitted CPDs on ``device`` (the first card unless the caller names
another): every update leaves ``self.bn`` ready for ``infer_exact`` and
``serve.PGMQueryEngine``.
"""

from __future__ import annotations

import functools
import operator
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core.streaming import drift_init, drift_update, tree_map
from repro_torch.data.stream import Attribute, Batch, DataStream
from repro_torch.learn_structure import chowliu as CL
from repro_torch.learn_structure import scores as S
from repro_torch.learn_structure.search import hill_climb

LEARNERS = ("hillclimb", "chowliu", "tan")


class AdaptiveStructure:
    """Windowed structure learner with Page-Hinkley re-search triggering.

    learner          "hillclimb" (general CLG search), "chowliu" (tree) or
                     "tan" (class-augmented tree; needs ``class_name``)
    window           target instances kept as re-search evidence; eviction
                     is chunk-granular and never drops below this, so the
                     window holds [window, window + batch) instances
    drift_threshold  PH lambda on the mean batch log-likelihood
    relearn_every    also re-run the search every k batches (None = only
                     on drift -- CPDs still refit every batch)
    """

    def __init__(self, attributes: Sequence[Attribute], *,
                 learner: str = "hillclimb",
                 class_name: Optional[str] = None,
                 window: int = 20_000, drift_threshold: float = 3.0,
                 delta: float = 0.05, relearn_every: Optional[int] = None,
                 ess: float = 1.0, kappa: float = 1.0, a0: float = 1.0,
                 b0: float = 1.0, backend: Optional[str] = None,
                 device: devmod.DeviceLike = None, **learn_kw) -> None:
        if learner not in LEARNERS:
            raise ValueError(f"unknown learner {learner!r}; "
                             f"expected one of {LEARNERS}")
        if learner == "tan" and class_name is None:
            raise ValueError("learner='tan' needs class_name")
        self.device, self.backend = S.placement(device, backend)
        self.attributes = list(attributes)
        self.learner = learner
        self.class_name = class_name
        self.window = window
        self.drift_threshold = drift_threshold
        self.delta = delta
        self.relearn_every = relearn_every
        # conjugate hyperparameters: one set for the search scores, the
        # relearn fits AND the per-batch refit, so self.bn never flips
        # smoothing regime between relearn and refit batches
        self.fit_kw = dict(ess=ess, kappa=kappa, a0=a0, b0=b0)
        self.learn_kw = learn_kw
        _, self.col = S.variables_of(self.attributes)

        self._chunks: List[Tuple[np.ndarray, np.ndarray]] = []
        # per-chunk suff stats under the CURRENT structure (None until a
        # structure exists); the refit sums these instead of re-counting
        self._chunk_stats: List[Optional[Dict[str, object]]] = []
        self._n_window = 0
        self.drift = drift_init(self.device)
        self.bn = None
        self.parents: Dict[str, Tuple[str, ...]] = {}
        self.n_batches = 0
        self.n_drifts = 0
        self.n_relearn = 0

    # -- window plumbing -----------------------------------------------------

    def _chunk_batch(self, xc: np.ndarray, xd: np.ndarray) -> Batch:
        return S.batch_to(Batch(xc, xd, np.ones(xc.shape[0], np.float32)),
                          self.device)

    def _stats(self, xc: np.ndarray, xd: np.ndarray) -> Dict[str, object]:
        return S.structure_stats(self.attributes, dict(self.parents),
                                 self._chunk_batch(xc, xd),
                                 backend=self.backend, device=self.device)

    def _push(self, xc: np.ndarray, xd: np.ndarray, *,
              compute_stats: bool) -> None:
        self._chunks.append((xc, xd))
        self._chunk_stats.append(self._stats(xc, xd) if compute_stats
                                 else None)
        self._n_window += xc.shape[0]
        while self._chunks and self._n_window - self._chunks[0][0].shape[0] \
                >= self.window:
            old = self._chunks.pop(0)
            self._chunk_stats.pop(0)
            self._n_window -= old[0].shape[0]

    def _window_batch(self) -> Batch:
        xc = np.concatenate([c for c, _ in self._chunks])
        xd = np.concatenate([d for _, d in self._chunks])
        return self._chunk_batch(xc, xd)

    # -- scoring the incoming batch under the current network -----------------

    def _batch_score(self, xc: np.ndarray, xd: np.ndarray) -> float:
        b = self._chunk_batch(xc, xd)
        asg = {}
        for name, (kind, c) in self.col.items():
            asg[name] = b.xc[:, c] if kind == "c" else b.xd[:, c]
        return float(self.bn.log_prob(asg).mean())

    # -- learning ------------------------------------------------------------

    def _relearn(self, warm: bool) -> None:
        old = {k: frozenset(v) for k, v in self.parents.items()}
        batch = self._window_batch()
        kw = {**self.fit_kw, **self.learn_kw, "backend": self.backend,
              "device": self.device}
        if self.learner == "hillclimb":
            res = hill_climb(batch, self.attributes,
                             init_parents=(dict(self.parents)
                                           if warm and self.parents
                                           else None), **kw)
            self.parents, self.bn = res.parents, res.bn
        elif self.learner == "chowliu":
            edges, self.bn = CL.chow_liu(batch, self.attributes, **kw)
            self.parents = self._parents_of(edges)
        else:
            edges, self.bn = CL.tan(batch, self.attributes, self.class_name,
                                    **kw)
            self.parents = self._parents_of(edges)
        self.n_relearn += 1
        # re-reduce window chunks under the new family set -- but when the
        # search kept the structure (scheduled relearn, no change), the
        # stored stats are still valid and only the chunks pushed without
        # stats (the one awaiting this relearn) need reducing
        changed = old != {k: frozenset(v) for k, v in self.parents.items()}
        self._chunk_stats = [
            st if st is not None and not changed else self._stats(xc, xd)
            for (xc, xd), st in zip(self._chunks, self._chunk_stats)]

    def _parents_of(self, edges) -> Dict[str, Tuple[str, ...]]:
        out: Dict[str, List[str]] = {a.name: [] for a in self.attributes}
        for u, v in edges:
            out[v].append(u)
        return {k: tuple(v) for k, v in out.items()}

    def _refit(self) -> None:
        """Conjugate CPD tracking at fixed structure: sum the stored
        per-chunk stats (small arrays, O(n_chunks)) -- no re-counting."""
        stats = tree_map(
            lambda *leaves: functools.reduce(operator.add, leaves),
            *self._chunk_stats)
        self.bn = S.cpds_from_stats(self.attributes, dict(self.parents),
                                    stats, **self.fit_kw)

    # -- the streaming API ----------------------------------------------------

    def update(self, xc, xd=None, mask=None) -> Dict[str, float]:
        """Consume one arriving batch; returns
        ``{score, ph, drifted, relearned, n_window}``."""
        if isinstance(xc, Batch):
            batch = xc
            keep = np.asarray(batch.mask) > 0          # drop tail padding
            xc, xd = np.asarray(batch.xc)[keep], np.asarray(batch.xd)[keep]
        elif mask is not None:
            keep = np.asarray(mask) > 0
            xc, xd = np.asarray(xc)[keep], (np.asarray(xd)[keep]
                                            if xd is not None else None)
        xc = np.asarray(xc, np.float32)
        xd = (np.asarray(xd, np.int32) if xd is not None
              else np.zeros((xc.shape[0], 0), np.int32))
        self.n_batches += 1

        score, ph, drifted = 0.0, 0.0, False
        if self.bn is not None:
            score = self._batch_score(xc, xd)
            self.drift, ph_ = drift_update(
                self.drift, torch.tensor(score, dtype=torch.float32,
                                         device=self.device),
                delta=self.delta)
            ph = float(ph_)
            drifted = ph > self.drift_threshold
        if drifted:
            # the pre-drift window describes the dead concept -- restart the
            # evidence from this batch and re-search
            self.n_drifts += 1
            self.drift = drift_init(self.device)
            self._chunks, self._chunk_stats, self._n_window = [], [], 0

        # decide BEFORE pushing: a relearn re-reduces every window chunk
        # under the (possibly new) structure anyway, so the arriving chunk
        # is only reduced at push time when the structure will stand
        relearned = (self.bn is None or drifted
                     or bool(self.relearn_every
                             and self.n_batches % self.relearn_every == 0))
        self._push(xc, xd, compute_stats=not relearned)
        if relearned:
            self._relearn(warm=drifted)
        else:
            self._refit()           # conjugate CPD tracking, same structure
        return {"score": score, "ph": ph, "drifted": float(drifted),
                "relearned": float(relearned),
                "n_window": float(self._n_window)}

    def fit_stream(self, stream: DataStream, batch_size: int = 500
                   ) -> List[Dict[str, float]]:
        """Drive :meth:`update` over a whole ``DataStream``."""
        return [self.update(b) for b in stream.batches(batch_size)]

    def edges(self) -> set:
        return {(p, c) for c, ps in self.parents.items() for p in ps}
