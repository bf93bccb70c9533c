"""Batched probabilistic-query serving (counterpart of the PGM half of
``repro.serve.engine``).

:class:`PGMQueryEngine` -- queries against a CLG ``BayesianNetwork`` queue
up and, at ``flush()``, are grouped by evidence *schema* (the set of
observed variable names).  Each group rides the leading batch axis of the
junction-tree tables, so N exact queries sharing a schema cost ONE
propagation (``mode="exact"``); ``mode="vmp"`` serves q(Z | x) from a
fitted plate model through ``Model.posterior_z``.

Not ported yet: ``mode="importance"`` (ROADMAP Queue 1 item 13),
``mode="temporal"`` (item 11), replica sharding over a mesh (item 10), and
the language-model ``DecodeEngine`` (item 15).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch import device as devmod
from repro_torch.data.stream import Batch
from repro_torch.serve.plan import PlanCache, PlanKey

_NOT_PORTED = {"importance": "ROADMAP Queue 1 item 13 (approximate "
                             "inference)",
               "temporal": "ROADMAP Queue 1 item 11 (dynamic models)"}


@dataclasses.dataclass
class PGMQuery:
    qid: int
    target: str                       # variable whose posterior is requested
    evidence: Dict[str, float]
    result: Optional[np.ndarray] = None       # posterior table over target
    log_evidence: Optional[float] = None      # exact mode only
    done: bool = False


class PGMQueryEngine:
    """Schema-batched posterior queries over a CLG Bayesian network.

    ``mode="exact"`` routes through :class:`JunctionTreeEngine` -- queries
    with the same evidence schema propagate together in one batched pass,
    on ``device`` (the first card by default) with ``backend`` (the device's
    default: the CUDA kernels on a card).  ``mode="vmp"`` serves q(Z | x)
    from a fitted plate model (``repro_torch.pgm_models``) on the model's
    own device; N fully observed queries sharing a schema cost one
    ``posterior_z`` call, and evidence must cover every feature ``X{i}``.
    """

    def __init__(self, bn, *, mode: str = "exact",
                 backend: Optional[str] = None,
                 device: devmod.DeviceLike = None,
                 plan_cache: Optional[PlanCache] = None,
                 network_version: int = 0, pad_pow2: bool = False,
                 mesh=None) -> None:
        from repro_torch.infer_exact import JunctionTreeEngine

        if mode in _NOT_PORTED:
            raise NotImplementedError(
                f"mode={mode!r} is not ported yet: {_NOT_PORTED[mode]}")
        if mode not in ("exact", "vmp"):
            raise ValueError(f"unknown mode {mode!r}")
        if mesh is not None:
            raise NotImplementedError("replica sharding over a mesh is not "
                                      "ported yet (ROADMAP Queue 1 item 10)")
        if mode == "vmp":
            # ``bn`` is a plate Model with a discrete latent Z
            if not hasattr(bn, "cp") or bn.cp.layout.K <= 1:
                raise ValueError("mode='vmp' needs a plate Model with a "
                                 "discrete latent Z")
        self.bn = bn
        self.mode = mode
        # pad exact-mode buckets to the next power of two (vmp always does)
        # so arbitrary batch sizes reuse a handful of plans
        self.pad_pow2 = pad_pow2
        # one PlanCache serves every mode
        self.plans = plan_cache if plan_cache is not None else PlanCache()
        self.network_version = network_version
        self._jt = (JunctionTreeEngine(bn, backend=backend, device=device,
                                       plan_cache=self.plans,
                                       network_version=network_version)
                    if mode == "exact" else None)
        self._queue: List[PGMQuery] = []
        self._next = 0

    # -- model lifecycle -----------------------------------------------------

    def set_model(self, bn, *, network_version: Optional[int] = None) -> None:
        """Swap the served network/model in place (the hot-swap primitive).

        Bumps ``network_version`` (or sets it to the explicit one), so every
        plan built for the old model stops hitting and ages out of the LRU.
        Queued queries are answered by the NEW model on the next flush.
        """
        self.bn = bn
        self.network_version = (self.network_version + 1
                                if network_version is None else network_version)
        if self._jt is not None:
            self._jt.set_model(bn, network_version=self.network_version)

    # -- query intake --------------------------------------------------------

    def _validate(self, target: str, evidence: Dict[str, float]
                  ) -> Dict[str, float]:
        """Reject malformed queries at SUBMIT time: flush() empties the
        queue before it answers, so a late error would drop queued work."""
        if self.mode == "vmp":
            if target != "Z":
                raise ValueError(f"mode='vmp' serves the latent Z, "
                                 f"got target {target!r}")
            names = {f"X{i}" for i in range(self.bn.spec.n_features)}
            missing = names - set(evidence)
            if missing:
                raise ValueError(f"mode='vmp' needs fully observed features; "
                                 f"missing {sorted(missing)}")
        return dict(evidence)

    def bucket_key(self, evidence: Dict[str, float]) -> tuple:
        """The schema bucket for evidence -- queries sharing a key ride one
        propagation."""
        return tuple(sorted(evidence))

    def submit(self, target: str, evidence: Dict[str, float]) -> PGMQuery:
        q = PGMQuery(self._next, target, self._validate(target, evidence))
        self._next += 1
        self._queue.append(q)
        return q

    def flush(self) -> List[PGMQuery]:
        """Answer every queued query; one propagation per evidence schema.
        Returns the queries in SUBMISSION order."""
        done, queue = [], self._queue
        self._queue = []
        groups: Dict[tuple, List[PGMQuery]] = {}
        for q in queue:
            groups.setdefault(self.bucket_key(q.evidence), []).append(q)
        for schema, qs in groups.items():
            if self.mode == "exact":
                self._flush_exact(schema, qs)
            else:
                self._flush_vmp(schema, qs)
            done.extend(qs)
        # callers pair results with requests positionally, and qid is the
        # submission sequence number
        done.sort(key=lambda q: q.qid)
        return done

    def _flush_exact(self, schema: tuple, qs: List[PGMQuery]) -> None:
        B = len(qs)
        cap = (1 << max(B - 1, 0).bit_length()) if self.pad_pow2 else B
        ev = {}
        for n in schema:
            col = np.asarray([q.evidence[n] for q in qs])
            if cap != B:
                # pad with copies of row 0: rows are independent through the
                # tree, so real rows stay equal to the unpadded run
                col = np.concatenate([col, np.repeat(col[:1], cap - B)])
            ev[n] = col
        self._jt.set_evidence(ev)
        self._jt.run_inference()
        logz = np.atleast_1d(self._jt.log_evidence().cpu().numpy())
        for target in {q.target for q in qs}:
            var = self.bn.dag.variables.by_name(target)
            post = np.atleast_2d(
                self._jt.posterior_discrete(var).cpu().numpy())
            for b, q in enumerate(qs):
                if q.target == target:
                    q.result = post[b if post.shape[0] > 1 else 0]
                    q.log_evidence = float(logz[b if logz.size > 1 else 0])
                    q.done = True

    def _flush_vmp(self, schema: tuple, qs: List[PGMQuery]) -> None:
        """q(Z | x) for a schema group in ONE posterior_z call (queries were
        validated at submit time: full evidence, target Z)."""
        spec = self.bn.spec
        dm = spec.discrete_map
        cont_ids = [i for i in range(spec.n_features) if i not in dm]
        B = len(qs)
        # pad to the next power of two so group sizes reuse a few plans
        cap = 1 << max(B - 1, 0).bit_length()
        xc = np.zeros((cap, len(cont_ids)), np.float32)
        xd = np.zeros((cap, len(dm)), np.int32)
        for b, q in enumerate(qs):
            xc[b] = [q.evidence[f"X{i}"] for i in cont_ids]
            xd[b] = [q.evidence[f"X{i}"] for i in sorted(dm)]
        key = PlanKey(self.network_version, "vmp", schema, (cap,))

        def build():
            # the posterior is read through self.bn at run time: model
            # updates between flushes are never served from a stale closure
            return lambda xc_, xd_: self.bn.posterior_z(
                Batch(xc_, xd_, np.ones(xc_.shape[0], np.float32)))

        plan = self.plans.get(key, build)
        post = plan.run(xc, xd).cpu().numpy()
        for b, q in enumerate(qs):
            q.result = post[b]
            q.done = True
