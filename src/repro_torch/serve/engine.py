"""Batched request serving (counterpart of ``repro.serve.engine``).

:class:`DecodeEngine` -- LM continuous batching: a fixed batch of request
slots decodes in lock-step (one shared position per step); a finished
request frees its slot for a queued prompt, whose tokens are fed one per
step (teacher-forced through ``decode_step``, as the JAX package does: no
separate prefill graph).  As there, a refilled slot keeps the caches and
state of the slot's earlier request.

:class:`PGMQueryEngine` -- queries against a CLG ``BayesianNetwork`` queue
up and, at ``flush()``, are grouped by evidence *schema* (the set of
observed variable names).  Each group rides the leading batch axis of the
junction-tree tables, so N exact queries sharing a schema cost ONE
propagation (``mode="exact"``); ``mode="importance"`` answers each query
with likelihood weighting (one sampler run a query, seeded ``seed + qid``);
``mode="vmp"`` serves q(Z | x) from a fitted plate model through
``Model.posterior_z``; ``mode="temporal"`` serves filtered and h-step
predictive hidden-state posteriors from a fitted HMM-family model
(``pgm_models.dynamic``), one factored-frontier pass per (T, horizon)
bucket.  ``mode="vmp"`` with a ``DeviceMesh`` splits each bucket over the
mesh's data shards (``core.dvmp.dvmp_posterior_z``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import dvmp
from repro_torch.data.stream import Batch
from repro_torch.nn import transformer as T
from repro_torch.obs import sink as obs
from repro_torch.obs.trace import span
from repro_torch.serve.plan import PlanCache, PlanKey

@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class DecodeEngine:
    """Lock-step decoding of ``batch`` request slots over one
    ``DecodeState`` of ``capacity`` KV slots; greedy, or sampled from a
    ``torch.Generator`` seeded with ``seed``.  Runs where ``params`` live.
    ``sh`` (a ``transformer.Shardings``): every rank runs the engine on the
    same requests with its blocks of the model (``sharding.shard_params``)
    and of the caches -- each ring's sequence split over ``model`` --, and
    gets the same tokens.

    The audio family is refused with ``ValueError``, as the JAX package's
    engine fails on it: its decode state needs encoder frames, and a
    request carries only a prompt."""

    def __init__(self, params, cfg, batch: int, capacity: int,
                 eos: Optional[int] = None, greedy: bool = True,
                 seed: int = 0, sh: T.Shardings = T.NO_SHARD):
        if cfg.arch_type == "audio":
            raise ValueError(f"{cfg.name}: DecodeEngine serves no audio "
                             f"model (its decode state needs enc_input, "
                             f"which a Request does not carry)")
        self.params, self.cfg, self.sh = params, cfg, sh
        self.batch, self.capacity = batch, capacity
        self.eos = eos
        self.greedy = greedy
        self.device = params["embed"]["table"].device
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = T.init_decode_state(params, cfg, batch, capacity, sh=sh)
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * batch
        self._pending_prefill: List[List[int]] = [[] for _ in range(batch)]
        self._tok = np.zeros((batch, 1), np.int64)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _fill_slots(self) -> None:
        for i in range(self.batch):
            if self.active[i] is None and self.queue:
                req = self.queue.pop(0)
                self.active[i] = req
                # prompt tokens are fed one per engine step (lock-step)
                self._pending_prefill[i] = list(req.prompt)
                self._tok[i, 0] = self._pending_prefill[i].pop(0) \
                    if self._pending_prefill[i] else 0

    @torch.no_grad()
    def step(self) -> int:
        """One synchronized decode step for the whole batch.

        Returns the number of active requests."""
        self._fill_slots()
        if not any(self.active):
            return 0
        tok = torch.from_numpy(self._tok).to(self.device)
        logits, self.state = T.decode_step(self.params, self.state, tok,
                                           self.cfg, sh=self.sh)
        if self.greedy:
            nxt = logits[:, 0].argmax(-1)
        else:
            nxt = torch.multinomial(torch.softmax(logits[:, 0], -1), 1,
                                    generator=self.gen)[:, 0]
        nxt = nxt.cpu().numpy()
        for i, req in enumerate(self.active):
            if req is None:
                continue
            if self._pending_prefill[i]:
                # still teacher-forcing the prompt
                self._tok[i, 0] = self._pending_prefill[i].pop(0)
                continue
            tok_i = int(nxt[i])
            req.out.append(tok_i)
            self._tok[i, 0] = tok_i
            if (self.eos is not None and tok_i == self.eos) \
                    or len(req.out) >= req.max_new:
                req.done = True
                self.active[i] = None
        return sum(r is not None for r in self.active)

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                break


def vmp_bucket_rows(n_queries: int, shards: int = 1) -> int:
    """Rows of a vmp bucket: the next power of two, so that group sizes
    reuse a few plans, rounded up to a multiple of the data shards so that
    every rank of a mesh takes an equal block (a world need not be a power
    of two)."""
    cap = 1 << max(n_queries - 1, 0).bit_length()
    return -(-cap // shards) * shards


@dataclasses.dataclass
class PGMQuery:
    qid: int
    target: str                       # variable whose posterior is requested
    evidence: Dict[str, float]
    payload: Optional[np.ndarray] = None      # temporal mode: [T, F] sequence
    result: Optional[np.ndarray] = None       # posterior table over target
    log_evidence: Optional[float] = None      # exact mode only
    done: bool = False


class PGMQueryEngine:
    """Schema-batched posterior queries over a CLG Bayesian network.

    ``mode="exact"`` routes through :class:`JunctionTreeEngine` -- queries
    with the same evidence schema propagate together in one batched pass,
    on ``device`` (the first card by default) with ``backend`` (the device's
    default: the CUDA kernels on a card).  ``mode="importance"`` answers each
    query with likelihood weighting, ``n_samples`` particles on ``device``
    from a generator seeded ``seed + qid``.  ``mode="vmp"`` serves q(Z | x)
    from a fitted plate model (``repro_torch.pgm_models``) on the model's
    own device; N fully observed queries sharing a schema cost one
    ``posterior_z`` call, and evidence must cover every feature ``X{i}``.
    ``mode="temporal"`` serves ``"filter"`` ([T, S] beliefs) and
    ``"predict"`` ([S], ``{"horizon": h}`` steps past the end) queries from
    a fitted HMM-family model on its own device: queries carry a [T, F]
    sequence payload, bucket by (T, horizon), and each bucket, padded to a
    power of two, costs one factored-frontier pass that reads the model's
    posterior at run time.

    ``mesh`` (a ``DeviceMesh``, ``mode="vmp"`` only, as in the reference)
    splits each vmp bucket, padded to at least the data size, over the
    ``data_axes`` shards; every rank gets every row.  The engine is then
    SPMD: every rank submits the same queries in the same order and
    flushes together.
    """

    def __init__(self, bn, *, mode: str = "exact", n_samples: int = 10_000,
                 seed: int = 0, backend: Optional[str] = None,
                 device: devmod.DeviceLike = None,
                 plan_cache: Optional[PlanCache] = None,
                 network_version: int = 0, pad_pow2: bool = False,
                 mesh=None, data_axes: Sequence[str] = ("data",)) -> None:
        from repro_torch.infer_exact import JunctionTreeEngine

        if mode not in ("exact", "importance", "vmp", "temporal"):
            raise ValueError(f"unknown mode {mode!r}")
        if mesh is not None:
            if mode != "vmp":
                raise ValueError("mesh replica sharding is only wired for "
                                 "mode='vmp' (the dvmp path)")
            data_axes = dvmp.check_mesh(mesh, data_axes)
        if mode == "vmp":
            # ``bn`` is a plate Model with a discrete latent Z
            if not hasattr(bn, "cp") or bn.cp.layout.K <= 1:
                raise ValueError("mode='vmp' needs a plate Model with a "
                                 "discrete latent Z")
        if mode == "temporal" and not hasattr(bn, "filtered_posterior"):
            raise ValueError("mode='temporal' needs a fitted HMM-family "
                             "model (pgm_models.dynamic)")
        self.bn = bn
        self.mode = mode
        self.n_samples = n_samples
        self.seed = seed
        # importance mode samples on this device, which must hold the network
        self._is_device = (devmod.resolve_device(device)
                           if mode == "importance" else None)
        # pad exact-mode buckets to the next power of two (vmp and temporal
        # always do) so arbitrary batch sizes reuse a handful of plans
        self.pad_pow2 = pad_pow2
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
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

    def _validate(self, target: str, evidence: Dict[str, float],
                  payload: Optional[np.ndarray] = None
                  ) -> Tuple[Dict[str, float], Optional[np.ndarray]]:
        """Reject malformed queries at SUBMIT time (flush() empties the
        queue before it answers, so a late error would drop queued work);
        returns the normalised (evidence, payload)."""
        if self.mode == "vmp":
            if target != "Z":
                raise ValueError(f"mode='vmp' serves the latent Z, "
                                 f"got target {target!r}")
            names = {f"X{i}" for i in range(self.bn.spec.n_features)}
            missing = names - set(evidence)
            if missing:
                raise ValueError(f"mode='vmp' needs fully observed features; "
                                 f"missing {sorted(missing)}")
        if self.mode == "temporal":
            if target not in ("filter", "predict"):
                raise ValueError(f"mode='temporal' serves 'filter' or "
                                 f"'predict', got target {target!r}")
            arr = np.asarray(payload, np.float32)
            if arr.ndim != 2:
                raise ValueError("mode='temporal' needs a [T, F] sequence "
                                 "payload")
            h = 0 if target == "filter" else int(evidence.get("horizon", 1))
            # value-carrying schema: same-(T, horizon) queries batch together
            return {"T": float(arr.shape[0]), "h": float(h)}, arr
        return dict(evidence), None

    def bucket_key(self, evidence: Dict[str, float]) -> tuple:
        """The schema bucket for (normalised) evidence -- queries sharing a
        key ride one propagation.  Temporal buckets carry values ((T,
        horizon), not just the names): the sequence length selects the
        plan."""
        if self.mode == "temporal":
            return tuple(f"{k}{int(v)}" for k, v in sorted(evidence.items()))
        return tuple(sorted(evidence))

    def submit(self, target: str, evidence: Dict[str, float],
               payload: Optional[np.ndarray] = None) -> PGMQuery:
        ev, arr = self._validate(target, evidence, payload)
        q = PGMQuery(self._next, target, ev, arr)
        self._next += 1
        self._queue.append(q)
        return q

    def flush(self) -> List[PGMQuery]:
        """Answer every queued query; one propagation per evidence schema.
        Returns the queries in SUBMISSION order.

        With ``repro_torch.obs`` on, each schema bucket emits a
        ``serve_bucket`` event (queue depth, batch, plan-cache hit, build
        and execute split from the junction tree's ``last_run``, wall
        latency) and the flush a ``serve_flush`` summary and a
        ``kernel_dispatch`` snapshot; at TRACE, ``serve.flush`` /
        ``serve.bucket`` spans.  Off, each bucket adds one integer compare.
        """
        done, queue = [], self._queue
        self._queue = []
        groups: Dict[tuple, List[PGMQuery]] = {}
        for q in queue:
            groups.setdefault(self.bucket_key(q.evidence), []).append(q)
        queue_depth = len(queue)
        with span("serve.flush", mode=self.mode, n_queries=queue_depth,
                  n_buckets=len(groups)):
            for schema, qs in groups.items():
                t0 = time.perf_counter_ns()
                with span("serve.bucket", mode=self.mode,
                          schema=",".join(schema), batch=len(qs)):
                    if self.mode == "exact":
                        binfo = self._flush_exact(schema, qs)
                    elif self.mode == "vmp":
                        binfo = self._flush_vmp(schema, qs)
                    elif self.mode == "temporal":
                        binfo = self._flush_temporal(schema, qs)
                    else:
                        binfo = self._flush_importance(qs)
                if obs.enabled():
                    obs.emit("serve_bucket", mode=self.mode,
                             schema=",".join(schema), batch=len(qs),
                             queue_depth=queue_depth,
                             latency_us=(time.perf_counter_ns() - t0) / 1e3,
                             **binfo)
                done.extend(qs)
        if obs.enabled():
            obs.emit("serve_flush", mode=self.mode, n_queries=queue_depth,
                     n_buckets=len(groups))
            obs.emit_kernel_counts(site="serve.flush")
        # callers pair results with requests positionally, and qid is the
        # submission sequence number
        done.sort(key=lambda q: q.qid)
        return done

    def _flush_exact(self, schema: tuple, qs: List[PGMQuery]) -> dict:
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
        lr = self._jt.last_run or {}
        return {"cache_hit": bool(lr.get("cache_hit", False)),
                "compile_us": lr.get("compile_us", 0.0),
                "execute_us": lr.get("execute_us", 0.0)}

    def _flush_vmp(self, schema: tuple, qs: List[PGMQuery]) -> dict:
        """q(Z | x) for a schema group in ONE posterior_z call (queries were
        validated at submit time: full evidence, target Z)."""
        spec = self.bn.spec
        dm = spec.discrete_map
        cont_ids = [i for i in range(spec.n_features) if i not in dm]
        shards = (1 if self.mesh is None
                  else dvmp.data_size(self.mesh, self.data_axes))
        cap = vmp_bucket_rows(len(qs), shards)
        xc = np.zeros((cap, len(cont_ids)), np.float32)
        xd = np.zeros((cap, len(dm)), np.int32)
        for b, q in enumerate(qs):
            xc[b] = [q.evidence[f"X{i}"] for i in cont_ids]
            xd[b] = [q.evidence[f"X{i}"] for i in sorted(dm)]
        key = PlanKey(self.network_version, "vmp", schema, (cap,))
        cache_hit = self.plans.peek(key) is not None

        def build():
            # the posterior is read through self.bn at run time: model
            # updates between flushes are never served from a stale closure
            if self.mesh is None:
                return lambda xc_, xd_: self.bn.posterior_z(
                    Batch(xc_, xd_, np.ones(xc_.shape[0], np.float32)))

            def run(xc_, xd_):
                m = self.bn
                b = m._as_batch(Batch(xc_, xd_, np.ones(xc_.shape[0],
                                                        np.float32)))
                return dvmp.dvmp_posterior_z(
                    m.cp, m.posterior, b.xc, b.xd, self.mesh,
                    self.data_axes, backend=m.backend, chunk=m.chunk)
            return run

        plan = self.plans.get(key, build)
        post = plan.run(xc, xd).cpu().numpy()
        for b, q in enumerate(qs):
            q.result = post[b]
            q.done = True
        return {"cache_hit": cache_hit, "compile_us": 0.0, "execute_us": 0.0}

    def _flush_temporal(self, schema: tuple, qs: List[PGMQuery]) -> dict:
        """Filtered / predictive state posteriors for one (T, horizon)
        bucket: the sequences stack into one [cap, T, F] batch (cap = the
        next power of two; padded rows carry a zero mask) and ride one
        factored-frontier pass (``dynamic._temporal_serve``)."""
        from repro_torch.pgm_models import dynamic as dyn

        h = int(qs[0].evidence["h"])
        B = len(qs)
        cap = 1 << max(B - 1, 0).bit_length()
        T, F = qs[0].payload.shape
        xs = np.zeros((cap, T, F), np.float32)
        mask = np.zeros((cap, T), np.float32)
        for b, q in enumerate(qs):
            xs[b] = q.payload
            mask[b] = 1.0
        key = PlanKey(self.network_version, "temporal", schema, (cap, T))
        cache_hit = self.plans.peek(key) is not None

        def build():
            # the posterior is read through self.bn at run time: a refitted
            # or swapped model is never served from a stale closure
            def run(xs_, mask_):
                m = self.bn
                dev = m.device
                xc = torch.from_numpy(xs_).to(dev)
                return dyn._temporal_serve(
                    m.posterior, m._design(xc), m._emission_target(xc),
                    torch.from_numpy(mask_).to(dev), horizon=h)
            return run

        beliefs, last = self.plans.get(key, build).run(xs, mask)
        beliefs, last = beliefs.cpu().numpy(), last.cpu().numpy()
        for b, q in enumerate(qs):
            q.result = beliefs[b] if q.target == "filter" else last[b]
            q.done = True
        if not cache_hit and obs.enabled():
            obs.emit("temporal_plan", pipeline="factored_frontier",
                     batch=cap, T=T, S=int(self.bn.S), horizon=h)
        return {"cache_hit": cache_hit, "compile_us": 0.0, "execute_us": 0.0}

    def _flush_importance(self, qs: List[PGMQuery]) -> dict:
        """One likelihood-weighting run a query on the engine's device,
        seeded ``seed + qid`` (so an answer does not depend on what else
        was queued)."""
        from repro_torch.core.importance_sampling import ImportanceSampling

        for q in qs:
            inf = ImportanceSampling(n_samples=self.n_samples,
                                     seed=self.seed + q.qid,
                                     device=self._is_device)
            inf.set_model(self.bn)
            inf.set_evidence(q.evidence)
            inf.run_inference()
            var = self.bn.dag.variables.by_name(q.target)
            q.result = inf.posterior_discrete(var).cpu().numpy()
            q.done = True
        return {"cache_hit": False, "compile_us": 0.0, "execute_us": 0.0}
