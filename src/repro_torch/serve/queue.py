"""Async serving tier — deadline-aware micro-batching over PGMQueryEngine
(the port's counterpart of ``repro.serve.queue``).

* **Request queue + micro-batching** — :meth:`AsyncPGMServer.submit` returns
  immediately with a :class:`ServeTicket`; arriving queries coalesce into
  bucket-shaped batches (same grouping as :meth:`PGMQueryEngine.bucket_key`)
  and flush on size-or-timeout, with per-request deadlines driving flush
  order: the due bucket with the earliest deadline always flushes first.

* **Replicas** — ``replicas=N`` runs N worker threads over N engine
  replicas; all replicas share ONE :class:`~repro_torch.serve.plan.
  PlanCache`, so a plan built by any replica serves all of them (a plan's
  propagation only reads its engine).  ``mesh=`` (a ``DeviceMesh``)
  additionally splits each vmp bucket over the mesh's data shards
  (``PGMQueryEngine(mesh=)``, the d-VMP path); the engine is SPMD, and
  bucket boundaries follow each process's clock, so a mesh of more than one
  rank needs every rank to see the same buckets.

* **Hot model swap** — :meth:`swap_model` publishes a re-learnt network
  under ``network_version + 1``: new-version engines are built and their
  plans warmed in the background (serving continues), the engine list is
  switched atomically, queued-but-unflushed buckets drain through the OLD
  engines, and once the flushes that workers began on the OLD engines have
  ended, the old version's plans are invalidated.  No request is
  dropped; results issued before the switch come from the old network,
  after it from the new.

* **Robustness** (``repro_torch.resilience`` error vocabulary) —
  ``max_queue=`` bounds the submit queue with load shedding (rejected
  tickets carry a :class:`~repro_torch.resilience.errors.ShedError`),
  ``request_timeout_ms=`` arms a watchdog that fails stuck requests with a
  :class:`~repro_torch.resilience.errors.DeadlineError` instead of hanging
  the caller, and a supervisor thread detects dead worker replicas,
  requeues their in-flight bucket and respawns them — zero lost accepted
  tickets.

* **Replica health scoring** (``repro_torch.obs.health``) — every flush
  feeds a per-worker :class:`~repro_torch.obs.health.HealthTracker`
  (latency EWMA + error/timeout/crash demerits).  A worker whose score
  drops below ``health_threshold`` × the best replica's score defers
  claiming due buckets for ``health_penalty_ms``, so traffic drains toward
  healthy replicas *before* the sick one dies — without ever stranding a
  ticket.  Scoring reads host wall-clocks only; it never changes what a
  flush computes, so results stay bit-identical at every obs level.

**One card, several threads.**  Every worker issues its work on the
default CUDA stream of the engine's device, so the card runs the replicas'
flushes in issue order.  A worker never relies on its thread's current
device (torch keeps one a thread): the engines' tensors carry their
device, and the kernel wrappers launch on the stream of the tensor's
device, switching to it when it is not the current one.  Plans in
the shared cache hold tensors (CPDs, the fitted posterior) made on one
thread and read on another; that is safe on one stream.  Per-replica
streams would need ``record_stream`` and event waits for those tensors,
and are not done.  The host side of a flush holds the GIL, so replicas
overlap one flush's host work only with another's device work and waits.

Flush decisions emit ``serve_deadline`` events and swaps emit
``serve_swap`` (schema-validated, ``repro_torch.obs``); sheds, respawns
and retries emit ``serve_shed``/``serve_worker``/``serve_retry``; the
per-bucket ``serve_bucket`` telemetry comes from the underlying engine
unchanged.  When obs is enabled, each flush additionally records
per-request end-to-end latency into the ``serve_request_ms{mode,schema}``
histogram of the default metrics registry (``repro_torch.obs.agg``) and
emits a rolling ``slo`` event (exact-rank p50/p95/p99 + deadline-miss
rate); the supervisor periodically emits ``serve_health`` score snapshots.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import agg as _agg
from repro_torch.obs import sink as obs
from repro_torch.obs.health import HealthTracker
from repro_torch.resilience.errors import DeadlineError, ShedError
from repro_torch.serve.engine import PGMQueryEngine, PGMQuery
from repro_torch.serve.plan import PlanCache


class ServeTicket:
    """Future-like handle for one submitted query.

    ``result(timeout)`` blocks until the micro-batch containing the query
    flushes; ``query`` then holds the answered :class:`PGMQuery`.
    """

    __slots__ = ("rid", "deadline_s", "submitted_s", "done_s", "query",
                 "error", "deadline_miss", "trigger", "_event", "_lock")

    def __init__(self, rid: int, deadline_s: float, submitted_s: float):
        self.rid = rid
        self.deadline_s = deadline_s        # monotonic-clock deadline
        self.submitted_s = submitted_s
        self.done_s: Optional[float] = None
        self.query: Optional[PGMQuery] = None
        self.error: Optional[BaseException] = None
        self.deadline_miss = False
        self.trigger: Optional[str] = None  # what flushed the batch
        self._event = threading.Event()
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def _finish(self, *, query: Optional[PGMQuery] = None,
                error: Optional[BaseException] = None,
                trigger: Optional[str] = None, deadline_miss: bool = False,
                done_s: Optional[float] = None) -> bool:
        """First completion wins — the flush path and the timeout watchdog
        can race to finish the same ticket; the loser is a no-op so a
        result already observed by the caller is never mutated."""
        with self._lock:
            if self._event.is_set():
                return False
            self.query = query
            self.error = error
            self.trigger = trigger
            self.deadline_miss = deadline_miss
            self.done_s = done_s
            self._event.set()
            return True

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Posterior table for the query (blocks until flushed)."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not served "
                               f"within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.query.result


class SwapHandle:
    """Returned by ``swap_model(block=False)``: readiness event + outcome.

    ``wait()`` blocks until the background swap publishes (returning the
    summary dict) or fails (re-raising the warm-compile error — in which
    case the OLD engines are still serving, untouched)."""

    __slots__ = ("ready", "info", "error")

    def __init__(self) -> None:
        self.ready = threading.Event()
        self.info: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None

    def done(self) -> bool:
        return self.ready.is_set()

    def wait(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if not self.ready.wait(timeout):
            raise TimeoutError(f"model swap not ready within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.info


class _Bucket:
    __slots__ = ("key", "items", "first_s", "min_deadline_s", "version")

    def __init__(self, key: tuple, now: float):
        self.key = key
        # items hold the ORIGINAL (target, evidence, payload) so the engine
        # re-normalizes at flush time (e.g. temporal horizon extraction)
        self.items: List[Tuple[ServeTicket, str, Dict[str, float],
                               Optional[np.ndarray]]] = []
        self.first_s = now
        self.min_deadline_s = float("inf")
        # network version of the engines a worker took to flush it
        self.version: Optional[int] = None


class AsyncPGMServer:
    """Deadline-aware async micro-batching server over PGMQueryEngine.

    Parameters
    ----------
    max_batch        size trigger: a bucket reaching this many queries
                     flushes immediately (the whole bucket flushes — the
                     pow2 padding downstream absorbs overshoot)
    max_delay_ms     timeout trigger: no query waits longer than this for
                     batch-mates, deadline permitting
    default_deadline_ms
                     per-request deadline when ``submit`` gives none; a
                     bucket flushes ``deadline_margin_ms`` before its
                     earliest deadline even if ``max_delay_ms`` has not
                     elapsed
    replicas         worker threads x engine replicas (shared plan cache)
    backend, device  the engines' backend and device (``PGMQueryEngine``:
                     the first card and its kernels by default)
    mesh, data_axes  vmp mode only: split each bucket over the mesh's data
                     shards
    max_queue        bound on pending (submitted - completed) requests:
                     a submit over capacity is SHED — its ticket returns
                     immediately carrying a ``ShedError`` (None = unbounded)
    request_timeout_ms
                     watchdog grace past the request deadline: a ticket
                     still unanswered ``deadline + timeout`` after submit
                     fails with ``DeadlineError`` instead of hanging its
                     caller behind a stuck flush (None = no watchdog)
    supervise        run the supervisor thread (worker liveness + request
                     timeouts); on by default
    health           track per-replica health scores and bias dispatch
                     away from degraded workers (on by default; a lone
                     replica never defers)
    health_alpha, health_threshold
                     EWMA smoothing / degraded cut-off for the
                     :class:`~repro_torch.obs.health.HealthTracker`
    health_penalty_ms
                     how long a degraded worker holds back from claiming
                     a due bucket before serving it anyway (default:
                     2 x ``max_delay_ms``) — the bias window, not a drop
    """

    def __init__(self, bn, *, mode: str = "exact", max_batch: int = 32,
                 max_delay_ms: float = 5.0, default_deadline_ms: float = 50.0,
                 deadline_margin_ms: float = 1.0, replicas: int = 1,
                 backend: Optional[str] = None, device=None, mesh=None,
                 data_axes: Tuple[str, ...] = ("data",),
                 plan_cache: Optional[PlanCache] = None,
                 n_samples: int = 10_000, seed: int = 0,
                 max_queue: Optional[int] = None,
                 request_timeout_ms: Optional[float] = None,
                 supervise: bool = True,
                 supervise_interval_ms: float = 10.0,
                 health: bool = True, health_alpha: float = 0.3,
                 health_threshold: float = 0.5,
                 health_penalty_ms: Optional[float] = None) -> None:
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        self.mode = mode
        self.max_batch = max_batch
        self.max_delay_s = max_delay_ms / 1e3
        self.default_deadline_s = default_deadline_ms / 1e3
        self.margin_s = deadline_margin_ms / 1e3
        self.max_queue = max_queue
        self.request_timeout_s = (None if request_timeout_ms is None
                                  else request_timeout_ms / 1e3)
        self._mk = dict(mode=mode, backend=backend, device=device, mesh=mesh,
                        data_axes=data_axes, n_samples=n_samples, seed=seed)
        self.plans = plan_cache if plan_cache is not None else PlanCache()
        self.network_version = 0
        self._engines = [self._make_engine(bn, 0) for _ in range(replicas)]
        self._cv = threading.Condition()
        self._buckets: Dict[tuple, _Bucket] = {}
        # one arrival sample per seen bucket — the swap warm-up workload
        self._samples: Dict[tuple, Tuple[str, Dict[str, float],
                                         Optional[np.ndarray]]] = {}
        self._next_rid = 0
        self._stop = False
        self.submitted = 0
        self.completed = 0
        self.deadline_misses = 0
        self.shed = 0
        self.worker_restarts = 0
        self.flushes: Dict[str, int] = {}
        self.health = (HealthTracker(replicas, alpha=health_alpha,
                                     threshold=health_threshold)
                       if health else None)
        self._penalty_s = ((2.0 * max_delay_ms if health_penalty_ms is None
                            else health_penalty_ms) / 1e3)
        self._health_emit_s = 0.25
        self._health_last_emit = 0.0
        # fault-injection seam: called (widx, bucket) after a worker pops a
        # bucket and before it flushes; raising kills the worker mid-flight
        self._flush_hook = None
        # bucket each worker is currently flushing — the supervisor requeues
        # it if the worker dies before clearing its slot
        self._inflight: Dict[int, Optional[_Bucket]] = {
            i: None for i in range(replicas)}
        self._swap_lock = threading.Lock()
        self._workers = [
            threading.Thread(target=self._worker_loop, args=(i,), daemon=True,
                             name=f"serve-worker-{i}")
            for i in range(replicas)]
        for w in self._workers:
            w.start()
        self._sup_stop = threading.Event()
        self._sup_interval_s = supervise_interval_ms / 1e3
        self._supervisor: Optional[threading.Thread] = None
        if supervise:
            self._supervisor = threading.Thread(
                target=self._supervisor_loop, daemon=True,
                name="serve-supervisor")
            self._supervisor.start()

    def _make_engine(self, bn, version: int) -> PGMQueryEngine:
        eng = PGMQueryEngine(bn, plan_cache=self.plans,
                             network_version=version, pad_pow2=True,
                             **self._mk)
        # serializes this replica's submit+flush against the swap drain
        eng._serve_lock = threading.Lock()
        return eng

    # -- intake ---------------------------------------------------------------

    def submit(self, target: str, evidence: Dict[str, float],
               payload: Optional[np.ndarray] = None,
               deadline_ms: Optional[float] = None) -> ServeTicket:
        """Enqueue one query; returns immediately with a ticket.

        Over ``max_queue`` pending requests the submit is SHED: the
        returned ticket is already finished with a ``ShedError`` (the
        request was never accepted — retry after backoff is safe)."""
        eng = self._engines[0]
        ev, _ = eng._validate(target, evidence, payload)  # raise HERE, async
        key = eng.bucket_key(ev)
        now = time.monotonic()
        ddl = now + (self.default_deadline_s if deadline_ms is None
                     else deadline_ms / 1e3)
        depth = None
        with self._cv:
            if self._stop:
                raise RuntimeError("server is stopped")
            t = ServeTicket(self._next_rid, ddl, now)
            self._next_rid += 1
            if (self.max_queue is not None
                    and self.submitted - self.completed >= self.max_queue):
                depth = self.submitted - self.completed
                self.shed += 1
                t._finish(error=ShedError(
                    f"queue at capacity ({depth}/{self.max_queue} pending)"),
                    trigger="shed", done_s=now)
            else:
                self._enqueue_locked(t, key, target, evidence, payload,
                                     ddl, now)
        if depth is not None and obs.enabled():
            obs.emit("serve_shed", mode=self.mode, queue_depth=depth,
                     max_queue=self.max_queue)
            _agg.REGISTRY.counter("serve_shed_total", mode=self.mode).inc()
        return t

    def _enqueue_locked(self, t: ServeTicket, key: tuple, target: str,
                        evidence: Dict[str, float],
                        payload: Optional[np.ndarray], ddl: float,
                        now: float) -> None:
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = _Bucket(key, now)
        b.items.append((t, target, dict(evidence),
                        None if payload is None else np.asarray(payload)))
        b.min_deadline_s = min(b.min_deadline_s, ddl)
        self._samples.setdefault(
            key, (target, dict(evidence),
                  None if payload is None else np.asarray(payload)))
        self.submitted += 1
        self._cv.notify_all()

    # -- flush scheduling -----------------------------------------------------

    def _due_time(self, b: _Bucket) -> float:
        return min(b.first_s + self.max_delay_s,
                   b.min_deadline_s - self.margin_s)

    def _pop_due_locked(self, now: float, defer: bool = False
                        ) -> Optional[Tuple[_Bucket, str]]:
        """Earliest-deadline due bucket (or None).  Caller holds _cv.

        ``defer=True`` (a degraded worker asking) only yields buckets that
        have been due for longer than the health penalty window — healthy
        workers get first claim, but nothing is ever stranded: past the
        grace the degraded worker serves the bucket itself."""
        grace = self._penalty_s if defer else 0.0
        due = [b for b in self._buckets.values()
               if self._stop
               or (not defer and len(b.items) >= self.max_batch)
               or now >= self._due_time(b) + grace]
        if not due:
            return None
        b = min(due, key=lambda b: b.min_deadline_s)
        del self._buckets[b.key]
        if len(b.items) >= self.max_batch:
            trigger = "size"
        elif self._stop:
            trigger = "drain"
        elif b.min_deadline_s - self.margin_s <= b.first_s + self.max_delay_s:
            trigger = "deadline"
        else:
            trigger = "timeout"
        return b, trigger

    def _worker_loop(self, widx: int) -> None:
        while True:
            with self._cv:
                while True:
                    if self._stop and not self._buckets:
                        return
                    now = time.monotonic()
                    defer = (self.health is not None and not self._stop
                             and self.health.should_defer(widx))
                    item = self._pop_due_locked(now, defer=defer)
                    if item is not None:
                        engines = self._engines
                        # registered BEFORE flush: if this thread dies the
                        # supervisor requeues the bucket from here
                        self._inflight[widx] = item[0]
                        item[0].version = self.network_version
                        break
                    grace = self._penalty_s if defer else 0.0
                    nxt = min((self._due_time(b)
                               for b in self._buckets.values()),
                              default=None)
                    self._cv.wait(None if nxt is None
                                  else max(1e-4, nxt + grace - now))
            bucket, trigger = item
            t0 = time.monotonic()
            hook = self._flush_hook
            if hook is not None:
                # fault injection: a raise here kills the worker with the
                # bucket still registered in-flight (supervised recovery)
                hook(widx, bucket)
            failed = self._flush_bucket(engines[widx % len(engines)], bucket,
                                        trigger)
            if self.health is not None:
                # t0 predates the flush hook, so an injected stall shows up
                # in this worker's latency EWMA exactly like a real one
                self.health.record_flush(
                    widx, (time.monotonic() - t0) * 1e3, error=failed)
            with self._cv:
                self._inflight[widx] = None
                self._cv.notify_all()       # a swap may wait on this flush

    def _flush_bucket(self, eng: PGMQueryEngine, bucket: _Bucket,
                      trigger: str) -> bool:
        """Flush one bucket; returns True when the engine flush failed
        (the tickets were failed, never hung — the flag feeds health)."""
        now = time.monotonic()
        wait_us = (now - bucket.first_s) * 1e6
        pairs: List[Tuple[ServeTicket, PGMQuery]] = []
        err: Optional[BaseException] = None
        try:
            with eng._serve_lock:
                for t, target, evidence, payload in bucket.items:
                    pairs.append((t, eng.submit(target, evidence, payload)))
                eng.flush()
        except BaseException as e:          # fail the tickets, never hang them
            err = e
        done_s = time.monotonic()
        miss = 0
        finished = 0
        lats_ms: List[float] = []
        for t, q in pairs:
            late = done_s > t.deadline_s
            if t._finish(query=q, error=err, trigger=trigger, done_s=done_s,
                         deadline_miss=late):
                finished += 1
                miss += late
                lats_ms.append((done_s - t.submitted_s) * 1e3)
            # else: the timeout watchdog already failed this ticket
        if err is not None:                 # tickets created before the error
            for t, *_rest in bucket.items[len(pairs):]:
                if t._finish(error=err, trigger=trigger, done_s=done_s,
                             deadline_miss=done_s > t.deadline_s):
                    finished += 1
        with self._cv:
            self.completed += finished
            self.deadline_misses += miss
            self.flushes[trigger] = self.flushes.get(trigger, 0) + 1
        if obs.enabled():
            schema = ",".join(bucket.key)
            obs.emit("serve_deadline", mode=self.mode, schema=schema,
                     batch=len(bucket.items), trigger=trigger,
                     wait_us=wait_us, deadline_miss=miss)
            if lats_ms:
                self._record_slo(schema, lats_ms, miss)
        return err is not None

    def _record_slo(self, schema: str, lats_ms: List[float],
                    miss: int) -> None:
        """Fold one flush's end-to-end request latencies into the
        ``serve_request_ms{mode,schema}`` histogram and emit a rolling
        ``slo`` snapshot (exact-rank quantiles over everything recorded
        so far for this mode/schema).  Only called when obs is enabled."""
        hist = _agg.REGISTRY.histogram("serve_request_ms", mode=self.mode,
                                       schema=schema)
        for ms in lats_ms:
            hist.record(ms)
        misses = _agg.REGISTRY.counter("serve_deadline_miss_total",
                                       mode=self.mode, schema=schema)
        if miss:
            misses.inc(miss)
        p50, p95, p99 = hist.quantiles((0.5, 0.95, 0.99))
        obs.emit("slo", mode=self.mode, schema=schema, count=hist.count,
                 p50_ms=p50, p95_ms=p95, p99_ms=p99,
                 miss_rate=misses.value / max(hist.count, 1))

    # -- supervision ----------------------------------------------------------

    def _check_workers_locked(self) -> List[Tuple[int, int, threading.Thread]]:
        """Detect dead worker threads: requeue each one's in-flight bucket
        (merging into any bucket that re-formed under the same key) and
        stage a replacement thread.  Caller holds ``_cv``; the staged
        threads must be started OUTSIDE the lock."""
        staged = []
        for widx, w in enumerate(self._workers):
            if w.is_alive():
                continue
            b = self._inflight.get(widx)
            if b is None and self._stop:
                continue                    # normal shutdown exit
            requeued = 0
            if b is not None:
                self._inflight[widx] = None
                live = self._buckets.get(b.key)
                if live is None:
                    self._buckets[b.key] = b
                else:
                    live.items.extend(b.items)
                    live.first_s = min(live.first_s, b.first_s)
                    live.min_deadline_s = min(live.min_deadline_s,
                                              b.min_deadline_s)
                requeued = len(b.items)
            nw = threading.Thread(target=self._worker_loop, args=(widx,),
                                  daemon=True, name=f"serve-worker-{widx}")
            self._workers[widx] = nw
            self.worker_restarts += 1
            staged.append((widx, requeued, nw))
        if staged:
            self._cv.notify_all()
        return staged

    def _expired_tickets_locked(self, now: float
                                ) -> List[Tuple[ServeTicket, Optional[int]]]:
        """Tickets past deadline + request timeout, queued or in-flight.
        In-flight tickets carry the index of the worker holding them (the
        timeout is that replica's demerit); queued ones carry None."""
        if self.request_timeout_s is None:
            return []
        cut = self.request_timeout_s
        out: List[Tuple[ServeTicket, Optional[int]]] = []
        for b in self._buckets.values():
            out += [(t, None) for t, *_ in b.items
                    if not t.done() and now > t.deadline_s + cut]
        for widx, b in self._inflight.items():
            if b is not None:
                out += [(t, widx) for t, *_ in b.items
                        if not t.done() and now > t.deadline_s + cut]
        return out

    def _supervise_once(self) -> None:
        now = time.monotonic()
        with self._cv:
            staged = self._check_workers_locked()
            expired = self._expired_tickets_locked(now)
        for widx, requeued, nw in staged:
            nw.start()
            if self.health is not None:
                self.health.record_penalty(widx, "crash")
            if obs.enabled():
                obs.emit("serve_worker", worker=widx, action="respawn",
                         requeued=requeued)
        timed_out = 0
        for t, widx in expired:
            if t._finish(error=DeadlineError(
                    f"request {t.rid} timed out "
                    f"({self.request_timeout_s * 1e3:.0f}ms past deadline)"),
                    trigger="watchdog", done_s=now, deadline_miss=True):
                timed_out += 1
                if widx is not None and self.health is not None:
                    self.health.record_timeout(widx)
        if timed_out:
            with self._cv:
                self.completed += timed_out
                self.deadline_misses += timed_out
        self._emit_health()

    def _emit_health(self, force: bool = False) -> None:
        """Emit one ``serve_health`` event per replica (rate-limited to
        one snapshot per ``_health_emit_s`` unless forced) and mirror the
        scores into the registry's ``replica_score`` gauges."""
        if self.health is None or not obs.enabled():
            return
        now = time.monotonic()
        if not force and now - self._health_last_emit < self._health_emit_s:
            return
        self._health_last_emit = now
        for w, snap in enumerate(self.health.snapshots()):
            obs.emit("serve_health", worker=w, **snap)
            _agg.REGISTRY.gauge("replica_score", worker=w).set(snap["score"])

    def _supervisor_loop(self) -> None:
        while not self._sup_stop.wait(self._sup_interval_s):
            self._supervise_once()

    # -- hot model swap -------------------------------------------------------

    def swap_model(self, bn, *, warm: bool = True, block: bool = True):
        """Publish ``bn`` as a new network version without dropping traffic.

        1. Build new-version engine replicas and (``warm=True``) compile
           their plans by mirroring the OLD version's plan working set:
           for each old plan, the recorded sample request of its bucket is
           replayed at the plan's batch capacity — serving continues on
           the old engines throughout.
        2. Atomically switch the engine list: submissions from here on are
           answered by the new network.
        3. Drain queued-but-unflushed buckets through the OLD engines
           (deadline order), wait for the flushes that workers started on
           the OLD engines before the switch, then invalidate the old
           version's plans: none is left in the cache when this returns.

        ``block=True`` runs inline and returns the summary dict (also
        emitted as a ``serve_swap`` event).  ``block=False`` runs the
        whole sequence — including warm compilation — on a background
        thread and returns a :class:`SwapHandle` immediately; serving is
        never paused while the new version warms.

        A warm-compilation failure ABORTS the swap before the switch: the
        old engines keep serving untouched, the partially-warmed
        new-version plans are invalidated, and the error is re-raised
        (from this call when blocking, from ``handle.wait()`` otherwise).
        """
        handle = SwapHandle()

        def run() -> None:
            try:
                handle.info = self._do_swap(bn, warm)
            except BaseException as e:
                handle.error = e
            finally:
                handle.ready.set()

        if block:
            run()
            if handle.error is not None:
                raise handle.error
            return handle.info
        threading.Thread(target=run, daemon=True,
                         name="serve-swap").start()
        return handle

    def _do_swap(self, bn, warm: bool) -> Dict[str, Any]:
        t0 = time.perf_counter_ns()
        with self._swap_lock:               # concurrent swaps serialize
            with self._cv:
                old_version = self.network_version
                samples = dict(self._samples)
                n_rep = len(self._engines)
            new_version = old_version + 1
            try:
                new_engines = [self._make_engine(bn, new_version)
                               for _ in range(n_rep)]
                warmed = 0
                if warm:
                    # shared plan cache: one replica warms all
                    eng = new_engines[0]
                    old_keys = [k for k in self.plans.keys()
                                if k.network_version == old_version]
                    # bucket key == PlanKey.schema in every mode, so each
                    # old plan maps back to its bucket's sample request
                    for k in old_keys:
                        s = samples.get(k.schema)
                        if s is None:
                            continue
                        target, evidence, payload = s
                        with eng._serve_lock:
                            for _ in range(k.batch_shape[0]):
                                eng.submit(target, evidence, payload)
                            eng.flush()
                    warmed = sum(1 for k in self.plans.keys()
                                 if k.network_version == new_version)
            except BaseException:
                # abort: nothing switched — old engines serve on; drop any
                # half-warmed plans so the failed version leaves no residue
                self.plans.invalidate(new_version)
                raise
            with self._cv:
                old_engines, self._engines = self._engines, new_engines
                drained = list(self._buckets.values())
                self._buckets.clear()
                self.network_version = new_version
            n_drained = sum(len(b.items) for b in drained)
            for b in sorted(drained, key=lambda b: b.min_deadline_s):
                self._flush_bucket(old_engines[0], b, "drain")
            with self._cv:
                # flushes that took the old engines before the switch: wait
                # them out, or one could cache an old plan after the
                # invalidation.  A dead worker flushes nothing more (the
                # supervisor requeues its bucket onto the new engines), so
                # its death is polled for rather than notified.
                while any(b is not None and b.version < new_version
                          and self._workers[w].is_alive()
                          for w, b in self._inflight.items()):
                    self._cv.wait(self._sup_interval_s)
            self.plans.invalidate(old_version)
        info = {"old_version": old_version, "new_version": new_version,
                "warmed_plans": warmed, "drained": n_drained,
                "dur_us": (time.perf_counter_ns() - t0) / 1e3}
        if obs.enabled():
            obs.emit("serve_swap", **info)
        return info

    # -- lifecycle ------------------------------------------------------------

    def stop(self) -> None:
        """Drain every queued bucket, then stop workers and supervisor."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for w in list(self._workers):
            # a respawn the supervisor staged but has not started yet cannot
            # be joined: the loop below joins it once the supervisor is done
            if w.ident is not None:
                w.join()
        if self._supervisor is not None:
            # final pass: a worker that died holding a bucket is respawned
            # here, drains it (stop flushes everything), then exits
            self._supervise_once()
            self._sup_stop.set()
            self._supervisor.join()
        for w in list(self._workers):
            w.join()
        # final score snapshot so short runs always see serve_health events
        self._emit_health(force=True)

    def stats(self) -> Dict[str, Any]:
        health = (self.health.snapshots()
                  if self.health is not None else None)
        with self._cv:
            return {"submitted": self.submitted, "completed": self.completed,
                    "pending": self.submitted - self.completed,
                    "deadline_misses": self.deadline_misses,
                    "shed": self.shed,
                    "worker_restarts": self.worker_restarts,
                    "flushes": dict(self.flushes),
                    "network_version": self.network_version,
                    "replicas": len(self._engines),
                    "health": health,
                    "plans": self.plans.stats()}

    def __enter__(self) -> "AsyncPGMServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
