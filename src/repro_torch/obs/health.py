"""Per-replica health scoring for the async serving tier (the port's copy
of ``repro.obs.health``).

Drains traffic away from a degraded worker *before* it dies.  Each ``AsyncPGMServer`` worker gets a rolling
score in [0, 1] built from

* a flush-latency EWMA (``alpha``-smoothed, milliseconds),
* an error EWMA over flush outcomes (flush raised / engine error), and
* penalty events (request-timeout watchdog firings, quarantines) folded
  into the same error EWMA.

The score is *relative*: the fastest replica's EWMA defines "healthy"
latency, so a uniform slowdown (bigger batches, colder cache) degrades
nobody, while one replica stalling (sick accelerator, GC storm,
injected ``slow_flush``) drops only its own score.

``score_i = (ref / max(ewma_i, ref)) * max(0, 1 - err_ewma_i)`` with
``ref = min_j ewma_j``; replicas with fewer than ``min_flushes``
observations score a neutral 1.0 (unknown is healthy — a cold replica
must be allowed to warm up).

:meth:`HealthTracker.should_defer` is the dispatch hook: a worker whose
score fell below ``threshold`` × the best score — while at least one
healthier peer is available — backs off from claiming due buckets for a
grace period, biasing traffic toward healthy replicas without ever
stranding a ticket (a deferred bucket is still served by the degraded
worker once the grace expires, and deferral is disabled entirely during
drain/stop).

Pure Python and lock-cheap: one lock acquire per flush record, no torch,
no allocation on the hot path beyond EWMA arithmetic — callers gate on
``obs.enabled()`` only for *event emission*; the tracker itself is
always live so dispatch biasing works even with ``REPRO_OBS=off``
(scoring never changes device programs, only which worker pops a
bucket, so off-mode results stay bit-identical).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List


class _Replica:
    __slots__ = ("ewma_ms", "err_ewma", "flushes", "errors", "timeouts",
                 "penalties")

    def __init__(self) -> None:
        self.ewma_ms = 0.0
        self.err_ewma = 0.0
        self.flushes = 0
        self.errors = 0
        self.timeouts = 0
        self.penalties = 0


class HealthTracker:
    """Rolling per-replica health scores (see module docstring).

    Parameters
    ----------
    n_replicas:    number of workers tracked (index = worker index).
    alpha:         EWMA smoothing factor in (0, 1]; higher = faster
                   reaction to a stall, lower = smoother.
    threshold:     a replica is *degraded* when its score drops below
                   ``threshold * max(scores)``.
    min_flushes:   observations required before a replica can be scored
                   (cold replicas are neutral until then).
    """

    def __init__(self, n_replicas: int, *, alpha: float = 0.3,
                 threshold: float = 0.5, min_flushes: int = 3):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.min_flushes = int(min_flushes)
        self._lock = threading.Lock()
        self._replicas = [_Replica() for _ in range(n_replicas)]

    def __len__(self) -> int:
        return len(self._replicas)

    # -- recording ----------------------------------------------------------

    def record_flush(self, widx: int, latency_ms: float,
                     error: bool = False) -> None:
        """One completed (or failed) bucket flush on worker ``widx``."""
        a = self.alpha
        with self._lock:
            r = self._replicas[widx]
            if r.flushes == 0:
                r.ewma_ms = float(latency_ms)
            else:
                r.ewma_ms += a * (float(latency_ms) - r.ewma_ms)
            r.err_ewma += a * ((1.0 if error else 0.0) - r.err_ewma)
            r.flushes += 1
            if error:
                r.errors += 1

    def record_timeout(self, widx: int) -> None:
        """A request-timeout watchdog firing attributed to ``widx``
        (the worker holding the expired in-flight bucket)."""
        with self._lock:
            r = self._replicas[widx]
            r.timeouts += 1
            r.err_ewma += self.alpha * (1.0 - r.err_ewma)

    def record_penalty(self, widx: int, kind: str = "penalty") -> None:
        """Generic demerit (quarantined output, shed, retry) folded into
        the error EWMA at half weight."""
        with self._lock:
            r = self._replicas[widx]
            r.penalties += 1
            r.err_ewma += 0.5 * self.alpha * (1.0 - r.err_ewma)

    # -- scoring ------------------------------------------------------------

    def _scores_locked(self) -> List[float]:
        warm = [r for r in self._replicas if r.flushes >= self.min_flushes]
        if not warm:
            return [1.0] * len(self._replicas)
        ref = min(r.ewma_ms for r in warm)
        ref = max(ref, 1e-6)
        out = []
        for r in self._replicas:
            if r.flushes < self.min_flushes:
                out.append(1.0)
                continue
            lat = ref / max(r.ewma_ms, ref)
            err = max(0.0, 1.0 - r.err_ewma)
            out.append(lat * err)
        return out

    def scores(self) -> List[float]:
        with self._lock:
            return self._scores_locked()

    def score(self, widx: int) -> float:
        return self.scores()[widx]

    def should_defer(self, widx: int) -> bool:
        """True when worker ``widx`` is degraded AND a healthier peer
        exists to pick up the slack.  Never true for a lone replica or
        when every replica is equally sick (someone must serve)."""
        if len(self._replicas) < 2:
            return False
        with self._lock:
            s = self._scores_locked()
        mx = max(s)
        if mx <= 0.0 or s[widx] >= self.threshold * mx:
            return False
        return any(j != widx and sj >= self.threshold * mx
                   for j, sj in enumerate(s))

    # -- snapshots ----------------------------------------------------------

    def snapshots(self) -> List[Dict[str, Any]]:
        """Per-replica state dicts (score, ewma_ms, counters, degraded
        flag) — the payload of ``serve_health`` events and
        ``AsyncPGMServer.stats()["health"]``."""
        with self._lock:
            s = self._scores_locked()
            mx = max(s) if s else 1.0
            return [{"score": round(s[i], 6),
                     "ewma_ms": round(r.ewma_ms, 3),
                     "flushes": r.flushes,
                     "errors": r.errors,
                     "timeouts": r.timeouts,
                     "penalties": r.penalties,
                     "degraded": bool(s[i] < self.threshold * mx)}
                    for i, r in enumerate(self._replicas)]
