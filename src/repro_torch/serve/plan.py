"""The plan API — "build a plan" decoupled from "run a plan" (the port's
copy of ``repro.serve.plan``).  Three public names:

* :class:`PlanKey` — the identity of one compiled device program:
  ``(network_version, mode, schema, batch_shape, dtypes)``.  Everything
  shape- or model-affecting is in the key, so a key either resolves to a
  program that can serve the batch as-is or to nothing.  The
  ``network_version`` field is what makes hot model swap safe: a re-learnt
  network publishes under a new version, old-version plans simply stop
  hitting and age out of the LRU.

* :class:`CompiledPlan` — a plan's callable plus its bookkeeping (build
  wall time, run/hit counters).  ``plan.run(*args)`` dispatches.

* :class:`PlanCache` — a bounded LRU from :class:`PlanKey` to
  :class:`CompiledPlan` with hit/miss/eviction counters.
  ``cache.get(key)`` returns the plan or ``None``; ``cache.get(key,
  build)`` compiles-and-inserts on miss (``build()`` returns the raw
  callable; the cache times it).  One cache instance is shared by every
  mode of a :class:`~repro_torch.serve.engine.PGMQueryEngine` — exact-JT, vmp
  and temporal plans coexist, distinguished by ``PlanKey.mode``.

All methods are thread-safe: the async serving tier builds plans from its
worker threads while a hot swap warms plans from another.  A transient
build failure is retried with exponential backoff (``compile_retries``,
``retry_backoff_s``; each retry a ``serve_retry`` event), and
``fault_hook`` is the fault injector's seam (``resilience.faultinject``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.obs import sink as obs


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Identity of one compiled serving program.

    network_version  monotone int published by hot model swap; plans for
                     superseded versions never hit again
    mode             pipeline family: "jt-discrete" | "jt-strong" | "vmp"
                     | "temporal" | ...
    schema           the evidence schema (sorted observed-variable names;
                     value-carrying buckets encode values, e.g. "T16")
    batch_shape      device batch shape the program was compiled for
                     (leading dim is the pow2-padded capacity)
    dtypes           input dtypes, as strings
    """

    network_version: int
    mode: str
    schema: Tuple[str, ...]
    batch_shape: Tuple[int, ...]
    dtypes: Tuple[str, ...] = ()


class CompiledPlan:
    """A compiled program with run bookkeeping.  Built by
    :meth:`PlanCache.get`; ``run`` is the only mutating entry point."""

    __slots__ = ("key", "_fn", "compile_us", "hits", "runs", "created_s")

    def __init__(self, key: PlanKey, fn: Callable[..., Any],
                 compile_us: float = 0.0) -> None:
        self.key = key
        self._fn = fn
        self.compile_us = compile_us
        self.hits = 0          # cache hits (first get-after-compile is not one)
        self.runs = 0
        self.created_s = time.time()

    def run(self, *args: Any, **kw: Any) -> Any:
        """Dispatch the compiled program on a batch."""
        self.runs += 1
        return self._fn(*args, **kw)

    def __repr__(self) -> str:          # pragma: no cover - debugging aid
        return (f"CompiledPlan({self.key.mode}, v{self.key.network_version}, "
                f"schema={','.join(self.key.schema)}, "
                f"batch={self.key.batch_shape}, runs={self.runs})")


class PlanCache:
    """Bounded LRU of :class:`CompiledPlan` with hit/miss counters.

    ``max_plans`` bounds retention — long-lived servers seeing many
    (schema, batch) shapes or many network versions evict least-recently-
    used programs instead of growing without bound.
    """

    def __init__(self, max_plans: int = 128, *, compile_retries: int = 0,
                 retry_backoff_s: float = 0.05) -> None:
        if max_plans < 1:
            raise ValueError("max_plans must be >= 1")
        if compile_retries < 0:
            raise ValueError("compile_retries must be >= 0")
        self.max_plans = max_plans
        self.compile_retries = compile_retries
        self.retry_backoff_s = retry_backoff_s
        # fault injection / test seam: called with the PlanKey before each
        # build attempt; raising simulates a transient compile failure
        self.fault_hook: Optional[Callable[[PlanKey], None]] = None
        self._plans: "OrderedDict[PlanKey, CompiledPlan]" = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.retries = 0

    # -- core API ------------------------------------------------------------

    def peek(self, key: PlanKey) -> Optional[CompiledPlan]:
        """Look up without touching counters or LRU order."""
        with self._lock:
            return self._plans.get(key)

    def get(self, key: PlanKey,
            build: Optional[Callable[[], Callable[..., Any]]] = None
            ) -> Optional[CompiledPlan]:
        """Return the plan for ``key``; compile-and-insert on miss.

        A present key counts a hit (and refreshes LRU order).  An absent
        key counts a miss; with ``build`` the raw program is compiled
        (``build()`` — timed, the wall time lands in
        ``plan.compile_us``), wrapped and inserted, evicting the LRU entry
        when the cache is full.  Without ``build`` a miss returns None.
        """
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self.hits += 1
                plan.hits += 1
                self._plans.move_to_end(key)
                return plan
            self.misses += 1
            if build is None:
                return None
        # compile OUTSIDE the lock: tracing/lowering can take seconds and
        # concurrent readers must not block on it.  A racing second build
        # of the same key loses and is discarded below.  Transient build
        # failures are retried with exponential backoff up to
        # ``compile_retries`` times; an exhausted budget re-raises and
        # leaves NO cache entry, so the next get() retries cleanly.
        attempt = 0
        while True:
            t0 = time.perf_counter_ns()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(key)
                fn = build()
                break
            except Exception as e:
                attempt += 1
                if attempt > self.compile_retries:
                    raise
                with self._lock:
                    self.retries += 1
                if obs.enabled():
                    obs.emit("serve_retry", attempt=attempt,
                             error=type(e).__name__)
                time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))
        compile_us = (time.perf_counter_ns() - t0) / 1e3
        plan = CompiledPlan(key, fn, compile_us)
        with self._lock:
            won = self._plans.get(key)
            if won is not None:                 # lost the compile race
                return won
            self._plans[key] = plan
            while len(self._plans) > self.max_plans:
                self._plans.popitem(last=False)
                self.evictions += 1
            return plan

    # -- maintenance ---------------------------------------------------------

    def invalidate(self, network_version: Optional[int] = None) -> int:
        """Drop plans for one network version (or all).  Returns the
        number of plans dropped — the hot-swap drain path."""
        with self._lock:
            if network_version is None:
                n = len(self._plans)
                self._plans.clear()
                return n
            drop = [k for k in self._plans
                    if k.network_version == network_version]
            for k in drop:
                del self._plans[k]
            return len(drop)

    def keys(self) -> List[PlanKey]:
        with self._lock:
            return list(self._plans)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "retries": self.retries,
                    "size": len(self._plans), "max_plans": self.max_plans,
                    "hit_rate": (self.hits / total) if total else 0.0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def __contains__(self, key: PlanKey) -> bool:
        with self._lock:
            return key in self._plans
