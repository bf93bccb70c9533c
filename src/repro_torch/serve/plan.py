"""The plan API -- "build a plan" decoupled from "run a plan" (the port's
own copy of ``repro.serve.plan``, without its observability calls).

* :class:`PlanKey` -- the identity of one propagation plan:
  ``(network_version, mode, schema, batch_shape, dtypes)``.  Everything
  shape- or model-affecting is in the key.  ``network_version`` is what
  makes a model swap safe: a re-learnt network publishes under a new
  version, and old-version plans stop hitting and age out of the LRU.

* :class:`CompiledPlan` -- a plan's callable plus its bookkeeping (build
  wall time, run/hit counters).  ``plan.run(*args)`` dispatches.

* :class:`PlanCache` -- a bounded LRU from :class:`PlanKey` to
  :class:`CompiledPlan` with hit/miss/eviction counters.  ``cache.get(key)``
  returns the plan or ``None``; ``cache.get(key, build)`` builds and
  inserts on a miss (``build()`` returns the callable; the cache times it).
  One cache is shared by every mode of a ``PGMQueryEngine``.

All methods are thread-safe.  Build retries and the fault-injection hook
of the JAX package's cache come with the port of ``repro.resilience``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Identity of one serving plan.

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
    """A built plan with run bookkeeping.  Built by
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
        """Run the plan on a batch."""
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

    def __init__(self, max_plans: int = 128) -> None:
        if max_plans < 1:
            raise ValueError("max_plans must be >= 1")
        self.max_plans = max_plans
        self._plans: "OrderedDict[PlanKey, CompiledPlan]" = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- core API ------------------------------------------------------------

    def peek(self, key: PlanKey) -> Optional[CompiledPlan]:
        """Look up without touching counters or LRU order."""
        with self._lock:
            return self._plans.get(key)

    def get(self, key: PlanKey,
            build: Optional[Callable[[], Callable[..., Any]]] = None
            ) -> Optional[CompiledPlan]:
        """Return the plan for ``key``; build-and-insert on miss.

        A present key counts a hit (and refreshes LRU order).  An absent
        key counts a miss; with ``build`` the plan is built (``build()`` --
        timed, the wall time lands in ``plan.compile_us``), wrapped and
        inserted, evicting the LRU entry when the cache is full.  Without
        ``build`` a miss returns None.  A failing build raises and leaves
        no entry.
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
        # build OUTSIDE the lock: concurrent readers must not block on it.
        # A racing second build of the same key loses and is discarded below.
        t0 = time.perf_counter_ns()
        fn = build()
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
                    "evictions": self.evictions,
                    "size": len(self._plans), "max_plans": self.max_plans,
                    "hit_rate": (self.hits / total) if total else 0.0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def __contains__(self, key: PlanKey) -> bool:
        with self._lock:
            return key in self._plans
