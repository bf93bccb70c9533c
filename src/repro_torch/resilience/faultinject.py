"""Deterministic fault injection — the chaos harness behind the tests (the
port's copy of ``repro.resilience.faultinject``: the same seeded numpy
draws pick the same batches).

Every injector is seeded and reproducible: a chaos test that fails replays
bit-for-bit.  Four fault classes, matching the failure modes the
resilience layer defends against:

* :meth:`FaultInjector.poison_nan` — NaN-poison a seeded subset of
  stacked stream batches (exercises the non-finite quarantine gate);
* :meth:`FaultInjector.crash_worker` — kill one ``AsyncPGMServer`` worker
  thread mid-flight via the server's ``_flush_hook`` (exercises
  supervision: bucket requeue + replica respawn);
* :meth:`FaultInjector.fail_compiles` — make the next N plan builds raise
  :class:`~repro_torch.resilience.errors.TransientCompileError` via
  ``PlanCache.fault_hook`` (exercises retry-with-backoff, and swap abort
  when N exceeds the retry budget);
* :meth:`FaultInjector.slow_flush` — stall the next N flushes (exercises
  the per-request timeout watchdog).

Hooks compose: arming several injectors on one server chains them, so a
single run can see NaN batches + a crash + a compile failure.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.resilience.errors import TransientCompileError, WorkerCrashError


class FaultInjector:
    """Seeded injector factory.  ``log`` records every armed fault as
    ``(kind, detail)`` so tests/benches can report what was injected."""

    def __init__(self, seed: int = 0) -> None:
        self.rng = np.random.default_rng(seed)
        self.log: list = []

    # -- data faults ----------------------------------------------------------

    def poison_nan(self, xcs, rate: float,
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """NaN-poison a seeded fraction of the stacked batches ``[T, B, F]``
        (a numpy array, or a tensor: read back to the host).

        Whole batches are poisoned (every row NaN) so the quarantine
        outcome is deterministic; returns ``(poisoned_copy, indices)`` as
        numpy arrays.  ``rate > 0`` always poisons at least one batch."""
        if hasattr(xcs, "detach"):
            xcs = xcs.detach().cpu().numpy()
        xcs = np.array(xcs, dtype=np.asarray(xcs).dtype)
        T = xcs.shape[0]
        n = 0 if rate <= 0 else max(1, int(round(rate * T)))
        idx = np.sort(self.rng.choice(T, size=min(n, T), replace=False))
        xcs[idx] = np.nan
        self.log.append(("nan_batches", [int(i) for i in idx]))
        return xcs, idx

    # -- serving faults -------------------------------------------------------

    @staticmethod
    def _chain_flush_hook(server, fn) -> None:
        prev = getattr(server, "_flush_hook", None)

        def hook(widx: int, bucket) -> None:
            if prev is not None:
                prev(widx, bucket)
            fn(widx, bucket)

        server._flush_hook = hook

    def crash_worker(self, server, widx: Optional[int] = None
                     ) -> Dict[str, Any]:
        """Arm a one-shot crash: the next bucket pop kills that worker's
        thread (the bucket stays registered in-flight, so the supervisor
        must requeue it and respawn the replica).  ``widx`` pins the crash
        to one replica; None (default) fires on whichever worker pops
        first — with several replicas a pinned worker may never win a
        bucket race, so None is what a multi-replica chaos run wants."""
        box = {"armed": True, "fired": False}

        def fn(w: int, bucket) -> None:
            if box["armed"] and (widx is None or w == widx):
                box["armed"] = False
                box["fired"] = True
                raise WorkerCrashError(f"injected crash in worker {w}")

        self._chain_flush_hook(server, fn)
        self.log.append(("worker_crash", widx))
        return box

    def slow_flush(self, server, delay_s: float, n: int = 1,
                   widx: Optional[int] = None) -> Dict[str, Any]:
        """Arm ``n`` stalled flushes of ``delay_s`` each (the stuck-flush
        scenario the request-timeout watchdog converts into a
        :class:`~repro_torch.resilience.errors.DeadlineError`).  ``widx`` pins
        the stalls to one replica — the degraded-replica scenario the
        health scorer must detect and route around; None (default) stalls
        whichever worker pops next."""
        box = {"left": n, "fired": 0}

        def fn(w: int, bucket) -> None:
            if box["left"] > 0 and (widx is None or w == widx):
                box["left"] -= 1
                box["fired"] += 1
                time.sleep(delay_s)

        self._chain_flush_hook(server, fn)
        self.log.append(("slow_flush", (delay_s, n, widx)))
        return box

    def fail_compiles(self, cache, n: int = 1) -> Dict[str, Any]:
        """Arm the next ``n`` plan builds on ``cache`` to raise
        :class:`TransientCompileError` before compiling.  With
        ``n <= cache.compile_retries`` the request still succeeds after
        backoff; beyond the budget the build error propagates (and an
        in-progress hot swap aborts, leaving old engines serving)."""
        box = {"left": n}

        def hook(key) -> None:
            if box["left"] > 0:
                box["left"] -= 1
                raise TransientCompileError(
                    f"injected compile failure for {key.mode} plan")

        cache.fault_hook = hook
        self.log.append(("compile_failures", n))
        return box

    @staticmethod
    def disarm(server=None, cache=None) -> None:
        """Remove every armed hook from a server and/or cache."""
        if server is not None:
            server._flush_hook = None
        if cache is not None:
            cache.fault_hook = None
