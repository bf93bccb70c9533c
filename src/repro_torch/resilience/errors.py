"""Typed failure vocabulary shared by the serving tier and fault injection
(the port's copy of ``repro.resilience.errors``).

Dependency-free, so ``repro_torch.serve`` can raise these without an
import cycle, and callers can catch a specific failure mode instead of
string-matching RuntimeError.
"""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class for every resilience-layer failure."""


class ShedError(ResilienceError):
    """Submit rejected: the server's bounded queue is at capacity.

    The request was never accepted — retrying after backoff is safe and
    the intended client response."""


class DeadlineError(ResilienceError):
    """Request abandoned: deadline + request timeout elapsed before its
    micro-batch flush completed.  The caller gets this error instead of
    blocking forever on a stuck flush."""


class TransientCompileError(ResilienceError):
    """A plan build failed transiently (retryable).  Raised by the
    fault injector to exercise :class:`~repro_torch.serve.plan.PlanCache`'s
    retry-with-backoff path."""


class WorkerCrashError(ResilienceError):
    """Injected worker-thread death (fault injection only): the worker's
    thread exits mid-flight and supervision must requeue its bucket."""
