"""Fault tolerance for streaming and serving (the port's counterpart of
``repro.resilience``).  Three concerns, one package:

* **Non-finite quarantine** — the streaming step bodies
  (``core.streaming._stream_step``, ``pgm_models.dynamic.seq_stream_fit``)
  gate every Bayesian update on a health flag: a batch whose score, ELBO
  or posterior is not finite is skipped with the carried posterior held
  bit-exactly, counted, and surfaced as an obs ``quarantine`` event.

* **Posterior checkpoint/restore** (:mod:`repro_torch.resilience.
  checkpoint`) — periodic snapshots of the full streaming state in the JAX
  package's file format; resuming mid-stream gives the uninterrupted
  run's bits.

* **Fault injection** (:mod:`repro_torch.resilience.faultinject`) —
  seeded, deterministic injectors (NaN batches, worker crash, build
  failure, slow flush) that drive the chaos tests and ``chip_smoke.py``.

The serving tier's robustness knobs (bounded queue with shedding,
per-request timeout, worker supervision, build retry) live in
``repro_torch.serve`` but speak this package's typed error vocabulary
(:mod:`repro_torch.resilience.errors`).
"""

from repro_torch.resilience.errors import (  # noqa: F401
    DeadlineError,
    ResilienceError,
    ShedError,
    TransientCompileError,
    WorkerCrashError,
)
from repro_torch.resilience.checkpoint import (  # noqa: F401
    CheckpointManager,
    checkpointed_stream_fit,
    load,
    resume_stream_fit,
    save,
)
from repro_torch.resilience.faultinject import FaultInjector  # noqa: F401
