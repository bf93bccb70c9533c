"""JSONL telemetry sink, event schema and kernel dispatch counters (the
port's copy of ``repro.obs.sink``: the same schema, env knobs and
validator, so a file either package writes passes the other's
``validate_obs_events``).

* **level knob** — ``REPRO_OBS=off|basic|trace`` (default ``off``).
  ``off`` is a zero-overhead no-op: every ``emit``/``count_kernel`` call
  is a single integer compare, spans return a shared null span and no
  file is ever opened.  ``basic`` emits structured events (logs, stream
  batch metrics, drift, serve buckets, kernel dispatch counts).
  ``trace`` additionally emits the spans of ``obs.trace``.

* **JSONL sink** — every event is one JSON line appended to
  ``REPRO_OBS_PATH`` (default ``obs_events.jsonl``).  Base fields on every
  line: ``ts`` (unix seconds), ``seq`` (monotone per-process), ``run``
  (process run id), ``event`` (type).  Event types and their required
  fields are in :data:`EVENT_SCHEMA`; :func:`validate_obs_events` is the
  gate over an emitted file.

Kernel dispatch counters live here too (:func:`count_kernel`), named
``<kernel>:<route>``: ``<kernel>:cuda`` is bumped where a wrapper launches
its CUDA kernel (``kernels.clg_stats._launch``, shared by every wrapper), so
its count equals the wrapper's ``LAUNCHES`` delta; ``<kernel>:einsum`` where
the plain PyTorch version runs instead (a wrapper given CPU tensors, or the
suff-stats dispatchers of ``core.vmp`` on their einsum backend).  The port
runs eagerly, so every dispatch counts -- the JAX package counts once a
trace.  Counting is thread-safe (the async serving tier's workers share
it).
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

from repro_torch.obs import agg as _agg

OFF, BASIC, TRACE = 0, 1, 2
_LEVEL_NAMES = {"off": OFF, "basic": BASIC, "trace": TRACE}

# Event schema: event type -> required extra fields (base fields ``ts``,
# ``seq``, ``run``, ``event`` are required on every line).  Extra fields
# beyond the required set are allowed everywhere.
EVENT_SCHEMA: Dict[str, Tuple[str, ...]] = {
    # human log line (mirrored to stderr by obs.log)
    "log": ("msg",),
    # one named scalar gauge/counter
    "metric": ("name", "value"),
    # per-batch streaming-VMP metrics (one per stream_fit/stream_update batch)
    "stream_batch": ("t", "elbo", "score", "ph", "drifted", "n_eff", "rho",
                     "sweeps"),
    # Page-Hinkley drift firing (subset of stream_batch rows where drifted)
    "drift": ("t", "ph", "score"),
    # non-finite batch (or poisoned input rows) skipped with the carried
    # posterior held — the streaming scans' health gate and the DataStream
    # ``validate=`` row filter both emit these
    "quarantine": ("t",),
    # host-side latency span (trace level only)
    "span": ("name", "dur_us", "span_id"),
    # PGMQueryEngine.flush summary
    "serve_flush": ("mode", "n_queries", "n_buckets"),
    # one evidence-schema bucket inside a flush
    "serve_bucket": ("mode", "schema", "batch", "queue_depth", "cache_hit",
                     "compile_us", "execute_us", "latency_us"),
    # junction-tree propagation plan (emitted once per compiled schema)
    "jt_plan": ("pipeline", "n_cliques", "levels", "batch"),
    # one fused temporal VB-EM fit (pgm_models.dynamic update_model)
    "temporal_fit": ("model", "sweeps", "elbo", "delta"),
    # temporal filter/predict program compiled for a serve bucket
    "temporal_plan": ("pipeline", "batch", "T", "S", "horizon"),
    # async micro-batch flush decision (size / timeout / deadline trigger)
    "serve_deadline": ("mode", "schema", "batch", "trigger", "wait_us",
                       "deadline_miss"),
    # hot model swap: new network version published without dropping traffic
    "serve_swap": ("old_version", "new_version", "warmed_plans", "drained",
                   "dur_us"),
    # load shedding: a submit over the bounded-queue capacity was rejected
    "serve_shed": ("mode", "queue_depth", "max_queue"),
    # transient plan-compile failure retried with backoff (serve/plan.py)
    "serve_retry": ("attempt", "error"),
    # worker-replica supervision: dead worker respawned, bucket requeued
    "serve_worker": ("worker", "action", "requeued"),
    # streaming-state snapshot written (resilience/checkpoint.py)
    "checkpoint": ("t", "path", "reason"),
    # kernel-backend dispatch counter snapshot
    "kernel_dispatch": ("counts",),
    # the JAX package's estimator output (its files validate here too)
    "bench_estimate": ("name", "estimate"),
    # per-replica health score snapshot (serve/queue.py supervisor)
    "serve_health": ("worker", "score", "ewma_ms", "flushes", "errors"),
    # rolling SLO snapshot per (mode, schema) — exact-rank quantiles from
    # the obs/agg.py serve_request_ms histogram, emitted once per flush
    "slo": ("mode", "schema", "count", "p50_ms", "p95_ms", "p99_ms",
            "miss_rate"),
}

_BASE_FIELDS = ("ts", "seq", "run", "event")


class _State:
    def __init__(self) -> None:
        self.level = _LEVEL_NAMES.get(
            os.environ.get("REPRO_OBS", "off").lower(), OFF)
        self.path = os.environ.get("REPRO_OBS_PATH", "obs_events.jsonl")
        self.run = uuid.uuid4().hex[:12]
        self.seq = 0
        self.fh: Optional[io.TextIOBase] = None
        self.lock = threading.Lock()
        self.kernel_counts: Dict[str, int] = {}


_STATE = _State()


def level() -> int:
    """Current obs level (OFF/BASIC/TRACE)."""
    return _STATE.level


def enabled(min_level: int = BASIC) -> bool:
    return _STATE.level >= min_level


def configure(level: Optional[str] = None, path: Optional[str] = None,
              reset_counters: bool = False) -> Dict[str, str]:
    """Programmatic override of the env knobs (tests, drivers).

    Returns the PREVIOUS ``{"level", "path"}`` so callers can restore it.
    """
    prev = {"level": {v: k for k, v in _LEVEL_NAMES.items()}[_STATE.level],
            "path": _STATE.path}
    with _STATE.lock:
        if level is not None:
            if level not in _LEVEL_NAMES:
                raise ValueError(f"unknown obs level {level!r}; expected "
                                 f"{sorted(_LEVEL_NAMES)}")
            _STATE.level = _LEVEL_NAMES[level]
        if path is not None and path != _STATE.path:
            if _STATE.fh is not None:
                _STATE.fh.close()
                _STATE.fh = None
            _STATE.path = path
        if reset_counters:
            _STATE.kernel_counts.clear()
    if reset_counters:
        _agg.REGISTRY.reset()
    return prev


def _write(line: str) -> None:
    if _STATE.fh is None:
        _STATE.fh = open(_STATE.path, "a", buffering=1)
    _STATE.fh.write(line + "\n")


def emit(event: str, **fields: Any) -> None:
    """Append one event line to the JSONL sink (no-op when level is off)."""
    if _STATE.level < BASIC:
        return
    with _STATE.lock:
        _STATE.seq += 1
        rec = {"ts": time.time(), "seq": _STATE.seq, "run": _STATE.run,
               "event": event, **fields}
        _write(json.dumps(rec, default=_jsonable))
    return


def _jsonable(o: Any) -> Any:
    """Fallback encoder: numpy scalars, numpy arrays and tensors -> python
    (a tensor on a card is read back: callers emit after the device work)."""
    if hasattr(o, "detach"):
        o = o.detach().cpu()
    if hasattr(o, "item") and getattr(o, "ndim", None) == 0:
        return o.item()
    if hasattr(o, "tolist"):
        return o.tolist()
    return str(o)


def log(msg: str, component: Optional[str] = None, **fields: Any) -> None:
    """Structured logger replacing the launchers' ad-hoc ``print()``s.

    The human-readable line always goes to stderr (launch drivers keep
    their console output regardless of the obs level); the structured
    ``log`` event is additionally appended to the JSONL sink when obs is
    enabled.
    """
    print(msg, file=sys.stderr, flush=True)
    if _STATE.level >= BASIC:
        emit("log", msg=msg, component=component, **fields)


# ---------------------------------------------------------------------------
# kernel-backend dispatch counters
# ---------------------------------------------------------------------------


def count_kernel(name: str) -> None:
    """Bump the host-dispatch counter for ``<kernel>:<backend>``.

    Called where a kernel wrapper launches (``<kernel>:cuda``) or runs
    its plain version (``<kernel>:einsum``), and by the suff-stats
    dispatchers' einsum branches.  Single dict update when enabled, one
    integer compare when off."""
    if _STATE.level < BASIC:
        return
    with _STATE.lock:
        _STATE.kernel_counts[name] = _STATE.kernel_counts.get(name, 0) + 1
    _agg.REGISTRY.counter("kernel_dispatch_total", kernel=name).inc()


def kernel_counts() -> Dict[str, int]:
    return dict(_STATE.kernel_counts)


def emit_kernel_counts(**extra: Any) -> None:
    """Snapshot the dispatch counters into a ``kernel_dispatch`` event."""
    if _STATE.level < BASIC or not _STATE.kernel_counts:
        return
    emit("kernel_dispatch", counts=dict(_STATE.kernel_counts), **extra)


# ---------------------------------------------------------------------------
# streaming metrics emission (host side, post-scan)
# ---------------------------------------------------------------------------


def _host_columns(info: Dict[str, Any]) -> Dict[str, Any]:
    """The info columns as numpy arrays, read from the device in ONE
    transfer: the tensor columns are stacked as float64 and each comes back
    in its own dtype (bool, integer or float; sweeps and counts are exact
    in float64)."""
    import numpy as np

    cols = {k: info[k] for k in _STREAM_COLS if k in info}
    tens = {k: v for k, v in cols.items() if hasattr(v, "detach")}
    out = {k: np.atleast_1d(np.asarray(v)) for k, v in cols.items()
           if k not in tens}
    if tens:
        import torch

        T = max(v.reshape(-1).shape[0] for v in tens.values())
        host = torch.stack([v.detach().reshape(-1).to(torch.float64)
                            .expand(T) for v in tens.values()]).cpu().numpy()
        for (k, v), row in zip(tens.items(), host):
            dt = str(v.dtype).replace("torch.", "")
            out[k] = row.astype(np.bool_ if dt == "bool" else dt)
    return out


_STREAM_COLS = ("elbo", "score", "ph", "drifted", "n_eff", "rho", "sweeps",
                "quarantined")


def emit_stream_events(info: Dict[str, Any]) -> None:
    """Emit per-batch ``stream_batch`` events (+ ``drift`` events for the
    batches whose Page-Hinkley test fired, ``quarantine`` events for the
    skipped ones) from a ``stream_fit`` / ``stream_update`` info dict.
    Host-side: called AFTER the fit, which it reads in one transfer, so the
    fit itself is untouched."""
    if _STATE.level < BASIC:
        return
    cols = _host_columns(info)
    T = max((v.shape[0] for v in cols.values()), default=0)
    n_drift = n_quar = 0
    for t in range(T):
        row = {k: v[t].item() for k, v in cols.items()}
        emit("stream_batch", t=t, **row)
        if row.get("drifted"):
            n_drift += 1
            emit("drift", t=t, ph=row.get("ph"), score=row.get("score"))
        if row.get("quarantined"):
            n_quar += 1
            emit("quarantine", t=t, site="stream", score=row.get("score"),
                 elbo=row.get("elbo"))
    if T:
        _agg.REGISTRY.counter("stream_batches_total").inc(T)
    if n_drift:
        _agg.REGISTRY.counter("drift_total", site="stream").inc(n_drift)
    if n_quar:
        _agg.REGISTRY.counter("quarantine_total", site="stream").inc(n_quar)


# ---------------------------------------------------------------------------
# validation — the gate over an emitted JSONL file
# ---------------------------------------------------------------------------


def validate_obs_events(src: Union[str, Iterable[str]]) -> Dict[str, int]:
    """Validate a JSONL event stream against :data:`EVENT_SCHEMA`.

    ``src`` is a file path or an iterable of lines.  Raises ``ValueError``
    on the first malformed line (bad JSON, missing base field, unknown
    event type, missing required field, non-monotone ``seq`` within a
    run).  Returns ``{event_type: count}`` so callers can assert coverage.
    """
    if isinstance(src, str):
        with open(src) as fh:
            lines: List[str] = fh.readlines()
    else:
        lines = list(src)
    counts: Dict[str, int] = {}
    last_seq: Dict[str, int] = {}
    for i, line in enumerate(lines, 1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"line {i}: invalid JSON ({e})") from e
        if not isinstance(rec, dict):
            raise ValueError(f"line {i}: event must be a JSON object")
        for f in _BASE_FIELDS:
            if f not in rec:
                raise ValueError(f"line {i}: missing base field {f!r}")
        if not isinstance(rec["ts"], (int, float)):
            raise ValueError(f"line {i}: ts must be a number")
        ev = rec["event"]
        if ev not in EVENT_SCHEMA:
            raise ValueError(f"line {i}: unknown event type {ev!r}")
        for f in EVENT_SCHEMA[ev]:
            if f not in rec:
                raise ValueError(
                    f"line {i}: event {ev!r} missing field {f!r}")
        run = rec["run"]
        if run in last_seq and rec["seq"] <= last_seq[run]:
            raise ValueError(
                f"line {i}: seq {rec['seq']} not monotone within run {run}")
        last_seq[run] = rec["seq"]
        counts[ev] = counts.get(ev, 0) + 1
    return counts
