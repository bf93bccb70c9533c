"""Spans the benchmark wraps around calls into the program, and a reading
of ``torch.profiler``'s trace of a few steps.

:class:`Spans` replaces each wrap point (a module attribute, looked up by
the program at call time) with a wrapper that opens a ``record_function``
range of the wrap point's name and records the call's arguments (shapes,
dtypes and plain values), and puts the original back on exit.  The
program is not edited.

:func:`profile` runs a few calls under the profiler and reads its events
(exported in the Chrome trace format to a temporary file, read and
deleted) into a :class:`Trace`: every device operation (kernels, copies, fills),
the host thread and time of the call that launched it (CUDA's runtime or
driver call, by correlation id), and the ranges.  A range's device time
is the time of the operations launched while it was open on that thread,
so a share reads the same work whatever implements it.  A trace without
device operations raises: it never reads as 0.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _describe(v):
    if isinstance(v, torch.Tensor):
        return {"shape": tuple(v.shape), "dtype": str(v.dtype).split(".")[-1]}
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return type(v).__name__


class Spans:
    """While active, each wrap point ``name -> (module, attribute)`` runs
    inside a ``record_function(name)`` range and its calls' arguments are
    kept in ``calls[name]`` (``{"args": [...], "kwargs": {...}}``)."""

    def __init__(self, wraps: Dict[str, Tuple[str, str]]):
        self.wraps = dict(wraps)
        self.calls: Dict[str, List[dict]] = defaultdict(list)
        self.missing: List[str] = []
        self._saved: List[tuple] = []

    def _wrapper(self, name: str, fn: Callable):
        calls = self.calls[name]

        def wrapped(*args, **kwargs):
            calls.append({"args": [_describe(a) for a in args],
                          "kwargs": {k: _describe(v)
                                     for k, v in kwargs.items()}})
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    def __enter__(self) -> "Spans":
        for name, (mod_name, attr) in self.wraps.items():
            try:
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, attr)
            except (ImportError, AttributeError):
                self.missing.append(name)    # its metrics stay absent
                continue
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrapper(name, fn))
        return self

    def __exit__(self, *exc) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    kind: str
    launch_tid: Optional[int] = None
    launch_ns: Optional[int] = None
    span: Optional[str] = None       # the wrapped range it was launched in


@dataclasses.dataclass
class Trace:
    ops: List[DeviceOp]
    window_s: float                  # host clock over the profiled calls
    busy_s: float                    # union of the device operations
    span_device_s: Dict[str, float]  # device seconds launched in each range
    span_calls: Dict[str, List[dict]]
    span_count: Dict[str, int]       # ranges seen in the trace
    missing: List[str]
    host_labels: Dict[int, List[Tuple[int, str]]]   # tid -> (start, op)
    units: int                       # steps or calls profiled
    unmatched: int                   # device ops with no launching call
    kinds: Dict[str, int]            # events by activity type

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s)

    def device_ops_top(self, n: int = 10) -> List[list]:
        by = defaultdict(int)
        for op in self.ops:
            by[op.name] += op.dur_ns
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def idle_gaps_top(self, n: int = 10) -> List[list]:
        """The longest gaps between device operations, each named by the
        host op that launched the operation ending it."""
        ops = sorted(self.ops, key=lambda o: o.start_ns)
        gaps, end = [], None
        for op in ops:
            if end is not None and op.start_ns > end:
                gaps.append((op.start_ns - end, _label(self, op)))
            end = max(end or 0, op.start_ns + op.dur_ns)
        gaps.sort(key=lambda g: -g[0])
        return [[label, ns / 1e9] for ns, label in gaps[:n]]


def _label(tr: Trace, op: DeviceOp) -> str:
    """The host op that started last before the launch on its thread (the
    innermost one open then)."""
    labels = tr.host_labels.get(op.launch_tid)
    if op.launch_ns is None or not labels:
        return "unknown"
    i = bisect.bisect_right(labels, (op.launch_ns, "￿")) - 1
    return labels[i][1] if i >= 0 else "unknown"


def _union_ns(intervals: List[Tuple[int, int]]) -> int:
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def read_events(events: List[dict], spans: Spans, window_s: float,
                units: int) -> Trace:
    """A :class:`Trace` of the profiler's events in the Chrome trace
    format (``export_chrome_trace``): ``cat``, ``name``, ``ts`` and
    ``dur`` in microseconds, ``tid``, ``args.correlation``."""
    launches: Dict[int, Tuple[int, int]] = {}
    ranges: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
    host_ops: Dict[int, List[Tuple[int, str]]] = defaultdict(list)
    device: List[dict] = []
    names = set(spans.wraps)
    kinds: Dict[str, int] = defaultdict(int)
    for e in events:
        kind = e.get("cat")
        if kind is None or e.get("ph") != "X":
            continue
        kinds[kind] += 1
        ts = int(round(e["ts"] * 1e3))
        if kind in DEVICE_KINDS:
            device.append(e)
        elif kind in LAUNCH_KINDS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e["tid"], ts)
        elif kind in ("user_annotation", "cpu_op"):
            end_ns = ts + int(round(e.get("dur", 0) * 1e3))
            if kind == "user_annotation" and e["name"] in names:
                ranges[e["tid"]].append((ts, end_ns, e["name"]))
            host_ops[e["tid"]].append((ts, e["name"]))
    if not device:
        raise RuntimeError("the profiled calls show no device operation: "
                           "the trace is unusable (no metric reads 0)")
    ranges = {tid: sorted(rs) for tid, rs in ranges.items()}
    starts = {tid: [r[0] for r in rs] for tid, rs in ranges.items()}
    ops, unmatched = [], 0
    span_s: Dict[str, float] = defaultdict(float)
    for e in device:
        op = DeviceOp(name=e["name"], start_ns=int(round(e["ts"] * 1e3)),
                      dur_ns=int(round(e.get("dur", 0) * 1e3)), kind=e["cat"])
        hit = launches.get(e.get("args", {}).get("correlation"))
        if hit is None:
            unmatched += 1
        else:
            op.launch_tid, op.launch_ns = hit
            rs = ranges.get(op.launch_tid)
            if rs:
                i = bisect.bisect_right(starts[op.launch_tid],
                                        op.launch_ns) - 1
                while i >= 0:
                    s, end, name = rs[i]
                    if end >= op.launch_ns:
                        op.span = name
                        break
                    i -= 1
        if op.span is not None:
            span_s[op.span] += op.dur_ns / 1e9
        ops.append(op)
    busy = _union_ns([(o.start_ns, o.start_ns + o.dur_ns) for o in ops]) / 1e9
    count = {n: sum(1 for rs in ranges.values() for r in rs if r[2] == n)
             for n in names}
    return Trace(ops=ops, window_s=window_s, busy_s=busy,
                 span_device_s=dict(span_s), span_calls=dict(spans.calls),
                 span_count=count, missing=list(spans.missing),
                 host_labels={t: sorted(h) for t, h in host_ops.items()},
                 units=units, unmatched=unmatched, kinds=dict(kinds))


def profile(run_one: Callable[[], None], units: int,
            wraps: Dict[str, Tuple[str, str]], tries: int = 3) -> Trace:
    """``run_one()`` ``units`` times under ``torch.profiler`` with the wrap
    points' spans open; a wait on the card before the profiled range.  A
    profile that comes back without device operations is taken again (up
    to ``tries`` times), then raises."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    last: Optional[Exception] = None
    for _ in range(tries):
        torch.cuda.synchronize()
        with Spans(wraps) as spans, _profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(units):
                run_one()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        try:
            return read_events(events, spans, window_s, units)
        except RuntimeError as err:
            last = err
    raise RuntimeError(f"{tries} profiles without device operations") \
        from last
