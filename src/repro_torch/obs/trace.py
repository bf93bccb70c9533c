"""The port's one span system: host spans that ``torch.profiler`` sees
(the port's counterpart of ``repro.obs.trace``).

A span is *active* while obs runs at TRACE (``REPRO_OBS=trace``) or while
``torch.profiler`` records on the calling thread (the autograd engine
carries the profiler's state to its worker threads).  An active span:

* opens a ``torch.profiler.record_function`` range of its own name when
  the profiler records, so the device operations it launches are tied to
  it by correlation id, on the trace's own clock;
* stamps the native thread id (``threading.get_native_id()``, the
  profiler's ``tid``) and its parent, the innermost span open on that
  thread;
* appends a :class:`SpanRecord` (wall-clock start and end from
  ``time.time_ns()``, the profiler's clock) to a bounded in-memory buffer,
  read with :func:`recorded_spans`;
* emits a ``span`` event (``dur_us`` from the monotonic clock) at TRACE.

A span around device work measures the host's enqueue time unless the
body synchronizes (``jt.execute`` does, at TRACE only); the device time
of its launches is the profiler's.  An inactive span costs one check and
returns one shared null object: no clock read, no allocation.

Backward regions: autograd runs the backward of CUDA tensors on its own
thread, where no forward span is open.  :func:`backward_span` marks a
region's input (``closes``) and output (``opens``) with identity autograd
nodes whose backward opens and closes a span on the thread that runs
them; they are inserted only while spans are active and change no value
or gradient.  Every Python garbage collection is a ``gc`` span (one
``gc.callbacks`` entry, one check while spans are inactive), so a
collection inside a traced region names its own idle gap.
"""

from __future__ import annotations

import collections
import gc
import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from repro_torch.obs import sink

BUFFER_SPANS = 1 << 16          # the newest spans kept in memory

_ids = itertools.count(1)
_tls = threading.local()
_profiling = torch.autograd._profiler_enabled
_STATE = sink._STATE
_TRACE = sink.TRACE


class SpanRecord(NamedTuple):
    """A closed span: wall-clock ``start_ns`` / ``end_ns`` (``time.time_ns``)
    and the native ``tid`` of the thread it ran on."""

    name: str
    span_id: int
    parent_id: Optional[int]
    tid: int
    start_ns: int
    end_ns: int
    attrs: Dict[str, Any]


_buffer: "collections.deque[SpanRecord]" = collections.deque(
    maxlen=BUFFER_SPANS)


def active() -> bool:
    """Whether a span opened now would record (TRACE, or the profiler)."""
    return _STATE.level >= _TRACE or _profiling()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class Span:
    """One timed region (a context manager).  ``dur_us`` is valid after it
    exits; :meth:`add` attaches extra fields to its record and event."""

    __slots__ = ("name", "span_id", "parent_id", "attrs", "tid", "start_ns",
                 "dur_us", "_t0", "_rf")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.span_id = next(_ids)
        self.parent_id = None
        self.attrs = attrs
        self.dur_us = 0.0
        self._rf = None

    def add(self, **fields: Any) -> None:
        self.attrs.update(fields)

    def __enter__(self) -> "Span":
        st = _stack()
        self.parent_id = st[-1].span_id if st else None
        st.append(self)
        self.tid = threading.get_native_id()
        if _profiling():
            self._rf = torch.autograd.profiler.record_function(self.name)
            self._rf.__enter__()
        # the region's own clock readings lie inside the range's
        self.start_ns = time.time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, kind, exc, tb) -> bool:
        self.dur_us = (time.perf_counter_ns() - self._t0) / 1e3
        end_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        if kind is not None:
            # a raising body must not look like a clean span: stamp the
            # exception type and let it propagate
            self.attrs.setdefault("error", kind.__name__)
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)
        _buffer.append(SpanRecord(self.name, self.span_id, self.parent_id,
                                  self.tid, self.start_ns, end_ns,
                                  self.attrs))
        if _STATE.level >= _TRACE and self.name != "gc":
            # a collection may start inside the sink's own lock: gc spans
            # stay in the buffer and the profiler's trace
            sink.emit("span", name=self.name, dur_us=self.dur_us,
                      span_id=self.span_id, parent_id=self.parent_id,
                      tid=self.tid, **self.attrs)
        return False


class _NullSpan:
    __slots__ = ()
    span_id = None
    parent_id = None
    dur_us = 0.0

    def add(self, **fields: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, kind, exc, tb) -> bool:
        return False


_NULL = _NullSpan()


def span(name: str, **attrs: Any):
    """A span over a region while spans are active (module docstring), else
    the shared null span.

    Usage::

        with obs.span("serve.bucket", schema="X0,X1") as sp:
            ...
            sp.add(batch=8)

    Nesting records ``parent_id``, so a flush span owns its bucket spans.
    """
    if _STATE.level < _TRACE and not _profiling():
        return _NULL
    return Span(name, attrs)


def current_span() -> Optional[Span]:
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def recorded_spans() -> List[SpanRecord]:
    """The buffer's spans, oldest first (the newest ``BUFFER_SPANS``)."""
    while True:
        try:
            return list(_buffer)
        except RuntimeError:        # a span closed on another thread
            continue


def clear_spans() -> None:
    _buffer.clear()


# -- backward regions ---------------------------------------------------------


class _Edge(torch.autograd.Function):
    """Identity; its backward opens (``opening``) or closes the span of a
    :class:`BackwardSpan`."""

    @staticmethod
    def forward(ctx, x, region, opening):
        ctx.region, ctx.opening = region, opening
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if ctx.opening:
            ctx.region.open()
        else:
            ctx.region.close()
        return grad, None, None


class BackwardSpan:
    """The span of a region's backward: ``y = r.opens(y)`` on the region's
    output opens it when the output's gradient arrives, ``x = r.closes(x)``
    on its input closes it once the input's gradient is whole.  The
    region's nodes run between the two (autograd runs a node once all its
    gradients are in, the newest first), recomputation under remat
    included."""

    __slots__ = ("name", "attrs", "_span")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs, self._span = name, attrs, None

    def opens(self, y: torch.Tensor) -> torch.Tensor:
        return _Edge.apply(y, self, True)

    def closes(self, x: torch.Tensor) -> torch.Tensor:
        return _Edge.apply(x, self, False)

    def open(self) -> None:
        if self._span is None and active():
            self._span = Span(self.name, dict(self.attrs)).__enter__()

    def close(self) -> None:
        sp, self._span = self._span, None
        if sp is not None:
            sp.__exit__(None, None, None)


class _NullBackwardSpan:
    __slots__ = ()

    def opens(self, y):
        return y

    def closes(self, x):
        return x


_NULL_BACKWARD = _NullBackwardSpan()


def backward_span(name: str, x: torch.Tensor, **attrs: Any):
    """A :class:`BackwardSpan` for a region whose input is ``x``, where
    spans are active, grad is enabled and ``x`` requires it (so the closing
    node is reached); else a null one whose ``opens`` / ``closes`` return
    their argument."""
    if not (active() and torch.is_grad_enabled() and x.requires_grad):
        return _NULL_BACKWARD
    return BackwardSpan(name, attrs)


# -- garbage collections -------------------------------------------------------


def _on_gc(phase: str, info: Dict[str, int]) -> None:
    if phase == "start":
        if active():
            _tls.gc = Span("gc", {"generation": info["generation"]}
                           ).__enter__()
        return
    sp = getattr(_tls, "gc", None)
    if sp is not None:
        _tls.gc = None
        sp.add(collected=info["collected"])
        sp.__exit__(None, None, None)


gc.callbacks.append(_on_gc)
