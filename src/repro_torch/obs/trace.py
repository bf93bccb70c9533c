"""Host-side span tracer: context-manager API, monotonic clocks,
parent/child nesting (the port's copy of ``repro.obs.trace``).

Spans measure HOST latency (queueing, plan build, dispatch+wait) — the
serving tier's p50/p99 quantities.  A span around device work measures
the host's enqueue time unless the body synchronizes (``jt.execute`` does,
at TRACE only); device time is profiled via ``obs.profile`` (the
``torch.profiler`` hook) instead.

Below TRACE level, :func:`span` returns a shared null context — no
clock read, no allocation — so instrumented code paths cost one integer
compare when tracing is off.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, Iterator, Optional

from repro_torch.obs import sink

_ids = itertools.count(1)
_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class Span:
    """One timed region.  ``dur_us`` is valid after the context exits;
    :meth:`add` attaches extra fields to the emitted event."""

    __slots__ = ("name", "span_id", "parent_id", "attrs", "_t0", "dur_us")

    def __init__(self, name: str, parent_id: Optional[int],
                 attrs: Dict[str, Any]):
        self.name = name
        self.span_id = next(_ids)
        self.parent_id = parent_id
        self.attrs = attrs
        self._t0 = 0
        self.dur_us = 0.0

    def add(self, **fields: Any) -> None:
        self.attrs.update(fields)


@contextlib.contextmanager
def _timed(name: str, attrs: Dict[str, Any]) -> Iterator[Span]:
    st = _stack()
    sp = Span(name, st[-1].span_id if st else None, attrs)
    st.append(sp)
    sp._t0 = time.perf_counter_ns()
    try:
        yield sp
    except BaseException as e:
        # A raising body must not look like a clean span: stamp the
        # exception type on the event and let it propagate.
        sp.attrs.setdefault("error", type(e).__name__)
        raise
    finally:
        sp.dur_us = (time.perf_counter_ns() - sp._t0) / 1e3
        st.pop()
        sink.emit("span", name=sp.name, dur_us=sp.dur_us,
                  span_id=sp.span_id, parent_id=sp.parent_id,
                  tid=threading.get_ident(), **sp.attrs)


class _NullSpan:
    __slots__ = ()
    span_id = None
    parent_id = None
    dur_us = 0.0

    def add(self, **fields: Any) -> None:
        pass


_NULL = _NullSpan()


@contextlib.contextmanager
def _null() -> Iterator[_NullSpan]:
    yield _NULL


def span(name: str, **attrs: Any):
    """Time a host-side region; emits a ``span`` event at TRACE level.

    Usage::

        with obs.span("serve.bucket", schema="X0,X1") as sp:
            ...
            sp.add(batch=8)

    Nesting records ``parent_id`` so a flush span owns its bucket spans.
    Returns a null context below TRACE level.
    """
    if sink.level() < sink.TRACE:
        return _null()
    return _timed(name, attrs)


def current_span() -> Optional[Span]:
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None
