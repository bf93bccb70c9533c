"""Live metrics registry — thread-safe counters, gauges and mergeable
log-bucketed histograms with exact-rank quantile snapshots (the port's copy
of ``repro.obs.agg``; same snapshots, quantiles and merges).

The sink records raw *events*; this module is the aggregation tier
that can answer "what is p99 right now" in-process: hot paths record
into named instruments (one dict lookup + one lock per record), and any
thread can take a :meth:`MetricsRegistry.snapshot` — a plain-JSON view
that merges associatively across registries/processes
(:func:`merge_snapshots`) and exports to Prometheus text or feeds the
``slo`` events the serving queue emits per flush.

Three instrument kinds:

* :class:`Counter` — monotone float, ``inc(n)``.
* :class:`Gauge` — last-write-wins float with an update timestamp (the
  timestamp makes gauge merges associative: newest write wins).
* :class:`Histogram` — log-bucketed (geometric bucket edges
  ``lo * growth**i``), so nine decades of latency fit in ~150 sparse
  buckets with bounded relative error (``growth - 1`` per bucket).
  Quantiles are **exact-rank** over the recorded distribution: the
  bucket containing the rank-``floor(q*(count-1))`` observation is
  located by cumulative walk and its geometric midpoint returned
  (clipped to the exact observed min/max) — the same discipline as a
  production latency store, not a mean-based approximation.

Instruments are keyed by ``(name, sorted labels)``; the default
process-wide registry is :data:`REGISTRY`.  Everything here is pure
Python (no torch, no numpy), and record() sites stay cheap enough for
serving hot paths — callers gate on ``obs.enabled()`` so ``REPRO_OBS=off``
remains one integer compare.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

LabelsT = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, Any]) -> LabelsT:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotone counter.  ``inc`` is thread-safe; ``value`` is a float."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: LabelsT = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": "counter", "name": self.name,
                "labels": dict(self.labels), "value": self._value}


class Gauge:
    """Last-write-wins scalar.  Carries the wall-clock ``updated`` stamp
    so snapshot merges are associative (newest write wins)."""

    __slots__ = ("name", "labels", "_lock", "_value", "updated")

    def __init__(self, name: str, labels: LabelsT = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0
        self.updated = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            self.updated = time.time()

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": "gauge", "name": self.name,
                "labels": dict(self.labels), "value": self._value,
                "updated": self.updated}


class Histogram:
    """Mergeable log-bucketed histogram with exact-rank quantiles.

    Bucket ``i`` covers ``[lo * growth**i, lo * growth**(i+1))``; values
    below ``lo`` land in a dedicated underflow bucket (represented by the
    exact observed min), values at/above ``hi`` in the overflow bucket
    (exact observed max).  Counts are kept sparse (dict), so an idle
    histogram costs a few hundred bytes.
    """

    __slots__ = ("name", "labels", "lo", "hi", "growth", "n_bins",
                 "_inv_log_growth", "_lock", "_counts", "count", "sum",
                 "min", "max")

    UNDER = -1  # underflow bin index

    def __init__(self, name: str, labels: LabelsT = (), *,
                 lo: float = 1e-3, hi: float = 1e7, growth: float = 1.15):
        if not (lo > 0 and hi > lo and growth > 1.0):
            raise ValueError("need 0 < lo < hi and growth > 1")
        self.name = name
        self.labels = labels
        self.lo = float(lo)
        self.hi = float(hi)
        self.growth = float(growth)
        self.n_bins = int(math.ceil(math.log(hi / lo) / math.log(growth)))
        self._inv_log_growth = 1.0 / math.log(growth)
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _bin(self, v: float) -> int:
        if v < self.lo:
            return self.UNDER
        i = int(math.log(v / self.lo) * self._inv_log_growth)
        return min(i, self.n_bins)          # n_bins == overflow

    def edge(self, i: int) -> float:
        """Upper edge of bucket ``i`` (lower edge of bucket ``i+1``)."""
        return self.lo * self.growth ** (i + 1)

    def record(self, v: float) -> None:
        v = float(v)
        if v != v:                          # NaN: quarantine, don't poison
            return
        b = self._bin(v)
        with self._lock:
            self._counts[b] = self._counts.get(b, 0) + 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    # -- quantiles ----------------------------------------------------------

    def quantile(self, q: float) -> float:
        with self._lock:
            return _quantile(self._counts, self.count, self.min, self.max,
                             self.lo, self.growth, self.n_bins, q)

    def quantiles(self, qs: Sequence[float]) -> List[float]:
        with self._lock:
            return [_quantile(self._counts, self.count, self.min, self.max,
                              self.lo, self.growth, self.n_bins, q)
                    for q in qs]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"kind": "histogram", "name": self.name,
                    "labels": dict(self.labels),
                    "lo": self.lo, "hi": self.hi, "growth": self.growth,
                    "n_bins": self.n_bins,
                    "counts": {str(k): v for k, v in self._counts.items()},
                    "count": self.count, "sum": self.sum,
                    "min": self.min if self.count else None,
                    "max": self.max if self.count else None}


def _quantile(counts: Dict[int, int], total: int, vmin: float, vmax: float,
              lo: float, growth: float, n_bins: int, q: float) -> float:
    """Exact-rank quantile over bucketed counts: locate the bucket holding
    the rank-``floor(q*(total-1))`` observation, return its geometric
    midpoint clipped to the observed [min, max]."""
    if total <= 0:
        return math.nan
    q = min(1.0, max(0.0, q))
    rank = int(q * (total - 1))
    seen = 0
    for b in sorted(counts):
        seen += counts[b]
        if seen > rank:
            if b == Histogram.UNDER:
                return vmin
            if b >= n_bins:
                return vmax
            mid = lo * growth ** (b + 0.5)
            return min(max(mid, vmin), vmax)
    return vmax


def quantile_from_snapshot(h: Dict[str, Any], q: float) -> float:
    """Exact-rank quantile over a histogram *snapshot* (post-merge view)."""
    if h.get("kind") != "histogram":
        raise ValueError("quantile_from_snapshot needs a histogram snapshot")
    counts = {int(k): v for k, v in h["counts"].items()}
    vmin = h["min"] if h["min"] is not None else math.nan
    vmax = h["max"] if h["max"] is not None else math.nan
    return _quantile(counts, h["count"], vmin, vmax, h["lo"], h["growth"],
                     h["n_bins"], q)


class MetricsRegistry:
    """Thread-safe get-or-create store of named, labeled instruments."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, LabelsT], Any] = {}

    def _get(self, kind: str, cls, name: str, labels: Dict[str, Any],
             **kw: Any):
        key = (kind, name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = self._metrics[key] = cls(name, key[2], **kw)
        return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, *, lo: float = 1e-3, hi: float = 1e7,
                  growth: float = 1.15, **labels: Any) -> Histogram:
        return self._get("histogram", Histogram, name, labels,
                         lo=lo, hi=hi, growth=growth)

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time plain-JSON view: ``{"metrics": [entry, ...]}``,
        each entry self-describing (kind/name/labels + state).  Snapshots
        merge associatively via :func:`merge_snapshots`."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {"metrics": [m.snapshot() for m in metrics]}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


def _entry_key(e: Dict[str, Any]) -> Tuple[str, str, LabelsT]:
    return (e["kind"], e["name"], _labels_key(e["labels"]))


def _merge_entry(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    if a["kind"] != b["kind"]:
        raise ValueError(f"cannot merge {a['kind']} with {b['kind']}")
    if a["kind"] == "counter":
        out = dict(a)
        out["value"] = a["value"] + b["value"]
        return out
    if a["kind"] == "gauge":
        return dict(a if a["updated"] >= b["updated"] else b)
    # histogram: bucket-wise sum; configs must agree for merge to be exact
    for f in ("lo", "hi", "growth", "n_bins"):
        if a[f] != b[f]:
            raise ValueError(f"histogram bucket configs differ on {f!r}")
    counts = dict(a["counts"])
    for k, v in b["counts"].items():
        counts[k] = counts.get(k, 0) + v
    mins = [m for m in (a["min"], b["min"]) if m is not None]
    maxs = [m for m in (a["max"], b["max"]) if m is not None]
    out = dict(a)
    out.update(counts=counts, count=a["count"] + b["count"],
               sum=a["sum"] + b["sum"],
               min=min(mins) if mins else None,
               max=max(maxs) if maxs else None)
    return out


def merge_snapshots(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Merge two registry snapshots (associative and commutative up to
    entry order): counters add, gauges keep the newest write, histograms
    add bucket-wise.  The inputs are not mutated."""
    merged: Dict[Tuple[str, str, LabelsT], Dict[str, Any]] = {}
    order: List[Tuple[str, str, LabelsT]] = []
    for snap in (a, b):
        for e in snap["metrics"]:
            k = _entry_key(e)
            if k in merged:
                merged[k] = _merge_entry(merged[k], e)
            else:
                merged[k] = dict(e)
                order.append(k)
    return {"metrics": [merged[k] for k in sorted(order)]}


#: Default process-wide registry.  The sink's kernel-dispatch counters,
#: the streaming/resilience counters and the serving SLO histograms all
#: record here; ``obs.configure(reset_counters=True)`` clears it.
REGISTRY = MetricsRegistry()
