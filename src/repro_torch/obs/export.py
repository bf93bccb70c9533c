"""Exporters for the obs aggregation tier (the port's copy of
``repro.obs.export``: the same strings on the same snapshot and events).

Two read-side formats:

* :func:`prometheus_text` — Prometheus text exposition (version 0.0.4)
  of a :meth:`~repro_torch.obs.agg.MetricsRegistry.snapshot`: counters and
  gauges as single samples, histograms as cumulative ``_bucket{le=...}``
  series plus ``_sum``/``_count``, ready to drop behind any scrape
  endpoint or push to a textfile collector.

* :func:`chrome_trace` / :func:`write_chrome_trace` — Chrome-trace /
  Perfetto JSON (``{"traceEvents": [...]}``) built from the ``span``
  events in an obs JSONL stream.  Spans become complete ("X") events on
  one lane per emitting thread, so ``chrome://tracing`` or
  https://ui.perfetto.dev renders the serving queue's nested
  flush/bucket spans as a flame graph.

Both are pure read-side transforms: they never touch the sink or the
registry hot paths, so they add nothing to the ``REPRO_OBS=off`` cost.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Union

from repro_torch.obs import agg

# Fields of a span JSONL record that are structural rather than
# user-attached; everything else lands in the trace event's ``args``.
_SPAN_FIELDS = ("ts", "seq", "run", "event", "name", "dur_us", "span_id",
                "parent_id", "tid")


def _sanitize_name(name: str) -> str:
    out = [c if (c.isalnum() or c in "_:") else "_" for c in name]
    if out and out[0].isdigit():
        out.insert(0, "_")
    return "".join(out)


def _escape_label(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _labels_text(labels: Dict[str, Any], extra: str = "") -> str:
    parts = [f'{_sanitize_name(str(k))}="{_escape_label(v)}"'
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def prometheus_text(snapshot: Dict[str, Any]) -> str:
    """Render a registry snapshot in Prometheus text exposition format.

    Histogram buckets are emitted cumulatively with ``le`` set to the
    log-bucket upper edges (only buckets that change the cumulative
    count, plus ``+Inf``), matching how a Prometheus-native histogram
    with custom bounds would scrape.
    """
    lines: List[str] = []
    typed: set = set()

    def _type(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for e in snapshot["metrics"]:
        name = _sanitize_name(e["name"])
        kind = e["kind"]
        if kind in ("counter", "gauge"):
            _type(name, kind)
            lines.append(f"{name}{_labels_text(e['labels'])} {_fmt(e['value'])}")
            continue
        if kind != "histogram":
            raise ValueError(f"unknown metric kind {kind!r}")
        _type(name, "histogram")
        counts = {int(k): v for k, v in e["counts"].items()}
        cum = 0
        for b in sorted(counts):
            cum += counts[b]
            if b >= e["n_bins"]:
                continue            # overflow is covered by +Inf
            le = e["hi"] if b == e["n_bins"] - 1 else e["lo"] * e["growth"] ** (b + 1)
            lt = _labels_text(e["labels"], 'le="%r"' % le)
            lines.append(f"{name}_bucket{lt} {cum}")
        inf = _labels_text(e["labels"], 'le="+Inf"')
        lines.append(f"{name}_bucket{inf} {e['count']}")
        lines.append(f"{name}_sum{_labels_text(e['labels'])} {_fmt(e['sum'])}")
        lines.append(f"{name}_count{_labels_text(e['labels'])} {e['count']}")
    return "\n".join(lines) + "\n"


def default_prometheus_text() -> str:
    """Prometheus exposition of the process-wide default registry."""
    return prometheus_text(agg.REGISTRY.snapshot())


# ---------------------------------------------------------------------------
# Chrome trace / Perfetto export of span events
# ---------------------------------------------------------------------------


def _iter_records(src: Union[str, Iterable[Any]]) -> Iterable[Dict[str, Any]]:
    if isinstance(src, str):
        with open(src) as fh:
            for line in fh:
                if line.strip():
                    yield json.loads(line)
        return
    for item in src:
        if isinstance(item, str):
            if item.strip():
                yield json.loads(item)
        else:
            yield item


def chrome_trace(src: Union[str, Iterable[Any]]) -> Dict[str, Any]:
    """Convert the ``span`` events of an obs JSONL stream to Chrome-trace
    JSON.

    ``src`` is a JSONL file path, an iterable of lines, or an iterable of
    already-parsed dicts; non-span events are skipped.  Each span becomes
    a complete ("X") event: ``ts`` is the span *start* in microseconds
    (the sink stamps wall-clock at span end, so start = ts*1e6 - dur_us),
    ``dur`` is ``dur_us``, the lane (``tid``) is the emitting thread and
    the process is the obs run id.  Span attrs plus ``span_id`` /
    ``parent_id`` ride along in ``args``.
    """
    events: List[Dict[str, Any]] = []
    pids: Dict[str, int] = {}
    for rec in _iter_records(src):
        if rec.get("event") != "span":
            continue
        run = rec.get("run", "?")
        pid = pids.get(run)
        if pid is None:
            pid = pids[run] = len(pids) + 1
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": f"obs run {run}"}})
        dur = float(rec.get("dur_us", 0.0))
        args = {k: v for k, v in rec.items() if k not in _SPAN_FIELDS}
        args["span_id"] = rec.get("span_id")
        if rec.get("parent_id") is not None:
            args["parent_id"] = rec["parent_id"]
        events.append({
            "name": rec.get("name", "span"),
            "ph": "X",
            "ts": rec["ts"] * 1e6 - dur,
            "dur": dur,
            "pid": pid,
            "tid": rec.get("tid", 0),
            "args": args,
        })
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(src: Union[str, Iterable[Any]], out_path: str
                       ) -> Dict[str, Any]:
    """Write :func:`chrome_trace` output to ``out_path``; returns it."""
    trace = chrome_trace(src)
    with open(out_path, "w") as fh:
        json.dump(trace, fh)
    return trace
