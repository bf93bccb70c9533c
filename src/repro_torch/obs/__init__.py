"""repro_torch.obs — observability of the port: metrics tuples, spans, a
JSONL sink, a metrics registry with exporters and replica health scores
(the port's copy of ``repro.obs``, with the same event schema and
environment knobs).

    REPRO_OBS=basic  python ...   # JSONL events -> $REPRO_OBS_PATH
    REPRO_OBS=trace  python ...   # + span events

    from repro_torch import obs
    with obs.span("my.region", tag="x") as sp:
        ...
    obs.emit("metric", name="elbo", value=-1.23)
    obs.recorded_spans()          # the spans kept in memory

Spans are also active while ``torch.profiler`` records: each is then a
``record_function`` range of the profiler's trace (``obs/trace.py``).  See
``obs/sink.py`` for the event schema.
"""

from repro_torch.obs.agg import (REGISTRY, MetricsRegistry, merge_snapshots,
                                 quantile_from_snapshot)
from repro_torch.obs.sink import (BASIC, EVENT_SCHEMA, OFF, TRACE, configure,
                                  count_kernel, emit, emit_kernel_counts,
                                  emit_stream_events, enabled, kernel_counts,
                                  level, log, validate_obs_events)
from repro_torch.obs.trace import (SpanRecord, backward_span, clear_spans,
                                   current_span, recorded_spans, span)
from repro_torch.obs.export import (chrome_trace, default_prometheus_text,
                                    prometheus_text, write_chrome_trace)
from repro_torch.obs.health import HealthTracker
from repro_torch.obs.metrics import (DvmpMetrics, LocalStepMetrics,
                                     StreamBatchMetrics, TemporalFitMetrics)

__all__ = [
    "OFF", "BASIC", "TRACE", "EVENT_SCHEMA",
    "configure", "enabled", "level",
    "emit", "log", "span", "current_span", "backward_span",
    "recorded_spans", "clear_spans", "SpanRecord",
    "count_kernel", "kernel_counts", "emit_kernel_counts",
    "emit_stream_events",
    "validate_obs_events",
    "REGISTRY", "MetricsRegistry", "merge_snapshots",
    "quantile_from_snapshot",
    "prometheus_text", "default_prometheus_text",
    "chrome_trace", "write_chrome_trace",
    "HealthTracker",
    "StreamBatchMetrics", "TemporalFitMetrics", "LocalStepMetrics",
    "DvmpMetrics",
]
