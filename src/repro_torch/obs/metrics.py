"""Metrics tuples of the fit and step bodies (the port's copy of
``repro.obs.metrics``).

Plain NamedTuples of tensors, computed on the device beside the result
they describe: the streaming drivers stack :class:`StreamBatchMetrics`
columns, the temporal fits :class:`TemporalFitMetrics`, ``vmp.local_step``
returns :class:`LocalStepMetrics` and ``dvmp.dvmp_fit``
:class:`DvmpMetrics`.  Nothing here reads them back: the host decides after
the fact whether to ship them to the sink (``sink.emit_stream_events``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple


class StreamBatchMetrics(NamedTuple):
    """Per-batch gauges from one streaming-VMP step (0-dim tensors in
    ``stream_update``; ``[T]`` stacked columns out of ``stream_fit``)."""

    elbo: Any      # final ELBO of the batch fit
    score: Any     # per-instance ELBO (drift statistic input)
    ph: Any        # Page-Hinkley statistic after the batch
    drifted: Any   # bool: did the detector fire on this batch
    n_eff: Any     # effective instance count (mask sum)
    rho: Any       # prior tempering factor applied (1.0 = no temper)
    sweeps: Any    # VMP sweeps-to-convergence for the batch fit
    quarantined: Any  # bool: non-finite batch skipped, carried posterior held

    def as_info(self) -> Dict[str, Any]:
        """The dict view that ``stream_fit``/``stream_update`` return."""
        return dict(self._asdict())


class TemporalFitMetrics(NamedTuple):
    """Per-sweep gauges of a temporal VB-EM fit (``pgm_models.dynamic``):
    each field is a [sweeps] column (the device-held loop keeps one entry a
    sweep of the budget; the host loop one a sweep run)."""

    elbo: Any      # ELBO (loglik lower bound) after each sweep
    delta: Any     # |ELBO - previous ELBO| per sweep (0 once converged)
    active: Any    # bool: was this sweep adopted (vs held past tol)

    def as_info(self) -> Dict[str, Any]:
        return dict(self._asdict())


class LocalStepMetrics(NamedTuple):
    """Optional output of ``vmp.local_step(..., with_metrics=True)``."""

    chunk_n_eff: Any   # [n_chunks] effective instances reduced per chunk


class DvmpMetrics(NamedTuple):
    """Optional output of ``dvmp.dvmp_fit(..., with_metrics=True)``."""

    shard_n: Any   # [n_shards] each shard's effective instances, in order
    sweeps: Any    # sweeps the distributed fit ran
