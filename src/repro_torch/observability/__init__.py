"""repro_torch.observability — serving telemetry: metrics, tracing, export.

The port's copy of ``repro.observability`` (stdlib only):

* ``metrics`` — ``Counter``/``Gauge``/``Histogram`` behind a
  ``MetricsRegistry``; fixed-log-bucket histograms with interpolated
  p50/p95/p99, exact cross-host merging (``merge_snapshots``), Prometheus
  text exposition (``to_prometheus``).
* ``trace`` — ``TraceRecorder`` bounded ring of per-request lifecycle
  events with JSONL export; ``NULL_RECORDER`` is the allocation-free
  disabled path.
* ``export`` — ``format_stats_line``, ``StatsPrinter`` and
  ``MetricsServer``.

``profile_span(name)`` names a dispatch leg in a ``torch.profiler`` trace
(``torch.profiler.record_function``; the reference uses
``jax.profiler.TraceAnnotation``). Outside a profiling session it only
marks the range.
"""
from __future__ import annotations

import torch

from repro_torch.observability.export import (
    MetricsServer,
    StatsPrinter,
    format_stats_line,
)
from repro_torch.observability.metrics import (
    DEFAULT_MS_BOUNDS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    bucket_bounds_at,
    merge_snapshots,
    percentile_from_buckets,
    to_prometheus,
)
from repro_torch.observability.trace import (
    NULL_RECORDER,
    NullRecorder,
    TraceRecorder,
    read_jsonl,
)


def profile_span(name: str):
    """Context manager naming a dispatch leg in a ``torch.profiler`` trace."""
    return torch.profiler.record_function(name)


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_MS_BOUNDS", "merge_snapshots",
           "percentile_from_buckets", "bucket_bounds_at", "to_prometheus",
           "TraceRecorder", "NullRecorder", "NULL_RECORDER", "read_jsonl",
           "MetricsServer", "StatsPrinter", "format_stats_line",
           "profile_span"]
