"""Serving observability (DESIGN.md §10): allocation-cheap metrics
(counters / gauges / fixed-bucket histograms with interpolated
percentiles), a bounded per-tick trace with request lifecycle spans, and
JSONL / Chrome ``trace_event`` exporters.

Entry points: the engine owns a :class:`ServingTelemetry`
(``PagedServingEngine(telemetry=...)``, ``engine.dump_trace(path)``);
``tools/tracestats.py`` summarizes and validates dumped traces.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               log_bucket_edges)
from repro_torch.obs.trace import (SCHEMA_VERSION, SPAN_KINDS, TICK_FIELDS, Ring,
                             ServingTelemetry)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "log_bucket_edges",
    "Ring", "ServingTelemetry", "SCHEMA_VERSION", "SPAN_KINDS",
    "TICK_FIELDS",
]
