"""repro_torch.obs — round-level tracing and metrics for mining and serving.

Span traces (Perfetto ``trace_event`` JSON) of every host-side round
boundary, a label-aware metrics registry with HDR-style latency
histograms, and the schedule-census base both stats tiers inherit.
Tracing is off by default (a shared no-op tracer); install one with
``use_tracer(Tracer())`` or ``fca ... --trace out.json``.
"""

from repro_torch.obs.metrics import Histogram, Registry, ScheduleCensus, StatsBase
from repro_torch.obs.trace import (
    NOOP,
    NoopTracer,
    Tracer,
    async_overlaps,
    current,
    set_tracer,
    span_rollup,
    start_device_trace,
    stop_device_trace,
    use_tracer,
    validate_trace,
)

__all__ = [
    "Histogram",
    "Registry",
    "ScheduleCensus",
    "StatsBase",
    "NOOP",
    "NoopTracer",
    "Tracer",
    "async_overlaps",
    "current",
    "set_tracer",
    "span_rollup",
    "start_device_trace",
    "stop_device_trace",
    "use_tracer",
    "validate_trace",
]
