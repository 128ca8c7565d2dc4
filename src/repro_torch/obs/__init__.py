"""Observability of the port: request tracing, metrics, launch registry.

``trace.py`` and ``metrics.py`` are copies of the reference's
``repro.obs`` modules (pure Python, no framework import), so the engine's
spans and counters read the same in both packages.  The launch registry
lives beside the kernels (:mod:`repro_torch.kernels.profiling`) and is
re-exported here, as in the reference; it files launches, configs,
timings and cost estimates (``LaunchRegistry.attach_cost``, fed by
``torch.utils.flop_counter.FlopCounterMode`` on the torch side).
"""

from repro_torch.kernels.profiling import (
    LaunchRecord,
    LaunchRegistry,
    count_launches,
    launch_registry,
    record_launch,
)
from repro_torch.obs.metrics import (
    LATENCY_BUCKETS,
    SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Metrics,
)
from repro_torch.obs.trace import Span, Tracer, set_tracer, use_tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "LaunchRecord",
    "LaunchRegistry",
    "Metrics",
    "SIZE_BUCKETS",
    "Span",
    "Tracer",
    "count_launches",
    "launch_registry",
    "record_launch",
    "set_tracer",
    "use_tracer",
]
