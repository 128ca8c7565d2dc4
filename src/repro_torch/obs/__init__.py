"""Observability of the port: request tracing and metrics.

``trace.py`` and ``metrics.py`` are copies of the reference's
``repro.obs`` modules (pure Python, no framework import), so the engine's
spans and counters read the same in both packages.  The launch registry
lives beside the kernels (:mod:`repro_torch.kernels.profiling`).
Exporters past the dict / Prometheus text ones wait for ROADMAP A7.
"""

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
    "Metrics",
    "SIZE_BUCKETS",
    "Span",
    "Tracer",
    "set_tracer",
    "use_tracer",
]
