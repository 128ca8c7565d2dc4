"""Async serving tier of the port: deadline micro-batching,
snapshot-isolated reads, admission control and telemetry over the fused
query path.

The port of ``repro.serving``.  The layer cake, bottom-up:

* :class:`repro_torch.qe.QueryService`: multi-index registry and
  coalescing (one ``rmq_fused`` launch per flushed mixed batch on a fused
  engine), flush timing caller-driven;
* :class:`~repro_torch.serving.snapshot.SnapshotSlot`: double-buffered
  index per tenant; the immutable *front* serves reads, mutations stage
  onto the *back* log and swap in between flushes (``RMQ.update``:
  ``hierarchy_update`` on the card);
* :class:`~repro_torch.serving.tier.ServingTier`: the deadline scheduler
  (per-tenant latency SLOs and size triggers, bounded queues and
  token-bucket quotas rejecting with
  :class:`~repro_torch.serving.tier.Backpressure`), every submit
  returning a Future-style :class:`~repro_torch.serving.tier.Ticket`;
* :class:`~repro_torch.serving.aio.AsyncServingTier`: the same tier
  behind ``await``, with an event-loop pump in place of the flusher
  thread;
* :mod:`repro_torch.obs.metrics` (re-exported as
  ``repro_torch.serving.metrics``): counters, gauges and histograms,
  exported by :meth:`ServingTier.stats` or
  ``tier.metrics.to_prometheus()``.
"""

from repro_torch.serving.metrics import Counter, Gauge, Histogram, Metrics
from repro_torch.serving.snapshot import Snapshot, SnapshotSlot
from repro_torch.serving.tier import (
    Backpressure,
    FlushEvent,
    ServingTier,
    TenantConfig,
    Ticket,
)

__all__ = [
    "AsyncServingTier",
    "Backpressure",
    "Counter",
    "FlushEvent",
    "Gauge",
    "Histogram",
    "Metrics",
    "ServingTier",
    "Snapshot",
    "SnapshotSlot",
    "TenantConfig",
    "Ticket",
]


def __getattr__(name):
    # the asyncio front end is imported lazily, as in the reference
    if name == "AsyncServingTier":
        from repro_torch.serving.aio import AsyncServingTier

        return AsyncServingTier
    raise AttributeError(name)
