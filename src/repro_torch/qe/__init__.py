"""The adaptive batched query engine of the port.

* :class:`QueryPlanner` (a copy of ``repro.qe.planner``) classifies each
  query by span into short / mid / long and packs each class into padded
  power-of-two buckets;
* executors (:mod:`repro_torch.qe.executors`): short spans to the
  ``rmq_short`` kernel, mid spans to ``rmq_scan``, long spans to the
  :class:`~repro_torch.core.hybrid.HybridRMQ` top; with the ``fused``
  backend one ``rmq_fused`` launch per bucket; the offline bulk path
  through ``rmq_bulk``;
* :class:`ResultCache` (a copy of ``repro.qe.cache``): an LRU keyed by
  ``(op, generation, l, r)``;
* :class:`QueryEngine` ties them together for one index
  (``RMQ.engine()``).

Not ported yet: ``QueryService`` (ROADMAP A6/A8) and the distributed
executor (A10).
"""

from repro_torch.qe.cache import ResultCache
from repro_torch.qe.engine import QueryEngine
from repro_torch.qe.executors import BulkExecutor, FusedExecutor
from repro_torch.qe.planner import (
    FUSED,
    LONG,
    MID,
    SHORT,
    Bucket,
    QueryPlanner,
)

__all__ = [
    "Bucket",
    "BulkExecutor",
    "FUSED",
    "FusedExecutor",
    "LONG",
    "MID",
    "SHORT",
    "QueryEngine",
    "QueryPlanner",
    "ResultCache",
]
