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
  (``RMQ.engine()``);
* :class:`QueryService` (:mod:`repro_torch.qe.service`): a multi-index
  registry with a micro-batching admission queue, one engine execution
  per flushed (index, op) group (one mixed execution on a fused engine),
  and ``register_many`` through one batched build.

The distributed executor's names are exported; the executor itself
refuses until the port has a distributed index (ROADMAP A10).
"""

from repro_torch.qe.cache import ResultCache
from repro_torch.qe.distributed import (
    CROSSING,
    SEG_LOCAL,
    DistributedExecutor,
)
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
from repro_torch.qe.service import QueryService

__all__ = [
    "Bucket",
    "BulkExecutor",
    "CROSSING",
    "DistributedExecutor",
    "FUSED",
    "FusedExecutor",
    "LONG",
    "MID",
    "SEG_LOCAL",
    "SHORT",
    "QueryEngine",
    "QueryPlanner",
    "QueryService",
    "ResultCache",
]
