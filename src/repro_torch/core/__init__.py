"""GPU-RMQ core of the port: plan, hierarchy, plain walk and the facade.

    from repro_torch.core import RMQ

    rmq = RMQ.build(x, with_positions=True)   # on the card
    vals = rmq.query(ls, rs)                  # batched RMQ_value
    pos = rmq.query_index(ls, rs)             # batched RMQ_index (leftmost)
"""

from repro_torch.core.api import RMQ
from repro_torch.core.constants import PAD_POS, POS_INF_I32
from repro_torch.core.hierarchy import Hierarchy, build_hierarchy, pos_dtype_for
from repro_torch.core.plan import HierarchyPlan, LevelSplit, make_plan
from repro_torch.core.protocol import live_length
from repro_torch.core.query import (
    check_query_args,
    rmq_index_batch,
    rmq_value_batch,
    rmq_walk_batch,
)

__all__ = [
    "RMQ",
    "Hierarchy",
    "HierarchyPlan",
    "LevelSplit",
    "PAD_POS",
    "POS_INF_I32",
    "build_hierarchy",
    "check_query_args",
    "live_length",
    "make_plan",
    "pos_dtype_for",
    "rmq_index_batch",
    "rmq_value_batch",
    "rmq_walk_batch",
]
