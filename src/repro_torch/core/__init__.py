"""GPU-RMQ core of the port: plan, hierarchy, plain walk and the facade.

    from repro_torch.core import RMQ

    rmq = RMQ.build(x, with_positions=True)   # on the card
    rmq = RMQ.build(x, c="auto")              # geometry from the card's
                                              # tuning cache (c=128, t=64
                                              # on a miss)
    vals = rmq.query(ls, rs)                  # batched RMQ_value
    pos = rmq.query_index(ls, rs)             # batched RMQ_index (leftmost)

    # compact planes: 7-bit positions at c = 128, bf16 upper levels
    rmq = RMQ.build(x, with_positions=True, packed_pos=True,
                    summary_dtype="bfloat16")
    # slabs from a callable, past 2^31 through the eager walk
    rmq = RMQ.build_out_of_core(make_slab, n, with_positions=True)
    # many equal-length arrays, one B1 launch on the card
    batched = build_many(xs, make_plan(n), with_positions=True)
"""

from repro_torch.core import bitpack
from repro_torch.core.api import RMQ
from repro_torch.core.constants import PAD_POS, POS_INF_I32
from repro_torch.core.hierarchy import (
    Hierarchy,
    build_hierarchy,
    build_many,
    finalize_compact,
    pos_dtype_for,
)
from repro_torch.core.plan import HierarchyPlan, LevelSplit, make_plan
from repro_torch.core.protocol import (
    MutableRMQIndex,
    RMQIndex,
    is_distributed,
    live_length,
    supports_mutation,
)
from repro_torch.core.query import (
    check_query_args,
    rmq_index,
    rmq_index_batch,
    rmq_value,
    rmq_value_batch,
    rmq_walk_batch,
)
from repro_torch.core.theory import (
    aux_entries_bound,
    aux_entries_bound_ceil,
    expected_scanned_entries,
    max_scanned_entries,
    optimal_num_levels,
)

__all__ = [
    "RMQ",
    "RMQIndex",
    "MutableRMQIndex",
    "is_distributed",
    "supports_mutation",
    "Hierarchy",
    "HierarchyPlan",
    "LevelSplit",
    "PAD_POS",
    "POS_INF_I32",
    "aux_entries_bound",
    "aux_entries_bound_ceil",
    "bitpack",
    "build_hierarchy",
    "build_many",
    "check_query_args",
    "expected_scanned_entries",
    "finalize_compact",
    "live_length",
    "make_plan",
    "max_scanned_entries",
    "optimal_num_levels",
    "pos_dtype_for",
    "rmq_index",
    "rmq_index_batch",
    "rmq_value",
    "rmq_value_batch",
    "rmq_walk_batch",
]
