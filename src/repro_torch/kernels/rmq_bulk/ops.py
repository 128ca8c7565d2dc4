"""The bulk query pass: one launch per bucket of an endpoint-sorted batch
(B7).

The counterpart of the reference's ``rmq_bulk_batch``
(``repro/kernels/rmq_bulk/ops.py``).  On a CUDA hierarchy one launch of
``csrc/rmq_bulk.cu`` answers a bucket: the fused walk with each warp
holding its current level-0 boundary chunks in shared memory and loading
a chunk only when a span's chunk differs from the one it holds.  Reuse
needs a batch sorted by ``(chunk(l), chunk(r))``, which
:class:`repro_torch.qe.executors.BulkExecutor` provides; an unsorted
batch is answered the same, only without reuse.  Answers are
bit-identical to ``rmq_fused`` (values and leftmost positions).  On a
CPU hierarchy the plain version, :func:`rmq_bulk_batch_plain` (the plain
walk: the reference's oracle is its branch-free walk too), answers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.query import rmq_walk_batch
from repro_torch.kernels import _query, profiling

__all__ = [
    "LAUNCHES",
    "rmq_bulk_batch",
    "rmq_bulk_batch_cuda",
    "rmq_bulk_batch_plain",
    "rmq_bulk_index_batch",
    "rmq_bulk_value_batch",
]

LAUNCHES = profiling.KernelCounter("rmq_bulk")

# Shared memory of a block: two level-0 chunks for each of its 8 warps
# must fit (the top stage is dropped first when both do not).
_SMEM_LIMIT = 227 * 1024
_WARPS = 8

rmq_bulk_batch_plain = rmq_walk_batch


def rmq_bulk_batch_cuda(
    h: Hierarchy, ls, rs, track_pos: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch: ``(values, positions or None)`` for the bucket."""
    if _WARPS * 2 * h.plan.c * h.base.element_size() > _SMEM_LIMIT:
        raise ValueError(
            f"rmq_bulk: chunk size c={h.plan.c} of {h.base.dtype} is too "
            "large for the per-warp level-0 buffers in shared memory")
    return _query.table_walk("rmq_bulk", "rmq_bulk_query", LAUNCHES, h, ls,
                             rs, track_pos)


def rmq_bulk_batch(
    h: Hierarchy, ls, rs, track_pos: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(values, positions)`` for one bucket in one launch; ``positions``
    is ``None`` unless ``track_pos``."""
    if track_pos and not h.with_positions:
        raise ValueError(
            "hierarchy was built without positions; "
            "use build_hierarchy(..., with_positions=True)")
    ls = torch.as_tensor(ls, device=h.base.device)
    rs = torch.as_tensor(rs, device=h.base.device)
    profiling.record_launch(
        "rmq_bulk",
        lowering="cuda" if h.base.is_cuda else "eager",
        queries=int(ls.numel()),
        levels=h.plan.num_levels,
        chunk=int(h.plan.c),
        track_pos=bool(track_pos),
        operand_bytes=profiling.operand_bytes(
            h.base, h.upper, h.upper_pos if track_pos else None, ls, rs),
    )
    if h.base.is_cuda:
        vals, pos = rmq_bulk_batch_cuda(h, ls, rs, track_pos)
        return vals.reshape(ls.shape), (
            pos.reshape(ls.shape) if track_pos else None)
    return rmq_bulk_batch_plain(h, ls, rs, track_pos)


def rmq_bulk_value_batch(h: Hierarchy, ls, rs) -> torch.Tensor:
    """Batched ``RMQ_value`` through the bulk pass."""
    return rmq_bulk_batch(h, ls, rs, track_pos=False)[0]


def rmq_bulk_index_batch(h: Hierarchy, ls, rs) -> torch.Tensor:
    """Batched ``RMQ_index`` (leftmost minimum) through the bulk pass."""
    return rmq_bulk_batch(h, ls, rs, track_pos=True)[1]
