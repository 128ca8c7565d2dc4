"""Fused query path: a whole mixed batch, both planes, ONE launch.

The counterpart of the reference's ``rmq_fused_batch``
(``repro/kernels/rmq_fused/ops.py``).  On a CUDA hierarchy one launch of
``csrc/rmq_fused.cu`` answers the batch, every span class, and with
``track_pos`` emits the value and the leftmost-position planes together.
The kernel handles degenerate plans (one level, ``capacity < c``) itself,
where the reference falls back to a jnp program.  On a CPU hierarchy the
plain version, :func:`rmq_fused_batch_plain` (the plain walk), answers.

Compact planes: a packed position plane is unpacked before the launch
(``_query.launch_planes``), so a packed index launches B2 as a classic
one does.  An index with bf16 summaries is answered by the plain
exact-recovery walk on its own device, the card included, with no
launch: the reference answers it through its jnp walk too, and neither
package has a kernel for it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.query import rmq_walk_batch
from repro_torch.kernels import _query, profiling

__all__ = [
    "LAUNCHES",
    "rmq_fused_batch",
    "rmq_fused_batch_cuda",
    "rmq_fused_batch_plain",
    "rmq_fused_index_batch",
    "rmq_fused_value_batch",
]

LAUNCHES = profiling.KernelCounter("rmq_fused")

rmq_fused_batch_plain = rmq_walk_batch


def rmq_fused_batch_cuda(
    h: Hierarchy, ls, rs, track_pos: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch: ``(values, positions or None)`` for the batch."""
    return _query.table_walk("rmq_fused", "rmq_fused_query", LAUNCHES, h, ls,
                             rs, track_pos)


def rmq_fused_batch(
    h: Hierarchy, ls, rs, track_pos: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(values, positions)`` for the whole batch in one launch;
    ``positions`` is ``None`` unless ``track_pos``."""
    if track_pos and not h.with_positions:
        raise ValueError(
            "hierarchy was built without positions; "
            "use build_hierarchy(..., with_positions=True)")
    ls = torch.as_tensor(ls, device=h.base.device)
    rs = torch.as_tensor(rs, device=h.base.device)
    quantized = h.quantized
    profiling.record_launch(
        "rmq_fused",
        lowering="cuda" if h.base.is_cuda and not quantized else "eager",
        queries=int(ls.numel()),
        levels=h.plan.num_levels,
        track_pos=bool(track_pos),
        operand_bytes=profiling.operand_bytes(
            h.base, h.upper, h.upper_pos if track_pos else None, ls, rs),
    )
    if h.base.is_cuda and not quantized:
        vals, pos = rmq_fused_batch_cuda(h, ls, rs, track_pos)
        return vals.reshape(ls.shape), (
            pos.reshape(ls.shape) if track_pos else None)
    return rmq_fused_batch_plain(h, ls, rs, track_pos)


def rmq_fused_value_batch(h: Hierarchy, ls, rs) -> torch.Tensor:
    """Batched ``RMQ_value`` through the fused single-launch path."""
    return rmq_fused_batch(h, ls, rs, track_pos=False)[0]


def rmq_fused_index_batch(h: Hierarchy, ls, rs) -> torch.Tensor:
    """Batched ``RMQ_index`` (leftmost minimum) through the fused path."""
    return rmq_fused_batch(h, ls, rs, track_pos=True)[1]
