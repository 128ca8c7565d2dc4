"""Fused query path: a whole mixed batch, both planes, ONE launch.

The counterpart of the reference's ``rmq_fused_batch``
(``repro/kernels/rmq_fused/ops.py``).  On a CUDA hierarchy one launch of
``csrc/rmq_fused.cu`` answers the batch, every span class, and with
``track_pos`` emits the value and the leftmost-position planes together.
The kernel handles degenerate plans (one level, ``capacity < c``) itself,
where the reference falls back to a jnp program.  On a CPU hierarchy the
plain version, :func:`rmq_fused_batch_plain` (the plain walk), answers.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.query import rmq_walk_batch
from repro_torch.kernels import _build, _query, profiling

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


# (dtype, track, capacity, c, levels, padded_lens, offsets_table, base,
#  upper, upper_pos, ls, rs, m, out_v, out_p, stream)
_SIGNATURES = {
    "rmq_fused_query": (
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ),
}


def rmq_fused_batch_cuda(
    h: Hierarchy, ls, rs, track_pos: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch: ``(values, positions or None)`` for the batch."""
    ls, rs = _query.kernel_bounds(h, ls, rs, "rmq_fused")
    plan, dev = h.plan, h.base.device
    m = ls.numel()
    out_v = torch.empty(m, dtype=h.base.dtype, device=dev)
    out_p = torch.empty(m, dtype=torch.int32, device=dev) \
        if track_pos else None
    if m == 0:
        return out_v, out_p
    offsets = torch.tensor(plan.offsets or (0,), dtype=torch.int32,
                           device=dev)
    padded = _query.int_array(plan.padded_lens)
    lib = _build.load("rmq_fused", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.rmq_fused_query(
            _build.dtype_code(h.base.dtype), int(track_pos), plan.capacity,
            plan.c, plan.num_levels, ctypes.cast(padded, ctypes.c_void_p),
            _build.ptr(offsets), _build.ptr(h.base), _build.ptr(h.upper),
            _build.ptr(h.upper_pos if track_pos else None),
            _build.ptr(ls), _build.ptr(rs), m, _build.ptr(out_v),
            _build.ptr(out_p), _build.stream_of(dev))
    _build.check(lib, rc, "rmq_fused")
    LAUNCHES.hit()
    return out_v, out_p


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
    profiling.record_launch(
        "rmq_fused",
        lowering="cuda" if h.base.is_cuda else "eager",
        queries=int(ls.numel()),
        levels=h.plan.num_levels,
        track_pos=bool(track_pos),
        operand_bytes=profiling.operand_bytes(
            h.base, h.upper, h.upper_pos if track_pos else None, ls, rs),
    )
    if h.base.is_cuda:
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
