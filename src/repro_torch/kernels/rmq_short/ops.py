"""Short-span queries answered from level 0 alone (B5).

The counterpart of the reference's ``rmq_short_value_batch_pallas`` /
``rmq_short_index_batch_pallas`` (``repro/kernels/rmq_short/ops.py``).
Contract: every span satisfies ``r // c - l // c <= 1`` (the engine's
planner routes on it; a wider span would miss entries on the plain
path).  The answer never needs the hierarchy, and positions are the
level-0 indices, so ``RMQ_index`` works on value-only builds.

On a CUDA hierarchy one launch of ``csrc/rmq_short.cu`` answers the
batch: the Hopper walk of the other query kernels on level 0 alone, so a
value is the leftmost minimal entry's own bits, as ``rmq_fused`` returns
it.  It reads only ``[l, r]``, so it needs neither the reference's
anchor clamp nor its fallback for ``capacity < 2c``.  On a CPU hierarchy
the plain version, :func:`rmq_short_batch_plain` (``ref.py``, the
reference's two-chunk window scan), answers.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.protocol import check_capacity_limit
from repro_torch.kernels import _build, profiling
from repro_torch.kernels.rmq_short.ref import rmq_short_batch_ref

__all__ = [
    "LAUNCHES",
    "rmq_short_batch",
    "rmq_short_batch_cuda",
    "rmq_short_batch_plain",
    "rmq_short_index_batch",
    "rmq_short_value_batch",
]

LAUNCHES = profiling.KernelCounter("rmq_short")

_SIGNATURES = {
    "rmq_short_query": (
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ),
}

rmq_short_batch_plain = rmq_short_batch_ref


def rmq_short_batch_cuda(
    h: Hierarchy, ls, rs, track_pos: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch: ``(values, positions or None)`` for the batch."""
    plan, dev = h.plan, h.base.device
    check_capacity_limit(plan.capacity)
    ls = torch.as_tensor(ls, device=dev).to(torch.int32).reshape(-1)
    rs = torch.as_tensor(rs, device=dev).to(torch.int32).reshape(-1)
    if ls.shape != rs.shape:
        raise ValueError("rmq_short: bounds must match in shape")
    ls, rs = ls.contiguous(), rs.contiguous()
    _build.require_cuda("rmq_short", h.base, ls, rs)
    m = ls.numel()
    out_v = torch.empty(m, dtype=h.base.dtype, device=dev)
    out_p = torch.empty(m, dtype=torch.int32, device=dev) \
        if track_pos else None
    if m == 0:
        return out_v, out_p
    lib = _build.load("rmq_short", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.rmq_short_query(
            _build.dtype_code(h.base.dtype), int(track_pos), plan.capacity,
            plan.c, _build.ptr(h.base), _build.ptr(ls), _build.ptr(rs), m,
            _build.ptr(out_v), _build.ptr(out_p), _build.stream_of(dev))
    _build.check(lib, rc, "rmq_short")
    LAUNCHES.hit()
    return out_v, out_p


def rmq_short_batch(
    h: Hierarchy, ls, rs, track_pos: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(values, positions)`` of a batch of short spans, one launch;
    ``positions`` is ``None`` unless ``track_pos``."""
    ls = torch.as_tensor(ls, device=h.base.device)
    rs = torch.as_tensor(rs, device=h.base.device)
    profiling.record_launch(
        "rmq_short",
        lowering="cuda" if h.base.is_cuda else "eager",
        queries=int(ls.numel()),
        track_pos=bool(track_pos),
        operand_bytes=profiling.operand_bytes(h.base, ls, rs),
    )
    if h.base.is_cuda:
        vals, pos = rmq_short_batch_cuda(h, ls, rs, track_pos)
    else:
        vals, pos = rmq_short_batch_plain(
            h.base, ls, rs, h.plan.c, h.plan.capacity, track_pos)
    return vals.reshape(ls.shape), (
        pos.reshape(ls.shape) if track_pos else None)


def rmq_short_value_batch(h: Hierarchy, ls, rs) -> torch.Tensor:
    """Short-span ``RMQ_value``."""
    return rmq_short_batch(h, ls, rs, track_pos=False)[0]


def rmq_short_index_batch(h: Hierarchy, ls, rs) -> torch.Tensor:
    """Short-span ``RMQ_index`` (leftmost), also on value-only builds."""
    return rmq_short_batch(h, ls, rs, track_pos=True)[1]
