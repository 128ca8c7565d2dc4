"""Operand preparation shared by the query wrappers (B2, B4, B7), and the
one launch sequence of the two kernels that take the offsets table on
the device (B2 ``rmq_fused_query``, B7 ``rmq_bulk_query``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.protocol import check_capacity_limit, kernel_index_extent
from repro_torch.kernels import _build

__all__ = ["MAX_LEVELS", "STAGE_LIMIT", "TABLE_WALK_SIGNATURE", "int_array",
           "kernel_bounds", "stage_top", "table_walk"]

MAX_LEVELS = 32
# Shared memory a block may spend on its copy of the top level.  The
# largest top at the default geometry (c*t = 8192 entries, float32 values
# and int32 positions) takes 64 KB; float64 takes 96 KB.
STAGE_LIMIT = 112 * 1024


def kernel_bounds(h: Hierarchy, ls, rs, what: str):
    """``(ls, rs)`` as contiguous int32 tensors on the hierarchy's card,
    after the checks every query launch needs."""
    plan = h.plan
    check_capacity_limit(kernel_index_extent(plan))
    if plan.num_levels > MAX_LEVELS:
        raise ValueError(f"{what}: at most {MAX_LEVELS} levels")
    dev = h.base.device
    ls = torch.as_tensor(ls, device=dev).to(torch.int32).reshape(-1)
    rs = torch.as_tensor(rs, device=dev).to(torch.int32).reshape(-1)
    if ls.shape != rs.shape:
        raise ValueError(f"{what}: bounds must match in shape")
    _build.require_cuda(what, h.base, h.upper, h.upper_pos, ls, rs)
    if h.upper_pos is not None and h.upper_pos.dtype != torch.int32:
        raise TypeError(f"{what}: positions must be int32")
    return ls.contiguous(), rs.contiguous()


def stage_top(h: Hierarchy, track: bool) -> int:
    """1 if every block should copy the top level into shared memory."""
    plan = h.plan
    pos = 4 if (track and plan.num_levels > 1) else 0
    return int(plan.top_padded_len * (h.base.element_size() + pos)
               <= STAGE_LIMIT)


def int_array(values) -> ctypes.Array:
    values = list(values) or [0]
    return (ctypes.c_int * len(values))(*values)


# (dtype, track, capacity, c, levels, padded_lens, stage_top,
#  offsets_table, base, upper, upper_pos, ls, rs, m, out_v, out_p, stream)
TABLE_WALK_SIGNATURE = (
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
)


def table_walk(source: str, symbol: str, counter, h: Hierarchy, ls, rs,
               track_pos: bool):
    """One launch of ``symbol`` in ``csrc/<source>.cu``: ``(values,
    positions or None)`` for the batch."""
    ls, rs = kernel_bounds(h, ls, rs, source)
    plan, dev = h.plan, h.base.device
    m = ls.numel()
    out_v = torch.empty(m, dtype=h.base.dtype, device=dev)
    out_p = torch.empty(m, dtype=torch.int32, device=dev) \
        if track_pos else None
    if m == 0:
        return out_v, out_p
    offsets = torch.tensor(plan.offsets or (0,), dtype=torch.int32,
                           device=dev)
    padded = int_array(plan.padded_lens)
    lib = _build.load(source, {symbol: TABLE_WALK_SIGNATURE})
    with torch.cuda.device(dev):
        rc = getattr(lib, symbol)(
            _build.dtype_code(h.base.dtype), int(track_pos), plan.capacity,
            plan.c, plan.num_levels, ctypes.cast(padded, ctypes.c_void_p),
            stage_top(h, track_pos), _build.ptr(offsets),
            _build.ptr(h.base), _build.ptr(h.upper),
            _build.ptr(h.upper_pos if track_pos else None),
            _build.ptr(ls), _build.ptr(rs), m, _build.ptr(out_v),
            _build.ptr(out_p), _build.stream_of(dev))
    _build.check(lib, rc, source)
    counter.hit()
    return out_v, out_p
