"""Operand preparation shared by the query wrappers (B2, B4, B7), and the
launch sequence of B2 ``rmq_fused_query`` and B7 ``rmq_bulk_query``, which
share a C signature.  The kernels decide their top stage themselves
(``csrc/rmq_walk_hopper.cuh``).

The kernels read the classic planes: a packed position plane is
unpacked to the absolute int32 plane before a launch that reads
positions (:func:`launch_planes`), once a call, as the reference unpacks
inside each launch's program."""

from __future__ import annotations

import ctypes
import functools

import dataclasses

import torch

from repro_torch.core import bitpack
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.protocol import check_capacity_limit, kernel_index_extent
from repro_torch.kernels import _build

__all__ = ["MAX_LEVELS", "TABLE_WALK_SIGNATURE", "int_array",
           "kernel_bounds", "launch_planes", "offsets_table",
           "table_walk"]

MAX_LEVELS = 32


def launch_planes(h: Hierarchy, track_pos: bool) -> Hierarchy:
    """The planes a launch reads: the absolute position plane (a packed
    plane unpacked) where it tracks positions, none where it does not.
    Refuses bf16 summaries (:attr:`Hierarchy.quantized`): the query
    kernels compare summaries as they are, so such an index is answered
    by the plain exact-recovery walk (B2, B4) or refused (B7), as in the
    reference."""
    if h.quantized:
        raise ValueError(
            "the query kernels read float32/float64 summaries; an index "
            "with bf16 summaries is answered by the exact-recovery walk")
    pos = (bitpack.resolve_positions(h.upper_pos, h.plan) if track_pos
           else None)
    return dataclasses.replace(h, upper_pos=pos)


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


@functools.lru_cache(maxsize=64)
def offsets_table(offsets: tuple, device: torch.device) -> torch.Tensor:
    """A plan's level offsets as int32 on ``device``, made once: copying
    them to the card at every launch would wait for the card each time
    (a blocking copy), so a batch cut into buckets would leave it idle
    between its launches."""
    return torch.tensor(offsets or (0,), dtype=torch.int32, device=device)


def int_array(values) -> ctypes.Array:
    values = list(values) or [0]
    return (ctypes.c_int * len(values))(*values)


# (dtype, track, capacity, c, levels, padded_lens, offsets_table, base,
#  upper, upper_pos, ls, rs, m, out_v, out_p, stream)
TABLE_WALK_SIGNATURE = (
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
)


def table_walk(source: str, symbol: str, counter, h: Hierarchy, ls, rs,
               track_pos: bool):
    """One launch of ``symbol`` in ``csrc/<source>.cu``: ``(values,
    positions or None)`` for the batch."""
    h = launch_planes(h, track_pos)
    ls, rs = kernel_bounds(h, ls, rs, source)
    plan, dev = h.plan, h.base.device
    m = ls.numel()
    out_v = torch.empty(m, dtype=h.base.dtype, device=dev)
    out_p = torch.empty(m, dtype=torch.int32, device=dev) \
        if track_pos else None
    if m == 0:
        return out_v, out_p
    offsets = offsets_table(tuple(plan.offsets), dev)
    padded = int_array(plan.padded_lens)
    lib = _build.load(source, {symbol: TABLE_WALK_SIGNATURE})
    with torch.cuda.device(dev):
        rc = getattr(lib, symbol)(
            _build.dtype_code(h.base.dtype), int(track_pos), plan.capacity,
            plan.c, plan.num_levels, ctypes.cast(padded, ctypes.c_void_p),
            _build.ptr(offsets), _build.ptr(h.base), _build.ptr(h.upper),
            _build.ptr(h.upper_pos if track_pos else None),
            _build.ptr(ls), _build.ptr(rs), m, _build.ptr(out_v),
            _build.ptr(out_p), _build.stream_of(dev))
    _build.check(lib, rc, source)
    counter.hit()
    return out_v, out_p
