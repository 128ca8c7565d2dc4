"""Fused build: a full ``Hierarchy`` in ONE launch.

The counterpart of the reference's ``build_hierarchy_fused``
(``repro/kernels/hierarchy_fused/ops.py``).  On a CUDA tensor every upper
level comes out of one launch of ``csrc/hierarchy_fused.cu``; a
single-level plan (``capacity <= c * t``) has no upper level and
launches nothing.  On a CPU tensor the plain version,
:func:`fused_build_plain`, computes the same two planes.

The launch builds the classic planes; a compact plan's packed words and
bf16 summaries come from :func:`repro_torch.core.hierarchy.finalize_compact`
after it.  The reference refuses plans whose ``upper`` buffer passes an
8 MiB VMEM budget; the card keeps ``upper`` in device memory, so there
is no such limit here.

:func:`build_hierarchy_streamed` is the out-of-core build: the input
arrives in fixed-size slabs (a callable, a numpy array or memmap, or a
tensor), each slab is reduced to its level-1 entries by one launch on a
two-level segment plan, and levels 2 and up come from the plain
``reduce_level``, so the input never has to exist as one array before
it reaches the card.  Unlike the reference, which concatenates its
parts, the slabs are written into one preallocated capacity-length
``base`` on the device, so the peak holds one copy of the input; the
hierarchy is the same.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.constants import PAD_POS
from repro_torch.core.hierarchy import (
    Hierarchy,
    build_upper_planes,
    check_build_input,
    check_compact_build,
    finalize_compact,
    pad_to,
    pos_dtype_for,
    reduce_upper_levels,
)
from repro_torch.core.plan import HierarchyPlan, make_plan
from repro_torch.core.protocol import (
    check_capacity_limit,
    coerce_values,
    kernel_index_extent,
)
from repro_torch.kernels import _build, profiling

__all__ = [
    "LAUNCHES",
    "build_hierarchy_fused",
    "build_hierarchy_streamed",
    "fused_build_cuda",
    "fused_build_plain",
]

LAUNCHES = profiling.KernelCounter("hierarchy_fused")

# Level-1 entries per block tile: at least 256, and whole chunks of level
# 1 so that the tile also yields level 2.  The tile stays in shared
# memory while it does (twice over where the kernel double-buffers it),
# unless one copy passes _TILE_SMEM_LIMIT.
_MIN_TILE1 = 256
_TILE_SMEM_LIMIT = 96 * 1024
_MAX_LEVELS = 64

_SIGNATURES = {
    "rmq_fused_build": (
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p,
    ),
}
_MAX_ROWS = 65535  # the launch grid's y dimension

fused_build_plain = build_upper_planes


def fused_build_cuda(
    base: torch.Tensor, plan: HierarchyPlan, with_positions: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(upper, upper_pos)`` of a capacity-length ``base``, one launch.

    A ``(rows, capacity)`` ``base`` is a batch of builds in the same one
    launch (the grid's second dimension): the planes come back with the
    same leading row axis, row ``i`` equal to the build of ``base[i]``.
    """
    _build.require_cuda("hierarchy_fused", base)
    if plan.num_levels > _MAX_LEVELS:
        raise ValueError(f"hierarchy_fused: at most {_MAX_LEVELS} levels")
    if base.ndim not in (1, 2) or base.shape[-1] != plan.capacity:
        raise ValueError(
            f"hierarchy_fused: base must be ({plan.capacity},) or (rows, "
            f"{plan.capacity}), got {tuple(base.shape)}")
    rows = base.shape[0] if base.ndim == 2 else 1
    if not 1 <= rows <= _MAX_ROWS:
        raise ValueError(
            f"hierarchy_fused: 1 to {_MAX_ROWS} rows a launch, got {rows}")
    if with_positions:
        check_capacity_limit(kernel_index_extent(plan))
    base = base.contiguous()
    dev = base.device
    lead = tuple(base.shape[:-1])
    upper = base.new_full(lead + (plan.upper_size,), float("inf"))
    upper_pos = (
        torch.full(lead + (plan.upper_size,), PAD_POS, dtype=torch.int32,
                   device=dev)
        if with_positions else None
    )
    done = torch.zeros(rows, dtype=torch.int32, device=dev)
    tile1 = max(plan.c, _MIN_TILE1)
    tile_bytes = tile1 * (base.element_size() + (4 if with_positions else 0))
    level_lens = (ctypes.c_longlong * plan.num_levels)(*plan.level_lens)
    offsets = (ctypes.c_longlong * plan.num_upper_levels)(*plan.offsets)
    lib = _build.load("hierarchy_fused", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.rmq_fused_build(
            _build.dtype_code(base.dtype), int(with_positions),
            _build.ptr(base), plan.capacity, plan.c, plan.num_levels,
            ctypes.cast(level_lens, ctypes.c_void_p),
            ctypes.cast(offsets, ctypes.c_void_p),
            tile1, int(tile_bytes <= _TILE_SMEM_LIMIT),
            _build.ptr(upper), _build.ptr(upper_pos), _build.ptr(done),
            rows, plan.capacity, plan.upper_size, _build.stream_of(dev))
    _build.check(lib, rc, "hierarchy_fused")
    LAUNCHES.hit()
    return upper, upper_pos


def build_hierarchy_fused(
    x: torch.Tensor, plan: HierarchyPlan, with_positions: bool = False
) -> Hierarchy:
    """Single-launch build (paper §4.1, all levels in one pass).

    A ``(rows, n)`` ``x`` is a batch of builds (what
    :func:`repro_torch.core.hierarchy.build_many` passes): every plane
    comes back with a leading row axis, row ``i`` bit-identical to the
    build of ``x[i]``.  On a CUDA tensor the rows share ONE launch (the
    kernel's row axis); on a CPU tensor :func:`fused_build_plain` runs
    row by row.  Either way it records one launch.  A compact plan's rows
    go through :func:`finalize_compact` one by one.
    """
    check_build_input(x[0] if x.ndim == 2 else x, plan, with_positions)
    if x.is_cuda and with_positions and plan.num_levels > 1:
        check_capacity_limit(kernel_index_extent(plan))
    base = pad_to(x, plan.capacity, float("inf"))
    lead = tuple(base.shape[:-1])
    if plan.num_levels == 1:
        upper = base.new_full(lead + (0,), float("inf"))
        upper_pos = (
            torch.zeros(lead + (0,), dtype=pos_dtype_for(plan.capacity),
                        device=base.device)
            if with_positions else None
        )
        return _finalize(Hierarchy(
            base=base, upper=upper, upper_pos=upper_pos, plan=plan))
    profiling.record_launch(
        "hierarchy_fused",
        lowering="cuda" if base.is_cuda else "eager",
        levels=plan.num_levels,
        with_positions=bool(with_positions),
        rows=lead[0] if lead else 1,
        operand_bytes=profiling.operand_bytes(base),
    )
    if base.is_cuda:
        upper, upper_pos = fused_build_cuda(base, plan, with_positions)
    elif lead:
        planes = [fused_build_plain(row, plan, with_positions)
                  for row in base]
        upper = _stack_rows([u for u, _ in planes])
        upper_pos = _stack_rows([p for _, p in planes])
    else:
        upper, upper_pos = fused_build_plain(base, plan, with_positions)
    return _finalize(
        Hierarchy(base=base, upper=upper, upper_pos=upper_pos, plan=plan))


def _stack_rows(planes) -> Optional[torch.Tensor]:
    return None if planes[0] is None else torch.stack(planes)


def _finalize(h: Hierarchy) -> Hierarchy:
    """:func:`finalize_compact`, row by row where ``h`` has a row axis
    and a compact plan (a classic plan leaves the planes as they are)."""
    plan = h.plan
    if h.base.ndim == 1 or not (plan.packed_pos
                                or plan.summary_dtype == "bfloat16"):
        return finalize_compact(h)
    done = [finalize_compact(Hierarchy(
        base=h.base[i], upper=h.upper[i],
        upper_pos=None if h.upper_pos is None else h.upper_pos[i],
        plan=plan)) for i in range(h.base.shape[0])]
    return dataclasses.replace(
        h, upper=_stack_rows([r.upper for r in done]),
        upper_pos=_stack_rows([r.upper_pos for r in done]))


# -- the out-of-core build ---------------------------------------------------
def _segment_plan(segment_size: int, c: int) -> HierarchyPlan:
    """A two-level plan over exactly one ``segment_size`` slab:
    ``t = ceil(S / c^2)`` makes level 1 (``S / c`` entries) the top, so
    each launch reduces its slab to chunk minima and stops."""
    t = max(1, -(-segment_size // (c * c)))
    seg = make_plan(segment_size, c=c, t=t)
    if seg.num_levels != 2 or seg.level_lens[1] * c != segment_size:
        raise AssertionError(
            f"segment plan for S={segment_size}, c={c} is not a clean "
            f"two-level reduction (levels={seg.num_levels})")
    return seg


def _read_segment(source, start: int, stop: int,
                  device: torch.device) -> torch.Tensor:
    """One slab ``[start, stop)`` of the input on ``device``: a callable
    ``source(start, stop)`` or a sliceable array (numpy, memmap, tensor)."""
    vals = source(start, stop) if callable(source) else source[start:stop]
    if isinstance(vals, np.ndarray) and not vals.flags.writeable:
        vals = np.array(vals)  # a read-only memmap slab
    return coerce_values(vals, device)


def build_hierarchy_streamed(
    source,
    plan: HierarchyPlan,
    with_positions: bool = False,
    segment_size: Optional[int] = None,
    *,
    device,
) -> Hierarchy:
    """Out-of-core build on ``device`` (required: the input has no
    device of its own to take it from), one slab of ``segment_size``
    elements (a multiple of ``c``, at least ``2c``) at a time.

    Each slab is written into its place in the capacity-length ``base``
    (+inf past ``n``) and reduced by one :func:`build_hierarchy_fused`
    launch on the segment plan; its level-1 entries go straight into
    level 1 of ``upper``, its slab-local int32 positions made global as
    int64 (past 2^31: ``pos_dtype_for(capacity)``) before the slab's
    offset is added.  The result equals ``build_hierarchy(x, plan,
    with_positions)`` bit for bit, compact layouts included.
    """
    c, cap, n = plan.c, plan.capacity, plan.n
    dev = torch.device(device)
    if segment_size is None:
        segment_size = max(min(c * 4096, -(-cap // c) * c), 2 * c)
    if segment_size % c != 0 or segment_size < 2 * c:
        raise ValueError(
            f"segment_size must be a multiple of c={c} and >= {2 * c}, "
            f"got {segment_size}")
    probe = _read_segment(source, 0, min(n, segment_size), dev)
    check_compact_build(plan, with_positions, probe.dtype)
    if plan.num_levels == 1:
        full = probe if probe.shape[0] >= n else _read_segment(
            source, 0, n, dev)
        return build_hierarchy_fused(full, plan, with_positions)
    coord = pos_dtype_for(cap)
    seg_plan = _segment_plan(segment_size, c)
    m_seg = segment_size // c
    l1_off, l1_len = plan.offsets[0], plan.level_lens[1]
    base = torch.empty(cap, dtype=probe.dtype, device=dev)
    upper = base.new_full((plan.upper_size,), float("inf"))
    upper_pos = (torch.full((plan.upper_size,), PAD_POS, dtype=coord,
                            device=dev)
                 if with_positions else None)
    for s0 in range(0, cap, segment_size):
        stop = min(s0 + segment_size, cap)
        live = min(stop, n) - s0
        if s0 == 0:
            base[:live] = probe[:live]
        elif live > 0:
            base[s0:s0 + live] = _read_segment(source, s0, s0 + live, dev)
        base[s0 + max(live, 0):stop] = float("inf")
        # a whole slab is reduced in place; the last, short one from a
        # +inf-padded copy
        seg = pad_to(base[s0:stop], segment_size, float("inf"))
        h_seg = build_hierarchy_fused(seg, seg_plan, with_positions)
        e0 = s0 // c
        k = min(m_seg, l1_len - e0)
        upper[l1_off + e0:l1_off + e0 + k] = h_seg.upper[:k]
        if with_positions:
            upper_pos[l1_off + e0:l1_off + e0 + k] = (
                h_seg.upper_pos[:k].to(coord) + s0)
    # levels 2 and up by the plain build's reduction, from level 1
    l1 = slice(l1_off, l1_off + l1_len)
    reduce_upper_levels(plan, upper, upper_pos, 2, upper[l1],
                        None if upper_pos is None else upper_pos[l1])
    return finalize_compact(
        Hierarchy(base=base, upper=upper, upper_pos=upper_pos, plan=plan))
