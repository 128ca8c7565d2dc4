"""Fused build: a full ``Hierarchy`` in ONE launch.

The counterpart of the reference's ``build_hierarchy_fused``
(``repro/kernels/hierarchy_fused/ops.py``).  On a CUDA tensor every upper
level comes out of one launch of ``csrc/hierarchy_fused.cu``; a
single-level plan (``capacity <= c * t``) has no upper level and
launches nothing.  On a CPU tensor the plain version,
:func:`fused_build_plain`, computes the same two planes.

The reference refuses plans whose ``upper`` buffer passes an 8 MiB VMEM
budget; the card keeps ``upper`` in device memory, so there is no such
limit here.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.constants import PAD_POS
from repro_torch.core.hierarchy import (
    Hierarchy,
    build_upper_planes,
    check_build_input,
    pad_to,
    pos_dtype_for,
)
from repro_torch.core.plan import HierarchyPlan
from repro_torch.core.protocol import check_capacity_limit, kernel_index_extent
from repro_torch.kernels import _build, profiling

__all__ = [
    "LAUNCHES",
    "build_hierarchy_fused",
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
        ctypes.c_void_p, ctypes.c_void_p,
    ),
}

fused_build_plain = build_upper_planes


def fused_build_cuda(
    base: torch.Tensor, plan: HierarchyPlan, with_positions: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(upper, upper_pos)`` of a capacity-length ``base``, one launch."""
    _build.require_cuda("hierarchy_fused", base)
    if plan.num_levels > _MAX_LEVELS:
        raise ValueError(f"hierarchy_fused: at most {_MAX_LEVELS} levels")
    if with_positions:
        check_capacity_limit(kernel_index_extent(plan))
    dev = base.device
    upper = base.new_full((plan.upper_size,), float("inf"))
    upper_pos = (
        torch.full((plan.upper_size,), PAD_POS, dtype=torch.int32,
                   device=dev)
        if with_positions else None
    )
    done = torch.zeros(1, dtype=torch.int32, device=dev)
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
            _build.stream_of(dev))
    _build.check(lib, rc, "hierarchy_fused")
    LAUNCHES.hit()
    return upper, upper_pos


def build_hierarchy_fused(
    x: torch.Tensor, plan: HierarchyPlan, with_positions: bool = False
) -> Hierarchy:
    """Single-launch build (paper §4.1, all levels in one pass)."""
    check_build_input(x, plan)
    if x.is_cuda and with_positions and plan.num_levels > 1:
        check_capacity_limit(kernel_index_extent(plan))
    base = pad_to(x, plan.capacity, float("inf"))
    if plan.num_levels == 1:
        upper = base.new_full((0,), float("inf"))
        upper_pos = (
            torch.zeros(0, dtype=pos_dtype_for(plan.capacity),
                        device=base.device)
            if with_positions else None
        )
        return Hierarchy(base=base, upper=upper, upper_pos=upper_pos,
                         plan=plan)
    profiling.record_launch(
        "hierarchy_fused",
        lowering="cuda" if base.is_cuda else "eager",
        levels=plan.num_levels,
        with_positions=bool(with_positions),
        operand_bytes=profiling.operand_bytes(base),
    )
    if base.is_cuda:
        upper, upper_pos = fused_build_cuda(base, plan, with_positions)
    else:
        upper, upper_pos = fused_build_plain(base, plan, with_positions)
    return Hierarchy(base=base, upper=upper, upper_pos=upper_pos, plan=plan)
