"""Per-level build: a full ``Hierarchy`` through one launch per level.

The counterpart of the reference's ``build_hierarchy_pallas``
(``repro/kernels/hierarchy_build/ops.py``): ``L - 1`` launches of
``csrc/hierarchy_build.cu``, each reducing one level straight into its
slot of the preallocated ``upper`` buffer (so no per-level arrays and no
concatenate).  On a CPU tensor each level takes the plain version,
:func:`build_level_plain`.  The launches build the classic planes; a
compact plan's packed words and bf16 summaries come from
:func:`repro_torch.core.hierarchy.finalize_compact` after the last one.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.constants import PAD_POS
from repro_torch.core.hierarchy import (
    Hierarchy,
    check_build_input,
    finalize_compact,
    pad_to,
    pos_dtype_for,
    reduce_level,
)
from repro_torch.core.plan import HierarchyPlan
from repro_torch.core.protocol import check_capacity_limit, kernel_index_extent
from repro_torch.kernels import _build, profiling

__all__ = [
    "LAUNCHES",
    "build_hierarchy_percall",
    "build_level_cuda",
    "build_level_plain",
]

LAUNCHES = profiling.KernelCounter("hierarchy_build")

_SIGNATURES = {
    "rmq_build_level": (
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p,
    ),
}

build_level_plain = reduce_level


def build_level_cuda(
    values: torch.Tensor,
    positions: Optional[torch.Tensor],
    c: int,
    out_v: torch.Tensor,
    out_p: Optional[torch.Tensor],
) -> None:
    """Launch one level: chunk minima of ``values`` into ``out_v`` (and
    leftmost positions into ``out_p``).  ``positions=None`` with ``out_p``
    means level 0, whose positions the kernel takes from the indices."""
    _build.require_cuda("hierarchy_build", values, positions, out_v, out_p)
    if out_p is not None and out_p.dtype != torch.int32:
        raise TypeError("hierarchy_build: positions must be int32")
    lib = _build.load("hierarchy_build", _SIGNATURES)
    with torch.cuda.device(values.device):
        rc = lib.rmq_build_level(
            _build.dtype_code(values.dtype), int(out_p is not None),
            _build.ptr(values), _build.ptr(positions), values.numel(), c,
            _build.ptr(out_v), _build.ptr(out_p), out_v.numel(),
            _build.stream_of(values.device))
    _build.check(lib, rc, "hierarchy_build")
    LAUNCHES.hit()


def build_hierarchy_percall(
    x: torch.Tensor, plan: HierarchyPlan, with_positions: bool = False
) -> Hierarchy:
    """Level-by-level build (paper §4.1, bottom-up), ``L - 1`` launches."""
    check_build_input(x, plan, with_positions)
    on_card = x.is_cuda
    if on_card and with_positions:
        check_capacity_limit(kernel_index_extent(plan))
    base = pad_to(x, plan.capacity, float("inf"))
    pos_dtype = pos_dtype_for(plan.capacity)
    upper = base.new_full((plan.upper_size,), float("inf"))
    upper_pos = (
        torch.full((plan.upper_size,), PAD_POS, dtype=pos_dtype,
                   device=base.device)
        if with_positions else None
    )
    cur_v, cur_p = base, None
    for k in range(1, plan.num_levels):
        off, n_k = plan.offsets[k - 1], plan.level_lens[k]
        out_v = upper[off:off + n_k]
        out_p = upper_pos[off:off + n_k] if with_positions else None
        profiling.record_launch(
            "hierarchy_build",
            lowering="cuda" if on_card else "eager",
            level=k,
            with_positions=bool(with_positions),
            operand_bytes=profiling.operand_bytes(cur_v, cur_p),
        )
        if on_card:
            build_level_cuda(cur_v, cur_p, plan.c, out_v, out_p)
        else:
            v, p = build_level_plain(cur_v, cur_p, plan.c, n_k,
                                     with_positions, pos_dtype)
            out_v.copy_(v)
            if with_positions:
                out_p.copy_(p)
        cur_v, cur_p = out_v, out_p
    return finalize_compact(
        Hierarchy(base=base, upper=upper, upper_pos=upper_pos, plan=plan))
