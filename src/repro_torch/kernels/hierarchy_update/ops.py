"""Hierarchy updates through the per-level re-reduction kernel (B6).

The counterpart of the reference's ``update_hierarchy_pallas`` /
``append_hierarchy_pallas`` (``repro/kernels/hierarchy_update/ops.py``):
the same last-wins base scatter and per-level chunk dedupe as the plain
path (:mod:`repro_torch.streaming.updates`), with each level's
re-reduction one launch of ``csrc/hierarchy_update.cu``, ``L - 1``
launches per update, each writing straight into its level's slot of the
successor's ``upper`` / ``upper_pos``.  Every level records
``record_launch("hierarchy_update", level=..., touched=...)``, as the
reference does.  On a CPU hierarchy each level takes the plain version,
:func:`repair_level_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.plan import HierarchyPlan
from repro_torch.core.protocol import check_capacity_limit, kernel_index_extent
from repro_torch.kernels import _build, profiling
from repro_torch.streaming import updates as U

__all__ = [
    "LAUNCHES",
    "append_hierarchy_cuda",
    "repair_level",
    "repair_level_plain",
    "update_hierarchy_cuda",
    "update_level_cuda",
]

LAUNCHES = profiling.KernelCounter("hierarchy_update")

_SIGNATURES = {
    "rmq_update_level": (
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ),
}

repair_level_plain = U.repair_level_plain


def update_level_cuda(src_v, src_p, ids, c: int, out_v, out_p) -> None:
    """One launch: re-reduce chunks ``ids`` (deduped) of the source level
    into ``out_v[id]`` (and ``out_p[id]``).  ``src_p=None`` with
    ``out_p`` means level 0, whose positions are the indices."""
    ids = ids.to(torch.int32).contiguous()
    if ids.numel() == 0:
        return
    _build.require_cuda("hierarchy_update", src_v, src_p, ids, out_v, out_p)
    if out_p is not None and out_p.dtype != torch.int32:
        raise TypeError("hierarchy_update: positions must be int32")
    lib = _build.load("hierarchy_update", _SIGNATURES)
    with torch.cuda.device(src_v.device):
        rc = lib.rmq_update_level(
            _build.dtype_code(src_v.dtype), int(out_p is not None),
            _build.ptr(src_v), _build.ptr(src_p), src_v.numel(), c,
            _build.ptr(ids), ids.numel(), _build.ptr(out_v),
            _build.ptr(out_p), _build.stream_of(src_v.device))
    _build.check(lib, rc, "hierarchy_update")
    LAUNCHES.hit()


def repair_level(plan: HierarchyPlan, base, upper, upper_pos, level: int,
                 ids: torch.Tensor) -> None:
    """One level of an update: one launch on the card, the plain version
    on the CPU; both write in place into ``upper`` / ``upper_pos``."""
    src_v, src_p = U.level_source(plan, base, upper, upper_pos, level)
    track = upper_pos is not None
    profiling.record_launch(
        "hierarchy_update",
        lowering="cuda" if base.is_cuda else "eager",
        level=level,
        touched=int(ids.numel()),
        with_positions=track,
        operand_bytes=int(ids.numel()) * plan.c * (
            base.element_size() + (4 if track else 0)),
    )
    if not base.is_cuda:
        U.repair_plain(plan, base, upper, upper_pos, level, ids)
        return
    off, n_k = plan.offsets[level - 1], plan.padded_lens[level - 1]
    update_level_cuda(
        src_v, src_p, ids, plan.c, upper[off:off + n_k],
        upper_pos[off:off + n_k] if track else None)


def _check(h: Hierarchy) -> None:
    if h.base.is_cuda:
        check_capacity_limit(kernel_index_extent(h.plan))


def update_hierarchy_cuda(h: Hierarchy, idxs, vals) -> Hierarchy:
    """Batched point updates (last wins), one launch per upper level."""
    _check(h)
    return U.update_hierarchy(h, idxs, vals, repair=repair_level)


def append_hierarchy_cuda(h: Hierarchy, vals, start: int) -> Hierarchy:
    """Append ``vals`` at ``start``, one launch per upper level."""
    _check(h)
    return U.append_hierarchy(h, vals, start, repair=repair_level)
