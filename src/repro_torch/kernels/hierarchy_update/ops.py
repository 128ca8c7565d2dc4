"""Hierarchy updates through the sorted-run re-reduction kernel (B6).

The counterpart of the reference's ``update_hierarchy_pallas`` /
``append_hierarchy_pallas`` (``repro/kernels/hierarchy_update/ops.py``).
An update sorts its batch once (:func:`repro_torch.streaming.updates.
sort_batch`: a stable sort, out-of-range indices set to ``capacity`` at
the end) and hands it, at its static size, to one C call that launches
``csrc/hierarchy_update.cu`` once per upper level on PyTorch's current
stream: the level-1 launch writes the batch into the successor's level 0
(last wins) and every launch re-reduces the chunks the batch touches,
straight into the successor's ``upper`` / ``upper_pos``.  An append
passes its ``arange`` indices the same way.  Nothing on this path waits
for the card: no dedupe, no compaction, no read-back.  Every level records
``record_launch("hierarchy_update", level=..., touched=...)`` with the
batch's static size, as the reference records its static ``jnp.unique``
size, once its launch has gone out.  A CPU hierarchy takes the plain
update (:func:`repro_torch.streaming.updates.update_hierarchy` /
``append_hierarchy``) and records the same launches; a CUDA hierarchy
launches or raises.

Compact layouts take the plain update on every device, as the
reference's ``_jax_path_only`` sends them to its jnp update: B6 writes
absolute positions, not packed fields, and has no exact level-0
re-compare for bf16 summaries (:func:`plain_only`).  That route dedupes
with ``torch.unique``, which waits for the card, so the sync-free
property above holds for the classic layout only.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.plan import HierarchyPlan
from repro_torch.core.protocol import check_capacity_limit, kernel_index_extent
from repro_torch.kernels import _build, profiling
from repro_torch.streaming import updates as U

__all__ = [
    "LAUNCHES",
    "append_hierarchy_cuda",
    "plain_only",
    "repair_level_plain",
    "update_hierarchy_cuda",
    "update_levels_cuda",
]

LAUNCHES = profiling.KernelCounter("hierarchy_update")

_SIGNATURES = {
    "rmq_update_levels": (
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ),
}

repair_level_plain = U.repair_level_plain


def _record(plan: HierarchyPlan, level: int, touched: int, track: bool,
            item: int, lowering: str) -> None:
    profiling.record_launch(
        "hierarchy_update", lowering=lowering, level=level, touched=touched,
        with_positions=track,
        operand_bytes=touched * plan.c * (item + (4 if track else 0)))


def update_levels_cuda(plan: HierarchyPlan, base, upper, upper_pos, keys,
                       vals) -> None:
    """Write the sorted batch ``keys`` / ``vals`` (:func:`U.sort_batch`)
    into ``base`` and re-reduce every upper level in place: one host call,
    ``L - 1`` launches."""
    levels = plan.num_levels
    if levels < 2 or keys.numel() == 0:
        return
    _build.require_cuda("hierarchy_update", base, upper, upper_pos, keys,
                        vals)
    if keys.dtype != torch.int32 or vals.dtype != base.dtype:
        raise TypeError("hierarchy_update: keys must be int32 and values "
                        "of the base's dtype")
    if upper_pos is not None and upper_pos.dtype != torch.int32:
        raise TypeError("hierarchy_update: positions must be int32")
    lib = _build.load("hierarchy_update", _SIGNATURES)
    offsets = (ctypes.c_longlong * (levels - 1))(*plan.offsets)
    src_lens = (ctypes.c_longlong * (levels - 1))(
        plan.capacity, *plan.padded_lens[:-1])
    launched = ctypes.c_int(0)
    with torch.cuda.device(base.device):
        rc = lib.rmq_update_levels(
            _build.dtype_code(base.dtype), int(upper_pos is not None),
            _build.ptr(base), plan.capacity, _build.ptr(upper),
            _build.ptr(upper_pos), offsets, src_lens, levels,
            plan.c.bit_length() - 1, _build.ptr(keys), _build.ptr(vals),
            keys.numel(), ctypes.byref(launched),
            _build.stream_of(base.device))
    for level in range(1, launched.value + 1):
        LAUNCHES.hit()
        _record(plan, level, keys.numel(), upper_pos is not None,
                base.element_size(), "cuda")
    _build.check(lib, rc, "hierarchy_update")


def _launch(h: Hierarchy, keys, vals) -> Hierarchy:
    if h.plan.num_levels < 2:  # no upper level: no launch
        return dataclasses.replace(h, base=U.scatter_base(h.base, keys,
                                                          vals))
    base = h.base.clone()
    upper = h.upper.clone()
    upper_pos = None if h.upper_pos is None else h.upper_pos.clone()
    update_levels_cuda(h.plan, base, upper, upper_pos, keys, vals)
    return Hierarchy(base=base, upper=upper, upper_pos=upper_pos,
                     plan=h.plan)


def _plain(h: Hierarchy, out: Hierarchy, size: int) -> Hierarchy:
    """The plain successor ``out`` of a CPU hierarchy, with the launches
    the card would have made recorded (none for an empty batch)."""
    for level in range(1, h.plan.num_levels if size else 1):
        _record(h.plan, level, size, h.upper_pos is not None,
                h.base.element_size(), "eager")
    return out


def plain_only(h: Hierarchy) -> bool:
    """Layouts B6 cannot re-reduce: packed positions (it writes absolute
    ones) and bf16 summaries (they need the exact re-compare)."""
    return bool(h.plan.packed_pos) or h.quantized


def _check(h: Hierarchy) -> None:
    if h.base.is_cuda:
        check_capacity_limit(kernel_index_extent(h.plan))


def update_hierarchy_cuda(h: Hierarchy, idxs, vals) -> Hierarchy:
    """Batched point updates (last wins), one launch per upper level."""
    _check(h)
    if plain_only(h):
        return U.update_hierarchy(h, idxs, vals)
    if not h.base.is_cuda:
        return _plain(h, U.update_hierarchy(h, idxs, vals),
                      torch.as_tensor(idxs).numel())
    return _launch(h, *U.sort_batch(h, idxs, vals))


def append_hierarchy_cuda(h: Hierarchy, vals, start: int) -> Hierarchy:
    """Append ``vals`` at ``start``, one launch per upper level."""
    _check(h)
    if plain_only(h):
        return U.append_hierarchy(h, vals, start)
    vals = torch.as_tensor(vals, device=h.device).to(h.base.dtype)
    vals = vals.reshape(-1)
    if not h.base.is_cuda:
        return _plain(h, U.append_hierarchy(h, vals, start), vals.numel())
    keys = torch.arange(int(start), int(start) + vals.shape[0],
                        dtype=U.key_dtype(h.plan), device=h.device)
    return _launch(h, keys, vals)
