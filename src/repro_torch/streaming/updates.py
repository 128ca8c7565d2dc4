"""Incremental maintenance of the minima hierarchy, plain PyTorch.

The port of ``repro.streaming.updates``.  A point update at index ``i``
invalidates one ``c``-wide chunk per upper level (chunk ``i // c**k`` at
level ``k``), so a batch of ``B`` updates re-reduces at most
``min(B, m_k)`` chunks per level instead of rebuilding.

Per batch:

1. :func:`scatter_base` writes the new values into a copy of level 0:
   the last of duplicate indices wins, and indices outside
   ``[0, capacity)`` are dropped (negative ones too: they never wrap);
2. for each upper level the touched chunk ids are deduped
   (:func:`touched_chunk_ids`), each touched chunk is re-reduced from the
   level below (:func:`repair_level_plain`: min and leftmost position;
   level 1 synthesizes positions, ``PAD_POS`` past ``capacity``) and
   written into its slot of ``upper`` / ``upper_pos``;
3. the chunk ids are divided by ``c`` and the walk ascends.

The result equals a fresh build of the mutated array, bit for bit.  The
predecessor is never written: the successor gets its own ``base``,
``upper`` and ``upper_pos``, so an index that was updated still answers
for its own data.  The CUDA realization of step 2 is
``repro_torch.kernels.hierarchy_update`` (one launch per upper level).
Not ported: the packed and bf16 planes (ROADMAP A3).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.constants import PAD_POS
from repro_torch.core.hierarchy import Hierarchy, check_compact_build
from repro_torch.core.plan import HierarchyPlan

__all__ = [
    "append_hierarchy",
    "level_source",
    "propagate_updates",
    "repair_level_plain",
    "repair_plain",
    "scatter_base",
    "touched_chunk_ids",
    "update_hierarchy",
]

# repair(plan, base, upper, upper_pos, level, ids): re-reduce chunks
# ``ids`` of ``level`` into ``upper`` / ``upper_pos`` in place.
Repair = Callable[..., None]


def scatter_base(base: torch.Tensor, idxs: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """A copy of ``base`` with ``vals`` written at ``idxs``.

    Duplicate indices resolve last-wins (the latest batch entry, as if
    applied one by one): a stable sort groups each index's entries in
    batch order and only the last of each group is written, so the
    scatter never sees a duplicate (on the card a duplicate write has no
    defined winner).  Indices outside ``[0, len(base))`` are dropped.
    """
    cap = base.shape[0]
    idxs = idxs.to(device=base.device, dtype=torch.int64).reshape(-1)
    vals = vals.to(device=base.device, dtype=base.dtype).reshape(-1)
    out = base.clone()
    valid = (idxs >= 0) & (idxs < cap)
    vi, vv = idxs[valid], vals[valid]
    if vi.numel() == 0:
        return out
    si, perm = torch.sort(vi, stable=True)
    last = torch.ones_like(si, dtype=torch.bool)
    last[:-1] = si[1:] != si[:-1]
    out[si[last]] = vv[perm[last]]
    return out


def touched_chunk_ids(ids: torch.Tensor, num_chunks: int) -> torch.Tensor:
    """The distinct chunk ids of a level, ascending (int64).

    A batch at least as large as the level may touch every chunk, so it
    re-reduces all of them (a superset: re-reducing an untouched chunk
    rewrites the same summary) and skips the sort, as the reference does.
    """
    if ids.numel() >= num_chunks:
        return torch.arange(num_chunks, dtype=torch.int64, device=ids.device)
    return torch.unique(ids)


def level_source(plan: HierarchyPlan, base: torch.Tensor,
                 upper: torch.Tensor, upper_pos: Optional[torch.Tensor],
                 level: int):
    """``(values, positions or None)`` of the level that feeds upper
    ``level`` at its stored length; positions ``None`` for level 0, whose
    positions are the indices themselves."""
    if level == 1:
        return base, None
    off, padded = plan.level_slice(level - 1)
    pos = None if upper_pos is None else upper_pos[off:off + padded]
    return upper[off:off + padded], pos


def repair_level_plain(
    src_v: torch.Tensor,
    src_p: Optional[torch.Tensor],
    ids: torch.Tensor,
    c: int,
    track: bool,
    pos_dtype: torch.dtype = torch.int32,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Min and leftmost position of chunks ``ids`` of a source level.

    ``src_p=None`` means level 0: entries past its end read +inf and
    their positions are the indices, ``PAD_POS`` past the end.
    """
    length = src_v.shape[0]
    gather = ids.to(torch.int64)[:, None] * c + torch.arange(
        c, device=src_v.device)
    inside = gather < length
    safe = torch.where(inside, gather, 0)
    v = torch.where(inside, src_v[safe], float("inf"))
    am = torch.argmin(v, dim=1, keepdim=True)  # first occurrence: leftmost
    nv = v.gather(1, am)[:, 0]
    if not track:
        return nv, None
    if src_p is None:
        p = torch.where(inside, gather, PAD_POS)
    else:
        p = src_p[safe]
    return nv, p.gather(1, am)[:, 0].to(pos_dtype)


def repair_plain(plan: HierarchyPlan, base, upper, upper_pos, level: int,
                 ids: torch.Tensor) -> None:
    """Step 2 for one level on the plain path, written in place."""
    src_v, src_p = level_source(plan, base, upper, upper_pos, level)
    track = upper_pos is not None
    nv, np_ = repair_level_plain(
        src_v, src_p, ids, plan.c, track,
        upper_pos.dtype if track else torch.int32)
    off = plan.offsets[level - 1]
    upper[off + ids] = nv
    if track:
        upper_pos[off + ids] = np_


def propagate_updates(
    plan: HierarchyPlan,
    base: torch.Tensor,
    upper: torch.Tensor,
    upper_pos: Optional[torch.Tensor],
    idxs: torch.Tensor,
    repair: Repair = repair_plain,
) -> None:
    """Re-reduce every chunk on the root-to-leaf paths of ``idxs``, in
    place on ``upper`` / ``upper_pos``; ``base`` holds the new values.

    Indices outside ``[0, capacity)`` were dropped by the base scatter;
    their chunk id becomes 0, whose re-reduction of unchanged data
    rewrites the same summary.
    """
    check_compact_build(plan)
    idxs = idxs.to(device=base.device, dtype=torch.int64).reshape(-1)
    idxs = torch.where((idxs >= 0) & (idxs < plan.capacity), idxs, 0)
    ids = idxs // plan.c
    for level in range(1, plan.num_levels):
        ids = touched_chunk_ids(ids, plan.level_lens[level])
        repair(plan, base, upper, upper_pos, level, ids)
        ids = ids // plan.c


def _successor(h: Hierarchy, base: torch.Tensor, idxs: torch.Tensor,
               repair: Repair) -> Hierarchy:
    upper = h.upper.clone()
    upper_pos = None if h.upper_pos is None else h.upper_pos.clone()
    propagate_updates(h.plan, base, upper, upper_pos, idxs, repair)
    return Hierarchy(base=base, upper=upper, upper_pos=upper_pos,
                     plan=h.plan)


def update_hierarchy(h: Hierarchy, idxs, vals,
                     repair: Repair = repair_plain) -> Hierarchy:
    """The successor of ``h`` after ``a[idxs] = vals`` (last wins)."""
    idxs = torch.as_tensor(idxs, device=h.device)
    vals = torch.as_tensor(vals, device=h.device)
    base = scatter_base(h.base, idxs, vals)
    return _successor(h, base, idxs, repair)


def append_hierarchy(h: Hierarchy, vals, start: int,
                     repair: Repair = repair_plain) -> Hierarchy:
    """The successor of ``h`` with ``vals`` written at ``[start,
    start + B)``; the caller guarantees ``start + B <= capacity``."""
    vals = torch.as_tensor(vals, device=h.device).to(h.base.dtype)
    vals = vals.reshape(-1)
    start = int(start)
    base = h.base.clone()
    base[start:start + vals.shape[0]] = vals
    idxs = start + torch.arange(vals.shape[0], device=h.device)
    return _successor(h, base, idxs, repair)
