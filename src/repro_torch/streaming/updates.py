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
   level below (:func:`repair_plain`: min and leftmost position; level
   1 synthesizes positions, ``PAD_POS`` past ``capacity``) and written
   into its slot of ``upper`` / ``upper_pos``;
3. the chunk ids are divided by ``c`` and the walk ascends.

The result equals a fresh build of the mutated array, bit for bit.  The
predecessor is never written: the successor gets its own ``base``,
``upper`` and ``upper_pos``, so an index that was updated still answers
for its own data.  Summaries follow the plain build's rule (the leftmost
least entry's bits, NaN least: ``torch.argmin``).

The CUDA realization (``repro_torch.kernels.hierarchy_update``, one
launch per upper level) never dedupes: :func:`sort_batch` sorts the
batch once at its static size, the level-1 launch writes each run of
equal indices' last entry into level 0, and level k re-reduces the chunk
of every entry whose chunk differs from its predecessor's.  The
scatter of step 1 waits for nothing either; ``torch.unique`` in step 2
waits for the card, so the plain update is not the card's path for the
classic layout.

Compact layouts (:func:`repair_plain`), the card's path too: with
packed positions a level's argmin is the chunk-local offset, written
back into the words with :func:`repro_torch.core.bitpack.scatter_offsets`;
with bf16 summaries the winner of a chunk above level 1 is decided
exactly (:func:`exact_recompare`: the children tied at the quantized
minimum re-read from level 0 through their positions).  Both at once
read the children's positions through the packed chains.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import bitpack
from repro_torch.core.constants import PAD_POS
from repro_torch.core.hierarchy import (Hierarchy, gather_bits,
                                        pos_dtype_for, quantized_planes,
                                        value_bits)
from repro_torch.core.plan import HierarchyPlan

__all__ = [
    "append_hierarchy",
    "exact_recompare",
    "key_dtype",
    "level_source",
    "propagate_updates",
    "repair_level_plain",
    "repair_plain",
    "scatter_base",
    "sort_batch",
    "touched_chunk_ids",
    "update_hierarchy",
]

def scatter_base(base: torch.Tensor, idxs: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """A copy of ``base`` with ``vals`` written at ``idxs``.

    Duplicate indices resolve last-wins (the latest batch entry, as if
    applied one by one): a stable sort groups each index's entries in
    batch order and every entry of a group writes the group's last value,
    so the scatter's duplicates agree (on the card a duplicate write has
    no defined winner).  Indices outside ``[0, len(base))`` are dropped:
    they write a scratch slot past the end.  Nothing here waits for the
    card.
    """
    cap = base.shape[0]
    idxs = idxs.to(device=base.device, dtype=torch.int64).reshape(-1)
    vals = vals.to(device=base.device, dtype=base.dtype).reshape(-1)
    if idxs.numel() == 0:
        return base.clone()
    keys = torch.where((idxs >= 0) & (idxs < cap), idxs, cap)
    keys, perm = torch.sort(keys, stable=True)
    q = torch.arange(keys.numel(), device=keys.device)
    nxt = torch.cat([keys[1:], keys.new_full((1,), -1)])
    last = torch.where(nxt != keys, q, keys.numel())
    last = torch.flip(torch.cummin(torch.flip(last, (0,)), 0).values, (0,))
    out = torch.cat([base, base.new_zeros(1)])
    value_bits(out).scatter_(0, keys, value_bits(
        vals.index_select(0, perm.index_select(0, last))))
    return out[:cap]


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
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Min, leftmost position and winning lane of chunks ``ids`` of a
    source level; the lane is the chunk-local offset a packed plane
    stores.

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
    nv = gather_bits(v, 1, am)[:, 0]
    if not track:
        return nv, None, am[:, 0]
    if src_p is None:
        p = torch.where(inside, gather, PAD_POS)
    else:
        p = src_p[safe]
    return nv, p.gather(1, am)[:, 0].to(pos_dtype), am[:, 0]


def exact_recompare(v: torch.Tensor, p_abs: torch.Tensor,
                    live: torch.Tensor, base: torch.Tensor):
    """Row winners of quantized ``(B, c)`` windows, decided exactly.

    ``v`` holds bf16 summaries, so its row argmin can pick a wrong entry.
    Every ``live`` lane tied at the quantized row minimum (the NaNs where
    that minimum is NaN) is re-read from level 0 through its absolute
    position ``p_abs``; the least exact value wins, NaN least, the first
    lane (the least position) on ties.  Returns ``(winner's summary,
    winner's position, winner's lane)``: the summary is the winner's own
    stored bits, as a rebuild would store them.
    """
    vq = torch.where(live, v, float("inf"))
    mq = vq.amin(dim=1, keepdim=True)
    tied = ((vq == mq) | (vq != vq)) & live
    ex = torch.where(tied, base[p_abs.clamp(0, base.shape[0] - 1)],
                     float("inf"))
    m = ex.amin(dim=1, keepdim=True)
    win = ((ex == m) | (ex != ex)) & tied
    am = torch.argmax(win.to(torch.uint8), dim=1, keepdim=True)
    return gather_bits(v, 1, am)[:, 0], p_abs.gather(1, am)[:, 0], am[:, 0]


def _repair_exact(plan: HierarchyPlan, base, upper, upper_pos, level: int,
                  ids: torch.Tensor, packed: bool, coord: torch.dtype):
    """:func:`repair_level_plain` over bf16 summaries (``level >= 2``):
    the winner is decided by :func:`exact_recompare`.  Padding lanes are
    masked before a packed chain is followed: a padding entry's field is
    0, and its chain could leave the word array."""
    poff, padded = plan.level_slice(level - 1)
    gather = ids[:, None] * plan.c + torch.arange(plan.c, device=ids.device)
    live = gather < plan.level_lens[level - 1]
    safe = torch.where(live, gather, 0)
    v = upper[poff:poff + padded][safe]
    if packed:
        p_abs = bitpack.gather_absolute(upper_pos, plan, level - 1, safe,
                                        coord)
    else:
        p_abs = upper_pos[poff:poff + padded][safe]
    return exact_recompare(v, p_abs, live, base)


def repair_plain(plan: HierarchyPlan, base, upper, upper_pos, level: int,
                 ids: torch.Tensor) -> None:
    """Step 2 for one level on the plain path, written in place, for
    every plane layout: a packed plane takes the winning lane as its
    chunk-local offset (:func:`repro_torch.core.bitpack.scatter_offsets`),
    and bf16 summaries above level 1 are decided by
    :func:`exact_recompare` (level 0 is exact whatever the summaries)."""
    packed = upper_pos is not None and plan.packed_pos
    coord = (upper_pos.dtype if upper_pos is not None and not packed
             else pos_dtype_for(plan.capacity))
    if level > 1 and quantized_planes(upper, base):
        nv, np_, am = _repair_exact(plan, base, upper, upper_pos, level, ids,
                                    packed, coord)
    else:
        src_v, src_p = level_source(plan, base, upper,
                                    None if packed else upper_pos, level)
        nv, np_, am = repair_level_plain(
            src_v, src_p, ids, plan.c,
            upper_pos is not None and not packed, coord)
    off = plan.offsets[level - 1]
    upper[off + ids] = nv.to(upper.dtype)
    if packed:
        upper_pos.copy_(bitpack.scatter_offsets(
            upper_pos, off + ids, am, bitpack.pos_bits(plan.c)))
    elif upper_pos is not None:
        upper_pos[off + ids] = np_


def propagate_updates(
    plan: HierarchyPlan,
    base: torch.Tensor,
    upper: torch.Tensor,
    upper_pos: Optional[torch.Tensor],
    idxs: torch.Tensor,
) -> None:
    """Re-reduce every chunk on the root-to-leaf paths of ``idxs``, in
    place on ``upper`` / ``upper_pos``; ``base`` holds the new values.
    Every plane layout: classic, packed positions, bf16 summaries, both
    (:func:`repair_plain`).

    Indices outside ``[0, capacity)`` were dropped by the base scatter;
    their chunk id becomes 0, whose re-reduction of unchanged data
    rewrites the same summary.
    """
    idxs = idxs.to(device=base.device, dtype=torch.int64).reshape(-1)
    idxs = torch.where((idxs >= 0) & (idxs < plan.capacity), idxs, 0)
    ids = idxs // plan.c
    for level in range(1, plan.num_levels):
        ids = touched_chunk_ids(ids, plan.level_lens[level])
        repair_plain(plan, base, upper, upper_pos, level, ids)
        ids = ids // plan.c


def _successor(h: Hierarchy, base: torch.Tensor,
               idxs: torch.Tensor) -> Hierarchy:
    upper = h.upper.clone()
    upper_pos = None if h.upper_pos is None else h.upper_pos.clone()
    propagate_updates(h.plan, base, upper, upper_pos, idxs)
    return Hierarchy(base=base, upper=upper, upper_pos=upper_pos,
                     plan=h.plan)


def update_hierarchy(h: Hierarchy, idxs, vals) -> Hierarchy:
    """The successor of ``h`` after ``a[idxs] = vals`` (last wins)."""
    idxs = torch.as_tensor(idxs, device=h.device)
    vals = torch.as_tensor(vals, device=h.device)
    base = scatter_base(h.base, idxs, vals)
    return _successor(h, base, idxs)


def append_hierarchy(h: Hierarchy, vals, start: int) -> Hierarchy:
    """The successor of ``h`` with ``vals`` written at ``[start,
    start + B)``; the caller guarantees ``start + B <= capacity``."""
    vals = torch.as_tensor(vals, device=h.device).to(h.base.dtype)
    vals = vals.reshape(-1)
    start = int(start)
    base = h.base.clone()
    base[start:start + vals.shape[0]] = vals
    idxs = start + torch.arange(vals.shape[0], device=h.device)
    return _successor(h, base, idxs)


def key_dtype(plan: HierarchyPlan) -> torch.dtype:
    """The sorted batch's index dtype: int32 where every index and the
    out-of-range mark (``capacity``) fit."""
    return torch.int32 if plan.capacity < 2**31 else torch.int64


def sort_batch(h: Hierarchy, idxs, vals):
    """``(keys, vals)``: the batch as the update kernel takes it, at its
    static size.  The indices ascend by a stable sort, so equal indices
    keep their batch order and the last of each run is the write that
    stays; each value stays beside its index; indices outside ``[0,
    capacity)`` become ``capacity`` and sort to the end, where they are
    skipped.  Nothing here waits for the card."""
    cap = h.plan.capacity
    idxs = torch.as_tensor(idxs, device=h.device).to(torch.int64)
    vals = torch.as_tensor(vals, device=h.device).to(h.base.dtype)
    keys = torch.where((idxs >= 0) & (idxs < cap), idxs.reshape(-1), cap)
    keys, perm = torch.sort(keys.to(key_dtype(h.plan)), stable=True)
    return keys, vals.reshape(-1).index_select(0, perm)
