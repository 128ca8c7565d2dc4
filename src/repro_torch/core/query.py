"""Batched hierarchical RMQ answering (paper §4.2–§4.4), plain PyTorch.

The plain walk that the CUDA query kernels (``kernels/rmq_fused``,
``kernels/rmq_scan``) are held bit-identical to.  It works on whole
batch tensors, level by level, with the kernels' decomposition:

* at every level below the top, two aligned ``c``-wide windows per query
  (the left and right partial chunks, masked to the range) are gathered
  as one ``(m, 2, c)`` tensor and reduced;
* the ascend is ``l' = ceil(l / c)``, ``r' = floor(r / c)`` with ``r``
  exclusive, so a range that is used up stays empty;
* the top level (at most ``c * t`` entries) is scanned in full, masked
  to ``[l, r)``.

Every candidate is a ``(value, key)`` pair, the key its position (or,
value-only, the first level-0 index it covers), and the merge is
lexicographic, so the answer is the minimum and its leftmost position,
whatever order the windows come in.  NaN is the least value (the rule of
``torch.argmin`` and of the port's kernels): a span that holds a NaN
answers its leftmost NaN, with that entry's own bits.  Values are always
the winning entry's bits, so a zero minimum keeps its leftmost sign.
Large batches are walked in slices so that no gathered window tensor
exceeds ``_WINDOW_ELEMS`` entries.

Compact planes: a packed position plane is resolved to the absolute
plane once a batch (:func:`repro_torch.core.bitpack.resolve_positions`),
and only where positions are read.  Over bf16 summaries the walk is the
exact-recovery walk: at every upper level and the top, each candidate
tied at the quantized minimum (the NaNs, where that minimum is NaN) is
re-read from level 0 through its position, the exact value decides and
the smaller position breaks ties, so the answers are the classic
layout's bit for bit (bf16 rounding is monotone, so the true minimum is
always among the tied).  Value queries track positions for it.

Query convention: ``(l, r)`` are **inclusive**, ``0 <= l <= r < n``
(paper §2.1).  Invalid bounds give unspecified answers but every read
stays inside the hierarchy, as in the kernels.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

from repro_torch.core import bitpack
from repro_torch.core.hierarchy import Hierarchy, gather_bits, pos_dtype_for

__all__ = [
    "check_query_args",
    "rmq_index",
    "rmq_index_batch",
    "rmq_value",
    "rmq_value_batch",
    "rmq_walk_batch",
]

# Entries of the largest window tensor a slice gathers.  A slice takes
# about 200 small PyTorch operations: at 1 << 24 entries (2^15 spans a
# slice under a 512-entry top) a large batch on the card waits on the
# host's dispatch of them; at 1 << 26 it waits on the card (temporaries
# of about 16 bytes an entry).
_WINDOW_ELEMS = 1 << 26


def _debug_checks_enabled() -> bool:
    return os.environ.get("REPRO_RMQ_DEBUG", "0") not in ("", "0")


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def check_query_args(ls, rs, n: int, debug: Optional[bool] = None,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate a query batch against ``0 <= l <= r < n``.

    Dtype and shape problems are always rejected.  The value check reads
    the bounds back from the device, so it runs only in debug mode
    (``debug=True`` or env ``REPRO_RMQ_DEBUG=1``).  Returns ``(ls, rs)``
    as tensors on ``device`` (default: where they already are).
    """
    ls = torch.as_tensor(ls, device=device)
    rs = torch.as_tensor(rs, device=device)
    for name, a in (("ls", ls), ("rs", rs)):
        if not _is_integer(a.dtype):
            raise TypeError(
                f"query bounds {name} must be integers, got {a.dtype}")
    if ls.shape != rs.shape:
        raise ValueError(
            f"query bounds must match in shape, got {tuple(ls.shape)} vs "
            f"{tuple(rs.shape)}")
    if debug is None:
        debug = _debug_checks_enabled()
    if debug:
        bad = (ls < 0) | (ls > rs) | (rs >= n)
        if bool(bad.any()):
            i = int(torch.argmax(bad.reshape(-1).to(torch.uint8)))
            raise ValueError(
                f"query {i} = ({int(ls.reshape(-1)[i])}, "
                f"{int(rs.reshape(-1)[i])}) violates 0 <= l <= r < n "
                f"with n={n}")
    return ls, rs


def nan_less(a, b):
    """``a < b`` under the port's order, where NaN is the least value (two
    NaNs tie)."""
    return (a < b) | (a.isnan() & ~b.isnan())


def _least(vals, mask):
    """``(masked, hit)``: ``vals`` with +inf where ``mask`` does not hold,
    and where the least of them over the last axis stands (the NaNs
    where it is NaN: none equals it then, and there is no NaN where it is
    not), within ``mask``."""
    masked = torch.where(mask, vals, float("inf"))
    m = masked.amin(dim=-1, keepdim=True)  # NaN wherever one is in mask
    hit = (masked == m).logical_or_(masked != masked).logical_and_(mask)
    return masked, hit


def _window_min(vals, mask, lane):
    """``(value, at)``: the least entry over the last axis where ``mask``
    holds, and its index on that axis (``at`` keeps the axis; ``lane`` is
    ``arange`` of it).  NaN is the least value and ties go to the first
    entry, so on a window whose keys ascend along the axis the winner has
    the least key; the value is its own bits.  Where ``mask`` holds
    nowhere: +inf at the last index, whose key means nothing (a span whose
    minimum is +inf answers its own ``l``, as in the kernels)."""
    masked, hit = _least(vals, mask)
    at = torch.where(hit, lane, lane.shape[0] - 1).amin(dim=-1,
                                                        keepdim=True)
    return gather_bits(masked, -1, at)[..., 0], at


def _exact_window_min(quant, pos, mask, lane, base):
    """:func:`_window_min` over quantized (bf16) entries with positions
    ``pos``: the entries tied at the quantized minimum are re-read from
    level 0 (``base``) and the least exact value wins, the first (the
    least position) on ties; the value is level 0's bits."""
    _, tied = _least(quant, mask)
    exact = base[pos.clamp(0, base.shape[0] - 1)]
    return _window_min(exact, tied, lane)


def _merge(m, p, m2, p2):
    """The lexicographic (value, key) minimum of two candidates, NaN
    least (two NaNs tie)."""
    before = p2 < p
    take = (m2 < m) | ((m2 == m) & before) | (
        (m2 != m2) & ((m == m) | before))
    return torch.where(take, m2, m), torch.where(take, p2, p)


def _keys(idx, parr, level: int, c: int, track: bool):
    """Tie keys of entries ``idx`` of a level: their positions where
    ``track``, else the first level-0 index each entry covers.  Either
    grows from left to right across the segments of a walk."""
    if not track:
        return idx * c ** level if level else idx
    return idx if parr is None else parr[idx].to(torch.int64)


def inf_at_l(m, p, ls):
    """Keys of a walk's answers with a span whose minimum is +inf (every
    entry +inf) answering its leftmost entry, ``l``: the walk keeps no
    key for +inf candidates."""
    return torch.where(m == float("inf"), ls.to(p.device, torch.int64), p)


def walk_lower_levels(h: Hierarchy, ls, rs, track: bool, ident: int):
    """Levels ``0 .. L-2`` of the walk for inclusive bounds.

    Returns ``(m, p, l, r)``: the merged ``(value, key)`` of those levels
    (keys are positions where ``track``, see :func:`_keys`; a +inf
    minimum's key means nothing, see :func:`inf_at_l`) and the range
    ``[l, r)`` still to answer on the top level, in its coordinates.
    Over bf16 summaries (``upper`` narrower than ``base``) the upper
    levels take the exact re-compare, which needs ``track`` and an
    absolute position plane.
    """
    plan, c = h.plan, h.plan.c
    exact = h.quantized
    dev = h.base.device
    l = ls.to(device=dev, dtype=torch.int64)
    r = rs.to(device=dev, dtype=torch.int64) + 1  # exclusive
    m = torch.full(l.shape, float("inf"), dtype=h.base.dtype, device=dev)
    p = torch.full(l.shape, ident, dtype=torch.int64, device=dev)
    lane = torch.arange(c, device=dev)
    lane2 = torch.arange(2 * c, device=dev)

    for level in range(plan.num_levels - 1):
        if level == 0:
            arr, parr, length = h.base, None, plan.capacity
        else:
            off, length = plan.level_slice(level)
            arr = h.upper[off:off + length]
            parr = h.upper_pos[off:off + length] if track else None
        next_l = -((-l) // c) * c
        prev_r = (r // c) * c
        hi_anchor = max(length - c, 0)
        a = ((l // c) * c).clamp(0, hi_anchor)
        b = prev_r.clamp(0, hi_anchor)
        idx = torch.stack([a, b], 1).unsqueeze(-1) + lane      # (m, 2, c)
        lo = torch.stack([l, torch.maximum(prev_r, l)], 1).unsqueeze(-1)
        hi = torch.stack([torch.minimum(next_l, r), r], 1).unsqueeze(-1)
        mask = ((idx >= lo) & (idx < hi)).flatten(1)
        idx = idx.flatten(1)
        if exact and level:
            wm, at = _exact_window_min(arr[idx], parr[idx], mask, lane2,
                                       h.base)
        else:
            wm, at = _window_min(arr[idx], mask, lane2)
        j = idx.gather(-1, at)[:, 0]
        m, p = _merge(m, p, wm, _keys(j, parr, level, c, track))
        l, r = -((-l) // c), r // c
    return m, p, l, r


def _walk_slice(h: Hierarchy, ls, rs, track: bool, ident: int):
    plan = h.plan
    dev = h.base.device
    m, p, l, r = walk_lower_levels(h, ls, rs, track, ident)
    top_level = plan.num_levels - 1
    if top_level == 0:
        top, top_pos = h.base, None
    else:
        off, length = plan.level_slice(top_level)
        top = h.upper[off:off + length]
        top_pos = h.upper_pos[off:off + length] if track else None
    idx = torch.arange(top.shape[0], device=dev)
    mask = (idx >= l.unsqueeze(-1)) & (idx < r.unsqueeze(-1))
    rows = l.shape[0]
    if top_level and h.quantized:
        wm, at = _exact_window_min(top.expand(rows, -1),
                                   top_pos.expand(rows, -1), mask, idx,
                                   h.base)
    else:
        wm, at = _window_min(top.expand(rows, -1), mask, idx)
    m, p = _merge(m, p, wm, _keys(at[:, 0], top_pos, top_level, plan.c,
                                  track))
    return m, (inf_at_l(m, p, ls) if track else p)


def rmq_walk_batch(
    h: Hierarchy, ls: torch.Tensor, rs: torch.Tensor, track_pos: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(values, positions)`` of a batch; positions ``None`` unless
    ``track_pos``.  Positions come in ``pos_dtype_for(capacity)``.  A
    packed plane is unpacked once here; bf16 summaries take the exact
    walk, positions tracked whatever ``track_pos``."""
    if track_pos and not h.with_positions:
        raise ValueError(
            "hierarchy was built without positions; "
            "use build_hierarchy(..., with_positions=True)")
    exact = h.quantized
    if exact and not h.with_positions:
        raise ValueError(
            "bf16 summaries need the position plane: the exact walk "
            "re-reads level 0 through it")
    track = track_pos or exact
    if track:
        h = dataclasses.replace(
            h, upper_pos=bitpack.resolve_positions(h.upper_pos, h.plan))
    plan = h.plan
    pos_dtype = pos_dtype_for(plan.capacity)
    ident = torch.iinfo(pos_dtype).max
    shape = ls.shape
    ls, rs = ls.reshape(-1), rs.reshape(-1)
    count = ls.shape[0]
    dev = h.base.device
    vals = torch.empty(count, dtype=h.base.dtype, device=dev)
    pos = torch.empty(count, dtype=pos_dtype, device=dev) \
        if track_pos else None
    width = max(2 * plan.c, plan.top_padded_len)
    step = max(1, _WINDOW_ELEMS // width)
    for s in range(0, count, step):
        v, p = _walk_slice(h, ls[s:s + step], rs[s:s + step], track, ident)
        vals[s:s + step] = v
        if track_pos:
            pos[s:s + step] = p
    return vals.reshape(shape), (
        pos.reshape(shape) if track_pos else None)


def rmq_value_batch(h: Hierarchy, ls, rs) -> torch.Tensor:
    """``RMQ_value`` for a batch of inclusive ranges (plain walk)."""
    return rmq_walk_batch(h, ls, rs, track_pos=False)[0]


def rmq_index_batch(h: Hierarchy, ls, rs) -> torch.Tensor:
    """``RMQ_index`` (leftmost minimum position) for a batch (plain walk)."""
    return rmq_walk_batch(h, ls, rs, track_pos=True)[1]


def rmq_value(h: Hierarchy, l, r) -> torch.Tensor:
    """Single-query ``RMQ_value`` (a 0-d tensor on the hierarchy's
    device)."""
    return rmq_value_batch(h, torch.as_tensor([l]), torch.as_tensor([r]))[0]


def rmq_index(h: Hierarchy, l, r) -> torch.Tensor:
    """Single-query ``RMQ_index`` (leftmost minimum position)."""
    return rmq_index_batch(h, torch.as_tensor([l]), torch.as_tensor([r]))[0]
