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

Every candidate is a ``(value, position)`` pair and the merge is
lexicographic, so the answer is the minimum and its leftmost position,
whatever order the windows come in.  Large batches are walked in slices
so that no gathered window tensor exceeds ``_WINDOW_ELEMS`` entries.

Query convention: ``(l, r)`` are **inclusive**, ``0 <= l <= r < n``
(paper §2.1).  Invalid bounds give unspecified answers but every read
stays inside the hierarchy, as in the kernels.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from repro_torch.core.hierarchy import Hierarchy, pos_dtype_for

__all__ = [
    "check_query_args",
    "rmq_index_batch",
    "rmq_value_batch",
    "rmq_walk_batch",
]

_WINDOW_ELEMS = 1 << 24


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


def _window_min(vals, pos, mask, track, ident):
    """(min, leftmost pos) over the last axis where ``mask`` holds."""
    masked = torch.where(mask, vals, float("inf"))
    m = masked.amin(dim=-1)
    if not track:
        return m, None
    cand = torch.where(mask & (masked == m.unsqueeze(-1)), pos, ident)
    return m, cand.amin(dim=-1)


def _merge(m, p, m2, p2, track):
    if not track:
        return torch.minimum(m, m2), None
    take = (m2 < m) | ((m2 == m) & (p2 < p))
    return torch.where(take, m2, m), torch.where(take, p2, p)


def walk_lower_levels(h: Hierarchy, ls, rs, track: bool, ident: int):
    """Levels ``0 .. L-2`` of the walk for inclusive bounds.

    Returns ``(m, p, l, r)``: the merged ``(value, position)`` of those
    levels (positions ``None`` unless ``track``) and the range ``[l, r)``
    still to answer on the top level, in its coordinates.
    """
    plan, c = h.plan, h.plan.c
    dev = h.base.device
    l = ls.to(device=dev, dtype=torch.int64)
    r = rs.to(device=dev, dtype=torch.int64) + 1  # exclusive
    m = torch.full(l.shape, float("inf"), dtype=h.base.dtype, device=dev)
    p = torch.full(l.shape, ident, dtype=torch.int64, device=dev) \
        if track else None
    lane = torch.arange(c, device=dev)

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
        pos = None
        if track:
            pos = idx if parr is None else parr[idx].to(torch.int64)
        wm, wp = _window_min(arr[idx], pos, mask, track, ident)
        m, p = _merge(m, p, wm, wp, track)
        l, r = -((-l) // c), r // c
    return m, p, l, r


def _walk_slice(h: Hierarchy, ls, rs, track: bool, ident: int):
    plan = h.plan
    dev = h.base.device
    m, p, l, r = walk_lower_levels(h, ls, rs, track, ident)
    if plan.num_levels == 1:
        top, top_pos = h.base, None
    else:
        off, length = plan.level_slice(plan.num_levels - 1)
        top = h.upper[off:off + length]
        top_pos = h.upper_pos[off:off + length] if track else None
    idx = torch.arange(top.shape[0], device=dev)
    mask = (idx >= l.unsqueeze(-1)) & (idx < r.unsqueeze(-1))
    pos = None
    if track:
        pos = idx if top_pos is None else top_pos.to(torch.int64)
    wm, wp = _window_min(top.expand(l.shape[0], -1), pos, mask, track,
                         ident)
    return _merge(m, p, wm, wp, track)


def rmq_walk_batch(
    h: Hierarchy, ls: torch.Tensor, rs: torch.Tensor, track_pos: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(values, positions)`` of a batch; positions ``None`` unless
    ``track_pos``.  Positions come in ``pos_dtype_for(capacity)``."""
    if track_pos and not h.with_positions:
        raise ValueError(
            "hierarchy was built without positions; "
            "use build_hierarchy(..., with_positions=True)")
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
        v, p = _walk_slice(h, ls[s:s + step], rs[s:s + step], track_pos,
                           ident)
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
