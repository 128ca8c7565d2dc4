"""Plain PyTorch version of the short-span query (the kernel's oracle).

The port of ``repro/kernels/rmq_short/ref.py``: a span with
``r // c - l // c <= 1`` lies inside the ``2c`` window from
``floor(l / c) * c``, so one masked scan of that window answers it, and
its leftmost position is the window index (level 0 is the original
array).  The anchor is clamped to ``capacity - min(2c, capacity)``, as in
the reference, so the window stays inside the level.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.hierarchy import pos_dtype_for

__all__ = ["rmq_short_batch_ref"]

# Entries of gathered windows per slice of the plain version.
_WINDOW_ELEMS = 1 << 24


def rmq_short_batch_ref(
    base: torch.Tensor, ls, rs, c: int, capacity: int, track_pos: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The reference's ``rmq_short_batch_ref``: a ``min(2c, capacity)``
    window anchored at ``floor(l/c)*c`` (clamped to the level), masked to
    ``[l, r]``; positions are the window indices."""
    w = min(2 * c, capacity)
    dev = base.device
    ls = torch.as_tensor(ls, device=dev).reshape(-1).to(torch.int64)
    rs = torch.as_tensor(rs, device=dev).reshape(-1).to(torch.int64)
    pos_dtype = pos_dtype_for(capacity)
    vals = torch.empty(ls.shape[0], dtype=base.dtype, device=dev)
    pos = torch.empty(ls.shape[0], dtype=pos_dtype, device=dev) \
        if track_pos else None
    lane = torch.arange(w, device=dev)
    step = max(1, _WINDOW_ELEMS // w)
    for s in range(0, ls.shape[0], step):
        l, r = ls[s:s + step], rs[s:s + step]
        anchor = ((l // c) * c).clamp(0, max(capacity - w, 0))
        idx = anchor[:, None] + lane
        mask = (idx >= l[:, None]) & (idx <= r[:, None])
        masked = torch.where(mask, base[idx], float("inf"))
        m = masked.amin(dim=1)
        vals[s:s + step] = m
        if track_pos:
            ident = torch.iinfo(pos_dtype).max
            cand = torch.where(mask & (masked == m[:, None]), idx, ident)
            pos[s:s + step] = cand.amin(dim=1).to(pos_dtype)
    return vals, pos
