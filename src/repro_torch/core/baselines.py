"""Baseline RMQ methods the paper compares against (§5.2), plain PyTorch.

The port of ``repro.core.baselines`` (which has no Pallas kernel):

* :class:`FullScan` — no preprocessing, one masked min over the whole
  array per query (the paper's "Full GPU Scan");
* :class:`SparseTable` — O(n log n) memory, O(1) per query (the memory
  profile the paper attributes to LCA), optionally tracking leftmost
  positions (the hybrid's top uses that);
* :class:`TwoLevelBlocks` — a GPU-RMQ hierarchy capped at two levels
  (the block-decomposition design point of CPU HRMQ).

All share the batched ``(ls, rs) -> values`` interface of
:mod:`repro_torch.core.query`.  ``build`` runs on the card unless
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import protocol as px
from repro_torch.core.api import resolve_device
from repro_torch.core.hierarchy import Hierarchy, build_hierarchy
from repro_torch.core.plan import make_plan
from repro_torch.core.query import rmq_value_batch

__all__ = ["FullScan", "SparseTable", "TwoLevelBlocks", "floor_log2"]

# Queries per slice of the full scan's (queries, n) mask.
_SCAN_ELEMS = 1 << 24


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """``floor(log2(x))`` of positive integers, exactly (``frexp``
    gives ``x = m * 2**e`` with ``m`` in ``[0.5, 1)``)."""
    return torch.frexp(x.to(torch.float64))[1].to(torch.int64) - 1


def _bounds(ls, rs, device):
    ls = torch.as_tensor(ls, device=device).reshape(-1).to(torch.int64)
    rs = torch.as_tensor(rs, device=device).reshape(-1).to(torch.int64)
    return ls, rs


@dataclasses.dataclass(frozen=True)
class FullScan:
    """One masked min over the whole array per query."""

    x: torch.Tensor

    @staticmethod
    def build(x, device=None) -> "FullScan":
        return FullScan(x=px.coerce_values(x, resolve_device(device)))

    def memory_bytes(self) -> int:
        return self.x.numel() * self.x.element_size()

    def auxiliary_bytes(self) -> int:
        return 0

    def query_batch(self, ls, rs) -> torch.Tensor:
        ls, rs = _bounds(ls, rs, self.x.device)
        n = self.x.shape[0]
        idx = torch.arange(n, device=self.x.device)
        out = torch.empty(ls.shape[0], dtype=self.x.dtype,
                          device=self.x.device)
        step = max(1, _SCAN_ELEMS // max(n, 1))
        for s in range(0, ls.shape[0], step):
            mask = (idx >= ls[s:s + step, None]) & (idx <= rs[s:s + step,
                                                              None])
            out[s:s + step] = torch.where(mask, self.x,
                                          float("inf")).amin(dim=1)
        return out


@dataclasses.dataclass(frozen=True)
class SparseTable:
    """``table[j, i] = min(x[i : i + 2^j])``: O(n log n) memory, O(1)
    query.  With ``positions`` (the original-array position of each entry
    of ``x``) it also keeps ``pos[j, i]``, the leftmost minimum's position,
    for O(1) ``RMQ_index``."""

    table: torch.Tensor            # (levels, n)
    pos: Optional[torch.Tensor]    # (levels, n) or None (value-only)
    n: int

    @staticmethod
    def build(x, positions=None, device=None) -> "SparseTable":
        """Over ``x`` (a tensor stays where it is; anything else goes to
        ``device``, the card by default)."""
        if not isinstance(x, torch.Tensor):
            x = px.coerce_values(x, resolve_device(device))
        n = int(x.shape[0])
        levels = max(1, n.bit_length())  # j = 0 .. floor(log2(n))
        rows = [x]
        track = positions is not None
        if track:
            positions = torch.as_tensor(positions, device=x.device)
            pad_pos = torch.iinfo(positions.dtype).max
            prows = [positions]
        for j in range(1, levels):
            prev = rows[-1]
            half = 1 << (j - 1)
            shifted = torch.cat([prev[half:], prev.new_full((half,),
                                                            float("inf"))])
            if track:
                pprev = prows[-1]
                pshift = torch.cat([pprev[half:],
                                    pprev.new_full((half,), pad_pos)])
                # lexicographic (value, position) min: leftmost on ties
                take2 = (shifted < prev) | ((shifted == prev)
                                            & (pshift < pprev))
                prows.append(torch.where(take2, pshift, pprev))
            rows.append(torch.minimum(prev, shifted))
        return SparseTable(table=torch.stack(rows),
                           pos=torch.stack(prows) if track else None, n=n)

    @property
    def with_positions(self) -> bool:
        return self.pos is not None

    def memory_bytes(self) -> int:
        total = self.table.numel() * self.table.element_size()
        if self.pos is not None:
            total += self.pos.numel() * self.pos.element_size()
        return total

    def auxiliary_bytes(self) -> int:
        return self.memory_bytes() - self.n * self.table.element_size()

    def lookup(self, l: torch.Tensor, r: torch.Tensor, track: bool):
        """``(values, positions or None)`` over inclusive ``[l, r]``
        (int64 tensors, ``0 <= l <= r < n``)."""
        j = floor_log2(r - l + 1)
        r2 = r + 1 - (1 << j)
        vl, vr = self.table[j, l], self.table[j, r2]
        if not track:
            return torch.minimum(vl, vr), None
        pl, pr = self.pos[j, l], self.pos[j, r2]
        take_r = (vr < vl) | ((vr == vl) & (pr < pl))
        return torch.where(take_r, vr, vl), torch.where(take_r, pr, pl)

    def query_batch(self, ls, rs) -> torch.Tensor:
        ls, rs = _bounds(ls, rs, self.table.device)
        return self.lookup(ls, rs, track=False)[0]

    def query_index_batch(self, ls, rs) -> torch.Tensor:
        """Leftmost-minimum positions (an index-tracking build only)."""
        if self.pos is None:
            raise ValueError(
                "sparse table built value-only; "
                "use SparseTable.build(x, positions=...)")
        ls, rs = _bounds(ls, rs, self.table.device)
        return self.lookup(ls, rs, track=True)[1]


@dataclasses.dataclass(frozen=True)
class TwoLevelBlocks:
    """A GPU-RMQ hierarchy capped at exactly two levels: a query scans two
    partial blocks (O(c)) and the block minima (O(n/c))."""

    hierarchy: Hierarchy

    @staticmethod
    def build(x, c: int = 256, device=None) -> "TwoLevelBlocks":
        x = px.coerce_values(x, resolve_device(device))
        n = int(x.shape[0])
        # t so that the first reduction already meets the cutoff
        t = max(1, math.ceil(math.ceil(n / c) / c))
        plan = make_plan(n, c=c, t=t)
        return TwoLevelBlocks(hierarchy=build_hierarchy(x, plan))

    def memory_bytes(self) -> int:
        return self.hierarchy.memory_bytes()

    def auxiliary_bytes(self) -> int:
        return self.hierarchy.auxiliary_bytes()

    def query_batch(self, ls, rs) -> torch.Tensor:
        ls, rs = _bounds(ls, rs, self.hierarchy.device)
        return rmq_value_batch(self.hierarchy, ls, rs)
