"""Hybrid RMQ: hierarchy lower levels + an O(1) sparse-table top (§4.5).

The port of ``repro.core.hybrid``, plain PyTorch as the reference's walk
is plain JAX: levels ``0 .. L-2`` take the standard boundary-chunk walk
(:func:`repro_torch.core.query.walk_lower_levels`), and the top level is
one sparse-table lookup instead of an O(c·t) scan.  Built from a
position-tracking hierarchy, the table tracks leftmost positions too, so
``query_index`` gets the same O(1) top; that is the query engine's
long-span route.

:meth:`HybridRMQ.from_hierarchy` wraps an existing hierarchy without
rebuilding it (one table build over at most ``c·t`` entries).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import protocol as px
from repro_torch.core.api import resolve_device
from repro_torch.core.baselines import SparseTable
from repro_torch.core.hierarchy import Hierarchy, pos_dtype_for
from repro_torch.core.plan import HierarchyPlan, make_plan
from repro_torch.core.query import _merge, walk_lower_levels

__all__ = ["HybridRMQ"]


@dataclasses.dataclass(frozen=True)
class HybridRMQ:
    """Minima hierarchy with a sparse-table top level."""

    hierarchy: Hierarchy
    top_table: SparseTable

    @staticmethod
    def build(
        x,
        c: int = 128,
        t: int = 1024,
        with_positions: bool = False,
        backend: str = "auto",
        device=None,
    ) -> "HybridRMQ":
        """The default ``t`` is 16x the scan version's: an O(1) top makes a
        large top free at query time (paper §4.5), one level fewer.
        ``backend`` picks the construction path; the walk is plain."""
        dev = resolve_device(device)
        x = px.coerce_values(x, dev)
        plan = make_plan(int(x.shape[0]), c=c, t=t)
        h = px.build_hierarchy_with_backend(
            x, plan, with_positions=with_positions,
            backend=px.resolve_backend(backend, dev))
        return HybridRMQ.from_hierarchy(h)

    @staticmethod
    def from_hierarchy(h: Hierarchy) -> "HybridRMQ":
        """Add a sparse-table top to an existing hierarchy (no rebuild);
        positions follow the hierarchy's."""
        plan = h.plan
        if plan.num_levels == 1:
            top = h.base
            top_pos = (torch.arange(h.base.shape[0], dtype=torch.int32,
                                    device=h.device)
                       if h.with_positions else None)
        else:
            off, _ = plan.level_slice(plan.num_levels - 1)
            top = h.upper[off:off + plan.top_len]
            top_pos = (h.upper_pos[off:off + plan.top_len]
                       if h.with_positions else None)
        return HybridRMQ(hierarchy=h,
                         top_table=SparseTable.build(top, positions=top_pos))

    # -- protocol surface (read-only: an update could move the top's
    # minima and invalidate table rows wholesale; the engine re-derives
    # the hybrid per generation) ------------------------------------------
    backend = "eager"  # the hybrid walk is plain PyTorch on every backend
    generation = 0

    @property
    def plan(self) -> HierarchyPlan:
        return self.hierarchy.plan

    @property
    def length(self) -> int:
        return self.plan.n

    @property
    def capacity(self) -> int:
        return self.plan.capacity

    @property
    def device(self) -> torch.device:
        return self.hierarchy.device

    @property
    def value_dtype(self) -> torch.dtype:
        return self.hierarchy.base.dtype

    @property
    def with_positions(self) -> bool:
        return self.top_table.with_positions

    def engine(self, **kwargs):
        """A span-routed :class:`repro_torch.qe.QueryEngine` over this
        index."""
        return px.make_engine(self, **kwargs)

    def auxiliary_bytes(self) -> int:
        return (self.hierarchy.auxiliary_bytes()
                + self.top_table.auxiliary_bytes())

    def _walk(self, ls, rs, track: bool):
        h = self.hierarchy
        pos_dtype = pos_dtype_for(self.plan.capacity)
        ident = torch.iinfo(pos_dtype).max
        ls = torch.as_tensor(ls, device=h.device).reshape(-1)
        rs = torch.as_tensor(rs, device=h.device).reshape(-1)
        m, p, l, r = walk_lower_levels(h, ls, rs, track, ident)
        # O(1) top over [l, r); an empty range contributes (+inf, ident)
        last = self.top_table.n - 1
        nonempty = r > l
        lo = l.clamp(0, last)
        hi = torch.maximum(r - 1, l).clamp(0, last)
        tm, tp = self.top_table.lookup(lo, hi, track)
        tm = torch.where(nonempty, tm, float("inf"))
        if track:
            tp = torch.where(nonempty, tp.to(torch.int64), ident)
        m, p = _merge(m, p, tm, tp, track)
        return m, (p.to(pos_dtype) if track else None)

    def query(self, ls, rs) -> torch.Tensor:
        """Batched ``RMQ_value`` with the O(1) top."""
        return self._walk(ls, rs, track=False)[0]

    def query_index(self, ls, rs) -> torch.Tensor:
        """Leftmost-minimum positions with the O(1) top."""
        if not self.with_positions:
            raise ValueError(
                "hybrid built value-only; build with with_positions=True "
                "(or from a position-tracking hierarchy)")
        return self._walk(ls, rs, track=True)[1]

    # protocol spellings (RMQIndex): same entry points, canonical names
    query_value_batch = query
    query_index_batch = query_index
