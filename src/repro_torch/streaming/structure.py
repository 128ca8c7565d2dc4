"""``StreamingRMQ``: a minima hierarchy that tracks a mutating array.

The port of ``repro.streaming.structure``.  Three online operations,
each in O(batch · log_c capacity) chunk re-reductions:

* :meth:`StreamingRMQ.update` — batched point updates (last wins);
* :meth:`StreamingRMQ.append` — extend the live region into the
  reserved, +inf-padded capacity (``make_plan(..., capacity=)`` keeps
  the geometry fixed across appends);
* :meth:`StreamingRMQ.retire` — slide the window start forward by
  writing +inf over the oldest entries, so they never win again.

Every mutator returns a successor with ``generation + 1``; the receiver
keeps its own buffers and still answers for its data.  Backends as in
:mod:`repro_torch.core.protocol`: ``cuda`` mutates through the
``hierarchy_update`` kernel (B6), ``fused`` through ``cuda`` on a card.
Entry points run on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import protocol as px
from repro_torch.core.api import resolve_device
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.plan import HierarchyPlan, make_plan
from repro_torch.core.query import check_query_args

__all__ = ["StreamingRMQ"]


@dataclasses.dataclass(frozen=True)
class StreamingRMQ:
    """A range-minimum index over an online array; ``[start, length)``
    is the live window."""

    hierarchy: Hierarchy
    backend: str
    length: int
    start: int = 0
    # Monotonic mutation counter, bumped by update / append / retire.
    generation: int = 0

    # -- construction -----------------------------------------------------
    @staticmethod
    def from_array(
        x,
        c: int = 128,
        t: int = 64,
        capacity: Optional[int] = None,
        with_positions: bool = False,
        backend: str = "auto",
        plan: Optional[HierarchyPlan] = None,
        device=None,
    ) -> "StreamingRMQ":
        """Build over ``x``, reserving ``capacity`` slots for appends."""
        dev = resolve_device(device)
        x = px.coerce_values(x, dev)
        n = int(x.shape[0])
        if plan is not None and capacity is not None:
            raise ValueError(
                "pass capacity via make_plan(..., capacity=...) when "
                "supplying an explicit plan")
        if plan is None:
            plan = make_plan(n, c=c, t=t, capacity=capacity)
        backend = px.resolve_backend(backend, dev)
        h = px.build_hierarchy_with_backend(
            x, plan, with_positions=with_positions, backend=backend)
        return StreamingRMQ(hierarchy=h, backend=backend, length=n)

    # -- mutation ---------------------------------------------------------
    def update(self, idxs, vals) -> "StreamingRMQ":
        """Batched point updates ``a[idxs] = vals`` (last wins on dups)."""
        idxs, vals = px.validate_update_batch(idxs, vals, n=self.length)
        if idxs.shape[0] == 0:
            return self
        return dataclasses.replace(
            self,
            hierarchy=px.dispatch_update(self.hierarchy, idxs, vals,
                                         self.backend),
            generation=self.generation + 1)

    def append(self, vals) -> "StreamingRMQ":
        """Extend the array with ``vals``; fails when capacity is spent."""
        vals = px.validate_append_batch(
            vals, length=self.length, capacity=self.capacity)
        b = int(vals.shape[0])
        if b == 0:
            return self
        h = px.dispatch_append(self.hierarchy, vals, self.length,
                               self.backend)
        return dataclasses.replace(
            self, hierarchy=h, length=self.length + b,
            generation=self.generation + 1)

    def retire(self, count: int) -> "StreamingRMQ":
        """Slide the window: drop the ``count`` oldest live entries.

        Retired slots become +inf (one batched update), so spans that
        straddle them still answer for the live window.  Capacity is not
        reclaimed.
        """
        count = min(int(count), self.length - self.start)
        if count <= 0:
            return self
        dev = self.hierarchy.device
        idxs = self.start + torch.arange(count, dtype=torch.int64,
                                         device=dev)
        vals = torch.full((count,), float("inf"),
                          dtype=self.hierarchy.base.dtype, device=dev)
        return dataclasses.replace(
            self,
            hierarchy=px.dispatch_update(self.hierarchy, idxs, vals,
                                         self.backend),
            start=self.start + count,
            generation=self.generation + 1)

    # -- queries ----------------------------------------------------------
    def _bounds(self, ls, rs):
        return check_query_args(ls, rs, self.length, device=self.device)

    def query(self, ls, rs) -> torch.Tensor:
        """Batched ``RMQ_value`` over inclusive ranges in the live window."""
        ls, rs = self._bounds(ls, rs)
        return px.dispatch_query_value(self.hierarchy, ls, rs, self.backend)

    def query_index(self, ls, rs) -> torch.Tensor:
        """Batched ``RMQ_index`` (leftmost minimum) over inclusive ranges."""
        ls, rs = self._bounds(ls, rs)
        return px.dispatch_query_index(self.hierarchy, ls, rs, self.backend)

    # protocol spellings (RMQIndex): same entry points, canonical names
    query_value_batch = query
    query_index_batch = query_index

    # -- adaptive batched engine -------------------------------------------
    def engine(self, **kwargs):
        """A span-routed :class:`repro_torch.qe.QueryEngine` over this
        index; re-attach it after every mutation."""
        return px.make_engine(self, **kwargs)

    # -- introspection ----------------------------------------------------
    @property
    def plan(self) -> HierarchyPlan:
        return self.hierarchy.plan

    @property
    def capacity(self) -> int:
        return self.plan.capacity

    @property
    def device(self) -> torch.device:
        return self.hierarchy.device

    @property
    def with_positions(self) -> bool:
        return self.hierarchy.with_positions

    @property
    def value_dtype(self) -> torch.dtype:
        return self.hierarchy.base.dtype

    def memory_bytes(self) -> int:
        return self.hierarchy.memory_bytes()
