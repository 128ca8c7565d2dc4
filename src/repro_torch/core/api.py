"""User-facing RMQ facade of the port: build on a device, query in batches.

``RMQ.build(x, device=None)`` builds on the card (``device=None`` means
``"cuda"``, and with no card it raises rather than building on the CPU);
pass ``device="cpu"`` for the plain PyTorch path on the host.
``backend`` picks the lowering (see :mod:`repro_torch.core.protocol`):
``"fused"`` (one launch per build and per batch), ``"cuda"`` (one launch
per level and per output plane), ``"eager"`` (plain PyTorch), or
``"auto"`` (``"cuda"`` on a card, ``"eager"`` on the CPU).  Every
backend gives bit-identical hierarchies and answers.

``packed_pos=True`` stores bit-packed chunk-local positions and
``summary_dtype="bfloat16"`` bf16 upper values with exact recovery from
level 0 (:mod:`repro_torch.core.bitpack`, :mod:`repro_torch.core.query`).
``RMQ.build_out_of_core`` builds from slabs (a callable, a numpy array or
memmap, a tensor), so the input never has to exist as one array off
the card, and serves capacities past 2^31 through the ``eager`` walk.

``update`` / ``append`` return a successor index with ``generation + 1``
(the predecessor keeps its own buffers and answers as before);
``engine()`` puts the span-routed :class:`repro_torch.qe.QueryEngine`
on top.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import protocol as px
from repro_torch.core.hierarchy import Hierarchy, pos_dtype_for
from repro_torch.core.plan import HierarchyPlan, make_plan
from repro_torch.core.query import check_query_args

__all__ = ["RMQ", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``None`` means the card; a CUDA device with no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default, pass device='cpu' to build on the host")
    return dev


@dataclasses.dataclass(frozen=True)
class RMQ:
    """A built range-minimum index (paper §4) with incremental updates."""

    hierarchy: Hierarchy
    backend: str
    # Live length; None means "the build length" (plan.n).
    length: Optional[int] = None
    # Monotonic mutation counter: every update / append returns a
    # successor with generation + 1; the engine's cache keys on it.
    generation: int = 0

    @staticmethod
    def build(
        x,
        c: int = 128,
        t: int = 64,
        with_positions: bool = False,
        backend: str = "auto",
        plan: Optional[HierarchyPlan] = None,
        capacity: Optional[int] = None,
        packed_pos: Optional[bool] = None,
        summary_dtype: Optional[str] = None,
        device=None,
    ) -> "RMQ":
        """Build over ``x``; ``capacity > len(x)`` reserves an +inf tail.
        ``packed_pos`` / ``summary_dtype`` pick the compact planes
        (``None``: the classic layout); an explicit ``plan`` carries its
        own."""
        dev = resolve_device(device)
        x = px.coerce_values(x, dev)
        if plan is not None and capacity is not None:
            raise ValueError(
                "pass capacity via make_plan(..., capacity=...) when "
                "supplying an explicit plan")
        if plan is None:
            plan = make_plan(int(x.shape[0]), c=c, t=t, capacity=capacity,
                             packed_pos=packed_pos,
                             summary_dtype=summary_dtype)
        backend = px.resolve_backend(backend, dev)
        h = px.build_hierarchy_with_backend(
            x, plan, with_positions=with_positions, backend=backend)
        return RMQ(hierarchy=h, backend=backend, length=plan.n)

    @staticmethod
    def build_out_of_core(
        source,
        n: int,
        c: int = 128,
        t: int = 64,
        with_positions: bool = False,
        capacity: Optional[int] = None,
        segment_size: Optional[int] = None,
        packed_pos: Optional[bool] = None,
        summary_dtype: Optional[str] = None,
        backend: str = "eager",
        device=None,
    ) -> "RMQ":
        """Build by streaming slabs of ``segment_size`` through the fused
        build (one B1 launch a slab on a card).

        ``source`` is a callable ``source(start, stop) -> values``, or a
        sliceable array (numpy array or memmap, tensor), of logical
        length ``n``.  Position builds past 2^31 get an int64 plane.
        Bit-identical to :meth:`build`.  ``backend`` picks the query
        lowering of the index: ``"eager"`` by default, the one walk whose
        coordinates are exact past 2^31 (the kernels refuse such
        extents).
        """
        dev = resolve_device(device)
        plan = make_plan(n, c=c, t=t, capacity=capacity,
                         packed_pos=packed_pos, summary_dtype=summary_dtype)
        from repro_torch.kernels.hierarchy_fused.ops import (
            build_hierarchy_streamed,
        )

        h = build_hierarchy_streamed(source, plan,
                                     with_positions=with_positions,
                                     segment_size=segment_size, device=dev)
        return RMQ(hierarchy=h, backend=px.resolve_backend(backend, dev),
                   length=n)

    # -- incremental maintenance ------------------------------------------
    def update(self, idxs, vals) -> "RMQ":
        """Batched point updates ``a[idxs] = vals`` (last wins on dups),
        one chunk re-reduction per level per distinct index."""
        idxs, vals = px.validate_update_batch(idxs, vals, n=self.n)
        if idxs.shape[0] == 0:
            return self
        h = px.dispatch_update(self.hierarchy, idxs, vals, self.backend)
        return dataclasses.replace(
            self, hierarchy=h, generation=self.generation + 1)

    def append(self, vals) -> "RMQ":
        """Grow the array with ``vals`` inside the reserved capacity."""
        vals = px.validate_append_batch(
            vals, length=self.n, capacity=self.plan.capacity)
        b = int(vals.shape[0])
        if b == 0:
            return self
        h = px.dispatch_append(self.hierarchy, vals, self.n, self.backend)
        return dataclasses.replace(
            self, hierarchy=h, length=self.n + b,
            generation=self.generation + 1)

    # -- queries ----------------------------------------------------------
    def _bounds(self, ls, rs):
        ls, rs = check_query_args(ls, rs, self.n, device=self.device)
        coord = pos_dtype_for(self.capacity)
        return ls.to(coord), rs.to(coord)

    def query(self, ls, rs) -> torch.Tensor:
        """Batched ``RMQ_value`` over inclusive ranges."""
        ls, rs = self._bounds(ls, rs)
        return px.dispatch_query_value(self.hierarchy, ls, rs, self.backend)

    def query_index(self, ls, rs) -> torch.Tensor:
        """Batched ``RMQ_index`` (leftmost minimum) over inclusive ranges."""
        if not self.with_positions:
            raise ValueError(
                "index was built without positions; "
                "use RMQ.build(..., with_positions=True)")
        ls, rs = self._bounds(ls, rs)
        return px.dispatch_query_index(self.hierarchy, ls, rs, self.backend)

    # protocol spellings (RMQIndex): same entry points, canonical names
    query_value_batch = query
    query_index_batch = query_index

    # -- adaptive batched engine --------------------------------------------
    def engine(self, **kwargs):
        """A span-routed :class:`repro_torch.qe.QueryEngine` over this
        index; ``engine.attach(successor)`` after ``update`` / ``append``."""
        return px.make_engine(self, **kwargs)

    # -- introspection ----------------------------------------------------
    @property
    def n(self) -> int:
        """Live array length (grows with ``append``)."""
        return self.plan.n if self.length is None else self.length

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

    def auxiliary_bytes(self) -> int:
        return self.hierarchy.auxiliary_bytes()
