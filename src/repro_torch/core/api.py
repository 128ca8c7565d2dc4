"""User-facing RMQ facade of the port: build on a device, query in batches.

``RMQ.build(x, device=None)`` builds on the card (``device=None`` means
``"cuda"``, and with no card it raises rather than building on the CPU);
pass ``device="cpu"`` for the plain PyTorch path on the host.
``backend`` picks the lowering (see :mod:`repro_torch.core.protocol`):
``"fused"`` (one launch per build and per batch), ``"cuda"`` (one launch
per level and per output plane), ``"eager"`` (plain PyTorch), or
``"auto"`` (``"cuda"`` on a card, ``"eager"`` on the CPU).  Every
backend gives bit-identical hierarchies and answers.

Not ported yet: ``update`` / ``append`` (ROADMAP A4), ``engine`` (A6) and
``build_out_of_core`` (A3).
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
    """A built range-minimum index (paper §4)."""

    hierarchy: Hierarchy
    backend: str
    # Live length; None means "the build length" (plan.n).
    length: Optional[int] = None

    @staticmethod
    def build(
        x,
        c: int = 128,
        t: int = 64,
        with_positions: bool = False,
        backend: str = "auto",
        plan: Optional[HierarchyPlan] = None,
        capacity: Optional[int] = None,
        device=None,
    ) -> "RMQ":
        """Build over ``x``; ``capacity > len(x)`` reserves an +inf tail."""
        dev = resolve_device(device)
        x = px.coerce_values(x, dev)
        if plan is not None and capacity is not None:
            raise ValueError(
                "pass capacity via make_plan(..., capacity=...) when "
                "supplying an explicit plan")
        if plan is None:
            plan = make_plan(int(x.shape[0]), c=c, t=t, capacity=capacity)
        backend = px.resolve_backend(backend, dev)
        h = px.build_hierarchy_with_backend(
            x, plan, with_positions=with_positions, backend=backend)
        return RMQ(hierarchy=h, backend=backend, length=plan.n)

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

    # -- introspection ----------------------------------------------------
    @property
    def n(self) -> int:
        """Live array length."""
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
