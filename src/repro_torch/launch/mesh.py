"""The port's device mesh: named axes over one card or a process group.

The port of ``repro.launch.mesh``'s ``make_test_mesh``.  A :class:`Mesh`
holds the axis names and sizes (``mesh.shape["model"]``, as on a JAX
mesh), the process's device (the card unless the caller passes
``device="cpu"``) and an optional ``torch.distributed`` process group.

* Without a group one process holds every mesh position on its one
  device, as the reference's CPU tests hold 8 fake CPU devices: a
  :class:`repro_torch.core.distributed.DistributedRMQ` keeps all its
  segments here and combines them without a collective.
* With a group of world size ``W`` (which must divide the segment axis),
  rank ``r`` owns the ``r``-th contiguous block of ``S / W`` segments and
  the combine calls the group.

Building a mesh touches no device and starts no process; the caller
creates the group (``torch.distributed.init_process_group``) and passes
it.  ``make_production_mesh`` (the dry run's 256- and 512-chip meshes)
belongs to ROADMAP A10b.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["Mesh", "make_test_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes, this process's device and its process group."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device
    group: Optional[Any] = None  # a torch.distributed ProcessGroup

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(
                f"axis names {self.axis_names} and sizes {self.axis_sizes} "
                "differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        if any(s < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1: {self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, in axis order."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def rank(self) -> int:
        """This process's rank in the group (0 without one)."""
        if self.group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)

    @property
    def world(self) -> int:
        """The group's size (1 without one)."""
        if self.group is None:
            return 1
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    def local_block(self, axis: str) -> Tuple[int, int]:
        """``[lo, hi)``: the positions on ``axis`` this process owns, a
        contiguous block of ``size / world``."""
        size, world = self.shape[axis], self.world
        if size % world:
            raise ValueError(
                f"a group of {world} processes does not divide the "
                f"{axis!r} axis of size {size}")
        per = size // world
        return self.rank * per, (self.rank + 1) * per


def make_test_mesh(shape=(2, 4), axes=("data", "model"), device=None,
                   group=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` (the reference's test mesh by
    default) on ``device`` (``None``: the card; no card raises), calling
    ``group`` in its collectives."""
    from repro_torch.core.api import resolve_device

    return Mesh(tuple(axes), tuple(int(s) for s in shape),
                resolve_device(device), group)
