"""The port's device mesh: named axes over one card or a process group.

The port of ``repro.launch.mesh``.  A :class:`Mesh` holds the axis names
and sizes (``mesh.shape["model"]``, as on a JAX mesh), the process's
device (the card unless the caller passes ``device="cpu"``) and an
optional ``torch.distributed`` process group.

* Without a group one process holds every mesh position on its one
  device, as the reference's CPU tests hold 8 fake CPU devices: a
  :class:`repro_torch.core.distributed.DistributedRMQ` keeps all its
  segments here and combines them without a collective.
* With a group of world size ``W`` (which must divide the segment axis),
  rank ``r`` owns the ``r``-th contiguous block of ``S / W`` segments and
  the combine calls the group.
* With a group of one rank a mesh position (world size = the mesh's
  size), each rank has coordinates on the axes, row-major with the last
  axis fastest (rank = d * M + m on ``("data", "model")``), and one
  subgroup per axis: the ranks that differ from it only on that axis.
  :mod:`repro_torch.distributed.sharded` gathers and reduces over these.

Building a mesh touches no device and starts no process; the caller
creates the group (``torch.distributed.init_process_group``) and passes
it, and every rank builds the same mesh, since the subgroups are made by
every rank (``torch.distributed.new_group``).
:func:`make_production_mesh` gives the reference's production shapes on
the meta device: one H100 holds none of their positions.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["Mesh", "make_production_mesh", "make_test_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes, this process's device and its process group."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device
    group: Optional[Any] = None  # a torch.distributed ProcessGroup
    # {axis: this rank's subgroup on it}, with one rank a position
    axis_groups: Optional[Dict[str, Any]] = dataclasses.field(
        default=None, compare=False, repr=False)

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
    def size(self) -> int:
        """The number of mesh positions."""
        return math.prod(self.axis_sizes)

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

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis, with one rank a position
        (zeros on a one-position mesh without a group)."""
        if self.world != self.size:
            raise ValueError(
                f"coordinates need one rank a mesh position: {self.world} "
                f"ranks on a mesh of {self.size}")
        return dict(zip(self.axis_names, _unravel(self.rank,
                                                  self.axis_sizes)))

    def axis_group(self, axis: str):
        """The subgroup of the ranks that differ from this one only on
        ``axis`` (None without a group)."""
        if self.group is None:
            return None
        if self.axis_groups is None:
            raise ValueError(
                f"a mesh of {self.size} positions over {self.world} ranks "
                "has no axis subgroups (one rank a position makes them)")
        return self.axis_groups[axis]


def _unravel(rank: int, sizes: Sequence[int]) -> List[int]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return out[::-1]


def _ravel(coords: Sequence[int], sizes: Sequence[int]) -> int:
    rank = 0
    for c, s in zip(coords, sizes):
        rank = rank * s + c
    return rank


def _axis_groups(sizes: Tuple[int, ...], names: Tuple[str, ...],
                 group) -> Dict[str, Any]:
    """``{axis: subgroup}`` for this rank.  Every rank makes every
    subgroup, in the same order, as ``new_group`` requires."""
    import torch.distributed as dist

    me = dist.get_rank(group)
    ranks = [dist.get_global_rank(group, r) for r in range(math.prod(sizes))]
    mine = {}
    for i, axis in enumerate(names):
        others = [range(s) for j, s in enumerate(sizes) if j != i]
        for rest in itertools.product(*others):
            members = [_ravel(rest[:i] + (c,) + rest[i:], sizes)
                       for c in range(sizes[i])]
            sub = dist.new_group([ranks[r] for r in members])
            if me in members:
                mine[axis] = sub
    return mine


def make_test_mesh(shape=(2, 4), axes=("data", "model"), device=None,
                   group=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` (the reference's test mesh by
    default) on ``device`` (``None``: the card; no card raises), calling
    ``group`` in its collectives.  With one rank of ``group`` a position
    every rank makes the axis subgroups here."""
    import torch.distributed as dist

    from repro_torch.core.api import resolve_device

    names, sizes = tuple(axes), tuple(int(s) for s in shape)
    subgroups = None
    if group is not None and dist.get_world_size(group) == math.prod(sizes):
        subgroups = _axis_groups(sizes, names, group)
    return Mesh(names, sizes, resolve_device(device), group, subgroups)


def make_production_mesh(*, multi_pod: bool = False,
                         num_pods: int = 2) -> Mesh:
    """The reference's production mesh on the meta device, with no group:
    ``(16, 16)`` over ``("data", "model")``, or ``(num_pods, 16, 16)``
    over ``("pod", "data", "model")``.  ``pod`` and ``data`` carry data
    parallelism and FSDP weight sharding, ``model`` tensor, sequence and
    expert parallelism; the shardings read its axes only."""
    shape = (num_pods, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, torch.device("meta"))
