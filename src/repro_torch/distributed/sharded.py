"""Sharded trees over a mesh: each rank's blocks, gathers and reductions.

The port's stand-in for what GSPMD does with the reference's
``NamedSharding``s: plain tensors and explicit ``torch.distributed``
collectives on the mesh's axis subgroups
(:meth:`repro_torch.launch.mesh.Mesh.axis_group`), so every kernel of
the model (B8 and B9 are ``autograd.Function``s) still receives plain
tensors.

* :func:`local_blocks` slices each rank's block of every leaf by its spec:
  a dimension whose entry names axes ``(a1, a2, ...)`` is cut into
  ``|a1| * |a2| * ...`` blocks, ``a1`` slowest, as JAX cuts it.
* :func:`gather` rebuilds every whole leaf from the blocks: one
  ``all_gather`` a sharded axis, the last axis of an entry first.  An
  axis of size 1 holds the whole dimension and moves nothing.
* :func:`reduce_grads` takes the mean of float32 gradients, loss and aux
  loss over the batch's axes: an ``all_reduce`` (sum) a leaf on the
  subgroup of each axis of size > 1, then a division.  Every rank then
  holds the whole reduced gradients (no reduce-scatter).

* :func:`all_reduce_sum` and :func:`all_gather_rows` are the MoE's
  calls over the data axes (:mod:`repro_torch.models.moe`).

A mesh with one rank a position is required; without a mesh or a group
(one process) every leaf is whole and nothing is called.
Each collective call counts in :data:`COLLECTIVES` once it returns.

:func:`simulate` runs these functions on a mesh with no group (the meta
production mesh of :mod:`repro_torch.launch.cells`) as rank 0 of it
would: blocks are cut at rank 0's coordinates, a gather returns an empty
tensor of the whole shape, a reduction returns its input, and each call
adds the bytes it would move to a log by kind (an all-gather its result,
an all-reduce its operand).  Nothing is called and nothing counts.
"""

from __future__ import annotations

import contextlib
import math
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.shardings import PartitionSpec, entry_axes
from repro_torch.kernels.profiling import KernelCounter
from repro_torch.train.tree import tree_map

__all__ = ["COLLECTIVES", "all_gather_rows", "all_reduce_sum", "barrier",
           "coordinate", "data_axes", "gather", "gather_leaf", "leaf_spec",
           "local_block", "local_blocks", "reduce_grads", "simulate"]

COLLECTIVES = KernelCounter("collectives")

# (mesh, {kind: bytes}) while simulate(mesh) runs
_SIMULATED: Optional[Tuple[Any, Dict[str, float]]] = None


@contextlib.contextmanager
def simulate(mesh) -> Iterator[Dict[str, float]]:
    """Collectives on ``mesh`` (a mesh with no group) simulated as rank 0
    would make them; yields ``{kind: bytes}`` of the calls (see the module
    doc)."""
    global _SIMULATED
    if mesh.group is not None:
        raise ValueError("simulate() takes a mesh with no process group")
    prev, log = _SIMULATED, defaultdict(float)
    _SIMULATED = (mesh, log)
    try:
        yield log
    finally:
        _SIMULATED = prev


def _simulated(mesh) -> bool:
    return _SIMULATED is not None and _SIMULATED[0] is mesh


def _record(kind: str, t: torch.Tensor) -> None:
    _SIMULATED[1][kind] += t.numel() * t.element_size()


def _active(mesh) -> bool:
    """Whether collectives on ``mesh`` run (or are simulated)."""
    return mesh is not None and (mesh.group is not None or _simulated(mesh))


def _coords(mesh) -> Dict[str, int]:
    if _simulated(mesh):
        return {a: 0 for a in mesh.axis_names}
    return mesh.coords


def data_axes(mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    """The axes of ``axes`` of size > 1 on which collectives run: none
    without a mesh or a group (and outside :func:`simulate`)."""
    if not _active(mesh):
        return ()
    return tuple(a for a in axes if mesh.shape[a] > 1)


def _dist():
    import torch.distributed as dist

    return dist


def leaf_spec(spec: Sequence, leaf) -> PartitionSpec:
    """The spec of the stored leaf: a per-layer leaf's stacked spec
    without its layer-axis entry.  The port stores its layers as a list,
    so a spec that shards the layer axis cannot be stored."""
    spec = PartitionSpec(*spec)
    if len(spec) == leaf.dim() + 1:
        if spec[0] is not None:
            raise ValueError(
                f"the spec {spec} shards the stacked layer axis (the fsdp "
                "layout's largest-dimension rule); the port keeps its "
                "layers as a list of per-layer leaves and trains with the "
                "tp_sp layout")
        spec = PartitionSpec(*spec[1:])
    if len(spec) > leaf.dim():
        raise ValueError(f"the spec {spec} has more entries than the leaf "
                         f"of shape {tuple(leaf.shape)} has dimensions")
    return spec


def _blocks(mesh, entry) -> Tuple[int, int]:
    """``(this rank's block index, the number of blocks)`` of one entry."""
    index, count = 0, 1
    coords = _coords(mesh)
    for a in entry_axes(entry):
        index = index * mesh.shape[a] + coords[a]
        count *= mesh.shape[a]
    return index, count


def local_block(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``t``: a copy where a dimension
    is cut, ``t`` itself where none is."""
    spec = leaf_spec(spec, t)
    out = t
    for dim, entry in enumerate(spec):
        index, count = _blocks(mesh, entry)
        if count == 1:
            continue
        if t.shape[dim] % count:
            raise ValueError(
                f"{count} blocks do not divide dimension {dim} of a leaf of "
                f"shape {tuple(t.shape)} (spec {spec})")
        per = t.shape[dim] // count
        out = out.narrow(dim, index * per, per)
    return out if out is t else out.clone()


def local_blocks(tree: Any, specs: Any, mesh) -> Any:
    """Every leaf's block on this rank (see :func:`local_block`); ``tree``
    itself without a mesh or a group."""
    if not _active(mesh):
        return tree
    return tree_map(lambda t, s: local_block(t, s, mesh), tree, specs)


def _all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``(n * x.shape[0], ...)``: the blocks ``x`` of the ``n`` ranks on
    ``axis``, in coordinate order."""
    out = x.new_empty((mesh.shape[axis] * x.shape[0],) + tuple(x.shape[1:]))
    if _simulated(mesh):
        _record("all-gather", out)
        return out
    dist = _dist()
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=mesh.axis_group(axis))
    COLLECTIVES.hit()
    return out


def _all_reduce(t: torch.Tensor, mesh, axis: str) -> None:
    """Sum ``t`` in place over the ranks on ``axis``."""
    if _simulated(mesh):
        _record("all-reduce", t)
        return
    _dist().all_reduce(t, group=mesh.axis_group(axis))
    COLLECTIVES.hit()


def all_reduce_sum(t: torch.Tensor, mesh, axes: Sequence[str]
                   ) -> torch.Tensor:
    """``t`` summed in place over the ranks that differ from this one on
    ``axes`` (each of size > 1: see :func:`data_axes`); one call an axis."""
    for a in axes:
        _all_reduce(t, mesh, a)
    return t


def all_gather_rows(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``(n, *t.shape)``: ``t`` of each of the ``n`` ranks on ``axis``, in
    coordinate order (one call)."""
    return _all_gather(t.reshape(1, *t.shape).contiguous(), mesh, axis)


def coordinate(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 under :func:`simulate`)."""
    return _coords(mesh)[axis]


def gather_leaf(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block ``t`` (``t`` itself where no
    axis of its spec has a size > 1)."""
    spec = leaf_spec(spec, t)
    for dim, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            n = mesh.shape[a]
            if n == 1:
                continue
            out = _all_gather(t.movedim(dim, 0).contiguous(), mesh, a)
            t = out.movedim(0, dim).contiguous()
    return t


def gather(tree: Any, specs: Any, mesh) -> Any:
    """The whole leaves from every rank's blocks (a leaf held whole is
    returned as it is); ``tree`` itself without a mesh or a group."""
    if not _active(mesh):
        return tree
    return tree_map(lambda t, s: gather_leaf(t, s, mesh), tree, specs)


def reduce_grads(grads: Sequence[torch.Tensor], loss: torch.Tensor,
                 aux: torch.Tensor, mesh, axes: Sequence[str]):
    """The mean over the ranks that share this rank's coordinates off
    ``axes`` (the axes the batch's rows are split over): each float32
    gradient in place, and ``(loss, aux)`` as new tensors.  Returns
    ``(grads, loss, aux)``; an axis of size 1 calls nothing."""
    axes = data_axes(mesh, axes)
    if not axes:
        return grads, loss, aux
    pair = torch.stack([loss.float(), aux.float()])
    n = math.prod(mesh.shape[a] for a in axes)
    for a in axes:
        for g in grads:
            _all_reduce(g, mesh, a)
        _all_reduce(pair, mesh, a)
    for g in grads:
        g.div_(n)
    pair = pair / n
    return grads, pair[0], pair[1]


def barrier(mesh) -> None:
    """Wait for every rank of the mesh's group (nothing without one)."""
    if mesh.group is None:
        return
    _dist().barrier(group=mesh.group)
    COLLECTIVES.hit()
