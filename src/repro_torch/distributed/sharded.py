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

A mesh with one rank a position is required; without a mesh or a group
(one process) every leaf is whole and nothing is called.
Each collective call counts in :data:`COLLECTIVES` once it returns.
"""

from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

import torch

from repro_torch.distributed.shardings import PartitionSpec, entry_axes
from repro_torch.kernels.profiling import KernelCounter
from repro_torch.train.tree import tree_map

__all__ = ["COLLECTIVES", "barrier", "gather", "gather_leaf", "leaf_spec",
           "local_block", "local_blocks", "reduce_grads"]

COLLECTIVES = KernelCounter("collectives")


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
    coords = mesh.coords
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
    if mesh is None or mesh.group is None:
        return tree
    return tree_map(lambda t, s: local_block(t, s, mesh), tree, specs)


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    dist = _dist()
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)
    COLLECTIVES.hit()


def gather_leaf(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block ``t`` (``t`` itself where no
    axis of its spec has a size > 1)."""
    spec = leaf_spec(spec, t)
    for dim, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            n = mesh.shape[a]
            if n == 1:
                continue
            x = t.movedim(dim, 0).contiguous()
            out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            _all_gather(out, x, mesh.axis_group(a))
            t = out.movedim(0, dim).contiguous()
    return t


def gather(tree: Any, specs: Any, mesh) -> Any:
    """The whole leaves from every rank's blocks (a leaf held whole is
    returned as it is); ``tree`` itself without a mesh or a group."""
    if mesh is None or mesh.group is None:
        return tree
    return tree_map(lambda t, s: gather_leaf(t, s, mesh), tree, specs)


def reduce_grads(grads: Sequence[torch.Tensor], loss: torch.Tensor,
                 aux: torch.Tensor, mesh, axes: Sequence[str]):
    """The mean over the ranks that share this rank's coordinates off
    ``axes`` (the axes the batch's rows are split over): each float32
    gradient in place, and ``(loss, aux)`` as new tensors.  Returns
    ``(grads, loss, aux)``; an axis of size 1 calls nothing."""
    if mesh is None or mesh.group is None:
        return grads, loss, aux
    axes = [a for a in axes if mesh.shape[a] > 1]
    if not axes:
        return grads, loss, aux
    dist = _dist()
    pair = torch.stack([loss.float(), aux.float()])
    n = math.prod(mesh.shape[a] for a in axes)
    for a in axes:
        group = mesh.axis_group(a)
        for g in grads:
            dist.all_reduce(g, group=group)
            COLLECTIVES.hit()
        dist.all_reduce(pair, group=group)
        COLLECTIVES.hit()
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
