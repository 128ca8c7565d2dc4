"""The index protocol, backend selection, coercion, dispatch, validation.

The port of ``repro.core.protocol``: the read surface every index speaks
(:class:`RMQIndex`), the optional mutation surface
(:class:`MutableRMQIndex`), and the plumbing the indexes share.  Backend
names:

=========  ==================================================  ==========
``eager``  the plain PyTorch build and walk                    ref ``jax``
``cuda``   per-level build (B3) + per-plane query scan (B4)    ``pallas``
``fused``  one-launch build (B1) + one-launch batch (B2)       ``fused``
=========  ==================================================  ==========

``"auto"`` resolves to ``"cuda"`` on a CUDA device and to ``"eager"`` on
the CPU, as the reference resolves to ``"jax"`` off the TPU.  The kernel
backends also run on the CPU: each wrapper takes its plain version for a
CPU tensor, which is how the CPU tests reach them.

Mutations (:func:`mutation_backend`): ``cuda`` updates through the
per-level re-reduction kernel (B6); ``fused`` has no one-launch update
and mutates through ``cuda`` on a card and ``eager`` on the CPU, as the
reference's ``fused`` mutates through its platform default.  The
validators' error text is the reference's, byte for byte.
:func:`is_distributed` reads the ``distributed`` attribute that
:class:`repro_torch.core.distributed.DistributedRMQ` sets, and
:func:`make_engine` gives such an index the engine's segment routing.
"""

from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.hierarchy import (
    VALUE_DTYPES,
    Hierarchy,
    build_hierarchy,
    build_many,
)
from repro_torch.core.plan import HierarchyPlan
from repro_torch.core.query import _debug_checks_enabled, _is_integer
from repro_torch.obs import trace

__all__ = [
    "BACKENDS",
    "MutableRMQIndex",
    "RMQIndex",
    "build_hierarchy_with_backend",
    "build_many",
    "capacity_limit_message",
    "check_capacity_limit",
    "coerce_values",
    "dispatch_append",
    "dispatch_query_index",
    "dispatch_query_value",
    "dispatch_update",
    "is_distributed",
    "kernel_index_extent",
    "live_length",
    "make_engine",
    "mutation_backend",
    "resolve_backend",
    "runtime_backend",
    "supports_mutation",
    "validate_append_batch",
    "validate_update_batch",
]

BACKENDS = ("eager", "cuda", "fused")


def capacity_limit_message(capacity: int) -> str:
    """The one error text of every int32 index-space guard of the port."""
    return (
        f"capacity {capacity} exceeds the int32 index space of the CUDA "
        "kernels; capacities >= 2**31 need the int64-coordinate plain path "
        "(backend='eager')"
    )


def check_capacity_limit(extent: int) -> None:
    """Refuse an index extent past int32, at the kernels' strict sites."""
    if extent >= 2**31:
        raise ValueError(capacity_limit_message(extent))


def kernel_index_extent(plan: HierarchyPlan) -> int:
    """The largest level-0 coordinate a kernel forms for this plan: the
    capacity rounded up to whole chunks once there are upper levels."""
    if plan.num_levels == 1:
        return plan.capacity
    return plan.padded_lens[0] * plan.c


@runtime_checkable
class RMQIndex(Protocol):
    """Read surface shared by every index: static ``plan``, live
    ``length``, a ``generation`` that every mutation bumps (the engine's
    cache key) and the two batched query entry points."""

    backend: str

    @property
    def plan(self) -> HierarchyPlan: ...

    @property
    def length(self) -> Optional[int]: ...

    @property
    def generation(self) -> int: ...

    @property
    def value_dtype(self): ...

    @property
    def capacity(self) -> int: ...

    @property
    def with_positions(self) -> bool: ...

    def query_value_batch(self, ls, rs) -> torch.Tensor: ...

    def query_index_batch(self, ls, rs) -> torch.Tensor: ...


@runtime_checkable
class MutableRMQIndex(RMQIndex, Protocol):
    """Optional mutation surface: both mutators return a successor with
    ``generation + 1`` and leave the receiver as it was."""

    def update(self, idxs, vals) -> "MutableRMQIndex": ...

    def append(self, vals) -> "MutableRMQIndex": ...


def supports_mutation(index) -> bool:
    """Does ``index`` expose the ``update`` / ``append`` capability?"""
    return isinstance(index, MutableRMQIndex)


def is_distributed(index) -> bool:
    """Is ``index`` segment-sharded?  The engine routes such an index
    through :class:`repro_torch.qe.DistributedExecutor`."""
    return bool(getattr(index, "distributed", False))


def live_length(index) -> int:
    """The live element count of an index (``length``, else ``n``)."""
    length = getattr(index, "length", None)
    if length is not None:
        return int(length)
    n = getattr(index, "n", None)
    if n is not None:
        return int(n)
    return int(index.plan.n)


def resolve_backend(backend: str, device) -> str:
    """Normalize a backend name; ``"auto"`` follows the device."""
    if backend == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "eager"
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of "
            f"{('auto',) + BACKENDS}")
    return backend


def runtime_backend(backend: str) -> str:
    """The query lowering behind a resolved backend name (itself: every
    backend has a query path of its own)."""
    return backend


def mutation_backend(backend: str, device) -> str:
    """The update / append lowering behind a resolved backend name:
    ``fused`` mutates through ``cuda`` on a card, ``eager`` on the CPU."""
    if backend == "fused":
        return resolve_backend("auto", device)
    return backend


def coerce_values(x, device) -> torch.Tensor:
    """The input as a contiguous 1-D float32/bfloat16/float64 tensor on
    ``device``.

    Other real dtypes, float16 included, become float32 (exactly, for
    float16), as in the reference.  bfloat16 stays bfloat16: the index
    keeps a bf16 level 0 and bf16 upper levels, and the kernels read and
    write them as 2-byte values (comparing them widened to float32, which
    is exact), as the reference keeps bf16 through its kernels.

    NaN is accepted and is the least value, as ``torch.argmin`` has it: a
    chunk or a span that holds a NaN answers its leftmost NaN, with that
    entry's own bits as the value and its index as the position, on every
    path (plain and kernels alike).  Nothing scans the input for NaN (that
    would cost a pass over it and a read-back).  Subnormals are kept as
    they are, never flushed to zero.
    """
    x = torch.as_tensor(x)
    if x.ndim != 1:
        raise ValueError(f"input must be rank-1, got shape {tuple(x.shape)}")
    if x.dtype not in VALUE_DTYPES:
        x = x.to(torch.float32)
    return x.to(device).contiguous()


def build_hierarchy_with_backend(
    x: torch.Tensor, plan: HierarchyPlan, with_positions: bool, backend: str
) -> Hierarchy:
    """The one construction entry point; every backend gives a
    bit-identical hierarchy (values, leftmost positions, padding).

    Compact layouts (``plan.packed_pos`` / ``plan.summary_dtype``) apply
    on every backend: the plain build makes them natively, the kernel
    builds (B1, B3) make the classic planes and their wrappers go through
    :func:`repro_torch.core.hierarchy.finalize_compact`, as the reference
    routes its Pallas builds.  Each build refuses a compact plan that
    could not answer exactly (``check_compact_build``).
    """
    if backend == "fused":
        from repro_torch.kernels.hierarchy_fused import ops as fused_ops

        return fused_ops.build_hierarchy_fused(x, plan, with_positions)
    if backend == "cuda":
        from repro_torch.kernels.hierarchy_build import ops as build_ops

        return build_ops.build_hierarchy_percall(x, plan, with_positions)
    if backend == "eager":
        return build_hierarchy(x, plan, with_positions)
    raise ValueError(f"unknown backend {backend!r}")


def _run_dispatch(kind: str, backend: str, fn, *args):
    # a guarded span: with tracing off this is one global load
    tr = trace.current()
    if tr is None:
        return fn(*args)
    sp = tr.begin("dispatch")
    out = fn(*args)
    tr.end(sp, kind=kind, backend=backend)
    return out


def dispatch_query_value(h: Hierarchy, ls, rs, backend: str) -> torch.Tensor:
    """Batched ``RMQ_value`` through the chosen backend."""
    if backend == "fused":
        from repro_torch.kernels.rmq_fused import ops as fused_ops

        fn = fused_ops.rmq_fused_value_batch
    elif backend == "cuda":
        from repro_torch.kernels.rmq_scan import ops as scan_ops

        fn = scan_ops.rmq_value_batch_cuda
    else:
        from repro_torch.core.query import rmq_value_batch

        fn = rmq_value_batch
    return _run_dispatch("query_value", backend, fn, h, ls, rs)


def dispatch_query_index(h: Hierarchy, ls, rs, backend: str) -> torch.Tensor:
    """Batched ``RMQ_index`` (leftmost minimum) through the chosen backend."""
    if backend == "fused":
        from repro_torch.kernels.rmq_fused import ops as fused_ops

        fn = fused_ops.rmq_fused_index_batch
    elif backend == "cuda":
        from repro_torch.kernels.rmq_scan import ops as scan_ops

        fn = scan_ops.rmq_index_batch_cuda
    else:
        from repro_torch.core.query import rmq_index_batch

        fn = rmq_index_batch
    return _run_dispatch("query_index", backend, fn, h, ls, rs)


def dispatch_update(h: Hierarchy, idxs, vals, backend: str) -> Hierarchy:
    """Batched point updates through the mutation lowering."""
    backend = mutation_backend(backend, h.device)
    if backend == "cuda":
        from repro_torch.kernels.hierarchy_update import ops as upd_ops

        fn = upd_ops.update_hierarchy_cuda
    else:
        from repro_torch.streaming import updates as U

        fn = U.update_hierarchy
    return _run_dispatch("update", backend, fn, h, idxs, vals)


def dispatch_append(h: Hierarchy, vals, start: int,
                    backend: str) -> Hierarchy:
    """Append at live offset ``start`` through the mutation lowering."""
    backend = mutation_backend(backend, h.device)
    if backend == "cuda":
        from repro_torch.kernels.hierarchy_update import ops as upd_ops

        fn = upd_ops.append_hierarchy_cuda
    else:
        from repro_torch.streaming import updates as U

        fn = U.append_hierarchy
    return _run_dispatch("append", backend, fn, h, vals, start)


def _dtype_name(dtype: torch.dtype) -> str:
    """A dtype as the reference's messages spell it (``float32``)."""
    return str(dtype).replace("torch.", "")


def _shape(t) -> tuple:
    return tuple(int(d) for d in t.shape)


def validate_update_batch(idxs, vals, n: Optional[int] = None):
    """Shared ``idxs`` / ``vals`` checking for every ``update``.

    Out-of-range indices are dropped in normal operation; in debug mode
    (``REPRO_RMQ_DEBUG=1``) they are refused against the live length
    ``n``, which reads the batch back from the device.  Returns both as
    tensors.
    """
    idxs = torch.as_tensor(idxs)
    vals = torch.as_tensor(vals)
    if idxs.ndim != 1 or idxs.shape != vals.shape:
        raise ValueError(
            f"idxs/vals must be matching 1-D batches, got "
            f"{_shape(idxs)} vs {_shape(vals)}")
    if not _is_integer(idxs.dtype):
        raise TypeError(
            f"idxs must be integers, got {_dtype_name(idxs.dtype)}")
    if n is not None and _debug_checks_enabled():
        i_np = idxs.cpu().numpy()
        bad = (i_np < 0) | (i_np >= n)
        if bad.any():
            j = int(np.argmax(bad))
            raise ValueError(
                f"update index {j} = {i_np.flat[j]} out of range for "
                f"live length {n}")
    return idxs, vals


def validate_append_batch(vals, length: int, capacity: int) -> torch.Tensor:
    """Shared ``vals`` checking for every ``append``: 1-D, and no growth
    past the reserved capacity (that would need a new plan)."""
    vals = torch.as_tensor(vals)
    if vals.ndim != 1:
        raise ValueError(f"vals must be 1-D, got shape {_shape(vals)}")
    b = int(vals.shape[0])
    if length + b > capacity:
        raise ValueError(
            f"append of {b} overflows capacity {capacity} (live length "
            f"{length}); build with a larger capacity reservation")
    return vals


def make_engine(index, **kwargs):
    """A :class:`repro_torch.qe.QueryEngine` over ``index``, routed by
    span class (by segment containment for a distributed index);
    re-attach it (``engine.attach``) after every mutation."""
    from repro_torch.qe import QueryEngine

    return QueryEngine.for_index(index, **kwargs)
