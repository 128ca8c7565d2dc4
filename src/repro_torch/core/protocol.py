"""Backend selection, input coercion and dispatch behind the facade.

The port's subset of ``repro.core.protocol``: what ``RMQ`` needs to
build and query.  Backend names:

=========  ==================================================  ==========
``eager``  the plain PyTorch build and walk                    ref ``jax``
``cuda``   per-level build (B3) + per-plane query scan (B4)    ``pallas``
``fused``  one-launch build (B1) + one-launch batch (B2)       ``fused``
=========  ==================================================  ==========

``"auto"`` resolves to ``"cuda"`` on a CUDA device and to ``"eager"`` on
the CPU, as the reference resolves to ``"jax"`` off the TPU.  The kernel
backends also run on the CPU: each wrapper takes its plain version for a
CPU tensor, which is how the CPU tests reach them.
"""

from __future__ import annotations

import torch

from repro_torch.core.hierarchy import Hierarchy, build_hierarchy
from repro_torch.core.plan import HierarchyPlan

__all__ = [
    "BACKENDS",
    "build_hierarchy_with_backend",
    "capacity_limit_message",
    "check_capacity_limit",
    "coerce_values",
    "dispatch_query_index",
    "dispatch_query_value",
    "kernel_index_extent",
    "live_length",
    "resolve_backend",
]

BACKENDS = ("eager", "cuda", "fused")
_VALUE_DTYPES = (torch.float32, torch.float64)


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


def coerce_values(x, device) -> torch.Tensor:
    """The input as a contiguous 1-D float32/float64 tensor on ``device``.

    Other real dtypes become float32, as in the reference.  bfloat16
    (and float16) inputs are refused: the port has no bf16 path yet
    (ROADMAP).
    """
    x = torch.as_tensor(x)
    if x.ndim != 1:
        raise ValueError(f"input must be rank-1, got shape {tuple(x.shape)}")
    if x.dtype in (torch.bfloat16, torch.float16):
        raise TypeError(
            f"{x.dtype} inputs are not supported by the port yet; pass "
            "float32 or float64 values")
    if x.dtype not in _VALUE_DTYPES:
        x = x.to(torch.float32)
    return x.to(device).contiguous()


def build_hierarchy_with_backend(
    x: torch.Tensor, plan: HierarchyPlan, with_positions: bool, backend: str
) -> Hierarchy:
    """The one construction entry point; every backend gives a
    bit-identical hierarchy (values, leftmost positions, padding)."""
    if backend == "fused":
        from repro_torch.kernels.hierarchy_fused import ops as fused_ops

        return fused_ops.build_hierarchy_fused(x, plan, with_positions)
    if backend == "cuda":
        from repro_torch.kernels.hierarchy_build import ops as build_ops

        return build_ops.build_hierarchy_percall(x, plan, with_positions)
    if backend == "eager":
        return build_hierarchy(x, plan, with_positions)
    raise ValueError(f"unknown backend {backend!r}")


def dispatch_query_value(h: Hierarchy, ls, rs, backend: str) -> torch.Tensor:
    """Batched ``RMQ_value`` through the chosen backend."""
    if backend == "fused":
        from repro_torch.kernels.rmq_fused import ops as fused_ops

        return fused_ops.rmq_fused_value_batch(h, ls, rs)
    if backend == "cuda":
        from repro_torch.kernels.rmq_scan import ops as scan_ops

        return scan_ops.rmq_value_batch_cuda(h, ls, rs)
    from repro_torch.core.query import rmq_value_batch

    return rmq_value_batch(h, ls, rs)


def dispatch_query_index(h: Hierarchy, ls, rs, backend: str) -> torch.Tensor:
    """Batched ``RMQ_index`` (leftmost minimum) through the chosen backend."""
    if backend == "fused":
        from repro_torch.kernels.rmq_fused import ops as fused_ops

        return fused_ops.rmq_fused_index_batch(h, ls, rs)
    if backend == "cuda":
        from repro_torch.kernels.rmq_scan import ops as scan_ops

        return scan_ops.rmq_index_batch_cuda(h, ls, rs)
    from repro_torch.core.query import rmq_index_batch

    return rmq_index_batch(h, ls, rs)
