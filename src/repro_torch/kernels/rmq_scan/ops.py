"""The CL+WLQ query scan: one launch per output plane.

The counterpart of the reference's ``rmq_value_batch_pallas`` /
``rmq_index_batch_pallas`` (``repro/kernels/rmq_scan/ops.py``).  A value
batch is one launch of ``csrc/rmq_scan.cu`` that writes the value plane;
an index batch is one launch that tracks positions and writes the
position plane.  Degenerate plans (one level, ``capacity < c``) run in
the kernel too.  On a CPU hierarchy the plain version,
:func:`rmq_scan_plain` (the plain walk), answers.

Compact planes, as in ``rmq_fused``: a packed position plane is unpacked
before an index launch; bf16 summaries are answered by the plain
exact-recovery walk with no launch, the reference's route.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.query import rmq_walk_batch
from repro_torch.kernels import _build, _query, profiling

__all__ = [
    "LAUNCHES",
    "rmq_index_batch_cuda",
    "rmq_scan_cuda",
    "rmq_scan_plain",
    "rmq_value_batch_cuda",
]

LAUNCHES = profiling.KernelCounter("rmq_scan")

_SIGNATURES = {
    "rmq_scan_query": (
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ),
}


def rmq_scan_plain(h: Hierarchy, ls, rs, track_pos: bool) -> torch.Tensor:
    """The plane one launch would write: positions if ``track_pos``,
    else values."""
    vals, pos = rmq_walk_batch(h, ls, rs, track_pos)
    return pos if track_pos else vals


def rmq_scan_cuda(h: Hierarchy, ls, rs, track_pos: bool) -> torch.Tensor:
    """One launch: the position plane if ``track_pos``, else values."""
    h = _query.launch_planes(h, track_pos)
    ls, rs = _query.kernel_bounds(h, ls, rs, "rmq_scan")
    plan, dev = h.plan, h.base.device
    m = ls.numel()
    out = torch.empty(m, dtype=torch.int32 if track_pos else h.base.dtype,
                      device=dev)
    if m == 0:
        return out
    offsets = _query.int_array(plan.offsets)
    padded = _query.int_array(plan.padded_lens)
    lib = _build.load("rmq_scan", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.rmq_scan_query(
            _build.dtype_code(h.base.dtype), int(track_pos), plan.capacity,
            plan.c, plan.num_levels, ctypes.cast(offsets, ctypes.c_void_p),
            ctypes.cast(padded, ctypes.c_void_p), _build.ptr(h.base),
            _build.ptr(h.upper),
            _build.ptr(h.upper_pos if track_pos else None),
            _build.ptr(ls), _build.ptr(rs), m, _build.ptr(out),
            _build.stream_of(dev))
    _build.check(lib, rc, "rmq_scan")
    LAUNCHES.hit()
    return out


def _scan(h: Hierarchy, ls, rs, track_pos: bool) -> torch.Tensor:
    ls = torch.as_tensor(ls, device=h.base.device)
    rs = torch.as_tensor(rs, device=h.base.device)
    quantized = h.quantized
    profiling.record_launch(
        "rmq_scan",
        lowering="cuda" if h.base.is_cuda and not quantized else "eager",
        queries=int(ls.numel()),
        levels=h.plan.num_levels,
        track_pos=bool(track_pos),
        operand_bytes=profiling.operand_bytes(
            h.base, h.upper, h.upper_pos if track_pos else None, ls, rs),
    )
    if h.base.is_cuda and not quantized:
        return rmq_scan_cuda(h, ls, rs, track_pos).reshape(ls.shape)
    return rmq_scan_plain(h, ls, rs, track_pos)


def rmq_value_batch_cuda(h: Hierarchy, ls, rs) -> torch.Tensor:
    """Batched ``RMQ_value``: one launch writing the value plane."""
    return _scan(h, ls, rs, track_pos=False)


def rmq_index_batch_cuda(h: Hierarchy, ls, rs) -> torch.Tensor:
    """Batched ``RMQ_index``: one launch writing the position plane."""
    if not h.with_positions:
        raise ValueError("hierarchy built without positions")
    return _scan(h, ls, rs, track_pos=True)
