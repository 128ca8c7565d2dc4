"""Operand preparation shared by the two query wrappers (B2 and B4)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.protocol import check_capacity_limit, kernel_index_extent
from repro_torch.kernels import _build

__all__ = ["MAX_LEVELS", "STAGE_LIMIT", "int_array", "kernel_bounds",
           "stage_top"]

MAX_LEVELS = 32
# Shared memory a block may spend on its copy of the top level.  The
# largest top at the default geometry (c*t = 8192 entries, float32 values
# and int32 positions) takes 64 KB; float64 takes 96 KB.
STAGE_LIMIT = 112 * 1024


def kernel_bounds(h: Hierarchy, ls, rs, what: str):
    """``(ls, rs)`` as contiguous int32 tensors on the hierarchy's card,
    after the checks every query launch needs."""
    plan = h.plan
    check_capacity_limit(kernel_index_extent(plan))
    if plan.num_levels > MAX_LEVELS:
        raise ValueError(f"{what}: at most {MAX_LEVELS} levels")
    dev = h.base.device
    ls = torch.as_tensor(ls, device=dev).to(torch.int32).reshape(-1)
    rs = torch.as_tensor(rs, device=dev).to(torch.int32).reshape(-1)
    if ls.shape != rs.shape:
        raise ValueError(f"{what}: bounds must match in shape")
    _build.require_cuda(what, h.base, h.upper, h.upper_pos, ls, rs)
    if h.upper_pos is not None and h.upper_pos.dtype != torch.int32:
        raise TypeError(f"{what}: positions must be int32")
    return ls.contiguous(), rs.contiguous()


def stage_top(h: Hierarchy, track: bool) -> int:
    """1 if every block should copy the top level into shared memory."""
    plan = h.plan
    pos = 4 if (track and plan.num_levels > 1) else 0
    return int(plan.top_padded_len * (h.base.element_size() + pos)
               <= STAGE_LIMIT)


def int_array(values) -> ctypes.Array:
    values = list(values) or [0]
    return (ctypes.c_int * len(values))(*values)
