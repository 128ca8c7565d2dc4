"""The GPU-RMQ minima hierarchy (paper §4.1) and its plain construction.

Layout, shared with the reference ``repro.core.hierarchy`` entry for
entry:

* ``base`` is level 0, stored at ``plan.capacity`` and +inf-padded past
  the live tail;
* ``upper`` is one contiguous buffer holding levels 1..L-1, level k at
  ``plan.offsets[k-1]``, each padded to a multiple of ``c`` with +inf
  (paper: "we store all precomputed layers in a single, contiguous
  buffer");
* ``upper_pos`` (position-tracking builds) holds, for each summary entry,
  the position in the original array of its minimum, leftmost on ties,
  with ``PAD_POS`` in the padding.

:func:`build_hierarchy` is the plain PyTorch construction: one
``(m, c)`` argmin per level straight into the preallocated buffer.  The
CUDA builds (``kernels/hierarchy_fused``: one launch;
``kernels/hierarchy_build``: one launch per level) are held bit-identical
to it.  When ``capacity == n`` the hierarchy's ``base`` is the input
tensor itself, not a copy (4 GiB saved at n = 2^30): writing to the
input afterwards changes the index.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.constants import PAD_POS
from repro_torch.core.plan import HierarchyPlan

__all__ = [
    "Hierarchy",
    "build_hierarchy",
    "build_upper_planes",
    "check_build_input",
    "check_compact_build",
    "pad_to",
    "pos_dtype_for",
    "reduce_level",
]


def pos_dtype_for(n: int) -> torch.dtype:
    """Position dtype for an array of length ``n``: int32 below 2^31,
    int64 past it.  PyTorch needs no x64 switch, so unlike the reference
    this never refuses; the CUDA kernels refuse capacities past the
    int32 index space on their own (``protocol.check_capacity_limit``)."""
    return torch.int32 if n < 2**31 else torch.int64


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """Device-resident minima hierarchy: three tensors and the plan."""

    base: torch.Tensor
    upper: torch.Tensor
    upper_pos: Optional[torch.Tensor]
    plan: HierarchyPlan

    @property
    def with_positions(self) -> bool:
        return self.upper_pos is not None

    @property
    def device(self) -> torch.device:
        return self.base.device

    def memory_bytes(self) -> int:
        """Total bytes of the structure (input + auxiliary)."""
        return self.base.numel() * self.base.element_size() + (
            self.auxiliary_bytes())

    def auxiliary_bytes(self) -> int:
        total = self.upper.numel() * self.upper.element_size()
        if self.upper_pos is not None:
            total += self.upper_pos.numel() * self.upper_pos.element_size()
        return total


def pad_to(x: torch.Tensor, length: int, fill) -> torch.Tensor:
    """``x`` extended to ``length`` with ``fill`` (``x`` itself if long
    enough already)."""
    pad = length - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad,), fill)])


def check_compact_build(plan: HierarchyPlan) -> None:
    """Refuse the compact layouts, which are not ported yet (ROADMAP A3)."""
    if plan.packed_pos or plan.summary_dtype != "float32":
        raise NotImplementedError(
            "compact planes (packed_pos=True / summary_dtype='bfloat16') "
            "are not ported yet (ROADMAP A3); build the classic layout")


def reduce_level(
    values: torch.Tensor,
    positions: Optional[torch.Tensor],
    c: int,
    out_len: int,
    track: bool,
    pos_dtype: torch.dtype = torch.int32,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Chunk minima of one level: ``out_len`` ``(value, leftmost pos)``.

    ``values`` holds the level's live entries; chunks past them read
    +inf / ``PAD_POS``.  ``positions=None`` means level 0, whose
    positions are the indices themselves (``PAD_POS`` past its end).
    """
    v = pad_to(values, out_len * c, float("inf")).view(out_len, c)
    idx = torch.argmin(v, dim=1)  # first occurrence: the leftmost tie
    nxt_v = v.gather(1, idx[:, None])[:, 0]
    if not track:
        return nxt_v, None
    if positions is None:
        p = idx + torch.arange(out_len, device=v.device) * c
        nxt_p = torch.where(p < values.shape[0], p, PAD_POS).to(pos_dtype)
    else:
        p = pad_to(positions, out_len * c, PAD_POS).view(out_len, c)
        nxt_p = p.gather(1, idx[:, None])[:, 0]
    return nxt_v, nxt_p


def build_upper_planes(
    base: torch.Tensor, plan: HierarchyPlan, with_positions: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(upper, upper_pos)`` of a capacity-length ``base``, plainly.

    The buffers are preallocated +inf / ``PAD_POS``; that fill is every
    level's padding, since only live entries are written.
    """
    upper = base.new_full((plan.upper_size,), float("inf"))
    pos_dtype = pos_dtype_for(plan.capacity)
    upper_pos = (
        torch.full((plan.upper_size,), PAD_POS, dtype=pos_dtype,
                   device=base.device)
        if with_positions else None
    )
    cur_v, cur_p = base, None
    for k in range(1, plan.num_levels):
        nxt_v, nxt_p = reduce_level(cur_v, cur_p, plan.c, plan.level_lens[k],
                                    with_positions, pos_dtype)
        off = plan.offsets[k - 1]
        upper[off:off + plan.level_lens[k]] = nxt_v
        if with_positions:
            upper_pos[off:off + plan.level_lens[k]] = nxt_p
        cur_v, cur_p = nxt_v, nxt_p
    return upper, upper_pos


def check_build_input(x: torch.Tensor, plan: HierarchyPlan) -> None:
    if x.ndim != 1:
        raise ValueError(f"input must be rank-1, got shape {tuple(x.shape)}")
    if x.shape[0] != plan.n:
        raise ValueError(f"plan is for n={plan.n}, input has n={x.shape[0]}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"values must be float32 or float64, got {x.dtype}")
    check_compact_build(plan)


def build_hierarchy(
    x: torch.Tensor, plan: HierarchyPlan, with_positions: bool = False
) -> Hierarchy:
    """Plain construction on ``x``'s device (the kernels' oracle)."""
    check_build_input(x, plan)
    base = pad_to(x, plan.capacity, float("inf"))
    upper, upper_pos = build_upper_planes(base, plan, with_positions)
    return Hierarchy(base=base, upper=upper, upper_pos=upper_pos, plan=plan)
