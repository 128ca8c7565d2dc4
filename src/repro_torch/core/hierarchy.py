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

Compact layouts (``plan.packed_pos`` / ``plan.summary_dtype``): a packed
plan stores ``upper_pos`` as uint32 words of chunk-local offsets
(:mod:`repro_torch.core.bitpack`), and a ``"bfloat16"`` plan stores
``upper`` as bfloat16 (float32 input, positions required: queries
re-read quantized ties from level 0 through the positions).

:func:`build_hierarchy` is the plain PyTorch construction: one
``(m, c)`` argmin per level straight into the preallocated buffer; a
packed build keeps each level's argmin as the local offset and packs at
the end, a bf16 build casts ``upper`` at the end.  The CUDA builds
(``kernels/hierarchy_fused``: one launch; ``kernels/hierarchy_build``:
one launch per level) build the classic planes and go through
:func:`finalize_compact`; all are held bit-identical to it.  When
``capacity == n`` the hierarchy's ``base`` is the input tensor itself,
not a copy (4 GiB saved at n = 2^30): writing to the input afterwards
changes the index.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.constants import PAD_POS
from repro_torch.core.plan import HierarchyPlan

__all__ = [
    "VALUE_DTYPES",
    "Hierarchy",
    "build_hierarchy",
    "build_many",
    "build_upper_planes",
    "check_build_input",
    "check_compact_build",
    "chunk_min",
    "finalize_compact",
    "gather_bits",
    "pad_to",
    "pos_dtype_for",
    "quantized_planes",
    "reduce_level",
    "reduce_upper_levels",
    "value_bits",
]


# The value dtypes an index stores (level 0 and, unless its plan asks for
# bf16 summaries, the upper levels).
VALUE_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def pos_dtype_for(n: int) -> torch.dtype:
    """Position dtype for an array of length ``n``: int32 below 2^31,
    int64 past it.  PyTorch needs no x64 switch, so unlike the reference
    this never refuses; the CUDA kernels refuse capacities past the
    int32 index space on their own (``protocol.check_capacity_limit``)."""
    return torch.int32 if n < 2**31 else torch.int64


def quantized_planes(upper: torch.Tensor, base: torch.Tensor) -> bool:
    """Do these planes store bf16 summaries (``upper`` narrower than
    ``base``)?  Such summaries can tie where the values differ, so every
    walk and update over them re-reads level 0 (the exact re-compare),
    and no query kernel compares them (:attr:`Hierarchy.quantized`)."""
    return upper.dtype != base.dtype


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

    @property
    def quantized(self) -> bool:
        """bf16 summaries: :func:`quantized_planes`."""
        return quantized_planes(self.upper, self.base)

    def memory_bytes(self) -> int:
        """Total bytes of the structure (input + auxiliary)."""
        return self.base.numel() * self.base.element_size() + (
            self.auxiliary_bytes())

    def auxiliary_bytes(self) -> int:
        total = self.upper.numel() * self.upper.element_size()
        if self.upper_pos is not None:
            total += self.upper_pos.numel() * self.upper_pos.element_size()
        return total


def value_bits(t: torch.Tensor) -> torch.Tensor:
    """A bf16 plane as its int16 bits (other planes as they are): PyTorch's
    CPU gather and scatter on bf16 compute a NaN's bits anew, so the plain
    versions move bf16 values by their bits."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def gather_bits(v: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``v.gather(dim, idx)``, each entry's own bits (:func:`value_bits`)."""
    return value_bits(v).gather(dim, idx).view(v.dtype)


def pad_to(x: torch.Tensor, length: int, fill) -> torch.Tensor:
    """``x`` extended along its last axis to ``length`` with ``fill``
    (``x`` itself if long enough already)."""
    pad = length - x.shape[-1]
    if pad == 0:
        return x
    return torch.cat([x, x.new_full(x.shape[:-1] + (pad,), fill)], dim=-1)


def check_compact_build(plan: HierarchyPlan, with_positions: bool,
                        dtype: torch.dtype) -> None:
    """Refuse compact-layout builds that cannot answer exactly: bf16
    summaries need positions (the exact re-compare reads level 0 through
    them) and float32 input."""
    if plan.summary_dtype == "bfloat16":
        if not with_positions:
            raise ValueError(
                "summary_dtype='bfloat16' requires with_positions=True: "
                "exact queries re-compare bf16-tied candidates on level 0 "
                "through the stored positions")
        if dtype != torch.float32:
            raise ValueError(
                "summary_dtype='bfloat16' supports float32 inputs only, "
                f"got {str(dtype).replace('torch.', '')}")


def finalize_compact(h: Hierarchy) -> Hierarchy:
    """The plan's compact layouts applied to a freshly built hierarchy:
    an absolute position plane packed into words where
    ``plan.packed_pos`` (a no-op on uint32 words), ``upper`` cast to
    bfloat16 where ``plan.summary_dtype == "bfloat16"``.  The CUDA
    builds build the classic planes and go through here."""
    plan = h.plan
    if (plan.packed_pos and h.upper_pos is not None
            and h.upper_pos.dtype != torch.uint32):
        from repro_torch.core import bitpack

        h = dataclasses.replace(
            h, upper_pos=bitpack.pack_plane_from_absolute(h.upper_pos, plan))
    if plan.summary_dtype == "bfloat16" and h.upper.dtype != torch.bfloat16:
        h = dataclasses.replace(h, upper=h.upper.to(torch.bfloat16))
    return h


def chunk_min(values: torch.Tensor, c: int, out_len: int):
    """``(minima, argmin)`` of ``out_len`` chunks of ``values`` (+inf past
    its end): the leftmost least entry's bits and its in-chunk offset,
    NaN least (``torch.argmin``'s rule)."""
    v = pad_to(values, out_len * c, float("inf")).view(out_len, c)
    idx = torch.argmin(v, dim=1)  # first occurrence: the leftmost tie
    return gather_bits(v, 1, idx[:, None])[:, 0], idx


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
    nxt_v, idx = chunk_min(values, c, out_len)
    if not track:
        return nxt_v, None
    if positions is None:
        p = idx + torch.arange(out_len, device=idx.device) * c
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
    upper_pos = (
        torch.full((plan.upper_size,), PAD_POS,
                   dtype=pos_dtype_for(plan.capacity), device=base.device)
        if with_positions else None
    )
    reduce_upper_levels(plan, upper, upper_pos, 1, base, None)
    return upper, upper_pos


def reduce_upper_levels(plan: HierarchyPlan, upper: torch.Tensor,
                        upper_pos: Optional[torch.Tensor], first: int,
                        cur_v: torch.Tensor,
                        cur_p: Optional[torch.Tensor]) -> None:
    """Levels ``first`` .. L-1 into their slots of ``upper`` /
    ``upper_pos`` (positions where it is not ``None``), reduced from the
    live entries ``cur_v`` / ``cur_p`` of level ``first - 1``
    (``cur_p=None`` for level 0)."""
    track = upper_pos is not None
    for k in range(first, plan.num_levels):
        cur_v, cur_p = reduce_level(
            cur_v, cur_p, plan.c, plan.level_lens[k], track,
            upper_pos.dtype if track else torch.int32)
        off = plan.offsets[k - 1]
        upper[off:off + plan.level_lens[k]] = cur_v
        if track:
            upper_pos[off:off + plan.level_lens[k]] = cur_p


def check_build_input(x: torch.Tensor, plan: HierarchyPlan,
                      with_positions: bool) -> None:
    if x.ndim != 1:
        raise ValueError(f"input must be rank-1, got shape {tuple(x.shape)}")
    if x.shape[0] != plan.n:
        raise ValueError(f"plan is for n={plan.n}, input has n={x.shape[0]}")
    if x.dtype not in VALUE_DTYPES:
        raise TypeError(
            f"values must be float32, bfloat16 or float64, got {x.dtype}")
    check_compact_build(plan, with_positions, x.dtype)


def _packed_upper_planes(base: torch.Tensor, plan: HierarchyPlan):
    """``(upper, packed words)``: each level's argmin is its chunk-local
    offset, packed once at the end; no absolute chain is built."""
    from repro_torch.core import bitpack

    upper = base.new_full((plan.upper_size,), float("inf"))
    local = torch.zeros(plan.upper_size, dtype=torch.int32,
                        device=base.device)
    cur = base
    for k in range(1, plan.num_levels):
        off, n_k = plan.offsets[k - 1], plan.level_lens[k]
        cur, idx = chunk_min(cur, plan.c, n_k)
        upper[off:off + n_k] = cur
        local[off:off + n_k] = idx.to(torch.int32)
    return upper, bitpack.pack_offsets(local, bitpack.pos_bits(plan.c))


def build_hierarchy(
    x: torch.Tensor, plan: HierarchyPlan, with_positions: bool = False
) -> Hierarchy:
    """Plain construction on ``x``'s device (the kernels' oracle), in the
    plan's layout."""
    check_build_input(x, plan, with_positions)
    base = pad_to(x, plan.capacity, float("inf"))
    if with_positions and plan.packed_pos:
        upper, upper_pos = _packed_upper_planes(base, plan)
    else:
        upper, upper_pos = build_upper_planes(base, plan, with_positions)
    if plan.summary_dtype == "bfloat16":
        upper = upper.to(torch.bfloat16)
    return Hierarchy(base=base, upper=upper, upper_pos=upper_pos, plan=plan)


def build_many(
    xs, plan: HierarchyPlan, with_positions: bool = False
) -> Hierarchy:
    """Batched construction: ``(B, n)`` inputs -> one batched Hierarchy.

    Every plane of the result carries a leading batch axis (``base`` is
    ``(B, capacity)``, ``upper`` is ``(B, upper_size)``), and row ``i`` is
    bit-identical to ``build_hierarchy(xs[i], plan, with_positions)``.
    On a CUDA tensor all ``B`` rows come out of ONE ``hierarchy_fused``
    launch, as the reference's vmapped build is one launch; on the CPU
    the plain build runs row by row
    (:func:`repro_torch.kernels.hierarchy_fused.ops.build_hierarchy_fused`
    given the rows).
    ``QueryService.register_many`` indexes many equal-length arrays
    through it.
    """
    xs = torch.as_tensor(xs)
    if xs.ndim != 2:
        raise ValueError(
            f"inputs must be rank-2 (B, n), got {tuple(xs.shape)}")
    if xs.shape[0] == 0:
        raise ValueError("build_many needs at least one row")
    check_build_input(xs[0], plan, with_positions)
    from repro_torch.kernels.hierarchy_fused import ops as fused_ops

    return fused_ops.build_hierarchy_fused(xs, plan, with_positions)
