"""Static geometry of a GPU-RMQ minima hierarchy (paper §4.1).

The layout is fully determined by ``(n, c, t)`` plus a reserved
``capacity``:

* ``n`` — logical input length at build time (level 0 is the input).
* ``c`` — chunk size: each level-(k+1) entry summarizes ``c`` adjacent
  level-k entries.  Power of two, as in the paper.
* ``t`` — build cutoff: levels are added until the topmost one holds at
  most ``c * t`` entries, so the final scan touches at most ``c * t``.
* ``capacity`` — stored length of level 0 (``>= n``).  The geometry is
  derived from it, so appends into the +inf tail (a later slice) never
  change the plan.

Plain Python metadata, hashable; no tensor appears here.  The port's copy
of ``repro.core.plan`` keeps every geometry property, the byte accounting
and the tuned path (``tuned=True`` / ``c="auto"``: the geometry from the
tuning cache, :mod:`repro_torch.tune`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

__all__ = ["HierarchyPlan", "LevelSplit", "make_plan"]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil_div(a, b) * b


@dataclasses.dataclass(frozen=True)
class LevelSplit:
    """How hierarchy levels split across execution engines (paper "hybrid").

    scan_chunks:  spans covering at most this many aligned ``c``-chunks
                  take the short-span route (1 or 2).
    sparse_top:   whether long spans route to the sparse-table top.
    long_cutoff:  the measured walk-vs-sparse-top crossover span; ``None``
                  keeps the planner's analytic default.
    fused:        execute through the single-launch fused query path.

    A tuned build carries its winner's split on the plan; the query
    engine reads it when no tuning cache is given
    (:class:`repro_torch.qe.QueryEngine`).
    """

    scan_chunks: int = 2
    sparse_top: bool = True
    long_cutoff: Optional[int] = None
    fused: bool = False

    def __post_init__(self):
        if self.scan_chunks not in (1, 2):
            raise ValueError(
                f"scan_chunks must be 1 or 2 (the short-span kernel scans "
                f"at most two aligned chunks), got {self.scan_chunks}")
        if self.long_cutoff is not None and self.long_cutoff < 1:
            raise ValueError(
                f"long_cutoff must be positive, got {self.long_cutoff}")


@dataclasses.dataclass(frozen=True)
class HierarchyPlan:
    """Immutable description of the level geometry.

    n:            logical input length at build time (level 0).
    c:            chunk size (power of two).
    t:            build cutoff threshold (max chunks on the top level).
    capacity:     stored length of level 0 (``>= n``).
    level_lens:   length of every level, ``level_lens[0] == capacity``.
    padded_lens:  each upper level's stored length, rounded up to a
                  multiple of ``c``.
    offsets:      start of each upper level (k >= 1) inside the single
                  contiguous ``upper`` buffer.
    level_split:  optional :class:`LevelSplit`.
    packed_pos:   bit-packed chunk-local position plane
                  (``repro_torch.core.bitpack``) in position builds.
    summary_dtype: ``"float32"`` or ``"bfloat16"`` upper values; bf16
                  needs float32 input and positions (queries recover
                  exact answers from level 0).
    """

    n: int
    c: int
    t: int
    level_lens: Tuple[int, ...]
    padded_lens: Tuple[int, ...]
    offsets: Tuple[int, ...]
    capacity: int = 0  # 0 means "== n"
    level_split: Optional[LevelSplit] = None
    packed_pos: bool = False
    summary_dtype: str = "float32"

    def __post_init__(self):
        if self.capacity == 0:
            object.__setattr__(self, "capacity", self.n)
        if self.summary_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"summary_dtype must be 'float32' or 'bfloat16', "
                f"got {self.summary_dtype!r}")

    @property
    def num_levels(self) -> int:
        return len(self.level_lens)

    @property
    def num_upper_levels(self) -> int:
        return self.num_levels - 1

    @property
    def upper_size(self) -> int:
        """Total entries in the contiguous upper buffer."""
        if self.num_levels == 1:
            return 0
        return self.offsets[-1] + self.padded_lens[-1]

    @property
    def top_len(self) -> int:
        """Logical length of the topmost level."""
        return self.level_lens[-1]

    @property
    def top_padded_len(self) -> int:
        if self.num_levels == 1:
            return self.level_lens[0]
        return self.padded_lens[-1]

    def level_slice(self, level: int) -> Tuple[int, int]:
        """(offset, padded_len) of an upper level inside the upper buffer."""
        if level < 1 or level >= self.num_levels:
            raise ValueError(f"level {level} is not an upper level")
        return self.offsets[level - 1], self.padded_lens[level - 1]

    # -- paper §4.1 analytical bounds ------------------------------------
    def max_scanned_entries(self) -> int:
        """Worst-case scanned entries: ``c*t + 2c*log_c(n)`` (paper §4.1)."""
        return self.c * self.t + 2 * self.c * max(self.num_levels - 1, 0)

    def memory_bound_entries(self) -> float:
        """Upper bound on auxiliary entries: ``n / (c - 1)`` (paper §4.1)."""
        return self.n / (self.c - 1)

    def auxiliary_entries(self) -> int:
        """Actual auxiliary entries materialized (excludes the input)."""
        return self.upper_size

    def overhead_fraction(self) -> float:
        """Auxiliary memory as a fraction of the input array."""
        return self.auxiliary_entries() / max(self.n, 1)

    # -- byte accounting (paper §5.5) --------------------------------------
    def pos_bits(self) -> int:
        """Bits per packed position entry (chunk-local offset < c)."""
        return max(1, (self.c - 1).bit_length())

    def input_bytes(self, value_itemsize: int = 4) -> int:
        """Bytes of the stored level-0 plane (padded to capacity)."""
        return self.capacity * value_itemsize

    def value_plane_bytes(self) -> int:
        """Bytes of the stored ``upper`` value plane under this plan."""
        itemsize = 2 if self.summary_dtype == "bfloat16" else 4
        return self.upper_size * itemsize

    def position_plane_bytes(self) -> int:
        """Bytes of the ``upper_pos`` plane of a position-tracking build:
        packed uint32 words under ``packed_pos``, else one absolute
        int32 (int64 past 2^31) per entry."""
        if self.upper_size == 0:
            return 0
        if self.packed_pos:
            return ((self.upper_size * self.pos_bits() + 31) // 32) * 4
        itemsize = 8 if self.capacity >= 2**31 else 4
        return self.upper_size * itemsize

    def auxiliary_bytes_planned(self, with_positions: bool = True) -> int:
        """Total auxiliary bytes (value plane + optional position plane)."""
        total = self.value_plane_bytes()
        if with_positions:
            total += self.position_plane_bytes()
        return total


def make_plan(
    n: int,
    c: Union[int, str] = 128,
    t: int = 64,
    capacity: Optional[int] = None,
    tuned: bool = False,
    span_mix: str = "mixed",
    tuning=None,
    platform: Optional[str] = None,
    level_split: Optional[LevelSplit] = None,
    packed_pos: Optional[bool] = None,
    summary_dtype: Optional[str] = None,
) -> HierarchyPlan:
    """Compute the level geometry for an input of length ``n``.

    Levels are added bottom-up until the topmost level holds at most
    ``c * t`` entries; for ``capacity <= c * t`` the plan is a single
    level (a pure scan).  ``capacity`` (default ``n``) reserves an
    +inf-padded tail and the geometry is derived from it.

    ``tuned=True`` (or ``c="auto"``) takes the geometry from the tuning
    cache (``tuning``, default :func:`repro_torch.tune.default_cache`),
    keyed by ``platform`` (default :func:`repro_torch.tune.
    current_platform`, the card's key), the size bucket and ``span_mix``.
    A hit adopts the winner's ``c``, ``t`` and :class:`LevelSplit`, and
    its ``packed_pos`` / ``summary_dtype`` unless given here.  A miss
    keeps the numeric ``c`` / ``t`` passed (``c="auto"``: 128) and
    attaches no split.
    """
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    if tuned or c == "auto":
        from repro_torch.tune import cache as _tc

        store = tuning if tuning is not None else _tc.default_cache()
        plat = platform or _tc.current_platform()
        cfg = store.lookup(plat, n, span_mix)
        if cfg is not None:
            c, t = cfg.c, cfg.t
            if level_split is None:
                level_split = cfg.level_split()
            if packed_pos is None:
                packed_pos = cfg.packed_pos
            if summary_dtype is None:
                summary_dtype = cfg.summary_dtype
        elif c == "auto":
            c = 128  # a miss: the default geometry
    if packed_pos is None:
        packed_pos = False
    if summary_dtype is None:
        summary_dtype = "float32"
    if c < 2 or (c & (c - 1)) != 0:
        raise ValueError(f"chunk size c must be a power of two >= 2, got {c}")
    if t < 1:
        raise ValueError(f"threshold t must be >= 1, got {t}")
    if capacity is None:
        capacity = n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < n {n}")

    level_lens = [capacity]
    while level_lens[-1] > c * t:
        level_lens.append(_ceil_div(level_lens[-1], c))

    padded = [_round_up(m, c) for m in level_lens[1:]]
    offsets = []
    acc = 0
    for p in padded:
        offsets.append(acc)
        acc += p

    return HierarchyPlan(
        n=n,
        c=c,
        t=t,
        level_lens=tuple(level_lens),
        padded_lens=tuple(padded),
        offsets=tuple(offsets),
        capacity=capacity,
        level_split=level_split,
        packed_pos=packed_pos,
        summary_dtype=summary_dtype,
    )
