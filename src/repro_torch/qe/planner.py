"""Span classification and bucket packing for the batched query engine.

Routing predicates (host-side numpy — the planner runs before any device
dispatch):

* **short** — the query's level-0 footprint spans at most two aligned
  ``c``-chunks (``r // c - l // c <= 1``).  Answered by the
  ``rmq_short`` direct scan; the hierarchy is never touched.
* **long** — ``span >= long_cutoff``, where the default cutoff
  ``2c · c^(L-2)`` is the smallest span that *must* ascend all the way
  to the top level (the walk's early exit fires once the remaining
  range is ``<= 2c``, and each ascent divides the span by ``c``).
  Routed to the hybrid's O(1) sparse-table top, which replaces the
  ``c·t``-entry top scan with two loads.
* **mid** — everything else: the standard hierarchy walk.

With the **fused** runtime backend (``kernels/rmq_fused``) the class
split is unnecessary — the kernel decomposes spans internally, so the
planner *degrades to a single bucket class* (``fused=True``): every
query lands in ``FUSED`` buckets and the engine executes the whole mix
through one executor, one launch per bucket.

Each class is packed into *fixed padded bucket shapes*: full buckets of
``max_bucket`` queries plus one tail padded up to a power of two (at
least ``min_bucket``).  The set of distinct shapes the executors ever
see is therefore ``O(log(max_bucket))`` per class — jit specializations
are bounded no matter how batch composition shifts between calls.
Padding queries are ``(0, 0)`` (valid on any non-empty array); their
results are dropped at scatter-back.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = ["SHORT", "MID", "LONG", "FUSED", "Bucket", "QueryPlanner"]

SHORT = "short"
MID = "mid"
LONG = "long"
FUSED = "fused"


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length() if x > 1 else 1


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One padded execution unit: ``idxs`` maps rows back to the batch."""

    cls: str           # SHORT | MID | LONG
    idxs: np.ndarray   # (k,) positions in the planned batch
    ls: np.ndarray     # (shape,) int32, padded with 0
    rs: np.ndarray     # (shape,) int32, padded with 0

    @property
    def shape(self) -> int:
        return int(self.ls.shape[0])

    @property
    def count(self) -> int:
        return int(self.idxs.shape[0])

    @property
    def padding(self) -> int:
        """Dead lanes: padded pow2 shape minus live queries."""
        return self.shape - self.count


@dataclasses.dataclass(frozen=True)
class QueryPlanner:
    """Static routing policy for one hierarchy geometry."""

    c: int
    num_levels: int
    long_cutoff: Optional[int] = None   # None -> 2c * c^(L-2) default
    long_enabled: bool = True
    min_bucket: int = 16
    max_bucket: int = 4096
    # fused runtime backend: no class split — the kernel decomposes
    # spans internally, so everything packs into FUSED buckets.
    fused: bool = False
    # bottom-scan threshold in aligned c-chunks (1 or 2): spans touching
    # at most this many chunks take the rmq_short route.  Tuned via
    # LevelSplit.scan_chunks; 2 is the kernel's maximum.
    scan_chunks: int = 2

    def effective_long_cutoff(self) -> int:
        if self.long_cutoff is not None:
            return self.long_cutoff
        return 2 * self.c ** max(self.num_levels - 1, 1)

    def classify(self, ls: np.ndarray, rs: np.ndarray) -> np.ndarray:
        """Class label per query (vectorized; '<U5' array)."""
        if self.fused:
            return np.full(ls.shape, FUSED, dtype="<U5")
        c = self.c
        out = np.full(ls.shape, MID, dtype="<U5")
        short = (rs // c) - (ls // c) <= self.scan_chunks - 1
        out[short] = SHORT
        if self.long_enabled and self.num_levels >= 2:
            span = rs.astype(np.int64) - ls + 1
            out[~short & (span >= self.effective_long_cutoff())] = LONG
        return out

    def plan(self, ls: np.ndarray, rs: np.ndarray) -> List[Bucket]:
        """Pack a batch into per-class padded buckets."""
        ls = np.asarray(ls, np.int32)
        rs = np.asarray(rs, np.int32)
        labels = self.classify(ls, rs)
        buckets: List[Bucket] = []
        classes = (FUSED,) if self.fused else (SHORT, MID, LONG)
        for cls in classes:
            idxs = np.nonzero(labels == cls)[0]
            for lo in range(0, idxs.shape[0], self.max_bucket):
                part = idxs[lo : lo + self.max_bucket]
                buckets.append(self._pack(cls, part, ls, rs))
        return buckets

    def _pack(self, cls: str, idxs: np.ndarray, ls, rs) -> Bucket:
        shape = min(
            max(_next_pow2(idxs.shape[0]), self.min_bucket),
            self.max_bucket,
        )
        pl = np.zeros((shape,), np.int32)
        pr = np.zeros((shape,), np.int32)
        pl[: idxs.shape[0]] = ls[idxs]
        pr[: idxs.shape[0]] = rs[idxs]
        return Bucket(cls=cls, idxs=idxs, ls=pl, rs=pr)
