"""Analytical bounds of paper §4.1 over a plan, in plain Python.

The port of ``repro.core.theory``.  For a hierarchy with chunk size
``c`` and cutoff ``t`` over ``n`` elements the paper gives:

* auxiliary entries ``E <= n / (c - 1)`` (a geometric series), and
* scanned entries a query ``<= c*t + 2c*log_c(n)`` (the top scan and
  two boundary scans a level).

:func:`expected_scanned_entries` gives the *expected* scanned entries of
a range size, for napkin math before a measurement.
"""

from __future__ import annotations

import math

from repro_torch.core.plan import HierarchyPlan

__all__ = [
    "aux_entries_bound",
    "aux_entries_bound_ceil",
    "expected_scanned_entries",
    "max_scanned_entries",
    "optimal_num_levels",
]


def aux_entries_bound(n: int, c: int) -> float:
    """Paper §4.1: ``E <= n / (c - 1)``.

    The paper's bound takes each level as exactly ``n / c**i``.  With a
    ceiling at every level the exact bound is ``n / (c - 1) +
    num_levels`` (one slack entry a level): for c = 2 and a small n the
    count can pass the closed form (n = 17, c = 2: 19 entries > 17).
    :func:`aux_entries_bound_ceil` is that corrected bound.
    """
    return n / (c - 1)


def aux_entries_bound_ceil(n: int, c: int, num_levels: int) -> float:
    """The ceiling-corrected auxiliary entry bound."""
    return n / (c - 1) + num_levels


def max_scanned_entries(plan: HierarchyPlan) -> int:
    """Worst-case entries one query touches."""
    return plan.max_scanned_entries()


def expected_scanned_entries(plan: HierarchyPlan, range_size: float) -> float:
    """Expected scanned entries of a query over ``range_size`` elements.

    The walk ascends until the range left on a level is at most ``2c``;
    each level it passes scans about ``c`` entries a boundary on average
    (uniform offsets), and the stop level scans at most ``2c``.  Ranges
    that never cover a whole top-level chunk stop early, which is why
    throughput hardly depends on the range size once the upper levels
    stay in cache (paper Fig. 16).
    """
    c, s = plan.c, max(range_size, 1.0)
    levels_climbed = 0
    while s > 2 * c and levels_climbed < plan.num_levels - 1:
        s /= c
        levels_climbed += 1
    boundary = levels_climbed * 2 * (c / 2)  # half a chunk a side
    stop = min(s, 2 * c) if levels_climbed < plan.num_levels - 1 else min(
        s, plan.top_len)
    return boundary + stop


def optimal_num_levels(n: int, c: int, t: int) -> int:
    """The level count in closed form: the least L with
    ``n / c**(L-1) <= c*t``."""
    levels = 1
    m = n
    while m > c * t:
        m = math.ceil(m / c)
        levels += 1
    return levels
