"""Shared numeric sentinels of the minima hierarchy and its kernels.

``PAD_POS`` is the position stored for padding entries (the +inf tail
of a level, chunks past ``capacity``).  Padding never wins a query
because its value is +inf, so it only has to exceed every real
position: ``INT32_MAX``.  ``POS_INF_I32`` is the identity of the
lexicographic ``(value, position)`` merge that keeps ties leftmost; the
same number, kept as its own name because the role differs.  The CUDA
sources define the same value in ``csrc/rmq_common.cuh``.
"""

from __future__ import annotations

__all__ = ["PAD_POS", "POS_INF_I32"]

PAD_POS = 2**31 - 1
POS_INF_I32 = PAD_POS
