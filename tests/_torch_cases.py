"""Inputs and geometries shared by the port's tests (numpy, from seeds)."""

import numpy as np


def tied_input(rng, n, dtype=np.float32):
    """Random values with deliberate ties, so leftmost positions matter."""
    x = rng.random(n).astype(dtype)
    x[rng.integers(0, n, max(n // 8, 1))] = 0.5
    # a coarse grid puts many equal minima inside one chunk
    coarse = rng.integers(0, n, max(n // 4, 1))
    x[coarse] = np.floor(x[coarse] * 16) / 16
    return x


def query_batch(rng, n, c, m=96):
    """Spans of every class on an array of live length ``n``: random,
    ``l == r``, short (within two chunks), chunk-aligned, long, and
    spans that end at the live tail."""
    ls = rng.integers(0, n, m)
    rs = np.minimum(ls + rng.integers(0, n, m), n - 1)
    parts_l = [np.minimum(ls, rs)]
    parts_r = [np.maximum(ls, rs)]
    pts = rng.integers(0, n, 16)
    parts_l.append(pts)
    parts_r.append(pts)
    sl = rng.integers(0, n, 32)
    parts_l.append(sl)
    parts_r.append(np.minimum(sl + rng.integers(0, 2 * c + 1, 32), n - 1))
    al = (rng.integers(0, max(n // c, 1), 16) * c).clip(0, n - 1)
    parts_l.append(al)
    parts_r.append(np.minimum(al + c * rng.integers(1, 4, 16) - 1, n - 1))
    parts_l.append(np.array([0, 0, n - 1, max(n - c - 3, 0), 1]))
    parts_r.append(np.array([n - 1, 0, n - 1, n - 1, n - 1]))
    tail = rng.integers(0, n, 8)
    parts_l.append(tail)
    parts_r.append(np.full(8, n - 1))
    return (np.concatenate(parts_l).astype(np.int32),
            np.concatenate(parts_r).astype(np.int32))


def brute_force(x, ls, rs):
    """Minimum and leftmost argmin of each inclusive span."""
    vals = np.array([x[l:r + 1].min() for l, r in zip(ls, rs)], x.dtype)
    pos = np.array([l + int(np.argmin(x[l:r + 1]))
                    for l, r in zip(ls, rs)], np.int64)
    return vals, pos


# (n, c, t, capacity): ragged tails, reserved capacity, single-level and
# deep plans (those of tests/test_fused_build.py first).
GEOMETRIES = [
    (1000, 8, 2, None),     # n % c != 0
    (4096, 8, 2, 8192),     # capacity > n (aligned)
    (999, 2, 1, 1500),      # ragged + ragged capacity, 10 upper levels
    (12_345, 16, 4, None),  # ragged, mid-depth
    (700, 128, 64, None),   # single-level plan (n <= c*t)
    (300, 16, 2, 1000),     # capacity-derived levels from a tiny n
]
