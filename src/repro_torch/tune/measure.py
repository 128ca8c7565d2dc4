"""The paper's workloads (§5.1), numpy only, drawn from a seed.

A copy of ``repro.tune.measure``'s generators, so the port and its
``chip_smoke.py`` draw the same inputs as the reference's benchmarks:

* input arrays: i.i.d. uniform [0, 1) float32;
* query range-size classes: large (uniform in [1, n]), medium
  (log-normal, mu = ln(n^0.6), sigma = 0.3), small (log-normal,
  mu = ln(n^0.3), sigma = 0.3), mixed (equal thirds);
* left borders uniform in [0, n - s];
* :func:`make_span_queries` pins spans inside one engine class (short /
  mid / long).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["make_input_array", "make_queries", "make_span_queries"]


def make_input_array(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random(n, dtype=np.float32)


def make_queries(
    n: int, m: int, kind: str = "mixed", seed: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Paper §5.1 range-size classes (large / medium / small / mixed)."""
    rng = np.random.default_rng(seed)

    def sizes(kind, count):
        if kind == "large":
            return rng.integers(1, n + 1, count)
        if kind == "medium":
            s = rng.lognormal(np.log(n ** 0.6), 0.3, count)
            return np.clip(s.astype(np.int64), 1, n)
        if kind == "small":
            s = rng.lognormal(np.log(n ** 0.3), 0.3, count)
            return np.clip(s.astype(np.int64), 1, n)
        if kind == "mixed":
            parts = [sizes(k, count // 3 + 1)
                     for k in ("large", "medium", "small")]
            s = np.concatenate(parts)[:count]
            rng.shuffle(s)
            return s
        raise ValueError(kind)

    s = sizes(kind, m)
    ls = (rng.random(m) * (n - s + 1)).astype(np.int64)
    rs = ls + s - 1
    return ls.astype(np.int32), rs.astype(np.int32)


def make_span_queries(n: int, m: int, c: int, kind: str, seed: int = 1):
    """Bounds with spans pinned inside one engine span class.

    ``kind``: ``short`` (at most two aligned ``c``-chunks), ``mid``,
    ``long`` (at least n/2), or ``mixed`` (equal thirds, shuffled).
    """
    rng = np.random.default_rng(seed)
    if kind == "short":
        s = rng.integers(1, c + 2, m)
    elif kind == "mid":
        s = rng.integers(4 * c, min(16 * c, n), m)
    elif kind == "long":
        s = rng.integers(n // 2, n + 1, m)
    elif kind == "mixed":
        parts = [make_span_queries(n, m // 3 + 1, c, k, seed + i)[0:2]
                 for i, k in enumerate(("short", "mid", "long"))]
        ls = np.concatenate([p[0] for p in parts])[:m]
        rs = np.concatenate([p[1] for p in parts])[:m]
        order = rng.permutation(m)
        return ls[order], rs[order]
    else:
        raise ValueError(kind)
    ls = (rng.random(m) * (n - s + 1)).astype(np.int64)
    rs = ls + s - 1
    return ls.astype(np.int32), rs.astype(np.int32)
