"""The paper's workloads (§5.1), drawn from a seed, and the timing discipline.

A copy of ``repro.tune.measure``'s generators, so the port and its
``chip_smoke.py`` draw the same inputs as the reference's benchmarks:

* input arrays: i.i.d. uniform [0, 1) float32;
* query range-size classes: large (uniform in [1, n]), medium
  (log-normal, mu = ln(n^0.6), sigma = 0.3), small (log-normal,
  mu = ln(n^0.3), sigma = 0.3), mixed (equal thirds);
* left borders uniform in [0, n - s];
* :func:`make_span_queries` pins spans inside one engine class (short /
  mid / long).

Timing discipline (:func:`time_fn`, the reference's): one untimed
warm-up call, then the median of ``repeats`` host-clock runs, each ending
in ``torch.cuda.synchronize()`` when the output lives on a card.  The
autotuner times whole engine batches, host work (dedup, planning,
packing) included, so the host clock to the end of device work is the
right clock; CUDA events would time the device alone.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import numpy as np
import torch

__all__ = ["make_input_array", "make_queries", "make_span_queries",
           "time_fn"]


def _cuda_devices(out):
    """The CUDA devices of the tensors in ``out`` (nested in tuples,
    lists and dicts)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return set().union(*map(_cuda_devices, out)) if out else set()
    return set()


def _wait(out) -> None:
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, repeats: int = 5) -> float:
    """Median host-clock seconds of ``fn()`` over ``repeats`` runs after
    one untimed warm-up, each to the end of its device work."""
    _wait(fn())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _wait(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


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
