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


# Edge cases of the leftmost-tie rule (B2 / B4): each kind of input with
# the spans that exercise it, over a plan whose capacity may exceed n.
# The JAX package answers NaN inconsistently and flushes subnormals to zero
# on the CPU (ROADMAP C7, C2), so tests against it take the first three
# kinds only; the port's own rule (NaN least, subnormals kept) is held by
# tests/test_torch_nan.py on the CPU and by the card tests on all five.
REFERENCE_EDGE_KINDS = ("signed_zeros", "inf_runs", "ties_across_segments")
EDGE_KINDS = REFERENCE_EDGE_KINDS + ("nan", "subnormals")
EDGE_GEOMETRIES = [
    (70_000, 128, 4, 1 << 17),   # default c, capacity > n, three levels
    (50_003, 64, 8, 1 << 16),    # c = 64: one chunk a warp for float64
    (9_000, 4, 4, 1 << 14),      # sub-warp chunks, seven levels
    (5_000, 128, 64, None),      # single-level plan
]
# Batch sizes around the 32-query tile: 1, 31, 33 and 32 k + 5.
EDGE_BATCHES = (1, 31, 33, 32 * 6 + 5)


def edge_input(kind, rng, n, c, dtype=np.float32):
    """Values where the answer turns on the tie rule.

    ``signed_zeros``: -0.0 and +0.0 side by side as every span's minimum;
    ``inf_runs``: +inf runs of a few chunks, one of them reaching the live
    end; ``ties_across_segments``: few distinct values, and one value
    below them every c - 1 entries, so one span finds equal minima in its
    partial chunks, on every upper level and in the top; ``nan``: quiet
    NaNs of both signs with distinct payloads, single, in runs and at
    chunk and segment edges (:func:`nan_input`); ``subnormals``: a
    sixteenth of the entries subnormal, of both signs, few distinct values
    so they tie (:func:`subnormal_input`)."""
    if kind == "nan":
        return nan_input(rng, n, c, dtype)
    if kind == "subnormals":
        return subnormal_input(rng, n, dtype)
    x = (rng.random(n) + 0.5).astype(dtype)
    if kind == "signed_zeros":
        z = rng.integers(0, max(n - 1, 1), max(n // 16, 2))
        x[z] = np.where(rng.random(z.size) < 0.5, -0.0, 0.0).astype(dtype)
        pairs = z[: z.size // 2]
        x[pairs] = -0.0  # -0.0 left of +0.0: the leftmost is -0.0
        x[np.minimum(pairs + 1, n - 1)] = 0.0
    elif kind == "inf_runs":
        for start in rng.integers(0, n, max(n // (8 * c), 1)):
            x[start:start + int(rng.integers(1, 4 * c))] = np.inf
        x[n - min(n, 3 * c):] = np.inf
    elif kind == "ties_across_segments":
        x = np.floor(x * 4).astype(dtype) / 4
        x[:: max(c - 1, 2)] = 0.25
    else:
        raise ValueError(kind)
    return x


def edge_spans(rng, n, c, m):
    """``m`` inclusive spans: :func:`query_batch`'s classes, then spans
    that start or end on chunk edges and spans over the live end."""
    ls, rs = query_batch(rng, n, c, m=max(m, 8))
    al = (rng.integers(0, max(n // c, 1), m) * c).clip(0, n - 1)
    ar = np.minimum(al + c * rng.integers(1, 2 * c + 2, m) - 1, n - 1)
    tl = np.maximum(n - rng.integers(1, 4 * c, m), 0)
    ls = np.concatenate([ls, al, tl, al]).astype(np.int32)
    rs = np.concatenate([rs, ar, np.full(m, n - 1), np.maximum(ar - 1,
                                                               al)])
    rs = rs.astype(np.int32)
    pick = rng.permutation(ls.size)[:m]
    return ls[pick], rs[pick]


def zero_heavy(rng, n, dtype=np.float32, share=0.3):
    """Values whose minimum is a zero of either sign in most chunks: a
    ``share`` of the entries set to -0.0 or +0.0 (the rest in [0.5, 1.5)),
    with -0.0 right before +0.0 in some pairs and +0.0 right before -0.0
    in others, so the leftmost minimal entry's sign is the answer's."""
    x = (rng.random(n) + 0.5).astype(dtype)
    if n == 0:
        return x
    k = max(int(n * share), 2)
    z = rng.integers(0, n, k)
    x[z] = np.where(rng.random(k) < 0.5, -0.0, 0.0).astype(dtype)
    pairs = z[: k // 4]
    x[pairs] = -0.0
    x[np.minimum(pairs + 1, n - 1)] = 0.0
    flipped = z[k // 4: k // 2]
    x[flipped] = 0.0
    x[np.minimum(flipped + 1, n - 1)] = -0.0
    return x


def _int_dtype(dtype):
    return np.int32 if np.dtype(dtype) == np.float32 else np.int64


def quiet_nans(rng, k, dtype=np.float32):
    """``k`` quiet NaNs of either sign, each with its own payload bits."""
    if np.dtype(dtype) == np.float32:
        bits = (0x7FC00000 | rng.integers(0, 1 << 22, k)).astype(np.int64)
        bits |= np.where(rng.random(k) < 0.5, 1 << 31, 0)
        return bits.astype(np.uint32).view(np.int32).view(np.float32)
    bits = (0x7FF8000000000000 | rng.integers(0, 1 << 51, k)).astype(
        np.uint64)
    bits |= np.where(rng.random(k) < 0.5, np.uint64(1 << 63),
                     np.uint64(0)).astype(np.uint64)
    return bits.view(np.float64)


def nan_input(rng, n, c, dtype=np.float32):
    """Values in [0.5, 1.5) with NaNs: single ones (about n / 128), runs
    of up to 2c, and NaNs on both sides of chunk edges (of c and c^2), each
    NaN with its own payload and sign; one number below every other value
    near each run, so spans beside a NaN have a least number too."""
    x = (rng.random(n) + 0.5).astype(dtype)
    if n == 0:
        return x
    at = [rng.integers(0, n, max(n // 128, 1))]
    for start in rng.integers(0, n, max(n // (32 * c), 1)):
        at.append(np.arange(start, min(start + int(rng.integers(1, 2 * c)),
                                       n)))
        x[max(start - 1, 0)] = 0.25
    for step in (c, c * c):
        edges = (rng.integers(1, max(n // step, 1) + 1, 4) * step)
        at.append(np.concatenate([edges - 1, edges]))
    at = np.concatenate(at)
    at = at[(at >= 0) & (at < n)]
    x[at] = quiet_nans(rng, at.size, dtype)
    return x


def subnormal_input(rng, n, dtype=np.float32):
    """Values in [0.5, 1.5) with a sixteenth of the entries subnormal: the
    smallest few of either sign and one near the normal range, so equal
    subnormals tie and the least of a span is often one."""
    x = (rng.random(n) + 0.5).astype(dtype)
    if n == 0:
        return x
    top = (1 << 23) - 1 if np.dtype(dtype) == np.float32 else (1 << 52) - 1
    pool = np.array([1, 2, 3, top], _int_dtype(dtype)).view(dtype)
    k = max(n // 16, 2)
    z = rng.integers(0, n, k)
    sign = np.where(rng.random(k) < 0.5, -1, 1).astype(dtype)
    x[z] = pool[rng.integers(0, pool.size, k)] * sign
    return x


# bfloat16 inputs (torch tensors on the CPU: numpy has no bfloat16).
# "dense": uniform [0, 1) cast to bf16, whose 8 mantissa bits make many
# entries tie, in a chunk and across chunks; "tied" / "zeros": tied_input /
# zero_heavy cast; the edge kinds: edge_input cast, with bf16 NaNs and
# subnormals made from their bits (a float cast would make every NaN
# 0x7fc0 and round float32 subnormals to zero).
BF16_KINDS = ("dense", "tied", "zeros") + EDGE_KINDS
BF16_REFERENCE_KINDS = ("dense", "tied", "zeros") + REFERENCE_EDGE_KINDS


def bf16_bits(bits):
    """A bfloat16 tensor from its 16-bit patterns (numpy integers)."""
    import torch

    return torch.from_numpy(
        np.asarray(bits).astype(np.uint16).view(np.int16)).view(
            torch.bfloat16)


def bf16_input(kind, rng, n, c):
    """``n`` bfloat16 values of ``kind`` (:data:`BF16_KINDS`)."""
    import torch

    if n == 0:
        return bf16_bits(np.zeros(0, np.int64))
    if kind == "dense":
        x = rng.random(n).astype(np.float32)
    elif kind == "tied":
        x = tied_input(rng, n)
    elif kind == "zeros":
        x = zero_heavy(rng, n)
    else:
        x = edge_input(kind, rng, n, c)
    bits = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    bits = bits.astype(np.int64) & 0xFFFF
    if kind == "nan":
        # quiet NaNs of either sign, each with its own payload
        at = np.isnan(x)
        k = int(at.sum())
        bits[at] = (0x7FC0 | rng.integers(0, 64, k)
                    | np.where(rng.random(k) < 0.5, 0x8000, 0))
    elif kind == "subnormals":
        # the smallest few of either sign and the largest, so they tie
        z = rng.integers(0, n, max(n // 16, 2))
        pool = np.array([1, 2, 3, 0x7F])
        bits[z] = (pool[rng.integers(0, pool.size, z.size)]
                   | np.where(rng.random(z.size) < 0.5, 0x8000, 0))
    return bf16_bits(bits)
