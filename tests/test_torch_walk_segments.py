"""A CPU rehearsal of the arithmetic of the Hopper query walk (B2, B4, B5,
B7).

``csrc/rmq_walk_hopper.cuh`` answers a query from its segments: the left
and the right partial chunk of every level below the top and the top's
range, which tile ``[l, r]`` from left to right (ranks 0 .. 2K).  It takes
the minimum over ``(value, segment rank, offset in the segment)`` instead
of over ``(value, position)``, gathers one position at the end, returns
the winning entry's own bits, and answers a span whose minimum is +inf
with its leftmost entry.  :func:`segment_walk` states that arithmetic in
plain PyTorch (test code only, on no path of the package) so that the tie
rule can be checked here against the JAX package's fused batch (interpret
mode, as ``tests/test_torch_query.py`` runs it), its core walk and brute
force, on the shared geometries with tied inputs, signed zeros, +inf runs
and equal minima in several segments of a span: positions bit for bit,
values bit for bit against the winning entry and equal to the
reference's (whose sign of a zero minimum is its min reduction's).  The
same arithmetic on the one-level geometry the short-span kernel (B5) runs
(level 0 as the top) is held to the reference's short-span kernel, and on
endpoint-sorted batches (the bulk kernel, B7) to the reference's bulk
pass; both give the bits of the multi-level walk on the same spans.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (
    GEOMETRIES,
    REFERENCE_EDGE_KINDS,
    brute_force,
    edge_input,
    edge_spans,
    query_batch,
    tied_input,
)
from repro.core.hierarchy import build_hierarchy as jbuild
from repro.core.plan import make_plan as jmake_plan
from repro.core.query import rmq_index_batch as jindex
from repro.core.query import rmq_value_batch as jvalue
from repro.kernels.rmq_bulk.ops import rmq_bulk_batch as jbulk
from repro.kernels.rmq_fused.ops import rmq_fused_batch as jfused_batch
from repro.kernels.rmq_short.ops import (
    rmq_short_index_batch,
    rmq_short_index_batch_pallas,
    rmq_short_value_batch,
    rmq_short_value_batch_pallas,
)
from repro_torch.core.constants import PAD_POS
from repro_torch.core.hierarchy import build_hierarchy
from repro_torch.core.plan import make_plan


def segments(plan, lo0: int, hi0: int, one_level: bool = False):
    """``[(rank, level, start, end)]`` of the half-open level-0 range
    ``[lo0, hi0)``, in rank order: left parts up the levels, the top,
    right parts down the levels; only nonempty segments.  ``one_level``:
    level 0 is the top (the short-span kernel's geometry)."""
    c, top_k = plan.c, 0 if one_level else plan.num_levels - 1
    left, right = [], []
    lo, hi, k = lo0, hi0, 0
    while k < top_k and lo < hi:
        next_l = -(-lo // c) * c
        a_hi = min(next_l, hi)
        b_lo = max((hi // c) * c, a_hi)
        left.append((k, k, lo, a_hi))
        right.append((2 * top_k - k, k, b_lo, hi))
        lo, hi, k = -(-lo // c), hi // c, k + 1
    top = []
    if k == top_k:
        top_len = plan.capacity if top_k == 0 else plan.padded_lens[top_k - 1]
        top = [(top_k, top_k, lo, min(hi, top_len))]
    return [s for s in left + top + right[::-1] if s[2] < s[3]]


def segment_walk(h, ls: np.ndarray, rs: np.ndarray, one_level=False):
    """``(values, positions)``: the walk's segment arithmetic, one query at
    a time (positions as the hierarchy's position dtype; int32 indices
    with ``one_level``, which reads level 0 alone)."""
    plan = h.plan
    levels = [h.base] + [
        h.upper[off:off + length]
        for off, length in zip(plan.offsets, plan.padded_lens)]
    inf = torch.tensor(float("inf"), dtype=h.base.dtype)
    vals = torch.empty(len(ls), dtype=h.base.dtype)
    pos = torch.empty(len(ls), dtype=torch.int32 if one_level
                      else h.upper_pos.dtype)
    for q, (l, r) in enumerate(zip(ls.tolist(), rs.tolist())):
        lo0, hi0 = max(l, 0), min(r + 1, plan.capacity)
        # The minimum over (value, segment rank, offset in the segment).
        best = None
        for rank, k, s, e in segments(plan, lo0, hi0, one_level):
            seg = levels[k][s:e]
            off = int(torch.argmin(seg))  # first offset of the segment min
            cand = (seg[off], rank, off)
            if best is None or (cand[0], cand[1]) < (best[0][0], best[0][1]):
                best = (cand, k, s)
        if best is None or not bool(best[0][0] < inf):
            # No finite entry: the leftmost entry of the span, +inf.
            vals[q] = inf
            pos[q] = lo0 if lo0 < hi0 else PAD_POS
            continue
        (value, _, off), k, s = best
        i = s + off
        vals[q] = value  # the winning entry's own bits
        # The one position gather.
        pos[q] = i if k == 0 else h.upper_pos[plan.offsets[k - 1] + i]
    return vals, pos


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def _check(x, n, c, t, cap, ls, rs):
    h = build_hierarchy(torch.from_numpy(x), make_plan(n, c=c, t=t,
                                                        capacity=cap), True)
    got_v, got_p = segment_walk(h, ls, rs)
    got_v, got_p = got_v.numpy(), got_p.numpy()
    bv, bp = brute_force(x, ls, rs)
    np.testing.assert_array_equal(got_p, bp)
    np.testing.assert_array_equal(_bits(got_v), _bits(x[bp]))
    jh = jbuild(jnp.asarray(x), jmake_plan(n, c=c, t=t, capacity=cap),
                with_positions=True)
    lj, rj = jnp.asarray(ls), jnp.asarray(rs)
    fv, fp = jfused_batch(jh, lj, rj, track_pos=True, interpret=True)
    for name, (v, p) in {"fused": (fv, fp),
                         "core": (jvalue(jh, lj, rj), jindex(jh, lj, rj))
                         }.items():
        # Positions bit for bit; values equal (the reference's sign of a
        # zero minimum is its min reduction's, which JAX leaves open).
        np.testing.assert_array_equal(got_p, np.asarray(p), err_msg=name)
        np.testing.assert_array_equal(got_v, np.asarray(v), err_msg=name)
        assert np.asarray(v).dtype == got_v.dtype, name


def test_segments_tile_the_span_in_rank_order():
    """The segments of every span are disjoint, in rank order, and cover
    [l, r] when mapped back to level 0."""
    for n, c, t, cap in GEOMETRIES:
        plan = make_plan(n, c=c, t=t, capacity=cap)
        rng = np.random.default_rng(n)
        ls, rs = query_batch(rng, n, c, m=48)
        for l, r in zip(ls.tolist(), rs.tolist()):
            segs = segments(plan, l, r + 1)
            assert [s[0] for s in segs] == sorted(s[0] for s in segs)
            covered = [(s * c ** k, e * c ** k) for _, k, s, e in segs]
            assert covered[0][0] == l and covered[-1][1] == r + 1
            for (_, e0), (s1, _) in zip(covered, covered[1:]):
                assert e0 == s1


@pytest.mark.parametrize("n,c,t,cap", GEOMETRIES)
def test_tied_inputs_match_reference(n, c, t, cap):
    rng = np.random.default_rng(7 * n + c)
    x = tied_input(rng, n)
    ls, rs = query_batch(rng, n, c, m=32)
    _check(x, n, c, t, cap, ls, rs)


@pytest.mark.parametrize("kind", REFERENCE_EDGE_KINDS)
@pytest.mark.parametrize("n,c,t,cap", GEOMETRIES)
def test_tie_edges_match_reference(n, c, t, cap, kind):
    rng = np.random.default_rng(11 * n + c)
    x = edge_input(kind, rng, n, c)
    ls, rs = edge_spans(rng, n, c, 40)
    _check(x, n, c, t, cap, ls, rs)


def test_float64_signed_zeros_match_reference():
    import jax

    n, c, t, cap = 777, 4, 2, 1024
    rng = np.random.default_rng(5)
    x = edge_input("signed_zeros", rng, n, c, np.float64)
    ls, rs = edge_spans(rng, n, c, 40)
    with jax.enable_x64(True):
        _check(x, n, c, t, cap, ls, rs)


def _short_of(ls, rs, c):
    """Each span cut to the short class (r // c - l // c <= 1)."""
    return ls, np.minimum(rs, (ls // c) * c + 2 * c - 1).astype(np.int32)


@pytest.mark.parametrize("kind", REFERENCE_EDGE_KINDS)
@pytest.mark.parametrize("n,c,t,cap", GEOMETRIES)
def test_one_level_walk_matches_reference_short(n, c, t, cap, kind):
    """B5's geometry: level 0 alone, as the top.  Positions bit for bit
    against the reference's short-span kernel (interpret mode) and its
    window scan; values equal to theirs, and bit for bit equal to the
    leftmost minimal entry and to the multi-level walk on the same
    spans."""
    rng = np.random.default_rng(13 * n + c)
    x = edge_input(kind, rng, n, c)
    ls, rs = _short_of(*edge_spans(rng, n, c, 40), c)
    h = build_hierarchy(torch.from_numpy(x), make_plan(n, c=c, t=t,
                                                        capacity=cap), True)
    got_v, got_p = (a.numpy() for a in segment_walk(h, ls, rs, True))
    full_v, full_p = (a.numpy() for a in segment_walk(h, ls, rs))
    bv, bp = brute_force(x, ls, rs)
    np.testing.assert_array_equal(got_p, bp)
    np.testing.assert_array_equal(_bits(got_v), _bits(x[bp]))
    np.testing.assert_array_equal(got_p, full_p)
    np.testing.assert_array_equal(_bits(got_v), _bits(full_v))
    jh = jbuild(jnp.asarray(x), jmake_plan(n, c=c, t=t, capacity=cap),
                with_positions=True)
    lj, rj = jnp.asarray(ls), jnp.asarray(rs)
    refs = {
        "kernel": (rmq_short_value_batch_pallas(jh, lj, rj, qb=16,
                                                interpret=True),
                   rmq_short_index_batch_pallas(jh, lj, rj, qb=16,
                                                interpret=True)),
        "ref": (rmq_short_value_batch(jh, lj, rj),
                rmq_short_index_batch(jh, lj, rj)),
    }
    for name, (v, p) in refs.items():
        np.testing.assert_array_equal(got_p, np.asarray(p), err_msg=name)
        np.testing.assert_array_equal(got_v, np.asarray(v), err_msg=name)


@pytest.mark.parametrize("kind", REFERENCE_EDGE_KINDS)
@pytest.mark.parametrize("n,c,t,cap", GEOMETRIES)
def test_sorted_bulk_batches_match_reference(n, c, t, cap, kind):
    """B7's batches: sorted by (chunk(l), chunk(r)) and padded with the
    bulk executor's (0, 0) sentinels.  Positions bit for bit against the
    reference's bulk pass (its lowering, and its kernel in interpret mode
    where it runs one), values equal to its values and bit for bit equal
    to the leftmost minimal entry."""
    rng = np.random.default_rng(17 * n + c)
    x = edge_input(kind, rng, n, c)
    ls, rs = edge_spans(rng, n, c, 40)
    order = np.lexsort((rs // c, ls // c))
    ls = np.concatenate([ls[order], np.zeros(5, np.int32)])
    rs = np.concatenate([rs[order], np.zeros(5, np.int32)])
    h = build_hierarchy(torch.from_numpy(x), make_plan(n, c=c, t=t,
                                                        capacity=cap), True)
    got_v, got_p = (a.numpy() for a in segment_walk(h, ls, rs))
    bv, bp = brute_force(x, ls, rs)
    np.testing.assert_array_equal(got_p, bp)
    np.testing.assert_array_equal(_bits(got_v), _bits(x[bp]))
    jh = jbuild(jnp.asarray(x), jmake_plan(n, c=c, t=t, capacity=cap),
                with_positions=True)
    lj, rj = jnp.asarray(ls), jnp.asarray(rs)
    refs = {"lowering": jbulk(jh, lj, rj, track_pos=True)}
    if jh.plan.num_levels >= 2 and jh.plan.capacity >= c:
        refs["kernel"] = jbulk(jh, lj, rj, track_pos=True, qb=16,
                               interpret=True)
    for name, (v, p) in refs.items():
        np.testing.assert_array_equal(got_p, np.asarray(p), err_msg=name)
        np.testing.assert_array_equal(got_v, np.asarray(v), err_msg=name)
