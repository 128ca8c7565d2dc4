"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where no CUDA device is present (decided
inside the test, never at import).  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Min and argmin are exact, so every RMQ comparison is bit-for-bit
(tolerance 0): values, leftmost positions and the +inf / PAD_POS padding.
The builds, the update and the value-only queries on zero-heavy input, and
every RMQ kernel on NaN and subnormal input, are compared as integer views
(``_same_bits``: ``torch.equal`` takes -0.0 for +0.0 and NaN for no value),
so a summary must carry its chunk's leftmost minimal entry's bits, NaN
being the least value.
Attention (B8) is held to its plain version within 2e-5 in float32 (the
same softmax summed in another order) and 2e-2 in bfloat16 (8-bit
mantissa inputs and output), the reference's own kernel-test tolerances.
The SSD scan (B9) is held within 1e-4 of max|plain| (the reference's SSD
test tolerance; float32 sums in other orders), its gradient and the
train steps on the card as stated at each test.
"""

import time

import numpy as np
import pytest
import torch

from _torch_cases import (
    BF16_KINDS,
    EDGE_BATCHES,
    EDGE_GEOMETRIES,
    EDGE_KINDS,
    GEOMETRIES,
    brute_force,
    edge_input,
    edge_spans,
    bf16_input,
    query_batch,
    tied_input,
    zero_heavy,
)
from repro_torch.core import RMQ, build_hierarchy, make_plan, rmq_walk_batch
from repro_torch.kernels.hierarchy_build import ops as build_ops
from repro_torch.kernels.hierarchy_fused import ops as fused_ops
from repro_torch.kernels.rmq_fused import ops as qfused_ops
from repro_torch.kernels.rmq_scan import ops as scan_ops

CARD_GEOMETRIES = GEOMETRIES + [
    (1 << 16, 128, 64, None),     # default geometry, 3 levels
    (70_000, 4, 64, 1 << 17),     # sub-warp chunks, many levels
    (50_001, 32, 8, None),        # one chunk per warp exactly
    (40_000, 1024, 4, None),      # several entries per lane
    (200_000, 128, 1024, None),   # top too large to stage
    (3, 128, 64, 64),             # n and capacity below c
    ((1 << 20) - 777, 128, 64, 1 << 20),  # a full c*t top (8192)
    (100_000, 128, 1024, None),   # single level, too large to stage
    ((1 << 24) + 6, 64, 1, None),  # float64 one chunk a warp, five levels
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", CARD_GEOMETRIES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_pos", [False, True])
def test_builds_match_plain(card, n, c, t, cap, dtype, with_pos):
    x = torch.from_numpy(
        tied_input(np.random.default_rng(n + c), n, dtype)).to(card)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    ref = build_hierarchy(x, plan, with_positions=with_pos)
    fused0, level0 = fused_ops.LAUNCHES.launches, build_ops.LAUNCHES.launches
    got_f = fused_ops.build_hierarchy_fused(x, plan, with_pos)
    got_l = build_ops.build_hierarchy_percall(x, plan, with_pos)
    torch.cuda.synchronize()
    assert fused_ops.LAUNCHES.launches - fused0 == min(
        1, plan.num_levels - 1)
    assert build_ops.LAUNCHES.launches - level0 == plan.num_levels - 1
    for got in (got_f, got_l):
        _same_bits(got.base, ref.base)
        _same_bits(got.upper, ref.upper)
        assert got.with_positions == with_pos
        if with_pos:
            _same_bits(got.upper_pos, ref.upper_pos)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", CARD_GEOMETRIES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_queries_match_plain(card, n, c, t, cap, dtype):
    rng = np.random.default_rng(3 * n + c)
    xn = tied_input(rng, n, dtype)
    x = torch.from_numpy(xn).to(card)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    h = build_hierarchy(x, plan, with_positions=True)
    ls_n, rs_n = query_batch(rng, n, c)
    ls, rs = torch.from_numpy(ls_n).to(card), torch.from_numpy(rs_n).to(card)
    want_v, want_p = rmq_walk_batch(h, ls, rs, track_pos=True)
    bv, bp = brute_force(xn, ls_n, rs_n)
    np.testing.assert_array_equal(want_v.cpu().numpy(), bv)
    np.testing.assert_array_equal(want_p.cpu().numpy(), bp)

    f0, s0 = qfused_ops.LAUNCHES.launches, scan_ops.LAUNCHES.launches
    fv, fp = qfused_ops.rmq_fused_batch(h, ls, rs, track_pos=True)
    fv_only = qfused_ops.rmq_fused_value_batch(h, ls, rs)
    sv = scan_ops.rmq_value_batch_cuda(h, ls, rs)
    sp = scan_ops.rmq_index_batch_cuda(h, ls, rs)
    torch.cuda.synchronize()
    assert qfused_ops.LAUNCHES.launches - f0 == 2
    assert scan_ops.LAUNCHES.launches - s0 == 2
    for v in (fv, fv_only, sv):
        _assert_same(want_v, v)
    for p in (fp, sp):
        _assert_same(want_p, p)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


@pytest.mark.gpu
@pytest.mark.parametrize("m", EDGE_BATCHES)
@pytest.mark.parametrize("n,c,t,cap", EDGE_GEOMETRIES)
@pytest.mark.parametrize("kind", EDGE_KINDS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_queries_tie_edges_match_plain(card, n, c, t, cap, kind, dtype, m):
    """B2 (both planes and value-only) and both B4 launches on the edges
    of the leftmost-tie rule: -0.0 beside +0.0, +inf minima, equal minima
    in several segments of a span, NaNs (the least value: a span answers
    its leftmost NaN) and subnormals, batches around the 32-query tile.
    Positions bit for bit against the plain walk and brute force (whose
    np.argmin takes the first NaN); values as integer views against the
    plain walk's and the winning entry's (every route returns the winning
    entry's own bits)."""
    rng = np.random.default_rng(n + m)
    xn = edge_input(kind, rng, n, c, dtype)
    ls_n, rs_n = edge_spans(rng, n, c, m)
    x = torch.from_numpy(xn).to(card)
    h = build_hierarchy(x, make_plan(n, c=c, t=t, capacity=cap),
                        with_positions=True)
    ls, rs = torch.from_numpy(ls_n).to(card), torch.from_numpy(rs_n).to(card)
    want_v, want_p = rmq_walk_batch(h, ls, rs, track_pos=True)
    bv, bp = brute_force(xn, ls_n, rs_n)
    np.testing.assert_array_equal(want_p.cpu().numpy(), bp)

    f0, s0 = qfused_ops.LAUNCHES.launches, scan_ops.LAUNCHES.launches
    fv, fp = qfused_ops.rmq_fused_batch(h, ls, rs, track_pos=True)
    fv_only = qfused_ops.rmq_fused_value_batch(h, ls, rs)
    sv = scan_ops.rmq_value_batch_cuda(h, ls, rs)
    sp = scan_ops.rmq_index_batch_cuda(h, ls, rs)
    torch.cuda.synchronize()
    assert qfused_ops.LAUNCHES.launches - f0 == 2
    assert scan_ops.LAUNCHES.launches - s0 == 2
    for v in (fv, fv_only, sv):
        _same_bits(v, want_v)
        np.testing.assert_array_equal(_bits(v.cpu().numpy()), _bits(xn[bp]))
    for p in (fp, sp):
        _assert_same(want_p, p)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", CARD_GEOMETRIES)
@pytest.mark.parametrize("kind", ["nan", "subnormals"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_pos", [False, True])
def test_builds_nan_and_subnormals_match_plain(card, n, c, t, cap, kind,
                                               dtype, with_pos):
    """B1 and B3 on NaN and subnormal input: the plain build's bits
    (integer views), value-only and with positions: a chunk holding a NaN
    keeps its leftmost NaN's bits and position, subnormals stay."""
    rng = np.random.default_rng(17 * n + c)
    x = torch.from_numpy(edge_input(kind, rng, n, c, dtype)).to(card)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    ref = build_hierarchy(x, plan, with_positions=with_pos)
    for build in (fused_ops.build_hierarchy_fused,
                  build_ops.build_hierarchy_percall):
        got = build(x, plan, with_pos)
        torch.cuda.synchronize()
        _same_bits(got.upper, ref.upper)
        if with_pos:
            _same_bits(got.upper_pos, ref.upper_pos)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["fused", "cuda", "eager"])
def test_facade_on_card(card, backend):
    rng = np.random.default_rng(11)
    n = 100_003
    xn = tied_input(rng, n)
    rmq = RMQ.build(xn, with_positions=True, backend=backend)
    assert rmq.device.type == "cuda" and rmq.backend == backend
    ls, rs = query_batch(rng, n, 128)
    bv, bp = brute_force(xn, ls, rs)
    np.testing.assert_array_equal(rmq.query(ls, rs).cpu().numpy(), bv)
    np.testing.assert_array_equal(rmq.query_index(ls, rs).cpu().numpy(), bp)


@pytest.mark.gpu
def test_auto_backend_is_cuda_on_card(card):
    rmq = RMQ.build(np.arange(5000, dtype=np.float32))
    assert rmq.backend == "cuda" and rmq.device.type == "cuda"


@pytest.mark.gpu
def test_kernel_refuses_int32_overflowing_plan(card):
    """A position build whose padded extent passes 2^31 never launches."""
    plan = make_plan(8, c=128, t=64, capacity=2**31)
    x = torch.zeros(8, device=card)
    before = fused_ops.LAUNCHES.launches
    with pytest.raises(ValueError, match="int32 index space"):
        fused_ops.build_hierarchy_fused(x, plan, with_positions=True)
    assert fused_ops.LAUNCHES.launches == before


# -- the second slice: update (B6), short spans (B5), bulk (B7) -----------
SLICE2_GEOMETRIES = [
    (70_000, 4, 64, 1 << 17),     # sub-warp chunks, capacity > n
    (50_001, 32, 8, None),        # one chunk per warp, ragged
    (1 << 16, 128, 64, None),     # default geometry
    (100_003, 128, 4, 1 << 17),   # ragged, capacity > n, four levels
    (1000, 32, 2, 1500),          # ragged capacity
    (700, 128, 64, None),         # single-level plan
    (3, 128, 64, 64),             # capacity < 2c
]


# The eviction index of llama3.2-3b serving: c = 16, t = 4 over the 2120
# score slots (cache 2048 + 64 + 8), live regions of every round.
EVICTION_GEOMETRIES = [
    (2120, 16, 4, None),
    (2033, 16, 4, 2120),
    (1575, 16, 4, 2120),
]


def _short_spans(rng, n, c, m=512):
    ls = rng.integers(0, n, m)
    rs = np.minimum((ls // c + rng.integers(0, 2, m)) * c
                    + rng.integers(0, c, m), n - 1)
    rs = np.maximum(rs, ls)
    return ls.astype(np.int32), rs.astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", SLICE2_GEOMETRIES
                         + EVICTION_GEOMETRIES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_pos", [False, True])
def test_update_kernel_matches_plain(card, n, c, t, cap, dtype, with_pos):
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.streaming import updates as U

    rng = np.random.default_rng(7 * n + c)
    x = torch.from_numpy(tied_input(rng, n, dtype)).to(card)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    h = build_hierarchy(x, plan, with_positions=with_pos)
    idxs = rng.integers(-3, plan.capacity + 3, 300)
    idxs[:40] = idxs[40:80]  # duplicates: the last one wins
    vals = (rng.random(300) - 0.5).astype(dtype)
    tail = (rng.random(min(plan.capacity - n, 257)) - 0.25).astype(dtype)
    before = upd_ops.LAUNCHES.launches
    got = upd_ops.update_hierarchy_cuda(h, idxs, vals)
    got_a = upd_ops.append_hierarchy_cuda(got, tail, n)
    torch.cuda.synchronize()
    appends = 1 if len(tail) else 0
    assert upd_ops.LAUNCHES.launches - before == (1 + appends) * (
        plan.num_levels - 1)
    want = U.update_hierarchy(h, torch.from_numpy(idxs),
                              torch.from_numpy(vals))
    want_a = U.append_hierarchy(want, torch.from_numpy(tail), n)
    fresh = build_hierarchy(want_a.base[:plan.capacity].clone(), make_plan(
        plan.capacity, c=c, t=t), with_positions=with_pos)
    for g, w in ((got, want), (got_a, want_a)):
        _assert_same(w.base, g.base)
        _assert_same(w.upper, g.upper)
        if with_pos:
            _assert_same(w.upper_pos, g.upper_pos)
    _assert_same(fresh.upper, got_a.upper)
    # the predecessor is untouched
    _assert_same(build_hierarchy(x, plan, with_positions=with_pos).upper,
                 h.upper)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", SLICE2_GEOMETRIES
                         + EVICTION_GEOMETRIES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_short_kernel_matches_plain(card, n, c, t, cap, dtype):
    from repro_torch.kernels.rmq_short import ops as short_ops

    rng = np.random.default_rng(5 * n + c)
    xn = tied_input(rng, n, dtype)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    for with_pos in (False, True):
        h = build_hierarchy(torch.from_numpy(xn).to(card), plan, with_pos)
        ls_n, rs_n = _short_spans(rng, n, c)
        ls = torch.from_numpy(ls_n).to(card)
        rs = torch.from_numpy(rs_n).to(card)
        before = short_ops.LAUNCHES.launches
        gv, gp = short_ops.rmq_short_batch(h, ls, rs, track_pos=True)
        gv_only = short_ops.rmq_short_value_batch(h, ls, rs)
        torch.cuda.synchronize()
        assert short_ops.LAUNCHES.launches - before == 2
        wv, wp = short_ops.rmq_short_batch_plain(
            h.base, ls, rs, c, plan.capacity, True)
        _assert_same(wv, gv)
        _assert_same(wv, gv_only)
        _assert_same(wp, gp)
        bv, bp = brute_force(xn, ls_n, rs_n)
        np.testing.assert_array_equal(gv.cpu().numpy(), bv)
        np.testing.assert_array_equal(gp.cpu().numpy(), bp)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", SLICE2_GEOMETRIES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ordered", [False, True])
def test_bulk_kernel_matches_plain(card, n, c, t, cap, dtype, ordered):
    from repro_torch.kernels.rmq_bulk import ops as bulk_ops

    rng = np.random.default_rng(11 * n + c)
    xn = tied_input(rng, n, dtype)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    h = build_hierarchy(torch.from_numpy(xn).to(card), plan, True)
    ls_n, rs_n = query_batch(rng, n, c, m=2048)
    if ordered:
        order = np.lexsort((rs_n // c, ls_n // c))
        ls_n, rs_n = ls_n[order], rs_n[order]
    # (0, 0) sentinels, as the bulk executor pads its buckets
    ls_n = np.concatenate([ls_n, np.zeros(37, np.int32)])
    rs_n = np.concatenate([rs_n, np.zeros(37, np.int32)])
    ls = torch.from_numpy(ls_n).to(card)
    rs = torch.from_numpy(rs_n).to(card)
    before = bulk_ops.LAUNCHES.launches
    gv, gp = bulk_ops.rmq_bulk_batch(h, ls, rs, track_pos=True)
    gv_only = bulk_ops.rmq_bulk_value_batch(h, ls, rs)
    torch.cuda.synchronize()
    assert bulk_ops.LAUNCHES.launches - before == 2
    wv, wp = rmq_walk_batch(h, ls, rs, track_pos=True)
    fv, fp = qfused_ops.rmq_fused_batch(h, ls, rs, track_pos=True)
    for v in (gv, gv_only, fv):
        _assert_same(wv, v)
    for p in (gp, fp):
        _assert_same(wp, p)
    bv, bp = brute_force(xn, ls_n, rs_n)
    np.testing.assert_array_equal(gv.cpu().numpy(), bv)
    np.testing.assert_array_equal(gp.cpu().numpy(), bp)


def _int_view(t):
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _same_bits(got, want):
    """Bit for bit: dtype, shape and the integer views (-0.0 != +0.0)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_int_view(got), _int_view(want))


@pytest.mark.gpu
@pytest.mark.parametrize("m", EDGE_BATCHES)
@pytest.mark.parametrize("n,c,t,cap", EDGE_GEOMETRIES)
@pytest.mark.parametrize("kind", EDGE_KINDS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_short_bulk_tie_edges_match_fused(card, n, c, t, cap, kind, dtype,
                                          m):
    """B5 and B7 against B2 on the same spans, bit for bit as integer
    views (torch.equal takes -0.0 for +0.0): signed zeros, +inf runs,
    equal minima in several segments, batches around the 32-query tile.
    B7 on unsorted and endpoint-sorted batches, on a position build and on
    a value-only build (B2 on the same build); B5 on the spans cut to the
    short class, on both builds, against B2 on the position build (level
    0 is the same; a position build's upper entries carry their chunk's
    leftmost minimal entry's bits).  Values also bit for bit against the
    leftmost minimal entry, positions against brute force."""
    from repro_torch.kernels.rmq_bulk import ops as bulk_ops
    from repro_torch.kernels.rmq_short import ops as short_ops

    rng = np.random.default_rng(2 * n + m)
    xn = edge_input(kind, rng, n, c, dtype)
    ls_n, rs_n = edge_spans(rng, n, c, m)
    x = torch.from_numpy(xn).to(card)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    hp = build_hierarchy(x, plan, with_positions=True)
    hv = build_hierarchy(x, plan, with_positions=False)
    sorted_ = np.lexsort((rs_n // c, ls_n // c))
    s_rs = np.minimum(rs_n, (ls_n // c) * c + 2 * c - 1).astype(np.int32)
    b0, s0 = bulk_ops.LAUNCHES.launches, short_ops.LAUNCHES.launches
    for l_n, r_n, short in ((ls_n, rs_n, False),
                            (ls_n[sorted_], rs_n[sorted_], False),
                            (ls_n, s_rs, True)):
        ls = torch.from_numpy(l_n).to(card)
        rs = torch.from_numpy(r_n).to(card)
        fv, fp = qfused_ops.rmq_fused_batch(hp, ls, rs, track_pos=True)
        if short:
            got = [short_ops.rmq_short_batch(h, ls, rs, track_pos=True)
                   for h in (hp, hv)]
            only = [short_ops.rmq_short_value_batch(h, ls, rs)
                    for h in (hp, hv)]
            want_only = [fv, fv]
        else:
            got = [bulk_ops.rmq_bulk_batch(hp, ls, rs, track_pos=True)]
            only = [bulk_ops.rmq_bulk_value_batch(h, ls, rs)
                    for h in (hp, hv)]
            want_only = [fv, qfused_ops.rmq_fused_value_batch(hv, ls, rs)]
        torch.cuda.synchronize()
        bv, bp = brute_force(xn, l_n, r_n)
        for v, p in got:
            _same_bits(v, fv)
            _assert_same(fp, p)
            np.testing.assert_array_equal(p.cpu().numpy(), bp)
            np.testing.assert_array_equal(_bits(v.cpu().numpy()),
                                          _bits(xn[bp]))
        for v, w in zip(only, want_only):
            _same_bits(v, w)
    assert bulk_ops.LAUNCHES.launches - b0 == 6
    assert short_ops.LAUNCHES.launches - s0 == 4


# Zero-heavy input: a third of the entries -0.0 or +0.0, so most chunks'
# minimum is a zero and the leftmost one's sign is the summary's (ROADMAP
# C5: the value-only builds and B6 kept whichever zero a lane met first).
@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", CARD_GEOMETRIES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_pos", [False, True])
def test_builds_zero_heavy_match_plain(card, n, c, t, cap, dtype, with_pos):
    """B1 and B3 on zero-heavy input: the plain build's bits (integer
    views), value-only and with positions."""
    x = torch.from_numpy(
        zero_heavy(np.random.default_rng(5 * n + c), n, dtype)).to(card)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    ref = build_hierarchy(x, plan, with_positions=with_pos)
    for build in (fused_ops.build_hierarchy_fused,
                  build_ops.build_hierarchy_percall):
        got = build(x, plan, with_pos)
        torch.cuda.synchronize()
        _same_bits(got.upper, ref.upper)
        if with_pos:
            _same_bits(got.upper_pos, ref.upper_pos)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", CARD_GEOMETRIES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_pos", [False, True])
def test_update_zero_heavy_matches_plain(card, n, c, t, cap, dtype,
                                         with_pos):
    """B6 on zero-heavy hierarchies and batches (zeros of either sign
    written over zeros and over values): the plain update's bits."""
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.streaming import updates as U

    rng = np.random.default_rng(11 * n + c)
    x = torch.from_numpy(zero_heavy(rng, n, dtype)).to(card)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    h = build_hierarchy(x, plan, with_positions=with_pos)
    idxs = rng.integers(0, plan.capacity, 512)
    vals = zero_heavy(rng, 512, dtype, share=0.5)
    tail = zero_heavy(rng, min(plan.capacity - n, 257), dtype, share=0.5)
    got = [upd_ops.update_hierarchy_cuda(h, idxs, vals)]
    want = [U.update_hierarchy(h, torch.from_numpy(idxs),
                               torch.from_numpy(vals))]
    if tail.size:
        got.append(upd_ops.append_hierarchy_cuda(got[0], tail, n))
        want.append(U.append_hierarchy(want[0], torch.from_numpy(tail), n))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _same_bits(g.base, w.base)
        _same_bits(g.upper, w.upper)
        if with_pos:
            _same_bits(g.upper_pos, w.upper_pos)


# B6's layouts: the run layout (c = 128 float32, c = 64 float64, whole
# vectors), part by part with sub-warp chunks, several entries a lane and
# a capacity that is not a whole number of vectors, a level with fewer
# chunks than the batch, and single-level plans (no launch).
UPDATE_GEOMETRIES = [
    (70_000, 128, 4, 1 << 17),
    (50_003, 64, 8, 1 << 16),
    (9_000, 4, 4, 1 << 14),
    (40_000, 1024, 4, None),
    (20_001, 16, 4, 20_001),
    (4096, 8, 2, None),
    (700, 128, 64, None),
]


def _runs_batch(rng, cap, size, dtype, kind):
    """Indices with duplicates, a run of one index over three 32-entry
    slices, negatives and indices past capacity; values of ``kind``."""
    idxs = rng.integers(-4, cap + 4, size)
    idxs[: size // 4] = idxs[size // 4: 2 * (size // 4)]
    idxs[-70:] = idxs[-71]
    if kind == "zero_heavy":
        vals = zero_heavy(rng, size, dtype, share=0.5)
    elif kind == "tied":
        vals = tied_input(rng, size, dtype) - 0.75
    else:
        vals = edge_input(kind, rng, size, 4, dtype) - 0.75
    return idxs.astype(np.int64), vals.astype(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", UPDATE_GEOMETRIES)
@pytest.mark.parametrize("kind", ["tied", "nan", "subnormals",
                                  "zero_heavy"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_pos", [False, True])
@pytest.mark.parametrize("size", [1, 33, 5000])
def test_update_sorted_runs_match_plain(card, n, c, t, cap, kind, dtype,
                                        with_pos, size):
    """B6 on the cases of the CPU rehearsal (tests/test_torch_update_runs
    .py): an update and two appends, each equal to the plain update as
    integer views, with L - 1 launches each."""
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.streaming import updates as U

    rng = np.random.default_rng(19 * n + size)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    base = tied_input(rng, n, dtype) if kind == "tied" else (
        zero_heavy(rng, n, dtype) if kind == "zero_heavy"
        else edge_input(kind, rng, n, c, dtype))
    h = build_hierarchy(torch.from_numpy(base).to(card), plan, with_pos)
    idxs, vals = _runs_batch(rng, plan.capacity, max(size, 72), dtype, kind)
    it = torch.from_numpy(idxs[:size]).to(card)
    vt = torch.from_numpy(vals[:size]).to(card)
    before = upd_ops.LAUNCHES.launches
    got = [upd_ops.update_hierarchy_cuda(h, it, vt)]
    want = [U.update_hierarchy(h, it, vt)]
    room = plan.capacity - n
    for count in (min(room, 300), min(room - min(room, 300), 5)):
        if count <= 0:
            continue
        tail = torch.from_numpy(vals[:count]).to(card) - 1
        start = plan.capacity - room
        got.append(upd_ops.append_hierarchy_cuda(got[-1], tail, start))
        want.append(U.append_hierarchy(want[-1], tail, start))
        room -= count
    torch.cuda.synchronize()
    assert upd_ops.LAUNCHES.launches - before == len(got) * (
        plan.num_levels - 1)
    for g, w in zip(got, want):
        _same_bits(g.base, w.base)
        _same_bits(g.upper, w.upper)
        if with_pos:
            _same_bits(g.upper_pos, w.upper_pos)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "fused"])
def test_mutations_never_wait_for_the_card(card, backend):
    """RMQ.update and StreamingRMQ.update / append / retire, with the batch
    already on the card, run under torch.cuda.set_sync_debug_mode("error")
    (any host sync raises), each with L - 1 launches, and equal the plain
    path; they also return while a sleep kernel queued before them still
    runs.  Control: the plain update of a batch smaller than level 1 (its
    per-level torch.unique) on the card raises under the same mode and
    returns only after the sleep."""
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.streaming import StreamingRMQ
    from repro_torch.streaming import updates as U

    rng = np.random.default_rng(23)
    n, cap, c, t = 70_000, 1 << 17, 128, 4
    xn = tied_input(rng, n)
    rmq = RMQ.build(xn, c=c, t=t, with_positions=True, backend=backend,
                    capacity=cap)
    s = StreamingRMQ.from_array(xn, c=c, t=t, capacity=cap,
                                with_positions=True, backend=backend)
    levels = rmq.plan.num_levels
    assert levels >= 3
    idxs = torch.from_numpy(rng.integers(-2, cap + 2, 4000)).to(card)
    vals = torch.from_numpy(rng.random(4000).astype(np.float32)).to(card)
    tail = torch.from_numpy(rng.random(999).astype(np.float32)).to(card)
    rmq.update(idxs, vals)  # builds the library outside the mode
    torch.cuda.synchronize()
    before = upd_ops.LAUNCHES.launches
    got = {}

    def mutate():
        got["r2"] = rmq.update(idxs, vals)
        got["s2"] = s.update(idxs, vals).append(tail).retire(1000)

    assert not _waits_for_the_card(mutate, strict=True)
    torch.cuda.synchronize()
    r2, s2 = got["r2"], got["s2"]
    assert upd_ops.LAUNCHES.launches - before == 4 * (levels - 1)
    want = U.update_hierarchy(rmq.hierarchy, idxs, vals)
    for g, w in ((r2.hierarchy.upper, want.upper),
                 (r2.hierarchy.upper_pos, want.upper_pos),
                 (r2.hierarchy.base, want.base)):
        _same_bits(g, w)
    ws = U.update_hierarchy(s.hierarchy, idxs, vals)
    ws = U.append_hierarchy(ws, tail, n)
    ws = U.update_hierarchy(ws, torch.arange(1000, device=card),
                            torch.full((1000,), float("inf"), device=card))
    _same_bits(s2.hierarchy.upper, ws.upper)
    _same_bits(s2.hierarchy.upper_pos, ws.upper_pos)
    h = rmq.hierarchy
    # fewer indices than level 1 has chunks: the plain update dedupes them
    # with torch.unique (a larger batch re-reduces every chunk instead)
    few, fv = idxs[:500], vals[:500]
    assert few.numel() < rmq.plan.level_lens[1]
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError, match="synchroniz"):
            U.update_hierarchy(h, few, fv)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _waits_for_the_card(lambda: U.update_hierarchy(h, few, fv),
                               strict=False)


def _waits_for_the_card(fn, strict: bool, cycles: int = 200_000_000):
    """Whether ``fn()`` waited for a sleep kernel queued on the stream just
    before it: it returned after the sleep's own time (measured alone), or
    found the stream idle; ``fn`` runs under
    ``set_sync_debug_mode("error")`` where ``strict``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    sleep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    if strict:
        torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    busy = not torch.cuda.current_stream().query()
    call_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return call_s >= 0.9 * sleep_s or not busy


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", CARD_GEOMETRIES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_value_only_builds_answer_with_the_leftmost_zero(card, n, c, t, cap,
                                                         dtype):
    """B2 on value-only B1 and B3 builds of zero-heavy data equals B2 on a
    position build of the same data, bit for bit, and each answer is its
    leftmost minimal entry's bits."""
    rng = np.random.default_rng(13 * n + c)
    xn = zero_heavy(rng, n, dtype)
    x = torch.from_numpy(xn).to(card)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    ls_n, rs_n = query_batch(rng, n, c)
    ls, rs = torch.from_numpy(ls_n).to(card), torch.from_numpy(rs_n).to(card)
    hp = fused_ops.build_hierarchy_fused(x, plan, True)
    fv, _ = qfused_ops.rmq_fused_batch(hp, ls, rs, track_pos=True)
    got = [qfused_ops.rmq_fused_value_batch(build(x, plan, False), ls, rs)
           for build in (fused_ops.build_hierarchy_fused,
                         build_ops.build_hierarchy_percall)]
    torch.cuda.synchronize()
    for v in got:
        _same_bits(v, fv)
    _, bp = brute_force(xn, ls_n, rs_n)
    np.testing.assert_array_equal(_bits(fv.cpu().numpy()), _bits(xn[bp]))


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["fused", "cuda"])
def test_mutation_and_engine_on_card(card, backend):
    """build -> update/append -> attach -> query again, on the card."""
    rng = np.random.default_rng(13)
    n, cap = 200_003, 1 << 18
    xn = tied_input(rng, n)
    rmq = RMQ.build(xn, c=32, t=16, with_positions=True, backend=backend,
                    capacity=cap)
    engine = rmq.engine(bulk_crossover=512)
    ls, rs = query_batch(rng, n, 32, m=1500)
    for got in (engine.query(ls, rs), engine.query_bulk(ls, rs)):
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      brute_force(xn, ls, rs)[0])
    idxs = rng.integers(0, n, 999)
    vals = (rng.random(999) - 0.5).astype(np.float32)
    rmq2 = rmq.update(idxs, vals).append(np.full(77, -2.0, np.float32))
    engine.attach(rmq2)
    x2 = xn.copy()
    for i, v in zip(idxs, vals):
        x2[i] = v
    x2 = np.concatenate([x2, np.full(77, -2.0, np.float32)])
    ls2, rs2 = query_batch(rng, n + 77, 32, m=1500)
    bv, bp = brute_force(x2, ls2, rs2)
    np.testing.assert_array_equal(engine.query(ls2, rs2).cpu().numpy(), bv)
    np.testing.assert_array_equal(
        engine.query_index(ls2, rs2).cpu().numpy(), bp)
    np.testing.assert_array_equal(
        engine.query_bulk(ls2, rs2, "index").cpu().numpy(), bp)
    # the predecessor still answers its own data
    np.testing.assert_array_equal(rmq.query(ls, rs).cpu().numpy(),
                                  brute_force(xn, ls, rs)[0])


@pytest.mark.gpu
def test_update_kernel_refuses_int32_overflowing_plan(card):
    """An update whose padded extent passes 2^31 never launches (the
    check comes before any operand is touched)."""
    from repro_torch.core import Hierarchy
    from repro_torch.kernels.hierarchy_update import ops as upd_ops

    plan = make_plan(8, c=128, t=64, capacity=2**31)
    huge = Hierarchy(base=torch.zeros(8, device=card),
                     upper=torch.zeros(8, device=card),
                     upper_pos=torch.zeros(8, dtype=torch.int32,
                                           device=card), plan=plan)
    before = upd_ops.LAUNCHES.launches
    with pytest.raises(ValueError, match="int32 index space"):
        upd_ops.update_hierarchy_cuda(huge, [1], [0.0])
    assert upd_ops.LAUNCHES.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_streaming_on_card(card, dtype):
    from repro_torch.streaming import StreamingRMQ

    rng = np.random.default_rng(17)
    n, cap, c = 30_001, 40_000, 32
    xn = tied_input(rng, n, dtype)
    s = StreamingRMQ.from_array(xn, c=c, t=4, capacity=cap,
                                with_positions=True, backend="fused")
    assert s.device.type == "cuda"
    tail = (rng.random(999) - 0.5).astype(dtype)
    s = s.append(tail).retire(3000).update([5000, 5000], [-7.0, -8.0])
    arr = np.concatenate([xn, tail])
    arr[:3000] = np.inf
    arr[5000] = -8.0
    plain = build_hierarchy(torch.from_numpy(arr).to(card), make_plan(
        len(arr), c=c, t=4, capacity=cap), True)
    _assert_same(plain.upper, s.hierarchy.upper)
    _assert_same(plain.upper_pos, s.hierarchy.upper_pos)
    ls, rs = query_batch(rng, len(arr), c)
    bv, bp = brute_force(arr, ls, rs)
    np.testing.assert_array_equal(s.query(ls, rs).cpu().numpy(), bv)
    np.testing.assert_array_equal(s.query_index(ls, rs).cpu().numpy(), bp)


# ---------------------------------------------------------------------------
# flash_attention (B8)
# ---------------------------------------------------------------------------
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _attn_inputs(card, seed, b, hq, hkv, s, d, dtype):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn((b, h, s, d), generator=g, device=card).to(dtype)
            for h in (hq, hkv, hkv)]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("group", [1, 3, 8])
@pytest.mark.parametrize("window", [None, 128, 1024, 1, 63, 64, 65])
@pytest.mark.parametrize("s", [128, 1971, 2048, 63, 64, 65, 127, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(card, d, group, window, s, dtype):
    """Lengths and windows at and beside the bf16 kernel's tiles (128
    query rows, 64 keys), where it masks; interior tiles go unmasked."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    b = 2 if s == 128 else 1
    q, k, v = _attn_inputs(card, d * s + group, b, 2 * group, 2, s, d,
                           dtype)
    before = fa_ops.LAUNCHES.launches
    got = fa_ops.attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES.launches - before == 1
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q, k, v, window=window)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_flash_first_token_and_scale(card):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = _attn_inputs(card, 0, 1, 2, 1, 300, 64, torch.float32)
    out = fa_ops.attention(q, k, v)
    torch.testing.assert_close(out[0, :, 0], v[0, :, 0].expand(2, 64),
                               atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(fa_ops.attention(q, k, v, scale=0.3),
                               attention_ref(q, k, v, scale=0.3),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_views_at_odd_offsets(card, dtype):
    """The kernels copy 16 bytes at a time; a contiguous view that starts
    off a 16-byte boundary is copied by the wrapper, not misread."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = _attn_inputs(card, 7, 1, 4, 2, 200, 64, dtype)
    flat = torch.empty(q.numel() + 1, dtype=dtype, device=card)
    flat[1:] = q.flatten()
    q_odd = flat[1:].view(q.shape)
    assert q_odd.is_contiguous() and q_odd.data_ptr() % 16
    before = fa_ops.LAUNCHES.launches
    got = fa_ops.attention(q_odd, k, v)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES.launches - before == 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(),
                               attention_ref(q, k, v).float(),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
def test_flash_refusals_on_card_count_nothing(card):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.profiling import count_launches

    q, k, v = _attn_inputs(card, 1, 1, 4, 2, 64, 32, torch.float32)
    bad = [
        (lambda: fa_ops.attention(q, k, v, causal=False), "causal"),
        (lambda: fa_ops.attention(q, k, v, impl="ref"), "launches the"),
        (lambda: fa_ops.attention(q.half(), k.half(), v.half()),
         "float32 or bfloat16"),
        (lambda: fa_ops.attention(q[..., :24], k[..., :24], v[..., :24]),
         "head_dim"),
        (lambda: fa_ops.attention(q, k[:, :, :32], v[:, :, :32]), "equal"),
        (lambda: fa_ops.attention(q, k, v, window=0), "window"),
        (lambda: fa_ops.attention(q, k.cpu(), v.cpu()), "CUDA device"),
    ]
    before = fa_ops.LAUNCHES.launches
    with count_launches() as counts:
        for call, match in bad:
            with pytest.raises(ValueError, match=match):
                call()
    assert counts == {}
    assert fa_ops.LAUNCHES.launches == before


@pytest.mark.gpu
def test_smoke_model_on_card_launches_flash_per_layer(card):
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import lm

    cfg = get_smoke_config("llama3.2-3b")
    params = lm.init_params(cfg, seed=0, device=card)
    toks = torch.randint(0, cfg.vocab_size, (2, 200), device=card)
    before = fa_ops.LAUNCHES.launches
    logits, cache = lm.prefill(cfg, params, toks, 256,
                               cache_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES.launches - before == cfg.num_layers
    want, _ = lm.prefill(cfg, params, toks, 256, cache_dtype=torch.float32,
                         attn_impl="ref")
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)
    full, _ = lm.forward(cfg, params, toks)
    plain, _ = lm.forward(cfg, params, toks, attn_impl="ref")
    torch.testing.assert_close(full, plain, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1024, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_hymba_geometry(card, window, dtype):
    """hymba-1.5b's prefill attention: head dim 64, 25 query heads over 5
    KV heads (group 5), S 2048, its 1024-token window and a global layer."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = _attn_inputs(card, 26, 1, 25, 5, 2048, 64, dtype)
    before = fa_ops.LAUNCHES.launches
    got = fa_ops.attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES.launches - before == 1
    want = attention_ref(q, k, v, window=window)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_hybrid_smoke_prefill_on_card(card, monkeypatch):
    """hymba-smoke's prefill on the card launches B8 and B9 once a layer
    and equals the same model through the plain attention and the plain
    chunked scan (1e-4: float32 on both sides, sums in other orders)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import lm, ssm

    cfg = get_smoke_config("hymba-1.5b")
    params = lm.init_params(cfg, seed=0, device=card)
    toks = torch.randint(0, cfg.vocab_size, (2, 200), device=card)
    fa0, ssd0 = fa_ops.LAUNCHES.launches, ssd_ops.LAUNCHES.launches
    logits, cache = lm.prefill(cfg, params, toks, 256,
                               cache_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES.launches - fa0 == cfg.num_layers
    assert ssd_ops.LAUNCHES.launches - ssd0 == cfg.num_layers
    monkeypatch.setattr(ssm, "ssd_with_state", lambda *a, **k: (
        ssd_ops.ssd_chunked_ref(*a, **k)))
    want, plain = lm.prefill(cfg, params, toks, 256,
                             cache_dtype=torch.float32, attn_impl="ref")
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES.launches - fa0 == cfg.num_layers
    assert ssd_ops.LAUNCHES.launches - ssd0 == cfg.num_layers
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)
    for key in ("k", "v", "ssd", "conv"):
        torch.testing.assert_close(cache[key], plain[key], atol=1e-4,
                                   rtol=1e-4)
    full, _ = lm.forward(cfg, params, toks)
    step, _, mass = lm.decode_step(cfg, params, toks[:, -1], cache, 200,
                                   return_attn_mass=True)
    assert bool(torch.isfinite(full).all() and torch.isfinite(step).all())
    assert not bool(mass.any())


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,s", [(16, 16, 2048), (16, 8, 2304)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_moe_and_prefix_geometries(card, hq, hkv, s, dtype):
    """qwen2-moe-a2.7b's prefill attention (16 heads over 16 KV heads,
    group 1, head dim 128, S 2048) and internvl2-2b's with its 256-position
    prefix (16 over 8, S 2304)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = _attn_inputs(card, s + hkv, 1, hq, hkv, s, 128, dtype)
    before = fa_ops.LAUNCHES.launches
    got = fa_ops.attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES.launches - before == 1
    want = attention_ref(q, k, v)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b",
                                  "llama4-maverick-400b-a17b",
                                  "internvl2-2b", "musicgen-medium"])
def test_moe_and_prefix_smoke_prefill_on_card(card, arch):
    """A MoE or frontend smoke model's prefill on the card (with a prefix
    where the model has a frontend) launches B8 once a layer and equals the
    same model with ``attn_impl="ref"`` (1e-4: float32 on both sides, sums
    in other orders); decode steps are finite and launch nothing."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import lm
    from repro_torch.models.frontends import synthetic_frontend_embeddings

    cfg = get_smoke_config(arch)
    params = lm.init_params(cfg, seed=0, device=card)
    toks = torch.randint(0, cfg.vocab_size, (2, 200), device=card)
    prefix = synthetic_frontend_embeddings(cfg, 2, device=card)
    f = cfg.frontend_tokens if cfg.frontend else 0
    fa0 = fa_ops.LAUNCHES.launches
    logits, cache = lm.prefill(cfg, params, toks, 256 + f,
                               cache_dtype=torch.float32,
                               prefix_embeddings=prefix)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES.launches - fa0 == cfg.num_layers
    want, plain = lm.prefill(cfg, params, toks, 256 + f,
                             cache_dtype=torch.float32, attn_impl="ref",
                             prefix_embeddings=prefix)
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)
    for key in ("k", "v"):
        torch.testing.assert_close(cache[key], plain[key], atol=1e-4,
                                   rtol=1e-4)
    full, aux = lm.forward(cfg, params, toks, prefix_embeddings=prefix)
    ref_full, ref_aux = lm.forward(cfg, params, toks, attn_impl="ref",
                                   prefix_embeddings=prefix)
    torch.testing.assert_close(full, ref_full, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux, ref_aux, atol=1e-4, rtol=1e-4)
    assert full.shape[1] == f + 200
    fa0 = fa_ops.LAUNCHES.launches
    step, _, mass = lm.decode_step(cfg, params, toks[:, -1], cache, f + 200,
                                   return_attn_mass=True)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES.launches == fa0
    assert bool(torch.isfinite(step).all() and torch.isfinite(mass).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_top_k_ties_on_card_go_to_the_lower_expert(card, dtype):
    """Router columns equal in pairs tie every token's probabilities
    exactly; on CUDA tensors the lower expert index still comes first (the
    order of ``jax.lax.top_k``), and ``moe_apply`` equals the same layer on
    the CPU."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe

    cfg = get_smoke_config("qwen2-moe-a2.7b")
    g = torch.Generator(device="cpu").manual_seed(4)
    p = moe.moe_init(g, cfg, torch.float32)
    p["router"][:, 1::2] = p["router"][:, 0::2]
    x = torch.randn((4096, cfg.d_model), generator=g)
    routed = dataclasses.replace(cfg, dtype=str(dtype).split(".")[-1])
    _, _, top_e = moe.route({"router": p["router"].to(card)},
                            x.to(card, dtype), routed)
    assert bool((top_e[:, 0] % 2 == 0).all())
    assert torch.equal(top_e[:, 1], top_e[:, 0] + 1)
    on_card = {k: (v.to(card) if torch.is_tensor(v) else
                   {n: {m: w.to(card) for m, w in d.items()}
                    for n, d in v.items()}) for k, v in p.items()}
    got, aux = moe.moe_apply(on_card, x.to(card), cfg)
    want, want_aux = moe.moe_apply(p, x, cfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=1e-5)


@pytest.mark.gpu
def test_serving_on_card_picks_the_plain_victims(card, monkeypatch):
    """ServeEngine on the card with eviction: every round's victims equal
    the plain (eager) manager's on the same scores and a brute-force
    leftmost argmin per window."""
    from repro_torch.configs import ServeConfig, get_smoke_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.eviction import RMQEvictionManager

    rounds = []
    orig = RMQEvictionManager.plan_evictions_streaming

    def wrapped(self, index, slot_scores, live):
        index, victims = orig(self, index, slot_scores, live)
        rounds.append((slot_scores.clone(), live, victims.clone()))
        return index, victims

    monkeypatch.setattr(RMQEvictionManager, "plan_evictions_streaming",
                        wrapped)
    cfg = get_smoke_config("llama3.2-3b")
    sc = ServeConfig(seq_len=96, batch=2, kv_cache_dtype="float32",
                     eviction_enabled=True, eviction_budget=48,
                     eviction_window=16, rmq_chunk=16, rmq_threshold=4)
    params = lm.init_params(cfg, seed=0, device=card)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), device=card)
    out = ServeEngine(cfg, params, sc).generate(toks, 48)
    assert out["evicted"] > 0 and out["tokens"].device.type == "cuda"
    plain = RMQEvictionManager(budget=48, protected_window=16, c=16, t=4,
                               backend="eager")
    index = plain.make_index(96, device=card)
    for scores, live, victims in rounds:
        index, want = orig(plain, index, scores, live)
        _assert_same(want, victims)
        ls, rs = plain._windows(live - 16, victims.numel())
        s = scores.cpu().numpy()
        brute = [l + int(np.argmin(s[l:r + 1])) for l, r in zip(ls, rs)]
        np.testing.assert_array_equal(victims.cpu().numpy(), brute)


def _moved(tree, device):
    """A tree of dicts and lists of tensors, copied to ``device``."""
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_moved(v, device) for v in tree]
    return tree.to(device)


def _mla_model(card):
    """minicpm3-smoke (float32) on the CPU and the same parameters on the
    card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    cfg = get_smoke_config("minicpm3-4b")
    params = lm.init_params(cfg, seed=0, device="cpu")
    return cfg, params, _moved(params, card)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [200, 512])
def test_mla_smoke_serving_on_card_matches_the_cpu(card, s):
    """minicpm3-smoke's prefill (S 200: the dense route; S 512: the card's
    blocked route, dense on the CPU) and three decode steps on CUDA
    tensors equal the same model on the CPU (1e-4: float32 on both sides,
    sums in other orders); MLA's decode returns no mass."""
    from repro_torch.models import layers, lm

    assert layers.mla_route(s, on_card=True) == ("blocked" if s == 512
                                                 else "ref")
    cfg, params, on_card = _mla_model(card)
    toks = torch.randint(0, cfg.vocab_size, (2, s),
                         generator=torch.Generator().manual_seed(s))
    want, cache = lm.prefill(cfg, params, toks, s + 8,
                             cache_dtype=torch.float32)
    got, gcache = lm.prefill(cfg, on_card, toks.to(card), s + 8,
                             cache_dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    token = want.argmax(-1).to(torch.int32)
    for pos in range(s, s + 3):
        want, cache, mass = lm.decode_step(cfg, params, token, cache, pos,
                                           return_attn_mass=True)
        got, gcache, gmass = lm.decode_step(cfg, on_card, token.to(card),
                                            gcache, pos,
                                            return_attn_mass=True)
        assert mass is None and gmass is None
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        token = want.argmax(-1).to(torch.int32)
    for key in ("latent", "rope"):
        torch.testing.assert_close(gcache[key].cpu(), cache[key], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.gpu
def test_mla_prefill_launches_no_flash_kernel(card):
    """MLA's attention takes the plain route on the card (query head dim
    24 against the value's 16): B8's counter stays 0 through a prefill, a
    forward and a served generate with eviction."""
    from repro_torch.configs import ServeConfig
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    cfg, _, on_card = _mla_model(card)
    toks = torch.randint(0, cfg.vocab_size, (2, 512), device=card)
    before = fa_ops.LAUNCHES.launches
    logits, _ = lm.prefill(cfg, on_card, toks, 520)
    full, _ = lm.forward(cfg, on_card, toks)
    sc = ServeConfig(seq_len=96, batch=2, kv_cache_dtype="float32",
                     eviction_enabled=True, eviction_budget=48,
                     eviction_window=16, rmq_chunk=16, rmq_threshold=4)
    out = ServeEngine(cfg, on_card, sc).generate(toks[:, :40], 48)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES.launches == before
    assert bool(torch.isfinite(logits).all() and torch.isfinite(full).all())
    assert out["evicted"] > 0 and out["tokens"].device.type == "cuda"


@pytest.mark.gpu
def test_mla_evict_permutes_the_latent_cache_on_card(card):
    """``_evict`` on CUDA ``latent`` / ``rope`` moves their rows along axis
    2 as it does on the CPU, bit for bit."""
    from repro_torch.configs import ServeConfig
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    cfg, params, on_card = _mla_model(card)
    sc = ServeConfig(seq_len=48, batch=2, kv_cache_dtype="float32",
                     eviction_enabled=True, eviction_budget=24,
                     eviction_window=4, rmq_chunk=4, rmq_threshold=2)
    toks = torch.randint(0, cfg.vocab_size, (2, 30),
                         generator=torch.Generator().manual_seed(5))
    _, cache = lm.prefill(cfg, params, toks, 48, cache_dtype=torch.float32)
    scores = torch.rand((2, 48), generator=torch.Generator().manual_seed(6))
    victims = torch.tensor([3, 9, 17], dtype=torch.int32)
    want, wscores, wlive = ServeEngine(cfg, params, sc)._evict(
        cache, scores, victims, 30)
    got, gscores, glive = ServeEngine(cfg, on_card, sc)._evict(
        {k: v.to(card) for k, v in cache.items()}, scores.to(card),
        victims.to(card), 30)
    assert glive == wlive == 27
    for key in ("latent", "rope"):
        assert got[key].device.type == "cuda"
        _same_bits(got[key].cpu(), want[key])
    _same_bits(gscores.cpu(), wscores)


@pytest.mark.gpu
def test_mla_decode_matches_the_materialized_attention_on_card(card):
    """float32 on the card: the absorbed decode at positions 504-511 over
    the cache that ``mla_attention`` filled equals the materialized
    output's rows (within 1e-5 of max|materialized|); with the cache's rope
    keys zeroed (the control) it is off by more than 1e-2 of it."""
    from repro_torch.models import layers

    cfg, _, on_card = _mla_model(card)
    p = on_card["layers"][1]["attn"]
    g = torch.Generator(device=card).manual_seed(9)
    x = torch.randn((2, 512, cfg.d_model), generator=g, device=card)
    full, (lat, rope), _ = layers.mla_attention(
        p, x, cfg, torch.arange(512, dtype=torch.int32, device=card))
    scale = float(full.abs().max())
    errs = []
    for zero_rope in (False, True):
        c_lat = torch.zeros((2, 520, cfg.kv_lora_rank), device=card)
        c_rope = torch.zeros((2, 520, cfg.qk_rope_head_dim), device=card)
        c_lat[:, :504], c_rope[:, :504] = lat[:, :504], rope[:, :504]
        if zero_rope:
            c_rope.zero_()
        rows = [layers.mla_decode(p, x[:, pos:pos + 1], cfg,
                                  (c_lat, c_rope), pos)[0]
                for pos in range(504, 512)]
        errs.append(float((torch.cat(rows, dim=1)
                           - full[:, 504:]).abs().max()))
    assert errs[0] <= 1e-5 * scale
    assert errs[1] > 1e-2 * scale


# ---------------------------------------------------------------------------
# B9: the SSD chunk scan.  The kernel and the plain chunked version compute
# the same chunk algebra at float32 accuracy with sums in other orders
# (3xTF32 tensor-core tiles against float32 einsums), so they are held
# within 1e-4 of max|plain|, the reference's own kernel-test tolerance;
# measured errors are about 1e-6.
# ---------------------------------------------------------------------------
SSD_CASES = [
    # (batch, L, H, P, N, chunk)
    (2, 256, 4, 64, 128, 128),   # mamba2 geometry, two chunks
    (1, 128, 2, 64, 16, 128),    # test_kernels.py's hymba case, one chunk
    (1, 512, 1, 32, 64, 128),
    (2, 256, 3, 32, 16, 128),    # P 32, N 16 (hymba's state size)
    (2, 256, 25, 64, 16, 128),   # hymba-1.5b: 25 heads x 64, N 16 (the
                                 # state kernel's partial-tile instance)
    (2, 96, 4, 32, 16, 32),      # mamba2-smoke (P 32, N 16, Q 32)
    (1, 60, 2, 24, 10, 20),      # ragged tiles: Q, P, N not multiples of 32
    (1, 128, 2, 64, 128, 128),   # one chunk at the mamba2 widths
    (1, 384, 2, 64, 128, 128),   # an odd chunk count (3)
    (2, 64, 3, 12, 16, 16),      # H * P = 36: P off the 8-wide MMA tile
    (1, 256, 2, 64, 100, 64),    # N 100: a second, partial 64-wide N tile
    (1, 128, 2, 128, 64, 64),    # P 128: two 64-wide P tiles
    (1, 192, 2, 100, 128, 96),   # P 100 (a partial P tile), Q 96 (6 m-tiles)
    (1, 64, 2, 33, 20, 16),      # odd P: unaligned rows, single stores
]


def _ssd_inputs(card, seed, b, l, h, p, n):
    g = torch.Generator(device=card).manual_seed(seed)
    dtx = torch.randn((b, l, h, p), generator=g, device=card) * 0.1
    la = -torch.rand((b, l, h), generator=g, device=card) * 0.1
    bm = torch.randn((b, l, n), generator=g, device=card) * 0.3
    cm = torch.randn((b, l, n), generator=g, device=card) * 0.3
    return dtx, la, bm, cm


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,h,p,n,q", SSD_CASES)
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_kernel_matches_plain(card, b, l, h, p, n, q, with_init):
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_ref

    dtx, la, bm, cm = _ssd_inputs(card, l * h + p, b, l, h, p, n)
    init = (torch.randn((b, h, p, n), device=card) * 0.5
            if with_init else None)
    before = ssd_ops.LAUNCHES.launches
    y, s = ssd_ops.ssd_scan_cuda(dtx, la, bm, cm, chunk=q, init_state=init,
                                 return_state=True)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES.launches - before == 1
    y_ref, s_ref = ssd_chunked_ref(dtx, la, bm, cm, chunk=q, init_state=init)
    assert _rel(y, y_ref) < 1e-4 and _rel(s, s_ref) < 1e-4
    if l <= 256:
        y_naive, s_naive = ssd_ref(dtx, la, bm, cm, init_state=init)
        assert _rel(y, y_naive) < 1e-4 and _rel(s, s_naive) < 1e-4
    # the routed entry points launch the same kernel
    torch.testing.assert_close(ssd_ops.ssd(dtx, la, bm, cm, chunk=q,
                                           init_state=init), y, atol=0, rtol=0)
    y2, s2 = ssd_ops.ssd_with_state(dtx, la, bm, cm, chunk=q,
                                    init_state=init)
    assert torch.equal(y2, y) and torch.equal(s2, s)
    assert ssd_ops.LAUNCHES.launches - before == 3


@pytest.mark.gpu
def test_ssd_kernel_state_continuity(card):
    """Two launches chained through the final state equal one long one."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    dtx, la, bm, cm = _ssd_inputs(card, 7, 1, 256, 2, 32, 64)
    y_full, s_full = ssd_ops.ssd_with_state(dtx, la, bm, cm, chunk=64)
    y_a, s_a = ssd_ops.ssd_with_state(dtx[:, :128].contiguous(),
                                      la[:, :128].contiguous(),
                                      bm[:, :128].contiguous(),
                                      cm[:, :128].contiguous(), chunk=64)
    y_b, s_b = ssd_ops.ssd_with_state(dtx[:, 128:].contiguous(),
                                      la[:, 128:].contiguous(),
                                      bm[:, 128:].contiguous(),
                                      cm[:, 128:].contiguous(), chunk=64,
                                      init_state=s_a)
    assert _rel(torch.cat([y_a, y_b], 1), y_full) < 1e-5
    assert _rel(s_b, s_full) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_kernel_gradient_matches_plain(card, with_state):
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

    b, l, h, p, n, q = 2, 128, 3, 32, 16, 32
    base = list(_ssd_inputs(card, 11, b, l, h, p, n))
    base.append(torch.randn((b, h, p, n), device=card) * 0.5)
    weights = torch.randn((b, l, h, p), device=card)
    wstate = torch.randn((b, h, p, n), device=card)

    def grads(fn):
        xs = [t.clone().requires_grad_(True) for t in base]
        y, s = fn(*xs)
        loss = (y * weights).sum() + ((s * wstate).sum() if with_state
                                      else 0.0)
        return torch.autograd.grad(loss, xs)

    before = ssd_ops.LAUNCHES.launches
    got = grads(lambda *xs: (ssd_ops.SSDScan.apply(*xs, q, True)
                             if with_state else
                             (ssd_ops.SSDScan.apply(*xs, q, False), None)))
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES.launches - before == 1  # the backward launches none
    want = grads(lambda *xs: ssd_chunked_ref(*xs[:4], chunk=q,
                                             init_state=xs[4]))
    for g, w in zip(got, want):
        assert g is not None and _rel(g, w) < 1e-5


@pytest.mark.gpu
def test_ssd_refusals_on_card_count_nothing(card):
    from repro_torch.kernels.profiling import count_launches
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    dtx, la, bm, cm = _ssd_inputs(card, 3, 1, 256, 2, 64, 128)
    bad = [
        (lambda: ssd_ops.ssd(dtx, la, bm, cm, chunk=96), "L % chunk"),
        (lambda: ssd_ops.ssd(dtx, la, bm, cm, chunk=256), "chunk <= 128"),
        (lambda: ssd_ops.ssd(dtx.double(), la, bm, cm), "float32"),
        (lambda: ssd_ops.ssd(dtx.bfloat16(), la, bm, cm), "float32"),
        (lambda: ssd_ops.ssd(dtx.transpose(2, 3).contiguous().transpose(
            2, 3), la, bm, cm), "contiguous"),
        (lambda: ssd_ops.ssd(dtx, la, bm.cpu(), cm), "CUDA device"),
        (lambda: ssd_ops.ssd(dtx, la, bm, cm, impl="pallas"), "impl"),
        (lambda: ssd_ops.ssd(dtx, la, bm, cm,
                             init_state=torch.zeros(1, 2, 64, 64,
                                                    device=card)),
         "init_state"),
        (lambda: ssd_ops.ssd_scan_cuda(
            torch.zeros(1, 128, 1, 128, device=card), la[:, :128, :1],
            torch.zeros(1, 128, 256, device=card),
            torch.zeros(1, 128, 256, device=card)), "shared memory"),
    ]
    before = ssd_ops.LAUNCHES.launches
    with count_launches() as counts:
        for call, match in bad:
            with pytest.raises(ValueError, match=match):
                call()
    assert counts == {}
    assert ssd_ops.LAUNCHES.launches == before


# ---------------------------------------------------------------------------
# Gradients and the train path on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_gradient_matches_plain(card, window, dtype):
    """B8's output carries a graph; q / k / v gradients through it equal the
    plain attention's (float32 within 2e-5: the backward is the plain
    version's own; bf16 within 2e-2 of max|plain| for the forward's
    rounding)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    base = _attn_inputs(card, 5, 2, 4, 2, 200, 32, dtype)
    w = torch.randn((2, 4, 200, 32), device=card)

    def grads(fn):
        xs = [t.clone().requires_grad_(True) for t in base]
        out = fn(*xs)
        assert out.grad_fn is not None
        return torch.autograd.grad((out.float() * w).sum(), xs)

    before = fa_ops.LAUNCHES.launches
    got = grads(lambda q, k, v: fa_ops.attention(q, k, v, window=window))
    got_raw = grads(lambda q, k, v: fa_ops.flash_attention_cuda(
        q, k, v, window=window))
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES.launches - before == 2   # backwards launch none
    want = grads(lambda q, k, v: attention_ref(q, k, v, window=window))
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for g, g2, wnt in zip(got, got_raw, want):
        assert torch.equal(g, g2)
        assert float((g.float() - wnt.float()).abs().max()
                     / wnt.float().abs().max()) < tol


@pytest.mark.gpu
def test_dense_train_step_on_card_gets_attention_gradients(card):
    """A dense model's train step through B8 equals the step through the
    plain attention: the gradient reaches q, k and v."""
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.train.train_step import build_train_step, \
        init_train_state

    cfg = get_smoke_config("llama3.2-3b")
    tc = TrainConfig(warmup_steps=1, remat_policy="full",
                     grad_allreduce_dtype="float32")
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=card)
    out = {}
    for impl in ("auto", "ref"):
        state = init_train_state(cfg, tc, device=card)
        state, m = build_train_step(cfg, tc, attn_impl=impl)(
            state, {"tokens": toks})
        out[impl] = (state, m)
    (s_k, m_k), (s_p, m_p) = out["auto"], out["ref"]
    assert float(m_k["loss"]) == pytest.approx(float(m_p["loss"]), rel=1e-5)
    assert float(m_k["grad_norm"]) == pytest.approx(float(m_p["grad_norm"]),
                                                    rel=1e-4)
    for name in ("q", "k", "v"):
        torch.testing.assert_close(
            s_k.params["layers"][0]["attn"][name]["w"],
            s_p.params["layers"][0]["attn"][name]["w"], atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("policy,per_layer", [
    ("none", 1), ("full", 2), ("names", 2), ("minimal", 2)])
def test_ssm_train_step_on_card(card, policy, per_layer, monkeypatch):
    """mamba2-smoke trains on the card through B9: one launch per layer per
    forward (twice with remat), nothing else counted, and the step equals
    the step through the plain chunked scan (loss 1e-5, parameters 1e-4)."""
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import ssm
    from repro_torch.train.train_step import build_train_step, \
        init_train_state

    cfg = get_smoke_config("mamba2-1.3b")
    tc = TrainConfig(warmup_steps=1, remat_policy=policy)
    toks = torch.randint(0, cfg.vocab_size, (2, 96), device=card)
    state = init_train_state(cfg, tc, device=card)
    before = ssd_ops.LAUNCHES.launches
    state, m = build_train_step(cfg, tc)(state, {"tokens": toks})
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES.launches - before == per_layer * cfg.num_layers
    # every SSM block's scan through the plain chunked version, asked for
    monkeypatch.setattr(ssm, "ssd", lambda *a, impl, **k: ssd_ops.ssd(
        *a, impl="chunked_ref", **k))
    plain = init_train_state(cfg, tc, device=card)
    plain, mp = build_train_step(cfg, tc)(plain, {"tokens": toks})
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES.launches - before == per_layer * cfg.num_layers
    assert float(m["loss"]) == pytest.approx(float(mp["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(mp["grad_norm"]),
                                                  rel=1e-4)
    for a, b in zip(state.params["layers"], plain.params["layers"]):
        torch.testing.assert_close(a["ssm"]["in_proj"]["w"],
                                   b["ssm"]["in_proj"]["w"], atol=1e-4,
                                   rtol=1e-4)


# -- compact planes: packed positions, bf16 summaries, the streamed build --
COMPACT = {
    "packed": dict(packed_pos=True),
    "bf16": dict(summary_dtype="bfloat16"),
    "packed_bf16": dict(packed_pos=True, summary_dtype="bfloat16"),
}
COMPACT_GEOMETRIES = [
    (1 << 16, 128, 64, None),     # default geometry, 3 levels
    (70_000, 4, 64, 1 << 17),     # sub-warp chunks, many levels
    (50_001, 32, 8, None),        # one chunk a warp
    (200_000, 128, 1024, None),   # top too large to stage
    (12_345, 16, 4, 20_000),      # ragged, capacity > n
]


def _plane_bits(t):
    """A plane as integers: bf16 as int16, packed words as int32."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    return _int_view(t)


def _planes_equal(h, hp) -> bool:
    return all(
        a.dtype == b.dtype and a.shape == b.shape
        and torch.equal(_plane_bits(a), _plane_bits(b))
        for a, b in ((h.base, hp.base), (h.upper, hp.upper),
                     (h.upper_pos, hp.upper_pos)))


def _lowered(x, c):
    """A control input: one entry that is no chunk's minimum set below
    every value, which moves summaries and positions on every level."""
    y = x.copy()
    j = int(np.argmax(x[:c]))
    y[j] = x.min() - 1.0
    return y


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(COMPACT))
@pytest.mark.parametrize("n,c,t,cap", COMPACT_GEOMETRIES)
def test_compact_builds_match_plain(card, n, c, t, cap, layout):
    """B1 (one launch) and B3 (L - 1 launches) on a compact plan, through
    ``finalize_compact``, equal the plain compact build as integer views:
    packed words word for word, bf16 as int16; control: the plain build
    of an input with one entry lowered differs."""
    rng = np.random.default_rng(n + c + len(layout))
    x = tied_input(rng, n)
    plan = make_plan(n, c=c, t=t, capacity=cap, **COMPACT[layout])
    xt = torch.from_numpy(x).to(card)
    hp = build_hierarchy(xt, plan, with_positions=True)
    f0, b0 = fused_ops.LAUNCHES.launches, build_ops.LAUNCHES.launches
    hf = fused_ops.build_hierarchy_fused(xt, plan, True)
    hb = build_ops.build_hierarchy_percall(xt, plan, True)
    torch.cuda.synchronize()
    assert fused_ops.LAUNCHES.launches - f0 == 1
    assert build_ops.LAUNCHES.launches - b0 == plan.num_levels - 1
    assert (hf.upper_pos.dtype == torch.uint32) == plan.packed_pos
    assert _planes_equal(hf, hp) and _planes_equal(hb, hp)
    control = build_hierarchy(torch.from_numpy(_lowered(x, c)).to(card),
                              plan, with_positions=True)
    assert not _planes_equal(hf, control)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", COMPACT_GEOMETRIES)
def test_packed_queries_match_classic(card, n, c, t, cap):
    """B2, the B4 pair, B7 and B5 on a packed index launch as on a classic
    one (the positions unpacked before each launch) and answer the
    classic index's bits; control: the classic index of an input with one
    entry lowered answers otherwise."""
    from repro_torch.kernels.rmq_bulk import ops as bulk_ops
    from repro_torch.kernels.rmq_short import ops as short_ops

    rng = np.random.default_rng(3 * n + c)
    x = tied_input(rng, n)
    kw = dict(c=c, t=t, capacity=cap, with_positions=True, backend="fused")
    hc = RMQ.build(x, **kw).hierarchy
    hk = RMQ.build(x, packed_pos=True, **kw).hierarchy
    assert hk.upper_pos.dtype == torch.uint32
    ls, rs = (torch.from_numpy(a).to(card)
              for a in query_batch(rng, n, c, m=3000))
    sl, sr = ls, torch.minimum(rs, (ls // c) * c + 2 * c - 1)
    counters = (qfused_ops.LAUNCHES, scan_ops.LAUNCHES, bulk_ops.LAUNCHES,
                short_ops.LAUNCHES)

    def answers(h):
        v, p = qfused_ops.rmq_fused_batch(h, ls, rs, True)
        out = [v, p, qfused_ops.rmq_fused_value_batch(h, ls, rs),
               scan_ops.rmq_value_batch_cuda(h, ls, rs),
               scan_ops.rmq_index_batch_cuda(h, ls, rs)]
        out += list(bulk_ops.rmq_bulk_batch(h, ls, rs, True))
        out += list(short_ops.rmq_short_batch(h, sl, sr, True))
        return out

    before = [k.launches for k in counters]
    got = answers(hk)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [2, 2, 1, 1]
    want = answers(hc)
    for g, w in zip(got, want):
        _same_bits(g, w)
    hx = RMQ.build(_lowered(x, c), **kw).hierarchy
    assert not all(torch.equal(_int_view(g), _int_view(w))
                   for g, w in zip(got, answers(hx)))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["bf16", "packed_bf16"])
@pytest.mark.parametrize("n,c,t,cap", COMPACT_GEOMETRIES)
def test_bf16_queries_take_the_exact_walk(card, n, c, t, cap, layout):
    """On bf16 summaries the B2 and B4 routes answer through the exact
    walk on the card with no launch, B7 refuses and B5 (level 0 alone)
    launches; every answer is the classic index's bits.  Control: the same
    walk over the bf16 plane read back as float32 (no level-0 re-compare)
    answers otherwise."""
    from repro_torch.kernels.rmq_bulk import ops as bulk_ops
    from repro_torch.kernels.rmq_short import ops as short_ops

    rng = np.random.default_rng(5 * n + c)
    x = (rng.random(n) + 1.0).astype(np.float32)  # bf16 ties everywhere
    kw = dict(c=c, t=t, capacity=cap, with_positions=True)
    classic = RMQ.build(x, backend="fused", **kw)
    r = RMQ.build(x, backend="fused", **COMPACT[layout], **kw)
    h = r.hierarchy
    assert h.upper.dtype == torch.bfloat16
    ls, rs = (torch.from_numpy(a).to(card)
              for a in query_batch(rng, n, c, m=3000))
    f0, s0 = qfused_ops.LAUNCHES.launches, scan_ops.LAUNCHES.launches
    got = [r.query(ls, rs), r.query_index(ls, rs),
           *qfused_ops.rmq_fused_batch(h, ls, rs, True),
           scan_ops.rmq_value_batch_cuda(h, ls, rs),
           scan_ops.rmq_index_batch_cuda(h, ls, rs)]
    torch.cuda.synchronize()
    assert (qfused_ops.LAUNCHES.launches, scan_ops.LAUNCHES.launches) == (
        f0, s0)
    hc = classic.hierarchy
    want = [classic.query(ls, rs), classic.query_index(ls, rs),
            *qfused_ops.rmq_fused_batch(hc, ls, rs, True),
            scan_ops.rmq_value_batch_cuda(hc, ls, rs),
            scan_ops.rmq_index_batch_cuda(hc, ls, rs)]
    for g, w in zip(got, want):
        _same_bits(g, w)
    with pytest.raises(ValueError, match="bf16"):
        bulk_ops.rmq_bulk_batch(h, ls, rs, True)
    sl, sr = ls, torch.minimum(rs, (ls // c) * c + 2 * c - 1)
    k0 = short_ops.LAUNCHES.launches
    sv, sp = short_ops.rmq_short_batch(h, sl, sr, True)
    torch.cuda.synchronize()
    assert short_ops.LAUNCHES.launches - k0 == 1
    cv, cp = short_ops.rmq_short_batch(hc, sl, sr, True)
    _same_bits(sv, cv)
    _same_bits(sp, cp)
    lossy = type(h)(base=h.base, upper=h.upper.float(),
                    upper_pos=h.upper_pos, plan=h.plan)
    v = rmq_walk_batch(lossy, ls, rs, track_pos=False)[0]
    assert not torch.equal(_int_view(v), _int_view(want[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(COMPACT) + ["classic"])
def test_compact_update_on_card_matches_rebuild(card, layout):
    """An update and an append on a compact ``cuda`` index take the plain
    update on the card (no B6 launch) and equal a rebuild of the mutated
    array; a classic index launches B6 and equals it too."""
    from repro_torch.kernels.hierarchy_update import ops as upd_ops

    lay = COMPACT.get(layout, {})
    rng = np.random.default_rng(17)
    n, cap = 100_003, 1 << 17
    x = tied_input(rng, n)
    kw = dict(c=32, t=16, capacity=cap, with_positions=True)
    r = RMQ.build(x, backend="cuda", **kw, **lay)
    idxs = rng.integers(0, n, 2000)
    vals = tied_input(rng, 2000)
    tail = tied_input(rng, 500)
    u0 = upd_ops.LAUNCHES.launches
    r2 = r.update(idxs, vals).append(tail)
    torch.cuda.synchronize()
    launched = upd_ops.LAUNCHES.launches - u0
    assert launched == (0 if lay else 2 * (r.plan.num_levels - 1))
    live = x.copy()
    for i, v in zip(idxs, vals):
        live[i] = v
    live = np.concatenate([live, tail])
    want = RMQ.build(live, backend="eager", **kw, **lay).hierarchy
    assert _planes_equal(r2.hierarchy, want)
    assert not _planes_equal(r.hierarchy, want)  # control: the predecessor


@pytest.mark.gpu
@pytest.mark.parametrize("mutation", ["update", "append", "streaming"])
@pytest.mark.parametrize("layout", sorted(COMPACT))
def test_compact_mutations_under_a_ragged_fourth_level(card, layout,
                                                       mutation):
    """Mutations past index 512 on a four-level plan with a ragged third
    level (capacity 576, c = 8: levels 576, 72, 9, 2), whose padding lanes
    would chain past the packed word array unless masked: the successor
    equals a rebuild of the mutated array and answers as brute force;
    control: the predecessor differs from the rebuild."""
    from repro_torch.streaming import StreamingRMQ

    lay = COMPACT[layout]
    rng = np.random.default_rng(576 + len(layout) + len(mutation))
    n = 576 if mutation == "update" else 520
    x = rng.integers(-4, 4, n).astype(np.float32)
    kw = dict(c=8, t=1, capacity=576, with_positions=True)
    r = (StreamingRMQ.from_array(x, backend="cuda", **kw, **lay)
         if mutation == "streaming"
         else RMQ.build(x, backend="cuda", **kw, **lay))
    assert list(r.plan.level_lens) == [576, 72, 9, 2]
    live = x.copy()
    if mutation == "update":
        idxs = rng.integers(512, 576, 12)
        vals = rng.integers(-4, 4, 12).astype(np.float32)
        for i, v in zip(idxs, vals):
            live[i] = v
        r2 = r.update(idxs, vals)
    else:
        tail = rng.integers(-4, 4, 56).astype(np.float32)
        live = np.concatenate([live, tail])
        r2 = r.append(tail)
    want = RMQ.build(live, backend="eager", **kw, **lay).hierarchy
    assert _planes_equal(r2.hierarchy, want)
    assert not _planes_equal(r.hierarchy, want)
    ls = rng.integers(0, 576, 200)
    rs = np.minimum(ls + rng.integers(0, 576, 200), 575)
    ls, rs = np.minimum(ls, rs), np.maximum(ls, rs)
    _, want_p = brute_force(live, ls, rs)
    got = r2.query_index(ls, rs)
    assert np.array_equal(got.cpu().numpy(), want_p)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["classic", "packed", "packed_bf16"])
@pytest.mark.parametrize("n,seg,cap", [(1_000_003, 1 << 16, None),
                                       (300_001, 1 << 12, 400_000)])
def test_out_of_core_build_matches_plain(card, n, seg, cap, layout):
    """``build_out_of_core`` from a host callable: one B1 launch a slab,
    the hierarchy equal to the plain build of the whole array on the card
    as integer views; control: the plain build of an input with one entry
    lowered differs.  Sampled spans through the eager walk against
    brute force."""
    lay = COMPACT.get(layout, {})
    rng = np.random.default_rng(n)
    x = tied_input(rng, n)
    f0 = fused_ops.LAUNCHES.launches
    r = RMQ.build_out_of_core(lambda a, b: x[a:b], n, c=128, t=64,
                              with_positions=True, capacity=cap,
                              segment_size=seg, **lay)
    torch.cuda.synchronize()
    assert fused_ops.LAUNCHES.launches - f0 == -(-r.plan.capacity // seg)
    assert r.backend == "eager" and r.device.type == "cuda"
    xt = torch.from_numpy(x).to(card)
    hp = build_hierarchy(xt, r.plan, with_positions=True)
    assert _planes_equal(r.hierarchy, hp)
    control = build_hierarchy(torch.from_numpy(_lowered(x, 128)).to(card),
                              r.plan, with_positions=True)
    assert not _planes_equal(r.hierarchy, control)
    ls, rs = query_batch(rng, n, 128, m=300)
    bv, bp = brute_force(x, ls, rs)
    np.testing.assert_array_equal(r.query(ls, rs).cpu().numpy(), bv)
    np.testing.assert_array_equal(r.query_index(ls, rs).cpu().numpy(), bp)


# ---------------------------------------------------------------------------
# the tuned path (A9): c="auto", QueryEngine(tuning=), the autotuner
# ---------------------------------------------------------------------------
def _card_cache(card, n, **kw):
    from repro_torch.tune import TunedConfig, TuningCache, current_platform

    cache = TuningCache()
    cache.put(current_platform(card), n, "mixed", TunedConfig(**kw))
    return cache


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "fused"])
@pytest.mark.parametrize("n,c,t", [((1 << 20) + 7, 32, 8),
                                   (1 << 20, 128, 64)])
def test_tuned_build_and_engine_match_plain(card, backend, n, c, t):
    """A cache hit on the card's key: the build adopts the winner's
    geometry and backend (one B1 launch fused, L - 1 B3 launches cuda),
    the engine with the cache adopts its backend; the hierarchy equals
    the plain build and the engine's answers the plain walk, as integer
    views.  Control: the same cache keyed for another card misses."""
    from repro_torch.qe import QueryEngine

    planner = "fused" if backend == "fused" else "routed"
    cache = _card_cache(card, n, c=c, t=t, backend=backend,
                        planner=planner)
    rng = np.random.default_rng(n + c)
    x = torch.from_numpy(tied_input(rng, n)).to(card)
    f0, b0 = fused_ops.LAUNCHES.launches, build_ops.LAUNCHES.launches
    r = RMQ.build(x, c="auto", tuning=cache, with_positions=True)
    torch.cuda.synchronize()
    assert (r.plan.c, r.plan.t, r.backend) == (c, t, backend)
    assert r.plan.level_split.fused == (backend == "fused")
    launched = (fused_ops.LAUNCHES.launches - f0,
                build_ops.LAUNCHES.launches - b0)
    assert launched == ((1, 0) if backend == "fused"
                        else (0, r.plan.num_levels - 1))
    hp = build_hierarchy(x, r.plan, with_positions=True)
    _same_bits(r.hierarchy.upper, hp.upper)
    _same_bits(r.hierarchy.upper_pos, hp.upper_pos)
    engine = QueryEngine(r, cache_size=0, tuning=cache)
    assert engine.backend == backend and engine.tuned["source"] == "cache"
    ls, rs = query_batch(rng, n, c, m=4096)
    wv, wp = rmq_walk_batch(hp, torch.from_numpy(ls).to(card),
                            torch.from_numpy(rs).to(card), track_pos=True)
    _same_bits(engine.query(ls, rs), wv)
    _same_bits(engine.query_index(ls, rs), wp)
    other = _keyed_for(cache, "cuda:another card")
    miss = RMQ.build(x, c="auto", tuning=other, with_positions=True)
    assert (miss.plan.c, miss.plan.t, miss.plan.level_split) == (
        128, 64, None)


def _keyed_for(cache, platform):
    """``cache``'s entries under another platform key."""
    from repro_torch.tune import TuningCache

    doc = cache.as_json()
    for e in doc["entries"]:
        e["platform"] = platform
    return TuningCache.from_json(doc)


@pytest.mark.gpu
def test_tuned_miss_is_the_default_build(card):
    from repro_torch.tune import TuningCache

    rng = np.random.default_rng(3)
    x = torch.from_numpy(zero_heavy(rng, 300_001)).to(card)
    default = RMQ.build(x, with_positions=True)
    tuned = RMQ.build(x, c="auto", tuning=TuningCache(),
                      with_positions=True)
    assert tuned.plan == default.plan and tuned.backend == "cuda"
    _same_bits(tuned.hierarchy.upper, default.hierarchy.upper)
    _same_bits(tuned.hierarchy.upper_pos, default.hierarchy.upper_pos)


@pytest.mark.gpu
def test_autotuner_tiny_search_on_the_card(card, tmp_path):
    from repro_torch.tune import (
        TINY_GEOMETRIES,
        Autotuner,
        TuningCache,
        current_platform,
    )

    tuner = Autotuner(geometries=TINY_GEOMETRIES, m=256, repeats=1,
                      crossover_points=2)
    assert tuner.device.type == "cuda"
    assert tuner.backends == ("cuda", "fused")
    cache, report = tuner.search([1 << 14])
    assert report["platform"] == current_platform(card)
    assert report["platform"].startswith("cuda:")
    assert len(report["measurements"]) == 3 * 2 * 4
    assert all(m["ns_per_query"] > 0 for m in report["measurements"])
    path = str(tmp_path / "cache.json")
    cache.save(path)
    loaded = TuningCache.load(path)
    for mix in ("short", "mid", "long", "mixed"):
        assert loaded.lookup(report["platform"], 1 << 14, mix) is not None


# ---------------------------------------------------------------------------
# build_many (B1 with a row axis) and the serving tier on the card
# ---------------------------------------------------------------------------
MANY_GEOMETRIES = [  # (n, c, t, capacity)
    (1 << 16, 128, 64, None),      # float32 run layout
    (1 << 16, 64, 16, None),       # float64 run layout (float32: parts)
    (70_001, 128, 8, 1 << 17),     # ragged n, capacity > n, four levels
    (50_000, 32, 8, None),         # the part-by-part layout
    (20_000, 4, 64, None),         # sub-warp chunks, many levels
]


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", MANY_GEOMETRIES)
@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("dtype,with_pos", [
    (np.float32, True), (np.float32, False), (np.float64, True)])
def test_build_many_rows_equal_solo_builds(card, n, c, t, cap, rows, dtype,
                                           with_pos):
    """One B1 launch builds every row; each row equals a solo B1 build
    and the plain build of that row, as integer views."""
    from repro_torch.core import build_many

    rng = np.random.default_rng(n + rows)
    xs = torch.from_numpy(np.stack([
        zero_heavy(rng, n, dtype) if i % 2 else tied_input(rng, n, dtype)
        for i in range(rows)])).to(card)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    before = fused_ops.LAUNCHES.launches
    batched = build_many(xs, plan, with_positions=with_pos)
    torch.cuda.synchronize()
    assert fused_ops.LAUNCHES.launches - before == 1
    assert batched.upper.shape == (rows, plan.upper_size)
    for i in range(rows):
        solo = fused_ops.build_hierarchy_fused(xs[i], plan, with_pos)
        plain = build_hierarchy(xs[i], plan, with_positions=with_pos)
        for want in (solo, plain):
            _same_bits(batched.base[i], want.base)
            _same_bits(batched.upper[i], want.upper)
            if with_pos:
                _same_bits(batched.upper_pos[i], want.upper_pos)


@pytest.mark.gpu
def test_register_many_is_one_build_launch(card):
    from repro_torch.qe import QueryService

    rng = np.random.default_rng(5)
    n = 1 << 18
    arrays = {f"r{i}": tied_input(rng, n) for i in range(4)}
    svc = QueryService()
    before = fused_ops.LAUNCHES.launches
    engines = svc.register_many(arrays, c=128, t=64, with_positions=True)
    assert fused_ops.LAUNCHES.launches - before == 1
    ls, rs = query_batch(rng, n, 128, m=512)
    for name, x in arrays.items():
        assert engines[name].index.device.type == "cuda"
        solo = RMQ.build(x, with_positions=True, backend="fused")
        _same_bits(svc.query(name, ls, rs), solo.query(ls, rs))
        _same_bits(svc.query_index(name, ls, rs), solo.query_index(ls, rs))


def _fused_tenant(card, n, seed):
    x = tied_input(np.random.default_rng(seed), n)
    return x, RMQ.build(x, with_positions=True, backend="fused")


@pytest.mark.gpu
def test_drained_flush_is_one_rmq_fused_launch(card):
    """A drained flush of a mixed backlog of max_batch spans on a fused
    tenant launches B2 exactly once; a staged update adds B6's launches
    once, at the swap; the answers equal B2 over the successor."""
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.serving import ServingTier

    n = 1 << 20
    x, r = _fused_tenant(card, n, 6)
    clock = [0.0]
    tier = ServingTier(clock=lambda: clock[0])
    tier.register_tenant("a", r, slo_ms=5.0, cache_size=0)
    rng = np.random.default_rng(7)
    reqs = []
    for i in range(32):   # 32 x 128 spans = max_batch
        ls, rs = query_batch(rng, n, 128, m=51)
        reqs.append((tier.submit("a", ls, rs, "index" if i % 2 else
                                 "value"), ls, rs, i % 2))
    idxs = rng.integers(0, n, 1 << 12).astype(np.int32)
    vals = tied_input(rng, 1 << 12)
    tier.update("a", idxs, vals)
    b0, u0 = qfused_ops.LAUNCHES.launches, upd_ops.LAUNCHES.launches
    clock[0] += 0.01
    tier.step()
    torch.cuda.synchronize()
    assert qfused_ops.LAUNCHES.launches - b0 == 1
    assert upd_ops.LAUNCHES.launches - u0 == r.plan.num_levels - 1
    succ = r.update(idxs, vals)
    for tk, ls, rs, is_index in reqs:
        assert tk.generation == 1
        want = (succ.query_index(ls, rs) if is_index
                else succ.query(ls, rs))
        _same_bits(tk.result(0), want)


@pytest.mark.gpu
def test_ticket_read_under_a_side_stream(card):
    """A client thread reads its answers under its own side stream while
    the flusher thread (and, for an oversized submission, another thread
    behind a sleep kernel) computed them on the default stream: the
    answers are complete and equal, as integer views."""
    from repro_torch.serving import ServingTier

    n = 1 << 20
    x, r = _fused_tenant(card, n, 8)
    rng = np.random.default_rng(9)
    batches = [query_batch(rng, n, 128, m=256) for _ in range(16)]
    big = query_batch(rng, n, 128, m=1 << 14)
    tier = ServingTier(idle_tick=0.001)
    tier.register_tenant("a", r, slo_ms=2.0, max_batch=4096,
                         max_queue=1 << 15, cache_size=0, bulk_crossover=1)
    got, errors = [], []

    def client(tk_big):
        try:
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                for j, (ls, rs) in enumerate(batches):
                    tk = tier.submit("a", ls, rs,
                                     "index" if j % 2 else "value")
                    got.append((j, tk.result(30.0).clone()))
                got.append((-1, tk_big.result(30.0).clone()))
            s.synchronize()
        except Exception as e:  # surfaced below
            errors.append(e)

    import threading

    with tier:
        # oversized: B7 inline on this thread's default stream, queued
        # behind a sleep kernel; the client reads it on its side stream
        torch.cuda._sleep(50_000_000)
        tk_big = tier.submit("a", *big)
        th = threading.Thread(target=client, args=(tk_big,))
        th.start()
        th.join(60.0)
    assert not errors, errors
    assert len(got) == len(batches) + 1
    for j, res in got:
        ls, rs = big if j < 0 else batches[j]
        want = (r.query_index(ls, rs) if j > 0 and j % 2
                else r.query(ls, rs))
        _same_bits(res, want)
    assert tier.stats()["flusher_errors"] == 0


# -- bfloat16 values (A3b) ---------------------------------------------------
# A bf16 index keeps bf16 planes (2 bytes an entry) and every RMQ kernel
# reads and writes them natively, comparing them widened to float32.  Each
# kernel is held to its plain version as int16 / int32 views, with the
# launch counts of float32 and, at c = 128 over a capacity of whole
# vectors, the run layout (builds, update) and the one-chunk-a-warp walk
# ("V4-fast"); test_bf16_controls_fail holds a control for each gate.
BF16_GEOMETRIES = [
    (1 << 16, 128, 64, None),             # run / fast layout
    ((1 << 16) + 5, 128, 64, None),       # ragged capacity: part by part
    (100_003, 128, 4, 1 << 17),           # ragged n, capacity > n, 4 levels
    ((1 << 20) - 777, 128, 64, 1 << 20),  # a full c*t top (8192)
    (70_000, 4, 64, 1 << 17),             # sub-warp chunks, many levels
    (50_001, 32, 8, None),                # c = 32
    (40_000, 1024, 4, None),              # several vectors a lane
    (200_000, 128, 1024, None),           # top too large to stage
    (700, 128, 64, None),                 # single level
    (3, 128, 64, 64),                     # n and capacity below c
]


def _bf16_fast(plan) -> bool:
    """Whether a bf16 plan takes the run layout and the fast walk."""
    return (plan.c == 128 and plan.capacity % 4 == 0
            and plan.num_levels > 1)


def _instances(name):
    from repro_torch.kernels import _build

    return _build.instances(name)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", BF16_GEOMETRIES)
@pytest.mark.parametrize("kind", BF16_KINDS)
@pytest.mark.parametrize("with_pos", [False, True])
def test_bf16_builds_match_plain(card, n, c, t, cap, kind, with_pos):
    x = bf16_input(kind, np.random.default_rng(n + c), n, c).to(card)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    ref = build_hierarchy(x, plan, with_positions=with_pos)
    assert ref.upper.dtype == torch.bfloat16
    for name in ("hierarchy_fused", "hierarchy_build"):
        _instances(name)  # clears them
    fused0, level0 = fused_ops.LAUNCHES.launches, build_ops.LAUNCHES.launches
    got_f = fused_ops.build_hierarchy_fused(x, plan, with_pos)
    inst_f = _instances("hierarchy_fused")
    got_l = build_ops.build_hierarchy_percall(x, plan, with_pos)
    inst_l = _instances("hierarchy_build")
    torch.cuda.synchronize()
    assert fused_ops.LAUNCHES.launches - fused0 == min(
        1, plan.num_levels - 1)
    assert build_ops.LAUNCHES.launches - level0 == plan.num_levels - 1
    if _bf16_fast(plan):
        assert inst_f == ["run"] and inst_l == ["run"]
    for got in (got_f, got_l):
        assert got.upper.element_size() == 2
        _same_bits(got.base, ref.base)
        _same_bits(got.upper, ref.upper)
        if with_pos:
            _same_bits(got.upper_pos, ref.upper_pos)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", BF16_GEOMETRIES)
@pytest.mark.parametrize("kind", BF16_KINDS)
def test_bf16_queries_match_plain(card, n, c, t, cap, kind):
    """B2, B4, B7 (on value-only and position builds) and B5 against the
    plain walk, as integer views; one launch a call."""
    from repro_torch.kernels.rmq_bulk import ops as bulk_ops
    from repro_torch.kernels.rmq_short import ops as short_ops

    rng = np.random.default_rng(3 * n + c)
    x = bf16_input(kind, rng, n, c).to(card)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    ls_n, rs_n = edge_spans(rng, n, c, 197)
    ls, rs = torch.from_numpy(ls_n).to(card), torch.from_numpy(rs_n).to(card)
    sl_n, sr_n = _short_spans(rng, n, c)
    sl, sr = torch.from_numpy(sl_n).to(card), torch.from_numpy(sr_n).to(card)
    fast = _bf16_fast(plan)
    mods = (qfused_ops, scan_ops, bulk_ops, short_ops)
    for with_pos in (False, True):
        h = build_hierarchy(x, plan, with_positions=with_pos)
        want_v, want_p = rmq_walk_batch(h, ls, rs, track_pos=with_pos)
        for name in ("rmq_fused", "rmq_scan", "rmq_bulk", "rmq_short"):
            _instances(name)  # clears them
        counts = [m.LAUNCHES.launches for m in mods]
        fv, fp = qfused_ops.rmq_fused_batch(h, ls, rs, track_pos=with_pos)
        sv = scan_ops.rmq_value_batch_cuda(h, ls, rs)
        bv, bp = bulk_ops.rmq_bulk_batch(h, ls, rs, track_pos=with_pos)
        qv, qp = short_ops.rmq_short_batch(h, sl, sr, track_pos=True)
        got_p = [fp, bp]
        if with_pos:
            got_p.append(scan_ops.rmq_index_batch_cuda(h, ls, rs))
        torch.cuda.synchronize()
        assert [m.LAUNCHES.launches - c0 for m, c0 in zip(mods, counts)] == [
            1, 1 + with_pos, 1, 1]
        if fast:
            for name in ("rmq_fused", "rmq_scan", "rmq_bulk"):
                assert _instances(name) == ["V4-fast"], name
            assert _instances("rmq_short") == ["V4"]
        for v in (fv, sv, bv):
            assert v.dtype == torch.bfloat16
            _same_bits(v, want_v)
        if with_pos:
            for p in got_p:
                _same_bits(p, want_p)
        wv, wp = short_ops.rmq_short_batch_plain(
            h.base, sl, sr, c, plan.capacity, True)
        _same_bits(qv, wv)
        _same_bits(qp, wp)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", BF16_GEOMETRIES)
@pytest.mark.parametrize("kind", BF16_KINDS)
@pytest.mark.parametrize("with_pos", [False, True])
def test_bf16_update_matches_plain(card, n, c, t, cap, kind, with_pos):
    """B6 on bf16 planes (NaN, zeros and ties written over the data)
    against the plain update, then a fresh build; L - 1 launches a call."""
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.streaming import updates as U

    rng = np.random.default_rng(7 * n + c)
    x = bf16_input(kind, rng, n, c).to(card)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    h = build_hierarchy(x, plan, with_positions=with_pos)
    idxs = rng.integers(-3, plan.capacity + 3, 300)
    idxs[:40] = idxs[40:80]  # duplicates: the last one wins
    vals = bf16_input(kind, rng, 300, c).to(card)
    tail = bf16_input(kind, rng, min(plan.capacity - n, 257), c).to(card)
    _instances("hierarchy_update")
    before = upd_ops.LAUNCHES.launches
    got = upd_ops.update_hierarchy_cuda(h, idxs, vals)
    got_a = upd_ops.append_hierarchy_cuda(got, tail, n)
    torch.cuda.synchronize()
    appends = 1 if len(tail) else 0
    assert upd_ops.LAUNCHES.launches - before == (1 + appends) * (
        plan.num_levels - 1)
    if _bf16_fast(plan):
        assert _instances("hierarchy_update") == ["run"]
    want = U.update_hierarchy(h, torch.from_numpy(idxs), vals)
    want_a = U.append_hierarchy(want, tail, n)
    fresh = build_hierarchy(want_a.base[:plan.capacity].clone(), make_plan(
        plan.capacity, c=c, t=t), with_positions=with_pos)
    for g, w in ((got, want), (got_a, want_a)):
        assert g.base.dtype == g.upper.dtype == torch.bfloat16
        _same_bits(g.base, w.base)
        _same_bits(g.upper, w.upper)
        if with_pos:
            _same_bits(g.upper_pos, w.upper_pos)
    _same_bits(got_a.upper, fresh.upper)


def _flip_zero(t):
    """-0.0 entries set to +0.0 (a control's plane)."""
    return torch.where((t == 0) & torch.signbit(t), torch.zeros_like(t), t)


def _nan_to_inf(t):
    return torch.where(torch.isnan(t), torch.full_like(t, float("inf")), t)


def _rightmost_build(x, plan):
    """A build whose ties go to the rightmost entry (a control)."""
    flipped = build_hierarchy(x.flip(0), make_plan(
        plan.n, c=plan.c, t=plan.t), with_positions=True)
    return flipped


@pytest.mark.gpu
def test_bf16_controls_fail(card):
    """Each gate of the bf16 tests has a control that must fail it: the
    plain planes with -0.0 set to +0.0 (zeros), NaN set to +inf (nan),
    and answers with the rightmost tie (dense), against B1, B3, B2, B4,
    B5, B6 and B7's bf16 instances."""
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.kernels.rmq_bulk import ops as bulk_ops
    from repro_torch.kernels.rmq_short import ops as short_ops

    def fails(got, control):
        return not torch.equal(_int_view(got), _int_view(control))

    n, c = 1 << 16, 128
    plan = make_plan(n, c=c, t=64)
    rng = np.random.default_rng(17)
    ls_n, rs_n = edge_spans(rng, n, c, 197)
    ls, rs = torch.from_numpy(ls_n).to(card), torch.from_numpy(rs_n).to(card)
    sl_n, sr_n = _short_spans(rng, n, c)
    sl, sr = torch.from_numpy(sl_n).to(card), torch.from_numpy(sr_n).to(card)
    for kind, control in (("zeros", _flip_zero), ("signed_zeros", _flip_zero),
                          ("nan", _nan_to_inf)):
        x = bf16_input(kind, rng, n, c).to(card)
        for got in (fused_ops.build_hierarchy_fused(x, plan, True),
                    build_ops.build_hierarchy_percall(x, plan, True)):
            assert fails(got.upper, control(
                build_hierarchy(x, plan, True).upper))
        h = build_hierarchy(x, plan, with_positions=True)
        want_v, _ = rmq_walk_batch(h, ls, rs, track_pos=True)
        want_s = short_ops.rmq_short_batch_plain(h.base, sl, sr, c, n,
                                                 False)[0]
        for v, want in ((qfused_ops.rmq_fused_value_batch(h, ls, rs), want_v),
                        (scan_ops.rmq_value_batch_cuda(h, ls, rs), want_v),
                        (bulk_ops.rmq_bulk_value_batch(h, ls, rs), want_v),
                        (short_ops.rmq_short_value_batch(h, sl, sr), want_s)):
            _same_bits(v, want)
            assert fails(v, control(want))
        vals = bf16_input(kind, rng, 4096, c).to(card)
        idxs = rng.integers(0, n, 4096)
        got = upd_ops.update_hierarchy_cuda(h, idxs, vals)
        assert fails(got.upper, control(build_hierarchy(
            got.base.clone(), plan, True).upper))
    # ties: the rightmost-tie build's positions differ
    x = bf16_input("tied", rng, n, c).to(card)
    right = _rightmost_build(x, plan)
    got = fused_ops.build_hierarchy_fused(x, plan, True)
    l1 = slice(plan.offsets[0], plan.offsets[0] + plan.level_lens[1])
    mirrored = (n - 1 - right.upper_pos[l1]).flip(0)
    assert fails(got.upper_pos[l1], mirrored)
    h = build_hierarchy(x, plan, with_positions=True)
    _, want_p = rmq_walk_batch(h, ls, rs, track_pos=True)
    _, right_p = rmq_walk_batch(right, n - 1 - rs, n - 1 - ls,
                                track_pos=True)
    fp = qfused_ops.rmq_fused_index_batch(h, ls, rs)
    _same_bits(fp, want_p)
    assert fails(fp, n - 1 - right_p)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_bf16_build_many_rows_equal_solo_builds(card, rows):
    """build_many over bf16 rows: one B1 launch with the row axis, each
    row equal to a solo build and the plain build, as int16 views."""
    from repro_torch.core import build_many

    n, c = (1 << 16) + 96, 128
    rng = np.random.default_rng(rows)
    xs = torch.stack([bf16_input(BF16_KINDS[i % len(BF16_KINDS)], rng, n, c)
                      for i in range(rows)]).to(card)
    plan = make_plan(n, c=c, t=16)
    _instances("hierarchy_fused")
    before = fused_ops.LAUNCHES.launches
    batched = build_many(xs, plan, with_positions=True)
    torch.cuda.synchronize()
    assert fused_ops.LAUNCHES.launches - before == 1
    assert _instances("hierarchy_fused") == ["run"]
    for i in range(rows):
        plain = build_hierarchy(xs[i], plan, with_positions=True)
        _same_bits(batched.upper[i], plain.upper)
        _same_bits(batched.upper_pos[i], plain.upper_pos)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["fused", "cuda"])
def test_bf16_facade_engine_and_streaming_on_card(card, backend):
    """RMQ.build / query / update, the engine (query, query_mixed,
    query_bulk) and StreamingRMQ on a bf16 input: bf16 planes and answers,
    float32's launch counts, no eager walk, equal to the plain index."""
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.kernels.rmq_bulk import ops as bulk_ops
    from repro_torch.streaming import StreamingRMQ

    n, c = (1 << 18) + 4, 128
    rng = np.random.default_rng(23)
    x = bf16_input("dense", rng, n, c).to(card)
    ls, rs = query_batch(rng, n, c, m=2048)
    f0, l0 = fused_ops.LAUNCHES.launches, build_ops.LAUNCHES.launches
    r = RMQ.build(x, with_positions=True, backend=backend)
    plain = RMQ.build(x, with_positions=True, backend="eager")
    L = r.plan.num_levels
    assert (fused_ops.LAUNCHES.launches - f0,
            build_ops.LAUNCHES.launches - l0) == (
                (1, 0) if backend == "fused" else (0, L - 1))
    assert r.hierarchy.base.element_size() == 2
    assert r.hierarchy.upper.dtype == torch.bfloat16
    q0, s0 = qfused_ops.LAUNCHES.launches, scan_ops.LAUNCHES.launches
    v, p = r.query(ls, rs), r.query_index(ls, rs)
    launched = (qfused_ops.LAUNCHES.launches - q0,
                scan_ops.LAUNCHES.launches - s0)
    assert launched == ((2, 0) if backend == "fused" else (0, 2))
    assert v.dtype == torch.bfloat16
    _same_bits(v, plain.query(ls, rs))
    _same_bits(p, plain.query_index(ls, rs))
    e = r.engine(cache_size=0)
    _same_bits(e.query(ls, rs), plain.query(ls, rs))
    is_index = np.arange(ls.size) % 3 == 0
    mv, mp = e.query_mixed(ls, rs, is_index)
    assert mv.dtype == torch.bfloat16
    sel = torch.from_numpy(~is_index).to(card)
    _same_bits(mv[sel], plain.query(ls, rs)[sel])
    _same_bits(mp[~sel], plain.query_index(ls, rs)[~sel])
    e.bulk_crossover = 1
    b0 = bulk_ops.LAUNCHES.launches
    bv = e.query_bulk(ls, rs)
    assert bulk_ops.LAUNCHES.launches > b0
    _same_bits(bv, plain.query(ls, rs))
    idxs = torch.from_numpy(rng.integers(0, n, 1 << 12)).to(card)
    vals = torch.from_numpy(rng.random(1 << 12).astype(np.float32)).to(card)
    u0 = upd_ops.LAUNCHES.launches
    r2 = r.update(idxs, vals)
    assert upd_ops.LAUNCHES.launches - u0 == L - 1
    p2 = plain.update(idxs, vals)
    _same_bits(r2.hierarchy.base, p2.hierarchy.base)
    _same_bits(r2.hierarchy.upper, p2.hierarchy.upper)
    _same_bits(r2.hierarchy.upper_pos, p2.hierarchy.upper_pos)
    s = StreamingRMQ.from_array(x, capacity=1 << 19, with_positions=True,
                                backend=backend)
    tail = bf16_input("zeros", rng, 777, c).to(card)
    u0 = upd_ops.LAUNCHES.launches
    s = s.append(tail).retire(1024)
    assert upd_ops.LAUNCHES.launches - u0 == 2 * (s.plan.num_levels - 1)
    arr = torch.cat([x, tail])
    arr[:1024] = float("inf")
    fresh = build_hierarchy(arr, make_plan(
        arr.numel(), c=c, t=64, capacity=1 << 19), True)
    _same_bits(s.hierarchy.base, fresh.base)
    _same_bits(s.hierarchy.upper, fresh.upper)
    _same_bits(s.hierarchy.upper_pos, fresh.upper_pos)
    ql, qr = query_batch(rng, arr.numel(), c, m=512)
    want_v, want_p = rmq_walk_batch(fresh, torch.from_numpy(ql).to(card),
                                    torch.from_numpy(qr).to(card), True)
    _same_bits(s.query(ql, qr), want_v)
    _same_bits(s.query_index(ql, qr), want_p.to(torch.int32))


# ---------------------------------------------------------------------------
# the segment-sharded index (A10a) on the card
# ---------------------------------------------------------------------------
def _dist_input(rng, n, dtype):
    if dtype == "bfloat16":
        return bf16_input("nan", rng, n, 16)
    return torch.from_numpy(zero_heavy(rng, n, np.dtype(dtype).type))


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["fused", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("shape,n,cap", [((2, 4), 40_001, 50_000),
                                         ((1, 3), 70_000, None)])
def test_distributed_kernels_match_eager(card, backend, dtype, shape, n,
                                         cap):
    """Each segment's planes, the monolithic and grouped answers, an
    update with duplicates and a straddling append: the kernels against
    the ``eager`` distributed index on the same mesh, as integer views."""
    from repro_torch.core import DistributedRMQ
    from repro_torch.launch.mesh import make_test_mesh

    rng = np.random.default_rng(n)
    x = _dist_input(rng, n, dtype).to(card)
    mesh = make_test_mesh(shape, device=card)
    kw = dict(c=16, t=8, with_positions=True, capacity=cap)
    d = DistributedRMQ.build(x, mesh, backend=backend, **kw)
    e = DistributedRMQ.build(x, mesh, backend="eager", **kw)
    for got, want in zip(d.segments, e.segments):
        _same_bits(got.base, want.base)
        _same_bits(got.upper, want.upper)
        _same_bits(got.upper_pos, want.upper_pos)
    ls, rs = query_batch(rng, n, 16, m=1024)
    _same_bits(d.query(ls, rs), e.query(ls, rs))
    _same_bits(d.query_index(ls, rs), e.query_index(ls, rs))
    s, seg = d.num_segments, d.segment_capacity
    gl = torch.from_numpy(rng.integers(0, seg // 2, (s, 64))).to(card)
    gr = gl + torch.from_numpy(rng.integers(0, seg // 2, (s, 64))).to(card)
    for a, b in zip(d._query_grouped(gl, gr, True),
                    e._query_grouped(gl, gr, True)):
        _same_bits(a, b)
    idxs = torch.from_numpy(rng.integers(0, n, 512)).to(card)
    idxs[1] = idxs[0]
    vals = _dist_input(rng, 512, dtype).to(card)
    d2, e2 = d.update(idxs, vals), e.update(idxs, vals)
    if cap is not None:
        tail = _dist_input(rng, cap - n, dtype).to(card)
        d2, e2 = d2.append(tail), e2.append(tail)
    for got, want in zip(d2.segments, e2.segments):
        _same_bits(got.base, want.base)
        _same_bits(got.upper, want.upper)
        _same_bits(got.upper_pos, want.upper_pos)
    ls, rs = query_batch(rng, d2.n, 16, m=1024)
    _same_bits(d2.query(ls, rs), e2.query(ls, rs))
    _same_bits(d2.query_index(ls, rs), e2.query_index(ls, rs))


@pytest.mark.gpu
def test_distributed_launch_and_collective_counts(card):
    """One B1 launch a fused build; one B2 launch a segment a batch and
    one combine; the grouped path: one launch a segment, no combine; B3
    and B6 once a level a segment; no collective without a group."""
    from repro_torch.core import DistributedRMQ
    from repro_torch.core import distributed as dist_mod
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.launch.mesh import make_test_mesh

    rng = np.random.default_rng(5)
    n = 1 << 20
    x = torch.from_numpy(rng.random(n).astype(np.float32)).to(card)
    mesh = make_test_mesh((2, 4), device=card)
    ls, rs = query_batch(rng, n, 128, m=4096)
    counters = (fused_ops.LAUNCHES, qfused_ops.LAUNCHES, build_ops.LAUNCHES,
                scan_ops.LAUNCHES, upd_ops.LAUNCHES, dist_mod.COMBINES,
                dist_mod.COLLECTIVES)

    def counts(fn):
        before = [k.launches for k in counters]
        fn()
        torch.cuda.synchronize()
        return [k.launches - b for k, b in zip(counters, before)]

    holder = {}
    assert counts(lambda: holder.update(d=DistributedRMQ.build(
        x, mesh, backend="fused", with_positions=True))) == [1, 0, 0, 0, 0,
                                                            0, 0]
    d = holder["d"]
    L = d.plan.num_levels
    assert counts(lambda: d.query_index(ls, rs)) == [0, 4, 0, 0, 0, 1, 0]
    gl = torch.zeros((4, 256), dtype=torch.int32, device=card)
    assert counts(lambda: d._query_grouped(gl, gl + 5, True)) == [
        0, 4, 0, 0, 0, 0, 0]
    idxs = torch.from_numpy(rng.integers(0, n, 1 << 12)).to(card)
    vals = torch.rand(1 << 12, device=card)
    assert counts(lambda: d.update(idxs, vals)) == [
        0, 0, 0, 0, 4 * (L - 1), 0, 0]
    assert counts(lambda: holder.update(c=DistributedRMQ.build(
        x, mesh, backend="cuda", with_positions=True))) == [
        0, 0, 4 * (L - 1), 0, 0, 0, 0]
    assert counts(lambda: holder["c"].query_index(ls, rs)) == [
        0, 0, 0, 8, 0, 1, 0]


@pytest.mark.gpu
def test_distributed_past_int32_on_one_card(card):
    """n = 2^31 + 4096 on a (1, 4) mesh: four segments of 2^29 + 1024
    keep the kernels, the global positions run in int64; the fused index
    against the eager one on the same planes, and against torch.min /
    argmin on spans across each boundary.  The engine refuses it."""
    import dataclasses

    from repro_torch.core import DistributedRMQ
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.qe import QueryEngine

    n = (1 << 31) + 4096
    g = torch.Generator(device=card).manual_seed(7)
    x = torch.rand(n, generator=g, device=card)
    d = DistributedRMQ.build(x, make_test_mesh((1, 4), device=card),
                             with_positions=True, backend="fused")
    assert d.segment_capacity == (1 << 29) + 1024
    e = dataclasses.replace(d, backend="eager")
    rng = np.random.default_rng(9)
    ls = rng.integers(0, n, 1 << 14)
    rs = np.minimum(ls + rng.integers(0, 1 << 26, 1 << 14), n - 1)
    bounds = [(k * d.segment_capacity - 5, k * d.segment_capacity + 5)
              for k in (1, 2, 3)]
    ls[:3], rs[:3] = zip(*bounds)
    pos = d.query_index(ls, rs)
    assert pos.dtype == torch.int64
    _same_bits(pos, e.query_index(ls, rs))
    _same_bits(d.query(ls, rs), e.query(ls, rs))
    for i, (l, r) in enumerate(bounds):
        span = x[l:r + 1]
        assert int(pos[i]) == l + int(torch.argmin(span))
    with pytest.raises(ValueError, match="int32 index space"):
        QueryEngine(d)
