"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where no CUDA device is present (decided
inside the test, never at import).  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Min and argmin are exact, so every comparison is bit-for-bit (tolerance
0): values, leftmost positions and the +inf / PAD_POS padding.
"""

import numpy as np
import pytest
import torch

from _torch_cases import GEOMETRIES, brute_force, query_batch, tied_input
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
        _assert_same(ref.base, got.base)
        _assert_same(ref.upper, got.upper)
        assert got.with_positions == with_pos
        if with_pos:
            _assert_same(ref.upper_pos, got.upper_pos)


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


def _short_spans(rng, n, c, m=512):
    ls = rng.integers(0, n, m)
    rs = np.minimum((ls // c + rng.integers(0, 2, m)) * c
                    + rng.integers(0, c, m), n - 1)
    rs = np.maximum(rs, ls)
    return ls.astype(np.int32), rs.astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,t,cap", SLICE2_GEOMETRIES)
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
@pytest.mark.parametrize("n,c,t,cap", SLICE2_GEOMETRIES)
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
