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
