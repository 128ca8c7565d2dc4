"""The port's NaN rule on its plain paths (the kernels' oracles), on the
CPU.

The rule: NaN is the least value (``torch.argmin``'s rule).  A chunk or a
span that holds a NaN answers its leftmost NaN: that entry's own bits as
the value and its index as the position.  Otherwise the answer is the
leftmost least entry, with its own bits (so a zero keeps its sign, and a
subnormal is kept, never flushed).  Held here, as integer views and
against a numpy oracle (``np.argmin`` takes the first NaN, then the first
least entry), on every ``EDGE_GEOMETRIES`` plan for NaN and subnormal
input: the plain build (value-only and with positions), the plain walk,
the plain update (the deduped path and the sorted-run path of B6) and
append, the short-span reference, the hybrid top and the baselines, and
the compact planes (packed positions, bf16 summaries: the exact walk
answers each span's leftmost NaN as the classic walk does).  The
JAX package has no consistent answer on NaN (ROADMAP C7) and flushes
subnormals on the CPU (C2), so nothing here is compared with it.  The card
tests (``tests/test_torch_cuda.py``) hold every kernel to these plain
versions on the same inputs.
"""

import numpy as np
import pytest
import torch

from _torch_cases import (
    EDGE_GEOMETRIES,
    edge_input,
    edge_spans,
    quiet_nans,
)
from repro_torch.core import (
    RMQ,
    bitpack,
    build_hierarchy,
    make_plan,
    rmq_walk_batch,
)
from repro_torch.core.baselines import FullScan, SparseTable
from repro_torch.core.constants import PAD_POS
from repro_torch.core.hybrid import HybridRMQ
from repro_torch.kernels.hierarchy_update import ops as upd_ops
from repro_torch.kernels.rmq_short.ref import rmq_short_batch_ref
from repro_torch.streaming import updates as U

KINDS = ("nan", "subnormals")
DTYPES = [np.float32, np.float64]


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def _same_bits(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = want.numpy() if isinstance(want, torch.Tensor) else want
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def oracle_upper(base: np.ndarray, plan):
    """``(upper, upper_pos)`` by the rule, level by level in numpy."""
    c = plan.c
    upper = np.full(plan.upper_size, np.inf, base.dtype)
    upos = np.full(plan.upper_size, PAD_POS, np.int64)
    cur_v = base
    cur_p = np.arange(base.size)
    for k in range(1, plan.num_levels):
        m = plan.level_lens[k]
        v = np.full(m * c, np.inf, base.dtype)
        v[:cur_v.size] = cur_v
        p = np.full(m * c, PAD_POS, np.int64)
        p[:cur_p.size] = cur_p
        at = np.argmin(v.reshape(m, c), axis=1) + np.arange(m) * c
        off = plan.offsets[k - 1]
        upper[off:off + m] = v[at]
        upos[off:off + m] = p[at]
        cur_v, cur_p = v[at], p[at]
    return upper, upos


def oracle_spans(x: np.ndarray, ls, rs):
    """Positions and the winning entries of inclusive spans, by the rule."""
    pos = np.array([l + int(np.argmin(x[l:r + 1]))
                    for l, r in zip(ls, rs)], np.int64)
    return x[pos], pos


def _plain(kind, n, c, t, cap, dtype, seed, with_pos=True):
    rng = np.random.default_rng(seed)
    x = edge_input(kind, rng, n, c, dtype)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    h = build_hierarchy(torch.from_numpy(x), plan, with_positions=with_pos)
    return rng, x, plan, h


def _check_hierarchy(h, x_live, plan, what=""):
    base = np.full(plan.capacity, np.inf, x_live.dtype)
    base[:x_live.size] = x_live
    upper, upos = oracle_upper(base, plan)
    _same_bits(h.base, base, what + " base")
    _same_bits(h.upper, upper, what + " upper")
    if h.upper_pos is not None:
        np.testing.assert_array_equal(h.upper_pos.numpy(), upos,
                                      err_msg=what + " upper_pos")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,c,t,cap", EDGE_GEOMETRIES)
def test_plain_build_follows_the_rule(n, c, t, cap, kind, dtype):
    """Every upper entry is its chunk's leftmost NaN, else its leftmost
    least entry: bits and position, value-only and with positions."""
    for with_pos in (False, True):
        _, x, plan, h = _plain(kind, n, c, t, cap, dtype, n + c, with_pos)
        _check_hierarchy(h, x, plan, f"with_pos={with_pos}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,c,t,cap", EDGE_GEOMETRIES)
def test_plain_walk_follows_the_rule(n, c, t, cap, kind, dtype):
    """Spans over NaNs and subnormals: the leftmost NaN (else the leftmost
    least entry), its bits and its position, on a position build and,
    value-only, on a value-only build."""
    rng, x, plan, hp = _plain(kind, n, c, t, cap, dtype, 3 * n + c)
    hv = build_hierarchy(torch.from_numpy(x), plan, with_positions=False)
    ls, rs = edge_spans(rng, n, c, 256)
    wv, wp = oracle_spans(x, ls, rs)
    lt, rt = torch.from_numpy(ls), torch.from_numpy(rs)
    v, p = rmq_walk_batch(hp, lt, rt, track_pos=True)
    np.testing.assert_array_equal(p.numpy(), wp)
    _same_bits(v, wv, "position build")
    _same_bits(rmq_walk_batch(hv, lt, rt, track_pos=False)[0], wv,
               "value-only build")
    if kind == "nan":
        assert np.isnan(wv).any() and not np.isnan(wv).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,c,t,cap", EDGE_GEOMETRIES)
def test_plain_update_follows_the_rule(n, c, t, cap, kind, dtype):
    """NaNs written over numbers and numbers over NaNs (duplicates
    included: the last write wins), then an append of NaNs: the deduped
    plain update, B6's sorted-run plain path and the appends equal the
    oracle's build of the mutated array, bit for bit."""
    rng, x, plan, h = _plain(kind, n, c, t, cap, dtype, 5 * n + c)
    idxs = rng.integers(-3, plan.capacity + 3, 400)
    idxs[:40] = idxs[40:80]
    idxs[80:120] = np.flatnonzero(np.isnan(x))[:40] if kind == "nan" \
        else idxs[80:120]
    vals = (rng.random(400) + 0.25).astype(dtype)
    vals[:60] = quiet_nans(rng, 60, dtype)
    it, vt = torch.from_numpy(idxs), torch.from_numpy(vals)
    live = np.full(plan.capacity, np.inf, dtype)
    live[:n] = x
    for i, v in zip(idxs, vals):
        if 0 <= i < plan.capacity:
            live[i] = v
    for name, got in (("deduped", U.update_hierarchy(h, it, vt)),
                      ("sorted runs", upd_ops.update_hierarchy_cuda(
                          h, it, vt))):
        _check_hierarchy(got, live, plan, name)
    tail = quiet_nans(rng, min(plan.capacity - n, 37), dtype)
    if tail.size:
        got = upd_ops.append_hierarchy_cuda(h, torch.from_numpy(tail), n)
        want = U.append_hierarchy(h, torch.from_numpy(tail), n)
        grown = np.concatenate([x, tail])
        _check_hierarchy(got, grown, plan, "append (sorted runs)")
        _check_hierarchy(want, grown, plan, "append (plain)")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,c,t,cap", EDGE_GEOMETRIES)
def test_short_reference_follows_the_rule(n, c, t, cap, kind, dtype):
    """The short-span reference (B5's oracle) on spans within two chunks:
    the leftmost NaN, else the leftmost least entry, bits and position."""
    rng, x, plan, h = _plain(kind, n, c, t, cap, dtype, 7 * n + c)
    ls, rs = edge_spans(rng, n, c, 256)
    rs = np.minimum(rs, (ls // c) * c + 2 * c - 1).astype(np.int32)
    v, p = rmq_short_batch_ref(h.base, torch.from_numpy(ls),
                               torch.from_numpy(rs), c, plan.capacity, True)
    vo, _ = rmq_short_batch_ref(h.base, torch.from_numpy(ls),
                                torch.from_numpy(rs), c, plan.capacity,
                                False)
    wv, wp = oracle_spans(x, ls, rs)
    np.testing.assert_array_equal(p.numpy(), wp)
    _same_bits(v, wv, "with positions")
    _same_bits(vo, wv, "value-only")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_hybrid_top_and_baselines_follow_the_rule(kind, dtype):
    """The engine's long-span route (the hybrid's sparse-table top) and
    the baselines answer by the same rule."""
    n, c, t, cap = EDGE_GEOMETRIES[0]
    rng, x, plan, h = _plain(kind, n, c, t, cap, dtype, 11)
    ls, rs = edge_spans(rng, n, c, 256)
    wv, wp = oracle_spans(x, ls, rs)
    lt, rt = torch.from_numpy(ls), torch.from_numpy(rs)
    hy = HybridRMQ.from_hierarchy(h)
    np.testing.assert_array_equal(hy.query_index(lt, rt).numpy(), wp)
    _same_bits(hy.query(lt, rt), wv, "hybrid")
    hyv = HybridRMQ.from_hierarchy(
        build_hierarchy(torch.from_numpy(x), plan, with_positions=False))
    _same_bits(hyv.query(lt, rt), wv, "hybrid value-only")
    xt = torch.from_numpy(x)
    st = SparseTable.build(xt, positions=torch.arange(n))
    np.testing.assert_array_equal(st.query_index_batch(lt, rt).numpy(), wp)
    _same_bits(st.query_batch(lt, rt), wv, "sparse table")
    _same_bits(SparseTable.build(xt).query_batch(lt, rt), wv,
               "sparse table value-only")
    full = FullScan.build(xt, device="cpu")
    _same_bits(full.query_batch(lt[:64], rt[:64]), wv[:64], "full scan")


@pytest.mark.parametrize("backend", ["eager", "cuda", "fused"])
@pytest.mark.parametrize("with_pos", [False, True])
def test_span_answers_its_leftmost_nan(backend, with_pos):
    """n = 4096 uniform, NaN at 5, 1000 and 1003 (1000 with its own
    payload), c = 4, t = 4: [900, 1100] answers the NaN at 1000 (its bits
    and its index, not the index of a number), [0, 7] the NaN at 5, and a
    span without a NaN its least number."""
    x = np.random.default_rng(0).random(4096).astype(np.float32)
    x[[5, 1000, 1003]] = np.nan
    x.view(np.int32)[1000] = 0x7FC00ABC
    r = RMQ.build(x, c=4, t=4, with_positions=with_pos, backend=backend,
                  device="cpu")
    ls, rs = [900, 0, 6, 1001], [1100, 7, 999, 1002]
    wv, wp = oracle_spans(x, np.array(ls), np.array(rs))
    assert wp.tolist()[:2] == [1000, 5]
    _same_bits(r.query(ls, rs), wv, backend)
    if with_pos:
        np.testing.assert_array_equal(r.query_index(ls, rs).numpy(), wp)


COMPACT = {
    "packed": dict(packed_pos=True),
    "bf16": dict(summary_dtype="bfloat16"),
    "packed_bf16": dict(packed_pos=True, summary_dtype="bfloat16"),
}


def _check_compact(h, x_live, plan, what=""):
    """The compact planes are the oracle's planes packed / cast."""
    base = np.full(plan.capacity, np.inf, x_live.dtype)
    base[:x_live.size] = x_live
    upper, upos = oracle_upper(base, plan)
    _same_bits(h.base, base, what + " base")
    want = torch.from_numpy(upper)
    if plan.summary_dtype == "bfloat16":
        assert h.upper.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            h.upper.view(torch.int16).numpy(),
            want.to(torch.bfloat16).view(torch.int16).numpy(),
            err_msg=what + " upper")
    else:
        _same_bits(h.upper, want, what + " upper")
    assert (h.upper_pos.dtype == torch.uint32) == plan.packed_pos
    np.testing.assert_array_equal(
        bitpack.resolve_positions(h.upper_pos, plan).numpy(), upos,
        err_msg=what + " upper_pos")


@pytest.mark.parametrize("layout", sorted(COMPACT))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,c,t,cap", EDGE_GEOMETRIES)
def test_compact_planes_follow_the_rule(n, c, t, cap, kind, layout):
    """float32 compact indexes: the planes are the oracle's packed / cast;
    the walk (the exact walk over bf16 summaries, value queries too)
    answers each span's leftmost NaN, else its leftmost least entry, bits
    and position, as the classic walk does; an update writing NaNs over
    numbers and numbers over NaNs keeps the planes the oracle's."""
    rng = np.random.default_rng(9 * n + c)
    x = edge_input(kind, rng, n, c, np.float32)
    plan = make_plan(n, c=c, t=t, capacity=cap, **COMPACT[layout])
    h = build_hierarchy(torch.from_numpy(x), plan, with_positions=True)
    _check_compact(h, x, plan, "build")
    ls, rs = edge_spans(rng, n, c, 256)
    wv, wp = oracle_spans(x, ls, rs)
    lt, rt = torch.from_numpy(ls), torch.from_numpy(rs)
    v, p = rmq_walk_batch(h, lt, rt, track_pos=True)
    np.testing.assert_array_equal(p.numpy(), wp)
    _same_bits(v, wv, "values with positions")
    _same_bits(rmq_walk_batch(h, lt, rt, track_pos=False)[0], wv,
               "value queries")
    idxs = rng.integers(0, plan.capacity, 300)
    vals = (rng.random(300) + 0.25).astype(np.float32)
    vals[:50] = quiet_nans(rng, 50, np.float32)
    if kind == "nan":
        idxs[50:90] = np.flatnonzero(np.isnan(x))[:40]
    live = np.full(plan.capacity, np.inf, np.float32)
    live[:n] = x
    for i, val in zip(idxs, vals):
        live[i] = val
    got = upd_ops.update_hierarchy_cuda(h, torch.from_numpy(idxs),
                                        torch.from_numpy(vals))
    _check_compact(got, live, plan, "update")
