"""The port's compact planes against the reference's, bit for bit.

Bit-packed positions (``packed_pos=True``), bf16 summaries with exact
recovery (``summary_dtype="bfloat16"``) and both, on the CPU, against
the JAX package's ``jax`` backend from the same numpy input, compared as
integer views: ``base`` and ``upper`` (bf16 as int16), the packed words
word for word, positions and answers, after the build and after update,
append and retire.  Every port backend (``eager``, and ``cuda`` /
``fused``, whose wrappers take their plain versions on the CPU) over
``RMQ``, ``StreamingRMQ`` and ``HybridRMQ`` (which refuses bf16), as the
reference's ``TestCompactLayoutSweep`` sweeps them; the engine on
compact indexes; ``build_out_of_core`` from a callable, a memmap and a
tensor; ``core/theory.py``; and the plan's byte accounting past 2^31.
Inputs carry no subnormals (the reference flushes them, ROADMAP C2);
the port's own NaN and zero-sign rule on compact planes is held in
``tests/test_torch_nan.py`` and below against the classic port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (
    EDGE_GEOMETRIES,
    REFERENCE_EDGE_KINDS,
    brute_force,
    edge_input,
    edge_spans,
    tied_input,
)
from repro.core import RMQ as JRMQ
from repro.core import make_plan as jmake_plan
from repro.core import rmq_index as j_rmq_index
from repro.core import rmq_value as j_rmq_value
from repro.core import theory as jtheory
from repro.core.hybrid import HybridRMQ as JHybrid
from repro.qe import QueryEngine as JEngine
from repro.streaming import StreamingRMQ as JStreaming
from repro_torch.core import (
    RMQ,
    bitpack,
    build_hierarchy,
    finalize_compact,
    make_plan,
    rmq_index,
    rmq_value,
    rmq_walk_batch,
    theory,
)
from repro_torch.core.hybrid import HybridRMQ
from repro_torch.kernels.profiling import launch_registry
from repro_torch.qe import LONG, QueryEngine
from repro_torch.streaming import StreamingRMQ

LAYOUTS = {
    "packed": dict(packed_pos=True),
    "bf16": dict(summary_dtype="bfloat16"),
    "packed_bf16": dict(packed_pos=True, summary_dtype="bfloat16"),
}
KINDS = ("rmq", "streaming", "hybrid")
BACKENDS = ("eager", "cuda", "fused")
GEO = dict(n=257, c=8, t=2, cap=400)


def _ints(a) -> np.ndarray:
    """A plane or an answer as integers: floats by their bits (bf16 as
    int16), integer planes as they are."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.numpy()
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        return a.view(np.int16)
    if a.dtype == np.float32:
        return a.view(np.int32)
    if a.dtype == np.float64:
        return a.view(np.int64)
    return a


def _same(got, want, what=""):
    g, w = _ints(got), _ints(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype,
                                                       w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _same_planes(h, jh, what=""):
    for name in ("base", "upper", "upper_pos"):
        _same(getattr(h, name), getattr(jh, name), f"{what} {name}")


def _values(rng, n):
    """Integer-valued floats: heavy ties make leftmost breaks decisive."""
    return rng.integers(-4, 4, n).astype(np.float32)


def _spans(rng, n, m=48):
    ls = rng.integers(0, n, m)
    rs = np.minimum(ls + rng.integers(0, n, m), n - 1)
    return (np.minimum(ls, rs).astype(np.int32),
            np.maximum(ls, rs).astype(np.int32))


def _build(kind, backend, x, layout, ref=False):
    c, t, cap = GEO["c"], GEO["t"], GEO["cap"]
    if ref:
        if kind == "rmq":
            return JRMQ.build(x, c=c, t=t, with_positions=True,
                              backend="jax", capacity=cap, **layout)
        if kind == "streaming":
            return JStreaming.from_array(x, c=c, t=t, with_positions=True,
                                         backend="jax", capacity=cap,
                                         **layout)
        return JHybrid.build(x, c=c, t=t, with_positions=True,
                             backend="jax", **layout)
    if kind == "rmq":
        return RMQ.build(x, c=c, t=t, with_positions=True, backend=backend,
                         capacity=cap, device="cpu", **layout)
    if kind == "streaming":
        return StreamingRMQ.from_array(x, c=c, t=t, with_positions=True,
                                       backend=backend, capacity=cap,
                                       device="cpu", **layout)
    return HybridRMQ.build(x, c=c, t=t, with_positions=True,
                           backend=backend, device="cpu", **layout)


def _check(idx, jidx, live, rng, what):
    ls, rs = _spans(rng, live.size)
    want_v, want_p = brute_force(live, ls, rs)
    _same(idx.query_value_batch(ls, rs), jidx.query_value_batch(ls, rs),
          what + " values")
    _same(idx.query_index_batch(ls, rs), jidx.query_index_batch(ls, rs),
          what + " positions")
    np.testing.assert_array_equal(idx.query_index_batch(ls, rs).numpy(),
                                  want_p)
    if hasattr(idx, "update"):
        _same_planes(idx.hierarchy, jidx.hierarchy, what)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", KINDS)
def test_compact_layout_sweep(kind, backend, layout):
    """Build, then two rounds of update (a duplicate index: last wins),
    append and, for the streaming index, retire; the hybrid rebuilds each
    round (it is read-only) and refuses bf16 summaries."""
    lay = LAYOUTS[layout]
    rng = np.random.default_rng(KINDS.index(kind) * 31
                                + BACKENDS.index(backend) * 7 + len(layout))
    x = _values(rng, GEO["n"])
    if kind == "hybrid" and "summary_dtype" in lay:
        with pytest.raises(ValueError, match="bf16"):
            _build(kind, backend, x, lay)
        with pytest.raises(ValueError, match="bf16"):
            _build(kind, backend, x, lay, ref=True)
        return
    idx = _build(kind, backend, x, lay)
    jidx = _build(kind, backend, x, lay, ref=True)
    if kind != "hybrid":
        assert (idx.hierarchy.upper_pos.dtype == torch.uint32) == (
            "packed_pos" in lay)
        assert (idx.hierarchy.upper.dtype == torch.bfloat16) == (
            "summary_dtype" in lay)
    live = x.copy()
    _check(idx, jidx, live, rng, "build")
    for step in range(2):
        idxs = rng.integers(0, live.size, 12)
        idxs[1] = idxs[0]
        vals = _values(rng, 12)
        tail = _values(rng, 20)
        for i, v in zip(idxs, vals):
            live[i] = v
        live = np.concatenate([live, tail])
        if kind == "hybrid":
            idx = HybridRMQ.build(live, c=GEO["c"], t=GEO["t"],
                                  with_positions=True, backend=backend,
                                  device="cpu", **lay)
            jidx = JHybrid.build(live, c=GEO["c"], t=GEO["t"],
                                 with_positions=True, backend="jax", **lay)
        else:
            ji = jnp.asarray(idxs, jnp.int32)
            idx = idx.update(idxs, vals).append(tail)
            jidx = jidx.update(ji, jnp.asarray(vals)).append(
                jnp.asarray(tail))
            if kind == "streaming":
                idx, jidx = idx.retire(9), jidx.retire(9)
                live[idx.start - 9:idx.start] = np.inf
        _check(idx, jidx, live, rng, f"step {step}")


@pytest.mark.parametrize("mutation", ["update", "append", "streaming"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_compact_mutations_under_a_ragged_fourth_level(layout, mutation):
    """Mutations at indices past 512 on a four-level plan whose third
    level is ragged (capacity 576, c = 8: levels 576, 72, 9, 2).  The
    padding lanes of the third level's chunks have zero fields, and
    followed down the packed chains they would leave the word array.
    Held to a rebuild of the mutated array and to the reference."""
    lay = LAYOUTS[layout]
    rng = np.random.default_rng(576 + len(layout) + len(mutation))
    n = 576 if mutation == "update" else 520
    x = _values(rng, n)
    kw = dict(c=8, t=1, capacity=576, with_positions=True)
    if mutation == "streaming":
        idx = StreamingRMQ.from_array(x, backend="eager", device="cpu",
                                      **kw, **lay)
        jidx = JStreaming.from_array(x, backend="jax", **kw, **lay)
    else:
        idx = RMQ.build(x, backend="eager", device="cpu", **kw, **lay)
        jidx = JRMQ.build(x, backend="jax", **kw, **lay)
    assert list(idx.plan.level_lens) == [576, 72, 9, 2]
    live = x.copy()
    if mutation == "update":
        idxs = rng.integers(512, 576, 12)
        vals = _values(rng, 12)
        for i, v in zip(idxs, vals):
            live[i] = v
        idx = idx.update(idxs, vals)
        jidx = jidx.update(jnp.asarray(idxs, jnp.int32), jnp.asarray(vals))
    else:
        tail = _values(rng, 56)
        live = np.concatenate([live, tail])
        idx, jidx = idx.append(tail), jidx.append(jnp.asarray(tail))
    rebuilt = RMQ.build(live, backend="eager", device="cpu", **kw, **lay)
    _same_planes(idx.hierarchy, rebuilt.hierarchy, "rebuild")
    _check(idx, jidx, live, rng, mutation)


def test_packed_plane_is_bitwise_classic():
    """The packed plane unpacks to the classic plane entry for entry, and
    the bf16 plane is the classic plane cast, after build and after
    mutations; the compact planes are really narrower."""
    rng = np.random.default_rng(90)
    x = tied_input(rng, 300)
    kw = dict(c=8, t=2, with_positions=True, capacity=400, device="cpu")
    classic = RMQ.build(x, **kw)
    both = RMQ.build(x, packed_pos=True, summary_dtype="bfloat16", **kw)
    idxs = rng.integers(0, 300, 16)
    vals = tied_input(rng, 16)
    tail = tied_input(rng, 40)
    for r, c in ((both, classic),
                 (both.update(idxs, vals).append(tail),
                  classic.update(idxs, vals).append(tail))):
        h, hc = r.hierarchy, c.hierarchy
        assert h.upper_pos.dtype == torch.uint32
        assert h.upper.dtype == torch.bfloat16
        assert h.base.dtype == torch.float32
        _same(bitpack.resolve_positions(h.upper_pos, r.plan), hc.upper_pos)
        _same(h.upper, hc.upper.to(torch.bfloat16))
        _same(h.base, hc.base)
        assert r.auxiliary_bytes() < c.auxiliary_bytes()
        assert r.auxiliary_bytes() == r.plan.auxiliary_bytes_planned(True)
    assert h.upper_pos.numel() < hc.upper_pos.numel()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n,c,t,cap", EDGE_GEOMETRIES)
def test_finalize_compact_of_every_build(n, c, t, cap, layout):
    """The kernel builds' CPU paths, which build the classic planes and go
    through ``finalize_compact``, equal the plain compact build and the
    reference's, at the edge geometries (single-level plan included)."""
    lay = LAYOUTS[layout]
    rng = np.random.default_rng(n + c)
    x = tied_input(rng, n)
    jr = JRMQ.build(x, c=c, t=t, capacity=cap, with_positions=True,
                    backend="jax", **lay)
    for backend in BACKENDS:
        r = RMQ.build(x, c=c, t=t, capacity=cap, with_positions=True,
                      backend=backend, device="cpu", **lay)
        _same_planes(r.hierarchy, jr.hierarchy, backend)
    plain = build_hierarchy(torch.from_numpy(x), r.plan, True)
    assert finalize_compact(plain) is plain  # already compact: a no-op


@pytest.mark.parametrize("kind", REFERENCE_EDGE_KINDS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_compact_answers_are_the_classic_bits(kind, layout):
    """On the tie-rule edge inputs (signed zeros, +inf runs, ties across
    segments) the compact index's answers are the classic index's, bit
    for bit (-0.0 and +0.0 differ), value-only queries on bf16 included;
    an update of zeros over the compact index equals its rebuild."""
    n, c, t, cap = EDGE_GEOMETRIES[0]
    rng = np.random.default_rng(7)
    x = edge_input(kind, rng, n, c)
    kw = dict(c=c, t=t, capacity=cap, with_positions=True, device="cpu")
    classic = RMQ.build(x, **kw)
    compact = RMQ.build(x, **kw, **LAYOUTS[layout])
    ls, rs = edge_spans(rng, n, c, 400)
    _same(compact.query(ls, rs), classic.query(ls, rs), "values")
    _same(compact.query_index(ls, rs), classic.query_index(ls, rs))
    idxs = rng.integers(0, n, 300)
    vals = np.where(rng.random(300) < 0.5, -0.0, 0.0).astype(np.float32)
    upd = compact.update(idxs, vals)
    live = x.copy()
    for i, v in zip(idxs, vals):
        live[i] = v
    _same_planes(upd.hierarchy, RMQ.build(live, **kw,
                                          **LAYOUTS[layout]).hierarchy)


def test_exact_walk_needs_the_recompare():
    """Control: the same walk over the bf16 plane read back as float32
    (no level-0 re-compare) answers other values than the classic
    index."""
    rng = np.random.default_rng(3)
    x = (rng.random(20_000) + 1.0).astype(np.float32)
    kw = dict(c=8, t=4, with_positions=True, device="cpu")
    classic = RMQ.build(x, **kw)
    bf16 = RMQ.build(x, summary_dtype="bfloat16", **kw)
    ls, rs = _spans(rng, x.size, 500)
    _same(bf16.query(ls, rs), classic.query(ls, rs))
    h = bf16.hierarchy
    lossy = type(h)(base=h.base, upper=h.upper.float(),
                    upper_pos=h.upper_pos, plan=h.plan)
    v = rmq_walk_batch(lossy, torch.from_numpy(ls), torch.from_numpy(rs),
                       track_pos=False)[0]
    assert not np.array_equal(_ints(v), _ints(classic.query(ls, rs)))


@pytest.mark.parametrize("layout", ["packed", "bf16"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_on_compact_indexes(backend, layout):
    """``query``, ``query_index`` and ``query_bulk`` (over the crossover)
    through the engine equal the reference engine's; with bf16 summaries
    the long class is off and the bulk batch takes the routed path."""
    lay = LAYOUTS[layout]
    rng = np.random.default_rng(11 + len(layout))
    x = tied_input(rng, 20_000)
    kw = dict(c=16, t=4, with_positions=True)
    port = RMQ.build(x, backend=backend, device="cpu", **kw, **lay)
    ref = JRMQ.build(x, backend="fused" if backend == "fused" else "jax",
                     **kw, **lay)
    e = QueryEngine(port, long_cutoff=3000, bulk_crossover=64)
    je = JEngine(ref, long_cutoff=3000, bulk_crossover=64)
    ls, rs = _spans(rng, x.size, 300)
    _same(e.query(ls, rs), je.query(ls, rs))
    _same(e.query_index(ls, rs), je.query_index(ls, rs))
    assert e.stats()["class_counts"] == je.stats()["class_counts"]
    if "summary_dtype" in lay:
        assert e.stats()["class_counts"][LONG] == 0
    else:
        _same(e.query_bulk(ls, rs), je.query_bulk(ls, rs))
    _same(e.query_bulk(ls, rs, "index"), je.query_bulk(ls, rs, "index"))


def test_bulk_kernel_refuses_bf16_summaries():
    from repro_torch.kernels.rmq_bulk import ops as bulk_ops

    r = RMQ.build(tied_input(np.random.default_rng(0), 3000), c=8, t=4,
                  with_positions=True, summary_dtype="bfloat16",
                  device="cpu")
    with pytest.raises(ValueError, match="bf16"):
        bulk_ops.rmq_bulk_batch(r.hierarchy, [0], [10])


@pytest.mark.parametrize("layout", sorted(LAYOUTS) + ["classic"])
def test_single_query_wrappers(layout):
    rng = np.random.default_rng(5)
    x = tied_input(rng, 5000)
    lay = LAYOUTS.get(layout, {})
    r = RMQ.build(x, c=8, t=2, with_positions=True, device="cpu", **lay)
    jr = JRMQ.build(x, c=8, t=2, with_positions=True, backend="jax", **lay)
    for l, rr in [(0, 4999), (17, 17), (100, 2100), (4000, 4999)]:
        v = rmq_value(r.hierarchy, l, rr)
        p = rmq_index(r.hierarchy, l, rr)
        assert v.shape == () and p.shape == ()
        _same(v, j_rmq_value(jr.hierarchy, l, rr))
        _same(p, j_rmq_index(jr.hierarchy, l, rr))


# -- the out-of-core build ---------------------------------------------------
OOC_CASES = [
    # (n, c, t, capacity, segment_size): odd n, capacity > n, a short last
    # slab, slabs past n, a single-level plan
    (1001, 8, 2, None, 64),
    (1001, 8, 2, 1500, 16),
    (5003, 16, 4, 7000, 256),
    (4097, 4, 4, None, 4096),
    (300, 8, 64, None, 32),
]


def _sources(x, tmp_path):
    mm = np.memmap(tmp_path / "x.f32", np.float32, "w+", shape=x.shape)
    mm[:] = x
    mm.flush()
    ro = np.memmap(tmp_path / "x.f32", np.float32, "r", shape=x.shape)
    return {"callable": lambda a, b: x[a:b], "memmap": ro,
            "tensor": torch.from_numpy(x)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS) + ["classic"])
@pytest.mark.parametrize("n,c,t,cap,seg", OOC_CASES)
def test_build_out_of_core(n, c, t, cap, seg, layout, tmp_path):
    """Against the reference's ``build_out_of_core`` and the port's
    ``RMQ.build``, from a callable, a read-only memmap and a tensor; one
    fused build a slab."""
    lay = LAYOUTS.get(layout, {})
    x = tied_input(np.random.default_rng(n + seg), n)
    jr = JRMQ.build_out_of_core(x, n, c=c, t=t, with_positions=True,
                                capacity=cap, segment_size=seg, **lay)
    whole = RMQ.build(x, c=c, t=t, with_positions=True, capacity=cap,
                      device="cpu", **lay)
    for name, src in _sources(x, tmp_path).items():
        with launch_registry() as reg:
            r = RMQ.build_out_of_core(src, n, c=c, t=t, with_positions=True,
                                      capacity=cap, segment_size=seg,
                                      device="cpu", **lay)
        _same_planes(r.hierarchy, jr.hierarchy, name)
        _same_planes(r.hierarchy, whole.hierarchy, name)
        cap_ = r.plan.capacity
        slabs = -(-cap_ // seg) if r.plan.num_levels > 1 else 1
        if r.plan.num_levels > 1:
            assert reg.counts == {"hierarchy_fused": slabs}, name
        assert r.backend == "eager" and r.n == n
    ls, rs = _spans(np.random.default_rng(1), n, 64)
    _same(r.query_index(ls, rs), jr.query_index(ls, rs))
    _same(r.query(ls, rs), jr.query(ls, rs))


def test_build_out_of_core_refusals():
    x = np.zeros(1000, np.float32)
    for seg in (12, 8):
        with pytest.raises(ValueError, match="segment_size"):
            RMQ.build_out_of_core(x, 1000, c=8, t=2, segment_size=seg,
                                  device="cpu")
    with pytest.raises(ValueError, match="requires with_positions"):
        RMQ.build_out_of_core(x, 1000, c=8, t=2, segment_size=64,
                              summary_dtype="bfloat16", device="cpu")


# -- core/theory.py and the plan's accounting -----------------------------
@pytest.mark.parametrize("n", [17, 1000, 4097, 1 << 20, (1 << 30) + 3])
@pytest.mark.parametrize("c", [2, 8, 128])
@pytest.mark.parametrize("t", [1, 4, 64])
def test_theory_matches_reference(n, c, t):
    plan, jplan = make_plan(n, c=c, t=t), jmake_plan(n, c=c, t=t)
    assert theory.aux_entries_bound(n, c) == jtheory.aux_entries_bound(n, c)
    assert theory.aux_entries_bound_ceil(n, c, plan.num_levels) == (
        jtheory.aux_entries_bound_ceil(n, c, jplan.num_levels))
    # the logical entries (the stored ones are padded to whole chunks)
    assert sum(plan.level_lens[1:]) <= theory.aux_entries_bound_ceil(
        n, c, plan.num_levels)
    assert theory.max_scanned_entries(plan) == (
        jtheory.max_scanned_entries(jplan))
    for r in (1, 2 * c, 1000, n):
        assert theory.expected_scanned_entries(plan, r) == (
            jtheory.expected_scanned_entries(jplan, r))
    assert theory.optimal_num_levels(n, c, t) == (
        jtheory.optimal_num_levels(n, c, t)) == plan.num_levels


# exact counts of make_plan(n, c=128, t=64): (aux bytes with positions,
# position plane bytes) by layout
ACCOUNTING = {
    1 << 30: {"classic": (67_637_248, 33_818_624),
              "packed": (41_216_448, 7_397_824),
              "bf16": (50_727_936, 33_818_624),
              "packed_bf16": (24_307_136, 7_397_824)},
    (1 << 31) + 4096: {"classic": (202_916_352, 135_277_568),
                       "packed": (82_434_768, 14_795_984),
                       "bf16": (169_096_960, 135_277_568),
                       "packed_bf16": (48_615_376, 14_795_984)},
}


@pytest.mark.parametrize("n", sorted(ACCOUNTING))
@pytest.mark.parametrize("layout", sorted(LAYOUTS) + ["classic"])
def test_plan_accounting_past_2_pow_31(n, layout):
    lay = LAYOUTS.get(layout, {})
    plan = make_plan(n, c=128, t=64, **lay)
    jplan = jmake_plan(n, c=128, t=64, **lay)
    for with_pos in (False, True):
        assert plan.auxiliary_bytes_planned(with_pos) == (
            jplan.auxiliary_bytes_planned(with_pos))
    assert plan.position_plane_bytes() == jplan.position_plane_bytes()
    assert plan.value_plane_bytes() == jplan.value_plane_bytes()
    assert (plan.auxiliary_bytes_planned(True),
            plan.position_plane_bytes()) == ACCOUNTING[n][layout]
