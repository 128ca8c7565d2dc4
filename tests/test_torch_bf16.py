"""bfloat16 input values (A3b): the port against the reference, bit for bit.

A bf16 input stays bf16: the index keeps a bf16 level 0 and bf16 upper
levels (2 bytes an entry), as the reference's does.  The inputs are made
from seeds with numpy and cast to bf16 with torch (round to nearest even,
the reference's ``astype``); both packages get the same bits.  Min and
argmin are exact, so the tolerance is 0 and every plane and answer is
compared as an integer view (bf16 as int16, positions and packed words as
int32): ``assert_array_equal`` takes -0.0 for +0.0.

* the port's builds on the CPU (plain, fused, per-level; value-only,
  with positions and packed) against the reference's jnp build, and
  against its Pallas per-level and fused builds in interpret mode with
  -0.0 equal to +0.0 (the reference's Pallas value summaries prefer -0.0,
  ``ROADMAP.md`` C6);
* ``query`` / ``query_index`` on every backend against the reference's
  ``rmq_value_batch`` / ``rmq_index_batch``, and against a brute force in
  the bf16-rounded values (the reference's ``TestBf16Values``);
* ``RMQ.update``, ``StreamingRMQ`` append / retire / update,
  ``build_out_of_core``, ``build_many`` / ``register_many`` and the tier
  against the reference; the engine (``query``, ``query_mixed``,
  ``query_bulk``: bf16 answers, carried on the host as int16 bits), the
  hybrid and the sparse table against a brute force over the bits;
* NaN (the least value) and subnormals on the port's own rule, against a
  brute force over the bits: the reference answers NaN inconsistently and
  flushes subnormals on the CPU (``ROADMAP.md`` C2), so the differential
  tests leave both out (``BF16_REFERENCE_KINDS``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (
    BF16_KINDS,
    BF16_REFERENCE_KINDS,
    bf16_bits,
    bf16_input,
    edge_spans,
    query_batch,
)
from repro.core import RMQ as JRMQ
from repro.core import build_many as jbuild_many
from repro.core import rmq_index_batch as jindex
from repro.core import rmq_value_batch as jvalue
from repro.core.hierarchy import build_hierarchy as jbuild
from repro.core.plan import make_plan as jmake_plan
from repro.kernels.hierarchy_build.ops import build_hierarchy_pallas
from repro.kernels.hierarchy_fused.ops import build_hierarchy_fused as jfused
from repro.streaming import StreamingRMQ as JStreamingRMQ
from repro_torch.core import RMQ, build_hierarchy, build_many, make_plan
from repro_torch.core.baselines import SparseTable
from repro_torch.core.hybrid import HybridRMQ
from repro_torch.core.interop import (
    hierarchy_from_reference,
    hierarchy_to_reference,
)
from repro_torch.kernels.hierarchy_build.ops import build_hierarchy_percall
from repro_torch.kernels.hierarchy_fused.ops import build_hierarchy_fused
from repro_torch.qe import QueryService
from repro_torch.streaming import StreamingRMQ

PORT_BUILDS = {
    "plain": build_hierarchy,
    "fused": build_hierarchy_fused,
    "percall": build_hierarchy_percall,
}
# (n, c, t, capacity): sub-warp chunks, capacity > n, ragged n at the
# paper's c, and a single-level plan.
GEOMETRIES = [
    (1000, 4, 2, None),
    (4999, 32, 4, 8192),
    (20_001, 128, 2, None),
    (700, 128, 64, None),
]


def _ref(x: torch.Tensor):
    """The same bf16 bits as a JAX array."""
    return jnp.asarray(x.view(torch.int16).numpy().view(jnp.bfloat16))


def _bits(a) -> np.ndarray:
    """An integer view of a plane or an answer of either package."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        elif a.dtype == torch.uint32:
            a = a.view(torch.int32)
        return a.numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _same(got, want, what=""):
    g, w = _bits(got), _bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, what
    np.testing.assert_array_equal(g, w, err_msg=what)


def _same_planes(got, ref):
    _same(got.base, ref.base, "base")
    _same(got.upper, ref.upper, "upper")
    assert (got.upper_pos is None) == (ref.upper_pos is None)
    if got.upper_pos is not None:
        _same(got.upper_pos, ref.upper_pos, "upper_pos")


def _same_values(got, want, what=""):
    """Equal as numbers (-0.0 == +0.0): the reference's sign of a zero
    minimum is its min reduction's, which JAX leaves open; the port's
    bits are held to the brute force's instead."""
    g, w = _bits(got), _bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, what
    np.testing.assert_array_equal(_widen(g), _widen(w), err_msg=what)


def _widen(bits: np.ndarray) -> np.ndarray:
    """bf16 bits (int16) as the float32 values they are (exact)."""
    return (bits.astype(np.int64).astype(np.uint32) << 16).view(np.float32)


def _brute(x: torch.Tensor, ls, rs):
    """Each span's leftmost least entry, NaN least: (bits, position)."""
    bits = _bits(x)
    f = _widen(bits)
    pos = np.array([l + int(np.argmin(f[l:r + 1]))  # NaN: its first one
                    for l, r in zip(ls, rs)], np.int64)
    return bits[pos], pos


@pytest.mark.parametrize("n,c,t,cap", GEOMETRIES)
@pytest.mark.parametrize("kind", BF16_REFERENCE_KINDS)
@pytest.mark.parametrize("with_pos", [False, True])
def test_builds_match_reference(n, c, t, cap, kind, with_pos):
    x = bf16_input(kind, np.random.default_rng(n + c), n, c)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    ref = jbuild(_ref(x), jmake_plan(n, c=c, t=t, capacity=cap),
                 with_positions=with_pos)
    assert ref.upper.dtype == jnp.bfloat16
    for name, build in PORT_BUILDS.items():
        got = build(x, plan, with_pos)
        assert got.base.dtype == got.upper.dtype == torch.bfloat16, name
        assert not got.quantized
        _same_planes(got, ref)


@pytest.mark.parametrize("n,c,t,cap", GEOMETRIES[:3])
def test_packed_build_matches_reference(n, c, t, cap):
    x = bf16_input("tied", np.random.default_rng(n), n, c)
    plan = make_plan(n, c=c, t=t, capacity=cap, packed_pos=True)
    ref = jbuild(_ref(x), jmake_plan(n, c=c, t=t, capacity=cap,
                                     packed_pos=True), with_positions=True)
    for build in PORT_BUILDS.values():
        got = build(x, plan, True)
        assert got.upper_pos.dtype == torch.uint32
        _same_planes(got, ref)


@pytest.mark.parametrize("c", [32, 128])
@pytest.mark.parametrize("kind", ["dense", "zeros"])
@pytest.mark.parametrize("with_pos", [False, True])
def test_builds_match_reference_pallas(c, kind, with_pos):
    """The reference's Pallas builds (interpret mode) on bf16: positions
    bit for bit, values with -0.0 equal to +0.0 (C6)."""
    n = 5000
    x = bf16_input(kind, np.random.default_rng(c), n, c)
    jplan = jmake_plan(n, c=c, t=2)
    got = build_hierarchy_fused(x, make_plan(n, c=c, t=2), with_pos)
    for ref in (build_hierarchy_pallas(_ref(x), jplan,
                                       with_positions=with_pos,
                                       interpret=True),
                jfused(_ref(x), jplan, with_positions=with_pos,
                       interpret=True)):
        assert ref.upper.dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            got.upper.float().numpy(), np.asarray(ref.upper, np.float32))
        if with_pos:
            _same(got.upper_pos, ref.upper_pos)


@pytest.mark.parametrize("n,c,t,cap", GEOMETRIES)
@pytest.mark.parametrize("kind", BF16_REFERENCE_KINDS)
def test_queries_match_reference(n, c, t, cap, kind):
    rng = np.random.default_rng(3 * n + c)
    x = bf16_input(kind, rng, n, c)
    ls, rs = edge_spans(rng, n, c, 64)
    ref = JRMQ.build(_ref(x), c=c, t=t, capacity=cap, with_positions=True)
    want_v, want_p = ref.query(ls, rs), ref.query_index(ls, rs)
    bv, bp = _brute(x, ls, rs)
    np.testing.assert_array_equal(np.asarray(want_p), bp)
    for backend in ("eager", "cuda", "fused"):
        r = RMQ.build(x, c=c, t=t, capacity=cap, with_positions=True,
                      backend=backend, device="cpu")
        v, p = r.query(ls, rs), r.query_index(ls, rs)
        assert v.dtype == torch.bfloat16
        _same_values(v, want_v, backend)
        _same(v, bv, backend)
        _same(p, want_p, backend)
    value_only = RMQ.build(x, c=c, t=t, capacity=cap, device="cpu")
    _same(value_only.query(ls, rs), bv)


def test_reference_bf16_values_mirrored():
    """The reference's TestBf16Values, on the port: the minimum and the
    leftmost argmin in bf16-rounded values, and the reference's own
    answers, through the plain walk and both kernel backends."""
    rng = np.random.default_rng(0)
    n = 20_000
    x32 = rng.random(n).astype(np.float32)
    x16 = torch.from_numpy(x32).to(torch.bfloat16)
    ls = rng.integers(0, n, 128)
    rs = rng.integers(0, n, 128)
    ls, rs = np.minimum(ls, rs), np.maximum(ls, rs)
    rounded = x16.float().numpy()
    want_v = np.array([rounded[l:r + 1].min() for l, r in zip(ls, rs)])
    want_p = np.array([l + int(np.argmin(rounded[l:r + 1]))
                       for l, r in zip(ls, rs)])
    jh = jbuild(_ref(x16), jmake_plan(n, c=64, t=8), with_positions=True)
    for backend in ("eager", "cuda", "fused"):
        r = RMQ.build(x16, c=64, t=8, with_positions=True, backend=backend,
                      device="cpu")
        assert r.hierarchy.upper.dtype == torch.bfloat16
        np.testing.assert_array_equal(r.query(ls, rs).float().numpy(),
                                      want_v)
        np.testing.assert_array_equal(r.query_index(ls, rs).numpy(), want_p)
        _same(r.query(ls, rs), jvalue(jh, jnp.asarray(ls), jnp.asarray(rs)))
        _same(r.query_index(ls, rs),
              jindex(jh, jnp.asarray(ls), jnp.asarray(rs)))


@pytest.mark.parametrize("backend", ["eager", "cuda", "fused"])
@pytest.mark.parametrize("kind", ["dense", "signed_zeros"])
def test_mutations_match_reference(backend, kind):
    """RMQ.update (float32 values rounded to bf16, and bf16 values), then
    StreamingRMQ append / retire / update, against the reference."""
    rng = np.random.default_rng(11)
    n, cap, c = 6000, 8192, 32
    x = bf16_input(kind, rng, n, c)
    idxs = rng.integers(0, n, 400)
    idxs[:50] = idxs[50:100]  # duplicates: the last one wins
    v32 = rng.random(400).astype(np.float32)
    r = RMQ.build(x, c=c, t=4, with_positions=True, backend=backend,
                  device="cpu")
    ref = JRMQ.build(_ref(x), c=c, t=4, with_positions=True)
    got, want = r.update(idxs, v32), ref.update(idxs, v32)
    assert got.hierarchy.base.dtype == torch.bfloat16
    _same_planes(got.hierarchy, want.hierarchy)
    vb = bf16_input(kind, rng, 400, c)
    _same_planes(got.update(idxs, vb).hierarchy,
                 want.update(idxs, _ref(vb)).hierarchy)

    s = StreamingRMQ.from_array(x, c=c, t=4, capacity=cap,
                                with_positions=True, backend=backend,
                                device="cpu")
    js = JStreamingRMQ.from_array(_ref(x), c=c, t=4, capacity=cap,
                                  with_positions=True)
    tail = bf16_input(kind, rng, 777, c)
    s = s.append(tail).retire(1024).update([5000, 5000], [-7.0, -8.0])
    js = js.append(_ref(tail)).retire(1024).update([5000, 5000],
                                                   [-7.0, -8.0])
    _same_planes(s.hierarchy, js.hierarchy)
    ls, rs = query_batch(rng, n + 777, c)
    _same_values(s.query(ls, rs), js.query(ls, rs))
    _same(s.query(ls, rs), _bits(s.hierarchy.base)[
        _bits(js.query_index(ls, rs))])
    _same(s.query_index(ls, rs), js.query_index(ls, rs))


@pytest.mark.parametrize("packed", [False, True])
def test_out_of_core_build_matches_reference(packed):
    """RMQ.build_out_of_core on bf16 slabs (a callable and a tensor): one
    fused build a slab, the planes equal to the reference's out-of-core
    build and to the port's RMQ.build."""
    from repro_torch.kernels.profiling import launch_registry

    n, c, seg = 20_011, 32, 4096
    x = bf16_input("tied", np.random.default_rng(31), n, c)
    lay = {"packed_pos": True} if packed else {}
    jr = JRMQ.build_out_of_core(_ref(x), n, c=c, t=4, with_positions=True,
                                segment_size=seg, **lay)
    whole = RMQ.build(x, c=c, t=4, with_positions=True, device="cpu", **lay)
    for src in (lambda a, b: x[a:b], x):
        with launch_registry() as reg:
            r = RMQ.build_out_of_core(src, n, c=c, t=4, with_positions=True,
                                      segment_size=seg, device="cpu", **lay)
        assert reg.counts == {"hierarchy_fused": -(-n // seg)}
        assert r.hierarchy.base.dtype == torch.bfloat16
        _same_planes(r.hierarchy, jr.hierarchy)
        _same_planes(r.hierarchy, whole.hierarchy)


def test_hybrid_and_baselines_answer_bf16():
    """HybridRMQ (the sparse-table top over bf16 values) and the sparse-
    table baseline keep bf16 and answer each span's leftmost least entry,
    bits and position.  The reference's hybrid answers float32 on a bf16
    index (its walk's float32 +inf promotes the bf16 values), the same
    numbers; its SparseTable keeps bf16, as the port's does."""
    rng = np.random.default_rng(13)
    n, c = 6000, 32
    x = bf16_input("tied", rng, n, c)
    ls, rs = query_batch(rng, n, c)
    bv, bp = _brute(x, ls, rs)
    hy = HybridRMQ.build(x, c=c, t=64, with_positions=True, device="cpu")
    assert hy.hierarchy.base.dtype == torch.bfloat16
    v = hy.query(ls, rs)
    assert v.dtype == torch.bfloat16
    _same(v, bv)
    _same(hy.query_index(ls, rs).long(), bp)
    st = SparseTable.build(x, device="cpu")
    assert st.table.dtype == torch.bfloat16
    _same(st.query_batch(ls, rs), bv)


@pytest.mark.parametrize("with_pos", [False, True])
def test_build_many_rows_match_reference(with_pos):
    rng = np.random.default_rng(5)
    n, c = 3000, 32
    xs = torch.stack([bf16_input(k, rng, n, c)
                      for k in ("dense", "tied", "zeros")])
    plan = make_plan(n, c=c, t=4)
    got = build_many(xs, plan, with_positions=with_pos)
    ref = jbuild_many(_ref(xs), jmake_plan(n, c=c, t=4),
                      with_positions=with_pos)
    assert got.upper.shape == (3, plan.upper_size)
    _same_planes(got, ref)


@pytest.mark.parametrize("backend", ["eager", "cuda", "fused"])
def test_engine_answers_bf16(backend):
    """The engine carries bf16 answers through numpy as int16 bits, so
    query, query_index, query_mixed and query_bulk (with and without the
    LRU) return bf16 tensors equal to the facade, NaN payloads and zero
    signs included."""
    rng = np.random.default_rng(17)
    n, c = 20_000, 32
    x = bf16_input("nan", rng, n, c)
    x[:4000] = bf16_input("signed_zeros", rng, 4000, c)
    ls, rs = edge_spans(rng, n, c, 300)
    r = RMQ.build(x, c=c, t=8, with_positions=True, backend=backend,
                  device="cpu")
    want_v, want_p = r.query(ls, rs), r.query_index(ls, rs)
    bv, bp = _brute(x, ls, rs)
    _same(want_v, bv)
    _same(want_p.long(), bp)
    is_index = rng.random(ls.size) < 0.5
    for cache_size in (0, 4096):
        e = r.engine(cache_size=cache_size)
        for _ in range(2):  # the second round hits the LRU
            v = e.query(ls, rs)
            assert v.dtype == torch.bfloat16
            _same(v, want_v)
            _same(e.query_index(ls, rs), want_p)
            mv, mp = e.query_mixed(ls, rs, is_index)
            assert mv.dtype == torch.bfloat16
            _same(mv[~is_index], want_v[~is_index])
            _same(mp[is_index], want_p[is_index])
        e.bulk_crossover = 1
        _same(e.query_bulk(ls, rs), want_v)
        _same(e.query_bulk(ls, rs, "index"), want_p)


def test_engine_host_round_trip_keeps_bits():
    """Every bf16 bit pattern survives the engine's host round trip."""
    from repro_torch.qe import engine

    t = bf16_bits(np.arange(1 << 16))
    host = engine._to_host(t)
    assert host.dtype == engine._np_dtype(torch.bfloat16) == np.int16
    _same(engine._to_device(host, torch.bfloat16, "cpu"), t)


def test_register_many_bf16_rows():
    rng = np.random.default_rng(19)
    n, c = 4096, 32
    arrays = {f"r{i}": bf16_input(k, rng, n, c)
              for i, k in enumerate(("dense", "tied", "zeros"))}
    svc = QueryService()
    engines = svc.register_many(arrays, c=c, t=4, with_positions=True,
                                device="cpu")
    ls, rs = query_batch(rng, n, c)
    for name, x in arrays.items():
        h = engines[name].index.hierarchy
        assert h.base.dtype == h.upper.dtype == torch.bfloat16
        ref = JRMQ.build(_ref(x), c=c, t=4, with_positions=True)
        v = svc.query(name, ls, rs)
        assert v.dtype == torch.bfloat16
        _same_values(v, ref.query(ls, rs))
        _same(v, _brute(x, ls, rs)[0])
        _same(svc.query_index(name, ls, rs), ref.query_index(ls, rs))


def test_serving_tier_bf16_tenant():
    """A ServingTier tenant over a bf16 index: a staged update (float32
    values rounded to bf16) swapped in at the flush, then bf16 answers
    equal to the reference index after the same update; c="auto" on the
    CPU misses the card's cache and builds the default geometry in bf16."""
    from repro_torch.serving import ServingTier

    rng = np.random.default_rng(37)
    n = 5000
    x = bf16_input("tied", rng, n, 128)
    r = RMQ.build(x, c="auto", with_positions=True, backend="fused",
                  device="cpu")
    assert r.plan == make_plan(n) and r.hierarchy.upper.dtype == torch.bfloat16
    clock = [0.0]
    tier = ServingTier(clock=lambda: clock[0])
    tier.register_tenant("a", r, slo_ms=5.0, cache_size=0)
    reqs = []
    for i in range(8):
        ls, rs = query_batch(rng, n, 128, m=16)
        reqs.append((tier.submit("a", ls, rs, "index" if i % 2 else
                                 "value"), ls, rs, i % 2))
    idxs = rng.integers(0, n, 256).astype(np.int32)
    vals = rng.random(256).astype(np.float32) - 0.5
    tier.update("a", idxs, vals)
    clock[0] += 0.01
    tier.step()
    ref = JRMQ.build(_ref(x), with_positions=True).update(idxs, vals)
    for tk, ls, rs, is_index in reqs:
        got = tk.result(0)
        if is_index:
            _same(got, ref.query_index(ls, rs))
        else:
            assert got.dtype == torch.bfloat16
            _same_values(got, ref.query(ls, rs))


@pytest.mark.parametrize("kind", sorted(set(BF16_KINDS)
                                        - set(BF16_REFERENCE_KINDS)))
@pytest.mark.parametrize("backend", ["eager", "cuda", "fused"])
def test_nan_and_subnormals_on_the_port_rule(kind, backend):
    """NaN is the least value and subnormals are kept: every build equals
    the plain one and every answer is the span's leftmost least entry's
    own bits (a NaN's payload and sign included)."""
    rng = np.random.default_rng(23)
    n, c = 9000, 32
    x = bf16_input(kind, rng, n, c)
    plan = make_plan(n, c=c, t=4)
    want = build_hierarchy(x, plan, True)
    for build in PORT_BUILDS.values():
        _same_planes(build(x, plan, True), want)
    ls, rs = edge_spans(rng, n, c, 200)
    r = RMQ.build(x, c=c, t=4, with_positions=True, backend=backend,
                  device="cpu")
    bv, bp = _brute(x, ls, rs)
    _same(r.query(ls, rs), bv)
    _same(r.query_index(ls, rs).long(), bp)
    idxs = rng.integers(0, n, 300)
    vals = bf16_input(kind, rng, 300, c)
    got = r.update(idxs, vals)
    arr = x.clone()
    arr[torch.from_numpy(idxs)] = vals
    _same_planes(got.hierarchy, build_hierarchy(arr, plan, True))


def test_memory_and_interop():
    """The planes take 2 bytes an entry, and cross to the reference and
    back as the same bits."""
    n, c = 10_000, 32
    x = bf16_input("dense", np.random.default_rng(29), n, c)
    r = RMQ.build(x, c=c, t=4, with_positions=True, device="cpu")
    h, plan = r.hierarchy, r.plan
    assert h.auxiliary_bytes() == plan.upper_size * (2 + 4)
    assert h.memory_bytes() == 2 * plan.capacity + h.auxiliary_bytes()
    ref = jbuild(_ref(x), jmake_plan(n, c=c, t=4), with_positions=True)
    out = hierarchy_to_reference(h)
    for key in ("base", "upper"):
        assert out[key].dtype == np.int16  # bf16 bits
        _same(out[key].view(jnp.bfloat16), getattr(ref, key))
    back = hierarchy_from_reference(ref.base, ref.upper, ref.upper_pos,
                                    ref.plan, "cpu")
    _same_planes(back, h)


def test_bf16_summaries_over_bf16_input_stay_refused():
    x = bf16_input("dense", np.random.default_rng(1), 5000, 32)
    with pytest.raises(ValueError, match="float32 inputs only"):
        RMQ.build(x, summary_dtype="bfloat16", with_positions=True,
                  device="cpu")
