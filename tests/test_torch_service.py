"""The port's ``QueryService`` and ``build_many`` against the reference's.

The same request script (``submit`` / ``submit_bulk`` / ``flush(names=)``
/ ``take`` / ``attach`` / a failing group / the unclaimed-result bound
and its drop hook / ``register_many``) goes through
``repro.qe.QueryService`` and ``repro_torch.qe.QueryService`` over
indexes built from the same numpy input.  Answers must be equal as
integer views (min and argmin are exact: tolerance 0) and the
``stats()`` counters equal.  ``build_many``'s rows must equal the
reference's ``build_many`` rows, the compact layouts included.  Mirrors
the service tests of ``tests/test_query_engine.py``,
``tests/test_differential.py``, ``tests/test_fused_build.py`` and
``tests/test_obs.py``.  Everything runs on the CPU (the kernel routes
take their plain versions).
"""

import jax  # noqa: F401  (both frameworks at the top; JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RMQ as JRMQ
from repro.core import build_many as jbuild_many
from repro.core import make_plan as jmake_plan
from repro.obs.metrics import Metrics as JMetrics
from repro.qe import QueryService as JService
from repro_torch.core import RMQ, build_hierarchy, build_many, make_plan
from repro_torch.kernels.profiling import count_launches
from repro_torch.obs.metrics import Metrics
from repro_torch.qe import QueryService

# (reference backend, port backend)
BACKENDS = [("fused", "fused"), ("jax", "eager")]
COUNTERS = ("requests", "flushes", "coalesced_batches", "mixed_retries",
            "pending_requests", "pending_queries", "unclaimed_results",
            "dropped_results")
ENGINE_COUNTERS = ("batches", "queries", "dedup_saved", "class_counts")


def _tied(rng, n):
    """Integer-valued floats: ties make leftmost-position breaks decisive."""
    return rng.integers(-4, 4, n).astype(np.float32)


def _spans(rng, n, m):
    ls = rng.integers(0, n, m)
    rs = np.minimum(ls + rng.integers(0, n, m), n - 1)
    return (np.minimum(ls, rs).astype(np.int32),
            np.maximum(ls, rs).astype(np.int32))


def _ints(a) -> np.ndarray:
    """An answer or a plane as integers: floats by their bits (bf16 as
    int16), packed words as int32."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        elif a.dtype == torch.uint32:
            a = a.view(torch.int32)
        a = a.numpy()
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        return a.view(np.int16)
    if a.dtype == np.uint32:
        return a.view(np.int32)
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


def _indexes(x, backends, with_positions=True, c=8, t=2):
    """``(port, reference)`` indexes over ``x``."""
    jb, pb = backends
    return (RMQ.build(x, c=c, t=t, with_positions=with_positions,
                      backend=pb, device="cpu"),
            JRMQ.build(x, c=c, t=t, with_positions=with_positions,
                       backend=jb))


def _same_counters(svc, jsvc):
    s, js = svc.stats(), jsvc.stats()
    assert {k: s[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert set(s["engines"]) == set(js["engines"])
    for name in s["engines"]:
        for key in ENGINE_COUNTERS:
            assert s["engines"][name][key] == js["engines"][name][key], (
                name, key)


def _script(svc, idx, spans):
    """The request script: returns ``[(label, answer)]``."""
    (la, ra), (lb, rb) = spans
    out = []
    svc.register("a", idx["a"])
    svc.register("b", idx["b"])
    t1 = svc.submit("a", la[:20], ra[:20])
    t2 = svc.submit("a", la[20:], ra[20:], op="index")
    t3 = svc.submit("b", lb[:5], rb[:5], op="index")
    t4 = svc.submit("a", la[:3], ra[:3])
    # bulk: answered now, claimable without a flush, the queue untouched
    tb = svc.submit_bulk("a", la, ra, op="index")
    assert svc.stats()["pending_requests"] == 4
    out.append(("bulk", svc.take(tb)))
    res = svc.flush(names=("a",))
    assert set(res) == {t1, t2, t4}
    assert svc.stats()["pending_requests"] == 1   # b still queued
    out += [("t1", res[t1]), ("t2 take", svc.take(t2)),
            ("t1 take", svc.take(t1)), ("t4", svc.take(t4))]
    with pytest.raises(KeyError):
        svc.take(t3)
    svc.flush()
    out.append(("t3", svc.take(t3)))
    # a failing group: admission checked positions against the old
    # binding, then a value-only successor lands before the flush
    t5 = svc.submit("b", lb[:3], rb[:3])
    t6 = svc.submit("b", lb[3:6], rb[3:6], op="index")
    t7 = svc.submit("b", lb[6:9], rb[6:9], op="index")
    svc.attach("b", idx["b value-only"], reset_cache=True)
    with pytest.raises(RuntimeError, match="claimable"):
        svc.flush()
    out.append(("t5 survives", svc.take(t5)))
    for tk in (t6, t7):
        with pytest.raises(KeyError):
            svc.take(tk)
    # the synchronous conveniences survive an unrelated failing group
    svc.attach("b", idx["b"], reset_cache=True)
    t8 = svc.submit("b", lb[:2], rb[:2], op="index")
    svc.attach("b", idx["b value-only"], reset_cache=True)
    out.append(("query", svc.query("a", la[:7], ra[:7])))
    with pytest.raises(KeyError):
        svc.take(t8)
    out.append(("query_index", svc.query_index("a", la[7:9], ra[7:9])))
    return out


@pytest.mark.parametrize("backends", BACKENDS, ids=["fused", "plain"])
def test_request_script_matches_reference(backends):
    rng = np.random.default_rng(0)
    xa, xb = _tied(rng, 1500), _tied(rng, 700)
    spans = (_spans(rng, 1500, 40), _spans(rng, 700, 12))
    pa, ja = _indexes(xa, backends)
    pb, jb = _indexes(xb, backends)
    pbv, jbv = _indexes(xb, backends, with_positions=False)
    svc, jsvc = QueryService(), JService()
    got = _script(svc, {"a": pa, "b": pb, "b value-only": pbv}, spans)
    want = _script(jsvc, {"a": ja, "b": jb, "b value-only": jbv}, spans)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (label, g), (_, w) in zip(got, want):
        assert isinstance(g, torch.Tensor), label
        _same(g, w, label)
    _same_counters(svc, jsvc)
    assert svc.stats()["mixed_retries"] == (1 if backends[1] == "fused"
                                            else 0)


@pytest.mark.parametrize("backends", BACKENDS, ids=["fused", "plain"])
def test_coalesce_auto_flush_and_registry_errors(backends):
    rng = np.random.default_rng(1)
    x = _tied(rng, 900)
    p, j = _indexes(x, backends)
    runs = []
    for svc, idx in ((QueryService(max_pending=8), p),
                     (JService(max_pending=8), j)):
        svc.register("a", idx)
        tickets = [svc.submit("a", np.array([i]), np.array([i + 100]))
                   for i in range(8)]
        assert svc.stats()["pending_queries"] == 0     # auto-flushed
        runs.append([svc.take(tk) for tk in tickets])
        with pytest.raises(KeyError, match="no index registered"):
            svc.submit("zzz", np.array([0]), np.array([1]))
        with pytest.raises(ValueError, match="op must be"):
            svc.submit("a", np.array([0]), np.array([1]), op="median")
        with pytest.raises(ValueError, match="matching 1-D"):
            svc.submit("a", np.array([0, 1]), np.array([1]))
        svc.auto_flush = False
        svc.submit("a", np.array([0]), np.array([1]))
        with pytest.raises(ValueError, match="pending"):
            svc.unregister("a")
        with pytest.raises(ValueError, match="pending"):
            svc.register("a", idx)
        svc.flush()
        svc.unregister("a")
        assert svc.stats()["engines"] == {}
    for g, w in zip(*runs):
        _same(g, w)


def test_index_op_on_a_value_only_index_fails_at_admission():
    x = np.random.default_rng(2).random(500).astype(np.float32)
    for svc, idx in ((QueryService(), RMQ.build(x, c=16, t=4,
                                                device="cpu")),
                     (JService(), JRMQ.build(x, c=16, t=4, backend="jax"))):
        svc.register("a", idx)
        with pytest.raises(ValueError, match="without positions"):
            svc.submit("a", np.array([0]), np.array([10]), op="index")


@pytest.mark.parametrize("backends", BACKENDS, ids=["fused", "plain"])
def test_unclaimed_bound_is_per_index_with_drop_hook(backends):
    rng = np.random.default_rng(3)
    xa, xb = _tied(rng, 400), _tied(rng, 400)
    pa, ja = _indexes(xa, backends)
    pb, jb = _indexes(xb, backends)
    runs = []
    for svc, a, b in ((QueryService(auto_flush=False, max_unclaimed=2),
                       pa, pb),
                      (JService(auto_flush=False, max_unclaimed=2),
                       ja, jb)):
        svc.register("a", a)
        svc.register("b", b)
        drops = []
        svc.on_dropped_result = lambda name, tk: drops.append((name, tk))
        t_b = svc.submit("b", np.array([0]), np.array([399]))
        svc.flush()
        flooded = []
        for i in range(5):
            flooded.append(svc.submit("a", np.array([i]),
                                      np.array([i + 5])))
            svc.flush()
        kept = [svc.take(t_b)] + [svc.take(tk) for tk in flooded[3:]]
        for tk in flooded[:3]:
            with pytest.raises(KeyError):
                svc.take(tk)
        runs.append((drops, flooded, kept, svc))
    (drops, flooded, kept, svc), (jdrops, jflooded, jkept, jsvc) = runs
    assert drops == jdrops and [n for n, _ in drops] == ["a", "a", "a"]
    assert [tk for _, tk in drops] == flooded[:3]
    for g, w in zip(kept, jkept):
        _same(g, w)
    _same_counters(svc, jsvc)
    assert svc.stats()["dropped_results"] == 3


@pytest.mark.parametrize("both_ops", [False, True])
def test_mixed_retry_counts_coalescing_once(both_ops):
    """A merged mixed execution that fails once is retried per op; the
    admission-coalesced group counts once in both packages."""
    rng = np.random.default_rng(4)
    x = _tied(rng, 900)
    p, j = _indexes(x, BACKENDS[0])
    runs = []
    for svc, idx in ((QueryService(), p), (JService(), j)):
        engine = svc.register("a", idx, cache_size=0)
        orig = engine.query_mixed
        state = {"calls": 0}

        def flaky(ls, rs, flags, orig=orig, state=state):
            state["calls"] += 1
            if state["calls"] == 1:
                raise RuntimeError("transient mixed-kernel failure")
            return orig(ls, rs, flags)

        engine.query_mixed = flaky
        srng = np.random.default_rng(5)
        tickets = []
        for op in ("value", "index") * (2 if both_ops else 1):
            ls, rs = _spans(srng, 900, 3)
            tickets.append(svc.submit("a", ls, rs, op))
        res = svc.flush()
        assert state["calls"] == 1
        runs.append(([res[tk] for tk in tickets], svc))
    (got, svc), (want, jsvc) = runs
    for g, w in zip(got, want):
        _same(g, w)
    _same_counters(svc, jsvc)
    assert svc.stats()["mixed_retries"] == 1
    assert svc.stats()["coalesced_batches"] == 1


def test_fused_flush_is_one_launch():
    """A flush mixing value and index requests on a fused engine is one
    ``query_mixed``: one ``rmq_fused`` launch (the plain path records the
    launch the card would make)."""
    rng = np.random.default_rng(6)
    x = _tied(rng, 3000)
    svc = QueryService(auto_flush=False)
    svc.register("a", RMQ.build(x, c=8, t=2, with_positions=True,
                                backend="fused", device="cpu"),
                 cache_size=0)
    tickets = []
    for i in range(64):
        ls, rs = _spans(rng, 3000, 64)
        tickets.append((svc.submit("a", ls, rs,
                                   "index" if i % 2 else "value"), ls, rs,
                        i % 2))
    with count_launches() as counts:
        svc.flush()
    assert counts == {"rmq_fused": 1}
    for tk, ls, rs, is_index in tickets[:8]:
        got = svc.take(tk).numpy()
        for k, (l, r) in enumerate(zip(ls, rs)):
            seg = x[l:r + 1]
            assert got[k] == (l + int(np.argmin(seg)) if is_index
                              else seg.min())


def test_service_engine_metrics_export():
    runs = []
    for svc_cls, m, idx in (
            (QueryService, Metrics(),
             RMQ.build(np.random.default_rng(2).random(512).astype(
                 np.float32), c=8, t=8, device="cpu")),
            (JService, JMetrics(),
             JRMQ.build(np.random.default_rng(2).random(512).astype(
                 np.float32), c=8, t=8, backend="jax"))):
        svc = svc_cls(auto_flush=False, metrics=m)
        svc.register("idx", idx, cache_size=16)
        tk = svc.submit("idx", np.array([1, 5]), np.array([3, 9]))
        svc.flush(names=("idx",))
        svc.take(tk)
        runs.append(m)
    prom, jprom = (m.to_prometheus() for m in runs)
    assert 'repro_engines_cache_hit_rate{index="idx"}' in prom
    assert "repro_flushes" in prom
    names = {line.split("{")[0].split(" ")[0]
             for line in prom.splitlines() if not line.startswith("#")}
    jnames = {line.split("{")[0].split(" ")[0]
              for line in jprom.splitlines() if not line.startswith("#")}
    assert names == jnames
    d, jd = runs[0].as_dict(), runs[1].as_dict()
    for key in ("requests", "flushes", "pending_queries",
                "unclaimed_results", "dropped_results"):
        assert d[key] == jd[key], key
    assert d["engines"]["idx"]["queries"] == jd["engines"]["idx"]["queries"]


def test_service_flush_span():
    from repro.obs.trace import Tracer as JTracer
    from repro.obs.trace import use_tracer as juse_tracer
    from repro_torch.obs.trace import Tracer, use_tracer

    x = np.random.default_rng(7).random(256).astype(np.float32)
    runs = []
    for svc, idx, tracer, use in (
            (QueryService(auto_flush=False),
             RMQ.build(x, c=8, t=8, device="cpu"), Tracer(), use_tracer),
            (JService(auto_flush=False),
             JRMQ.build(x, c=8, t=8, backend="jax"), JTracer(),
             juse_tracer)):
        svc.register("a", idx)
        with use(tracer):
            svc.submit("a", np.array([1]), np.array([200]))
            svc.submit("a", np.array([3]), np.array([9]))
            svc.flush()
        sp = [s for s in tracer.spans() if s.name == "service_flush"]
        runs.append(sp[0].args)
    assert runs[0] == runs[1] == {"requests": 2, "groups": 1, "failed": 0}


# ---------------------------------------------------------------------------
# register_many and build_many
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_positions", [False, True])
def test_register_many_matches_reference(with_positions):
    rng = np.random.default_rng(8)
    n = 2000
    arrays = {f"idx{i}": _tied(rng, n) for i in range(3)}
    svc, jsvc = QueryService(), JService()
    with count_launches() as counts:
        engines = svc.register_many(arrays, c=16, t=4, device="cpu",
                                    with_positions=with_positions)
    assert counts == {"hierarchy_fused": 1}      # one batched build
    jengines = jsvc.register_many(arrays, c=16, t=4,
                                  with_positions=with_positions)
    assert list(engines) == list(jengines) == list(arrays)
    ls, rs = _spans(rng, n, 32)
    for name, x in arrays.items():
        solo = build_hierarchy(torch.from_numpy(x), make_plan(n, c=16, t=4),
                               with_positions)
        h = engines[name].index.hierarchy
        for plane in ("base", "upper", "upper_pos"):
            _same(getattr(h, plane), getattr(solo, plane), plane)
            _same(getattr(h, plane),
                  getattr(jengines[name].index.hierarchy, plane), plane)
        _same(svc.query(name, ls, rs), jsvc.query(name, ls, rs), name)
        if with_positions:
            _same(svc.query_index(name, ls, rs),
                  jsvc.query_index(name, ls, rs), name)
    _same_counters(svc, jsvc)


def test_register_many_refusals_and_mixed_dtypes():
    rng = np.random.default_rng(9)
    x = _tied(rng, 512)
    for svc, kw in ((QueryService(), dict(device="cpu")), (JService(), {})):
        assert svc.register_many({}, **kw) == {}
        with pytest.raises(ValueError, match="equal lengths"):
            svc.register_many({"a": np.zeros(10, np.float32),
                               "b": np.zeros(11, np.float32)}, **kw)
        svc.register_many({"a": x, "b": x}, c=16, t=4, **kw)
        old = svc.engine("a")
        svc.submit("b", [0], [10])
        with pytest.raises(ValueError, match="pending"):
            svc.register_many({"a": x, "b": x}, c=16, t=4, **kw)
        assert svc.engine("a") is old     # all or nothing
        svc.flush()
    # mixed input dtypes are promoted to a common one, as jnp.stack does
    svc = QueryService()
    engines = svc.register_many({"f32": x, "f64": x.astype(np.float64)},
                                c=16, t=4, device="cpu")
    assert engines["f32"].index.value_dtype == torch.float64


LAYOUTS = [dict(), dict(capacity=6000), dict(packed_pos=True),
           dict(summary_dtype="bfloat16"),
           dict(packed_pos=True, summary_dtype="bfloat16")]
# bf16 summaries need positions (both packages refuse a value-only build)
CASES = [(layout, wp) for layout in LAYOUTS for wp in (False, True)
         if wp or "summary_dtype" not in layout]


@pytest.mark.parametrize("layout,with_positions", CASES)
def test_build_many_rows_equal_the_reference(layout, with_positions):
    rng = np.random.default_rng(10)
    xs = np.stack([_tied(rng, 5000) for _ in range(4)])
    plan = make_plan(5000, c=16, t=4, **layout)
    with count_launches() as counts:
        batched = build_many(torch.from_numpy(xs), plan, with_positions)
    assert counts == {"hierarchy_fused": 1}
    jbatched = jbuild_many(jnp.asarray(xs), jmake_plan(5000, c=16, t=4,
                                                       **layout),
                           with_positions=with_positions)
    assert batched.base.shape == (4, plan.capacity)
    for plane in ("base", "upper", "upper_pos"):
        _same(getattr(batched, plane), getattr(jbatched, plane), plane)
    for i in range(4):
        solo = build_hierarchy(torch.from_numpy(xs[i]), plan, with_positions)
        for plane in ("base", "upper", "upper_pos"):
            g = getattr(batched, plane)
            _same(None if g is None else g[i], getattr(solo, plane), plane)


def test_build_many_refusals():
    plan = make_plan(64, c=8, t=2)
    with pytest.raises(ValueError, match="rank-2"):
        build_many(torch.zeros(64), plan)
    with pytest.raises(ValueError, match="plan is for n=64"):
        build_many(torch.zeros((2, 65)), plan)
    with pytest.raises(TypeError, match="float32, bfloat16 or float64"):
        build_many(torch.zeros((2, 64), dtype=torch.int32), plan)
    with pytest.raises(ValueError, match="at least one row"):
        build_many(torch.zeros((0, 64)), plan)
    with pytest.raises(ValueError, match="rank-2"):
        jbuild_many(jnp.zeros((64,)), jmake_plan(64, c=8, t=2))


def test_build_many_single_level_plan_records_no_launch():
    rng = np.random.default_rng(11)
    xs = np.stack([_tied(rng, 100) for _ in range(3)])
    plan = make_plan(100, c=128, t=64)
    assert plan.num_levels == 1
    with count_launches() as counts:
        batched = build_many(torch.from_numpy(xs), plan, True)
    assert counts == {}
    jbatched = jbuild_many(jnp.asarray(xs), jmake_plan(100, c=128, t=64),
                           with_positions=True)
    for plane in ("base", "upper", "upper_pos"):
        _same(getattr(batched, plane), getattr(jbatched, plane), plane)
