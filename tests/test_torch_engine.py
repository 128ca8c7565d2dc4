"""The port's query engine against the reference's, bit for bit.

The reference ``QueryEngine`` and the port's, over indexes built from
the same numpy input, must give the same answers (``query``,
``query_index``, ``query_mixed``, ``query_bulk`` above and below the
crossover), the same ``stats()`` class counts, dedup savings and cache
hits, and no answer of an older generation after ``update`` + ``attach``.
The planner and the cache are copies of the reference's modules; the
port's engine runs on the CPU here (each kernel route takes its plain
version).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import brute_force, tied_input
from repro.core.api import RMQ as JRMQ
from repro.qe import QueryEngine as JEngine
from repro.streaming import StreamingRMQ as JStreaming
from repro_torch.core import RMQ
from repro_torch.core.hybrid import HybridRMQ
from repro_torch.kernels.profiling import count_launches, launch_registry
from repro_torch.obs import Metrics
from repro_torch.obs.trace import Tracer, use_tracer
from repro_torch.qe import (
    FUSED,
    LONG,
    MID,
    SHORT,
    QueryEngine,
    QueryPlanner,
    ResultCache,
)
from repro_torch.streaming import StreamingRMQ

ROOT = Path(__file__).resolve().parents[1]
# the port's backend for each of the reference's
REF_BACKEND = {"eager": "jax", "cuda": "pallas", "fused": "fused"}


def _mixed_queries(rng, n, c, m):
    """Bounds spread across the three span classes."""
    spans = np.concatenate([
        rng.integers(1, 2 * c + 1, m // 3 + 1),
        rng.integers(2 * c + 1, max(n // 4, 2 * c + 2), m // 3 + 1),
        rng.integers(max(n // 2, 2), n + 1, m // 3 + 1),
    ])[:m]
    rng.shuffle(spans)
    ls = (rng.random(m) * np.maximum(n - spans + 1, 1)).astype(np.int64)
    rs = np.minimum(ls + spans - 1, n - 1)
    return ls.astype(np.int32), rs.astype(np.int32)


def _pair(n, c, t, seed=0, backend="eager", with_positions=True, **kw):
    """The port's index and the reference's over the same input."""
    rng = np.random.default_rng(seed)
    x = tied_input(rng, n)
    port = RMQ.build(x, c=c, t=t, with_positions=with_positions,
                     backend=backend, device="cpu", **kw)
    ref = JRMQ.build(x, c=c, t=t, with_positions=with_positions,
                     backend="jax" if backend == "cuda" else
                     REF_BACKEND[backend], **kw)
    return rng, x, port, ref


def _engines(port, ref, backend, **kw):
    """A port engine and a reference engine; the reference's ``pallas``
    routes run its kernels in interpret mode."""
    jkw = dict(kw, backend=REF_BACKEND[backend])
    if backend == "cuda":
        jkw["interpret"] = True
    return QueryEngine(port, backend=backend, **kw), JEngine(ref, **jkw)


def _same(got, want):
    assert isinstance(got, torch.Tensor)
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def _same_stats(e, je):
    s, js = e.stats(), je.stats()
    for key in ("backend", "generation", "batches", "queries",
                "dedup_saved", "cache"):
        want = js[key] if key != "backend" else (
            {v: k for k, v in REF_BACKEND.items()}[js[key]])
        assert s[key] == want, key
    assert s["class_counts"] == js["class_counts"]


class TestPlanner:
    def test_modules_are_copies_of_the_reference(self):
        for rel in ("qe/planner.py", "qe/cache.py", "obs/trace.py",
                    "obs/metrics.py"):
            assert (ROOT / "src/repro_torch" / rel).read_text() == (
                ROOT / "src/repro" / rel).read_text(), rel

    def test_classification(self):
        p = QueryPlanner(c=128, num_levels=3)
        ls = np.array([0, 100, 127, 0, 0], np.int32)
        rs = np.array([255, 300, 128, 50_000, 2**20], np.int32)
        labels = p.classify(ls, rs)
        assert labels[0] == SHORT and labels[2] == SHORT
        assert labels[1] == MID and labels[4] == LONG

    def test_bucket_shapes_bounded_pow2(self):
        p = QueryPlanner(c=8, num_levels=2, min_bucket=16, max_bucket=64)
        rng = np.random.default_rng(0)
        ls = rng.integers(0, 1000, 333).astype(np.int32)
        rs = np.minimum(ls + rng.integers(1, 500, 333), 999).astype(np.int32)
        buckets = p.plan(ls, rs)
        covered = np.concatenate([b.idxs for b in buckets])
        assert sorted(covered.tolist()) == list(range(333))
        for b in buckets:
            assert b.shape in (16, 32, 64) and b.count <= b.shape
            assert (b.ls[b.count:] == 0).all() and (b.rs[b.count:] == 0).all()

    @pytest.mark.parametrize("backend", ["eager", "cuda", "fused"])
    def test_engine_planner_equals_reference(self, backend):
        _, _, port, ref = _pair(50_000, 128, 4, backend=backend)
        e, je = _engines(port, ref, backend, long_cutoff=3000)
        assert dataclasses.asdict(e.planner) == dataclasses.asdict(
            je.planner)
        tuned = dict(je.tuned)
        tuned["backend"] = backend
        assert e.tuned == tuned
        assert e.bulk_crossover == je.bulk_crossover


class TestEngineParity:
    @pytest.mark.parametrize("n,c,t", [
        (100_000, 128, 4),   # 3 levels: every class populated
        (50_000, 128, 64),   # 2 levels
        (4096, 8, 4),        # deep hierarchy, tiny chunks
        (700, 16, 2),
        (300, 128, 64),      # single level
    ])
    @pytest.mark.parametrize("backend", ["eager", "cuda", "fused"])
    def test_bit_identical_mixed_spans(self, n, c, t, backend):
        rng, x, port, ref = _pair(n, c, t, seed=n, backend=backend)
        e, je = _engines(port, ref, backend, max_bucket=256)
        ls, rs = _mixed_queries(rng, n, c, 600)
        ls[50:80], rs[50:80] = ls[0], rs[0]  # duplicates: dedup
        bv, bp = brute_force(x, ls, rs)
        for _ in range(2):  # the second pass is served from the cache
            got_v, got_p = e.query(ls, rs), e.query_index(ls, rs)
            _same(got_v, je.query(ls, rs))
            _same(got_p, je.query_index(ls, rs))
            np.testing.assert_array_equal(got_v.numpy(), bv)
            np.testing.assert_array_equal(got_p.numpy(), bp)
        _same_stats(e, je)

    def test_all_classes_exercised_and_launches(self):
        """cuda routes: short buckets to rmq_short, mid to rmq_scan, long
        to the plain hybrid; one launch per bucket and plane."""
        rng, _, port, ref = _pair(100_000, 128, 4, seed=1, backend="cuda")
        e = QueryEngine(port, cache_size=0, max_bucket=128)
        ls, rs = _mixed_queries(rng, 100_000, 128, 900)
        with count_launches() as counts:
            e.query(ls, rs)
        got = e.stats()["class_counts"]
        assert got[SHORT] > 0 and got[MID] > 0 and got[LONG] > 0
        buckets = {cls: -(-got[cls] // 128) for cls in (SHORT, MID)}
        assert counts == {"rmq_short": buckets[SHORT],
                          "rmq_scan": buckets[MID]}
        ex = e.stats()["executors"]
        assert (ex[SHORT]["calls"], ex[MID]["calls"]) == (
            buckets[SHORT], buckets[MID])

    def test_fused_mixed_is_one_launch_per_bucket(self):
        rng, x, port, ref = _pair(20_000, 64, 4, seed=2, backend="fused")
        e, je = _engines(port, ref, "fused", max_bucket=128)
        ls, rs = _mixed_queries(rng, 20_000, 64, 700)
        is_index = rng.random(700) < 0.5
        with count_launches() as counts:
            v, p = e.query_mixed(ls, rs, is_index)
        assert counts == {"rmq_fused": -(-e.stats()["class_counts"][FUSED]
                                         // 128)}
        jv, jp = je.query_mixed(ls, rs, is_index)
        _same(v[~torch.from_numpy(is_index)], np.asarray(jv)[~is_index])
        _same(p[torch.from_numpy(is_index)], np.asarray(jp)[is_index])
        bv, bp = brute_force(x, ls, rs)
        np.testing.assert_array_equal(v.numpy()[~is_index], bv[~is_index])
        np.testing.assert_array_equal(p.numpy()[is_index], bp[is_index])
        # a repeat is served from the cache: no launch
        with count_launches() as counts:
            e.query_mixed(ls, rs, is_index)
        je.query_mixed(ls, rs, is_index)
        assert counts == {}
        _same_stats(e, je)

    @pytest.mark.parametrize("backend", ["eager", "cuda"])
    def test_query_mixed_per_op_fallback(self, backend):
        rng, _, port, ref = _pair(5000, 16, 4, seed=3, backend=backend)
        e, je = _engines(port, ref, backend)
        ls, rs = _mixed_queries(rng, 5000, 16, 200)
        is_index = rng.random(200) < 0.3
        v, p = e.query_mixed(ls, rs, is_index)
        jv, jp = je.query_mixed(ls, rs, is_index)
        _same(v[~torch.from_numpy(is_index)], np.asarray(jv)[~is_index])
        _same(p[torch.from_numpy(is_index)], np.asarray(jp)[is_index])
        _same_stats(e, je)

    @pytest.mark.parametrize("backend", ["eager", "cuda", "fused"])
    @pytest.mark.parametrize("crossover", [16, 10**9])
    def test_query_bulk(self, backend, crossover):
        rng, x, port, ref = _pair(30_000, 32, 8, seed=4, backend=backend)
        e, je = _engines(port, ref, backend, bulk_crossover=crossover)
        e._bulk.max_bucket = je._bulk.max_bucket = 64  # several buckets
        ls, rs = _mixed_queries(rng, 30_000, 32, 300)
        ls[5], rs[5] = ls[4], rs[4]
        with count_launches() as counts:
            got = e.query_bulk(ls, rs)
        _same(got, je.query_bulk(ls, rs))
        _same(e.query_bulk(ls, rs, "index"), je.query_bulk(ls, rs, "index"))
        np.testing.assert_array_equal(got.numpy(), brute_force(x, ls, rs)[0])
        if crossover == 16:
            assert counts == {"rmq_bulk": -(-300 // 64)}
            bulk = e.stats()["executors"]["bulk"]
            assert bulk == je.stats()["executors"]["bulk"]
        _same_stats(e, je)

    def test_value_only_index_raises(self):
        x = np.random.default_rng(0).random(5000).astype(np.float32)
        e = RMQ.build(x, c=16, t=4, device="cpu").engine()
        for call in (lambda: e.query_index([0], [10]),
                     lambda: e.query_bulk([0], [10], "index"),
                     lambda: e.query_mixed([0, 1], [10, 11], [True, False])):
            with pytest.raises(ValueError, match="without positions"):
                call()

    def test_empty_batch(self):
        _, _, port, _ = _pair(1000, 16, 4)
        out = port.engine().query(np.zeros(0, np.int32), np.zeros(0,
                                                                  np.int32))
        assert out.shape == (0,) and out.dtype == torch.float32

    def test_int32_capacity_guard(self):
        _, _, rmq, _ = _pair(1000, 16, 4)
        huge = dataclasses.replace(rmq, hierarchy=dataclasses.replace(
            rmq.hierarchy, plan=dataclasses.replace(rmq.plan,
                                                    capacity=2**31)))
        with pytest.raises(ValueError, match="int32 index space"):
            QueryEngine(huge)

    def test_refusals_name_the_roadmap(self):
        _, _, rmq, _ = _pair(1000, 16, 4)
        # tuning is served (A9): an empty cache leaves the defaults
        from repro_torch.tune import TuningCache

        assert QueryEngine(rmq, tuning=TuningCache()).tuned["source"] == \
            "default"
        # compact planes are served (A3): a packed index's engine answers
        # as the classic index's does
        packed = RMQ.build(rmq.hierarchy.base[:rmq.n], c=16, t=4,
                           with_positions=True, packed_pos=True,
                           device="cpu")
        ls, rs = _mixed_queries(np.random.default_rng(3), 1000, 16, 60)
        np.testing.assert_array_equal(
            QueryEngine(packed).query_index(ls, rs).numpy(),
            rmq.query_index(ls, rs).numpy())

        # a distributed index is served (A10a): the engine routes it by
        # segment containment, as the facade answers it
        from repro_torch.core import DistributedRMQ
        from repro_torch.launch.mesh import make_test_mesh

        sharded = DistributedRMQ.build(
            rmq.hierarchy.base[:rmq.n], make_test_mesh((1, 4), device="cpu"),
            c=16, t=4, with_positions=True)
        e = QueryEngine(sharded)
        assert e.planner is None and e.distributed is not None
        np.testing.assert_array_equal(e.query_index(ls, rs).numpy(),
                                      rmq.query_index(ls, rs).numpy())
        counts = e.stats()["class_counts"]
        assert counts["seg_local"] > 0 and counts["crossing"] > 0

    def test_answers_on_the_index_device_and_hybrid_index(self):
        rng, x, port, _ = _pair(9000, 16, 4, seed=5)
        hyb = HybridRMQ.from_hierarchy(port.hierarchy)
        e = hyb.engine()
        ls, rs = _mixed_queries(rng, 9000, 16, 100)
        got = e.query_index(ls, rs)
        assert got.device == port.device
        np.testing.assert_array_equal(got.numpy(), brute_force(x, ls, rs)[1])


class TestMutationInvalidation:
    @pytest.mark.parametrize("backend", ["eager", "cuda", "fused"])
    def test_update_invalidates_cached_result(self, backend):
        _, x, rmq, _ = _pair(50_000, 128, 4, seed=3, backend=backend)
        engine = rmq.engine()
        l, r = 1000, 30_000
        assert float(engine.query([l], [r])[0]) == x[l:r + 1].min()
        h0 = engine.cache.hits
        engine.query([l], [r])
        assert engine.cache.hits == h0 + 1
        rmq2 = rmq.update(np.array([17_000]), np.array([-3.0], np.float32))
        assert rmq2.generation == rmq.generation + 1
        engine.attach(rmq2)
        assert float(engine.query([l], [r])[0]) == -3.0
        assert int(engine.query_index([l], [r])[0]) == 17_000
        # the predecessor still answers its own data
        assert float(rmq.query([l], [r])[0]) == x[l:r + 1].min()

    @pytest.mark.parametrize("backend", ["eager", "cuda", "fused"])
    def test_parity_after_interleaved_mutations(self, backend):
        rng, _, rmq, jrmq = _pair(20_000, 128, 4, seed=5, backend=backend,
                                  capacity=30_000)
        e, je = _engines(rmq, jrmq, backend)
        for _ in range(3):
            idxs = rng.integers(0, rmq.n, 50)
            vals = rng.random(50).astype(np.float32) - 0.5
            tail = rng.random(100).astype(np.float32)
            rmq = rmq.update(idxs, vals).append(tail)
            jrmq = jrmq.update(jnp.asarray(idxs, jnp.int32),
                               jnp.asarray(vals)).append(jnp.asarray(tail))
            e.attach(rmq)
            je.attach(jrmq)
            ls, rs = _mixed_queries(rng, rmq.n, 128, 300)
            _same(e.query(ls, rs), je.query(ls, rs))
            _same(e.query_index(ls, rs), je.query_index(ls, rs))
            _same(e.query_bulk(ls, rs, "index"),
                  je.query_bulk(ls, rs, "index"))
        _same_stats(e, je)

    def test_streaming_retire_through_the_engine(self):
        rng = np.random.default_rng(8)
        x = tied_input(rng, 4000)
        s = StreamingRMQ.from_array(x, c=16, t=4, capacity=6000,
                                    with_positions=True, backend="cuda",
                                    device="cpu")
        js = JStreaming.from_array(x, c=16, t=4, capacity=6000,
                                   with_positions=True, backend="pallas")
        e, je = s.engine(), js.engine()
        ls, rs = _mixed_queries(rng, 4000, 16, 200)
        _same(e.query(ls, rs), je.query(ls, rs))
        s, js = s.retire(1500).append(x[:500]), js.retire(1500).append(
            jnp.asarray(x[:500]))
        e.attach(s)
        je.attach(js)
        _same(e.query(ls, rs), je.query(ls, rs))
        _same(e.query_index(ls, rs), je.query_index(ls, rs))
        _same_stats(e, je)

    def test_attach_non_successor_clears_cache(self):
        _, _, rmq_a, _ = _pair(3000, 16, 4, seed=6)
        _, _, rmq_b, _ = _pair(3000, 16, 4, seed=7)
        engine = rmq_a.engine()
        engine.query([0], [100])
        assert len(engine.cache) > 0
        engine.attach(rmq_b)   # same generation: not a successor
        assert len(engine.cache) == 0


class TestCache:
    def test_lru_eviction_order(self):
        cache = ResultCache(capacity=2)
        cache.put("value", 0, 0, 1, 1.0)
        cache.put("value", 0, 0, 2, 2.0)
        assert cache.get("value", 0, 0, 1) == 1.0
        cache.put("value", 0, 0, 3, 3.0)
        assert cache.get("value", 0, 0, 2) is None
        assert cache.stats()["evictions"] == 1

    @pytest.mark.parametrize("cache_size", [0, 16, 8192])
    def test_engine_dedup_and_hits(self, cache_size):
        _, _, rmq, jrmq = _pair(10_000, 64, 4, seed=8)
        e, je = _engines(rmq, jrmq, "eager", cache_size=cache_size)
        ls = np.full((64,), 10, np.int32)
        rs = np.full((64,), 500, np.int32)
        for _ in range(2):
            _same(e.query(ls, rs), je.query(ls, rs))
        _same(e.query_index(ls[:1], rs[:1]), je.query_index(ls[:1], rs[:1]))
        assert e.stats()["dedup_saved"] == 126
        _same_stats(e, je)

    def test_metrics_trace_and_config_record(self):
        rng, _, rmq, _ = _pair(10_000, 64, 4, seed=9, backend="cuda")
        metrics = Metrics()
        tracer = Tracer()
        with launch_registry(timing=True) as reg, use_tracer(tracer):
            e = QueryEngine(rmq, metrics=metrics)
            ls, rs = _mixed_queries(rng, 10_000, 64, 100)
            e.query(ls, rs)
        assert [c.name for c in reg.configs] == ["engine_tuned_config"]
        assert reg.configs[0].meta["backend"] == "cuda"
        assert set(reg.timings) >= {"short:value", "mid:value"}
        names = {s.name for s in tracer.spans()}
        assert {"plan", "execute", "scatter"} <= names
        flat = metrics.as_dict()
        assert flat["queries"] == 100 and flat["batches"] == 1
