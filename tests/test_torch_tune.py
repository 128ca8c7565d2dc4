"""The port's autotuner and tuning cache against the reference's.

Mirrors ``tests/test_tune.py`` case by case, with the reference run on
the same numpy inputs and the same cache document (backend names
translated ``eager -> jax``, ``cuda -> pallas``).  Both packages key the
CPU as ``"cpu"``, so one document serves both.  Plans are compared field
for field; hierarchies and answers bit for bit as integer views
(tolerance 0: min and argmin are exact).  A miss, or an empty cache,
must leave every consumer on its defaults, bit for bit.  Timings are
not compared (they are the search's output, not its contract).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks at the top; JAX stays on the CPU)
import numpy as np
import pytest
import torch

from repro import tune as jtune
from repro.core.api import RMQ as JRMQ
from repro.core.plan import make_plan as jmake_plan
from repro.qe import QueryEngine as JEngine
from repro.streaming import StreamingRMQ as JStreaming
from repro_torch.core import RMQ, LevelSplit, make_plan
from repro_torch.core.hybrid import HybridRMQ
from repro_torch.kernels.profiling import count_launches, launch_registry
from repro_torch.obs.metrics import Metrics
from repro_torch.qe import QueryEngine
from repro_torch.streaming import StreamingRMQ
from repro_torch.tune import (
    DEFAULT_CACHE_PATH,
    DEFAULT_GEOMETRIES,
    SCHEMA_VERSION,
    TINY_GEOMETRIES,
    Autotuner,
    TunedConfig,
    TuningCache,
    TuningCacheError,
    current_platform,
    n_bucket,
    time_fn,
)
from repro_torch.tune import measure

ROOT = Path(__file__).resolve().parents[1]
TO_REF = {"eager": "jax", "cuda": "pallas", "fused": "fused"}
FROM_REF = {v: k for k, v in TO_REF.items()}


def _entry(platform="cpu", nb=13, mix="mixed", **over):
    e = {
        "platform": platform, "n_bucket": nb, "span_mix": mix,
        "c": 32, "t": 8, "backend": "eager", "planner": "routed",
        "long_cutoff": None, "scan_chunks": 2, "sparse_top": True,
        "ns_per_query": 100.0,
    }
    e.update(over)
    return e


def _doc(*entries, version=SCHEMA_VERSION):
    return {"schema_version": version, "entries": list(entries)}


def _ref_doc(doc):
    """The same document under the reference's backend names."""
    out = dict(doc)
    out["entries"] = [
        dict(e, backend=TO_REF.get(e["backend"], e["backend"]))
        if isinstance(e, dict) and "backend" in e else e
        for e in doc["entries"]]
    return out


def _pair(*entries):
    """``(port cache, reference cache)`` from one document."""
    doc = _doc(*entries)
    return (TuningCache.from_json(doc),
            jtune.TuningCache.from_json(_ref_doc(doc)))


def _same_config(cfg, jcfg):
    if cfg is None or jcfg is None:
        assert cfg is None and jcfg is None
        return
    d, jd = cfg.as_dict(), jcfg.as_dict()
    assert d.pop("backend") == FROM_REF[jd.pop("backend")]
    assert d == jd


def _ints(a) -> np.ndarray:
    """Floats by their bits, integer planes as they are."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32)
    if a.dtype == np.float64:
        return a.view(np.int64)
    return a


def _same(got, want, what=""):
    g, w = _ints(got), _ints(want)
    assert g.dtype == w.dtype and g.shape == w.shape, what
    np.testing.assert_array_equal(g, w, err_msg=what)


def _same_plan(plan, jplan):
    """Field for field (the split by its fields: two classes)."""
    for f in dataclasses.fields(plan):
        got, want = getattr(plan, f.name), getattr(jplan, f.name)
        if f.name == "level_split":
            if got is None or want is None:
                assert got is None and want is None
                continue
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name


def _spans(rng, n, m=200):
    ls = rng.integers(0, n, m)
    rs = np.minimum(ls + rng.integers(0, n, m), n - 1)
    return (np.minimum(ls, rs).astype(np.int32),
            np.maximum(ls, rs).astype(np.int32))


# ---------------------------------------------------------------------------
# config + cache semantics
# ---------------------------------------------------------------------------
ACCEPTED = [
    dict(c=8, t=8),
    dict(c=8, t=8, backend="cuda"),
    dict(c=2, t=1, backend="fused", planner="fused", long_cutoff=1,
         scan_chunks=1, sparse_top=False, bulk_crossover=1),
    dict(c=512, t=64, packed_pos=True, summary_dtype="bfloat16"),
]
REJECTED = [
    dict(c=12, t=8),                      # not a power of two
    dict(c=1, t=8),
    dict(c=8, t=0),
    dict(c=8, t=8, backend="tpu"),
    dict(c=8, t=8, planner="hybrid"),
    dict(c=8, t=8, scan_chunks=3),
    dict(c=8, t=8, long_cutoff=0),
    dict(c=8, t=8, bulk_crossover=0),
    dict(c=8, t=8, packed_pos=1),
    dict(c=8, t=8, summary_dtype="float16"),
]


def _ref_kwargs(kw):
    return dict(kw, backend=TO_REF.get(kw.get("backend", "eager"),
                                       kw.get("backend")))


class TestTunedConfig:
    @pytest.mark.parametrize("kw", ACCEPTED)
    def test_accepted_as_the_reference(self, kw):
        _same_config(TunedConfig(**kw), jtune.TunedConfig(**_ref_kwargs(kw)))

    @pytest.mark.parametrize("kw", REJECTED)
    def test_rejected_as_the_reference(self, kw):
        with pytest.raises(ValueError):
            TunedConfig(**kw)
        with pytest.raises(ValueError):
            jtune.TunedConfig(**_ref_kwargs(kw))

    @pytest.mark.parametrize("backend", ["jax", "pallas"])
    def test_reference_backend_names_rejected(self, backend):
        with pytest.raises(ValueError, match="the port's are"):
            TunedConfig(c=8, t=8, backend=backend)

    def test_level_split_expansion(self):
        kw = dict(c=8, t=8, backend="fused", planner="fused",
                  long_cutoff=512, scan_chunks=1)
        split = TunedConfig(**kw).level_split()
        assert split == LevelSplit(scan_chunks=1, sparse_top=True,
                                   long_cutoff=512, fused=True)
        assert dataclasses.asdict(split) == dataclasses.asdict(
            jtune.TunedConfig(**kw).level_split())

    def test_level_split_validation(self):
        with pytest.raises(ValueError):
            LevelSplit(scan_chunks=3)
        with pytest.raises(ValueError):
            LevelSplit(long_cutoff=-5)


LADDER_DOC = (
    _entry(nb=12, mix="short", c=32, backend="cuda"),
    _entry(nb=12, mix="mixed", c=64),
    _entry(nb=14, mix="mixed", c=128, backend="fused", planner="fused"),
    _entry(nb=18, mix="short", c=8),
    _entry(nb=18, mix="long", c=256, long_cutoff=900),
    _entry(platform="cuda:NVIDIA H100 80GB HBM3", nb=16, c=512),
)
LADDER_QUERIES = [
    ("cpu", 8000, "short"),      # exact
    ("cpu", 8191, "short"),      # exact, same bucket
    ("cpu", 8000, "long"),       # same bucket, falls back to mixed
    ("cpu", 8000, "mixed"),
    ("cpu", 2**16, "mixed"),     # nearest bucket: 14 over 18
    ("cpu", 2**16, "short"),     # nearest bucket, mixed at 14 (distance)
    ("cpu", 2**17, "short"),     # equal distance: the exact mix wins
    ("cpu", 2**20, "long"),      # nearest: the long entry at 18
    ("cpu", 2**20, "mid"),       # no mid anywhere: mixed at 14
    ("cpu", 3, "mixed"),
    ("cuda:NVIDIA H100 80GB HBM3", 2**16, "short"),
    ("cuda:NVIDIA H100 80GB HBM3", 2**30, "mixed"),
    ("cuda:another card", 2**16, "mixed"),   # platforms never cross
    ("tpu", 8000, "mixed"),
]


class TestCacheResolution:
    @pytest.mark.parametrize("platform,n,mix", LADDER_QUERIES)
    def test_lookup_as_the_reference(self, platform, n, mix):
        cache, jcache = _pair(*LADDER_DOC)
        _same_config(cache.lookup(platform, n, mix),
                     jcache.lookup(platform, n, mix))

    def test_exact_hit(self):
        cache = TuningCache()
        cfg = TunedConfig(c=32, t=8)
        cache.put("cpu", 8000, "short", cfg)       # bucket 12
        assert cache.lookup("cpu", 8191, "short") is cfg
        assert n_bucket(8000) == n_bucket(8191) == 12
        assert n_bucket(8000) == jtune.n_bucket(8000)

    def test_span_mix_falls_back_to_mixed(self):
        cache = TuningCache()
        mixed = TunedConfig(c=32, t=8)
        cache.put("cpu", 8000, "mixed", mixed)
        assert cache.lookup("cpu", 8000, "long") is mixed

    def test_nearest_bucket_fallback_prefers_requested_mix(self):
        cache = TuningCache()
        near_mixed = TunedConfig(c=64, t=8)
        far_short = TunedConfig(c=8, t=8)
        cache.put("cpu", 2**14, "mixed", near_mixed)
        cache.put("cpu", 2**18, "short", far_short)
        assert cache.lookup("cpu", 2**16, "mixed") is near_mixed
        cache.put("cpu", 2**14, "short", far_short)
        assert cache.lookup("cpu", 2**16, "short") is far_short

    def test_platform_never_crosses(self):
        cache = TuningCache()
        cache.put("cuda:NVIDIA H100 80GB HBM3", 8000, "mixed",
                  TunedConfig(c=32, t=8))
        assert cache.lookup("cpu", 8000, "mixed") is None

    def test_empty_cache_misses(self):
        assert TuningCache().lookup("cpu", 10_000) is None

    def test_put_rejects_unknown_mix(self):
        with pytest.raises(ValueError):
            TuningCache().put("cpu", 100, "huge", TunedConfig(c=8, t=8))

    def test_platform_keys_on_the_device(self, monkeypatch):
        assert current_platform("cpu") == "cpu"
        assert current_platform(torch.device("cpu")) == "cpu"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            current_platform()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            current_platform("cuda")


BAD_DOCS = [
    (lambda: {"schema_version": 99, "entries": []}, "schema_version"),
    (lambda: [], "JSON object"),
    (lambda: {"schema_version": SCHEMA_VERSION, "entries": {}},
     "'entries' must be a list"),
    (lambda: _doc("nope"), "must be an object"),
    (lambda: _doc({k: v for k, v in _entry().items() if k != "backend"}),
     "backend"),
    (lambda: _doc(_entry(c="128")), "'c' must be int"),
    (lambda: _doc(_entry(t=True)), "'t' must be int"),   # bools are ints
    (lambda: _doc(_entry(mix="huge")), "span_mix"),
    (lambda: _doc(_entry(c=12)), "power of two"),
    (lambda: _doc(_entry(scan_chunks=3)), "scan_chunks"),
]


class TestCacheSchema:
    def test_round_trip(self, tmp_path):
        cache = TuningCache()
        cache.put("cpu", 2**13, "mixed",
                  TunedConfig(c=32, t=8, backend="fused", planner="fused",
                              long_cutoff=900, ns_per_query=55.5,
                              bulk_crossover=4096, packed_pos=True))
        path = str(tmp_path / "cache.json")
        cache.save(path)
        assert not os.path.exists(path + ".tmp")
        loaded = TuningCache.load(path)
        assert len(loaded) == 1 and loaded.source == path
        cfg = loaded.lookup("cpu", 2**13, "mixed")
        assert cfg == cache.lookup("cpu", 2**13, "mixed")
        with open(path) as f:
            doc = json.load(f)
        assert doc["schema_version"] == SCHEMA_VERSION
        # the reference reads the same document (names translated)
        _same_config(cfg, jtune.TuningCache.from_json(_ref_doc(doc))
                     .lookup("cpu", 2**13, "mixed"))
        assert _ref_doc(doc) == jtune.TuningCache.from_json(
            _ref_doc(doc)).as_json()

    def test_version_1_reads_with_classic_layouts(self):
        doc = _doc(_entry(), version=1)
        cfg = TuningCache.from_json(doc).lookup("cpu", 2**13)
        assert (cfg.packed_pos, cfg.summary_dtype) == (False, "float32")
        _same_config(cfg, jtune.TuningCache.from_json(_ref_doc(doc))
                     .lookup("cpu", 2**13))

    @pytest.mark.parametrize("make,match", BAD_DOCS)
    def test_rejected_as_the_reference(self, make, match):
        with pytest.raises(TuningCacheError, match=match):
            TuningCache.from_json(make())
        with pytest.raises(jtune.TuningCacheError, match=match):
            jtune.TuningCache.from_json(_ref_doc(make()) if isinstance(
                make(), dict) and isinstance(make().get("entries"), list)
                else make())

    @pytest.mark.parametrize("backend", ["jax", "pallas"])
    def test_reference_document_refused(self, backend):
        doc = _doc(_entry(backend=backend))
        jtune.TuningCache.from_json(doc)    # the reference's own names
        with pytest.raises(TuningCacheError, match="unknown backend"):
            TuningCache.from_json(doc)

    def test_not_json_rejected(self, tmp_path):
        path = tmp_path / "bad.json"
        path.write_text("{nope")
        with pytest.raises(TuningCacheError, match="not valid JSON"):
            TuningCache.load(str(path))
        with pytest.raises(jtune.TuningCacheError, match="not valid JSON"):
            jtune.TuningCache.load(str(path))

    def test_default_cache_path_and_variable(self, tmp_path, monkeypatch):
        from repro_torch.tune import cache as tc

        assert DEFAULT_CACHE_PATH == str(
            ROOT / "results" / "tuning_cache_torch.json")
        path = tmp_path / "c.json"
        TuningCache.from_json(_doc(_entry(c=64))).save(str(path))
        # the reference's variable is not the port's
        monkeypatch.setenv("REPRO_TUNING_CACHE", "")
        monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(path))
        try:
            assert tc.default_cache(refresh=True).lookup(
                "cpu", 2**13).c == 64
            monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", "")
            assert len(tc.default_cache(refresh=True)) == 0
        finally:
            monkeypatch.delenv("REPRO_TORCH_TUNING_CACHE")
            tc.default_cache(refresh=True)


class TestCommittedCache:
    def test_loads_with_card_keys_and_port_backends(self):
        cache = TuningCache.load(DEFAULT_CACHE_PATH)
        doc = cache.as_json()
        assert doc["entries"]
        for e in doc["entries"]:
            assert e["platform"].startswith("cuda:"), e
            assert e["backend"] in ("eager", "cuda", "fused"), e
        buckets = {e["n_bucket"] for e in doc["entries"]}
        assert {20, 24, 27, 30} <= buckets
        for b in (20, 24, 27, 30):
            mixes = {e["span_mix"] for e in doc["entries"]
                     if e["n_bucket"] == b}
            assert mixes == {"short", "mid", "long", "mixed"}, b


# ---------------------------------------------------------------------------
# consumption: make_plan / RMQ.build / QueryEngine
# ---------------------------------------------------------------------------
PLAN_DOC = (
    _entry(nb=15, c=32, t=8, backend="fused", planner="fused",
           long_cutoff=700),
    _entry(nb=15, mix="short", c=16, t=4, scan_chunks=1),
    _entry(nb=17, mix="mixed", c=64, t=16, packed_pos=True,
           summary_dtype="bfloat16", bulk_crossover=2048),
)
PLAN_CASES = [
    dict(n=50_000),                               # hit
    dict(n=50_000, span_mix="short"),             # exact-mix hit
    dict(n=50_000, span_mix="long"),              # mixed fallback
    dict(n=2**21),                                # nearest bucket (17)
    dict(n=2**17, packed_pos=False),              # explicit layout wins
    dict(n=2**17, summary_dtype="float32", capacity=2**18),
    dict(n=50_000, c=64, tuned=True),             # numeric c, a hit
    dict(n=50_000, platform="tpu"),               # another platform: miss
    dict(n=50_000, empty=True),                   # empty cache: miss
    dict(n=50_000, c=64, tuned=True, empty=True),  # miss keeps numeric c
]


class TestTunedPlan:
    @pytest.mark.parametrize("case", PLAN_CASES)
    def test_plan_as_the_reference(self, case):
        case = dict(case)
        cache, jcache = (_pair() if case.pop("empty", False)
                         else _pair(*PLAN_DOC))
        case.setdefault("platform", "cpu")
        if "tuned" not in case:
            case["c"] = "auto"
        n = case.pop("n")
        plan = make_plan(n, tuning=cache, **case)
        _same_plan(plan, jmake_plan(n, tuning=jcache, **case))

    def test_miss_keeps_defaults(self):
        plan = make_plan(50_000, c="auto", tuning=TuningCache(),
                         platform="cpu")
        assert (plan.c, plan.t) == (128, 64)
        assert plan.level_split is None
        assert plan == make_plan(50_000)

    def test_hit_matches_an_explicit_twin(self):
        cache, _ = _pair(*PLAN_DOC)
        plan = make_plan(50_000, c="auto", tuning=cache, platform="cpu")
        assert (plan.c, plan.t) == (32, 8)
        assert plan.level_split == LevelSplit(long_cutoff=700, fused=True)
        twin = make_plan(50_000, c=32, t=8)
        assert plan.level_lens == twin.level_lens
        assert plan.offsets == twin.offsets


BUILD_DOC = (
    _entry(nb=14, c=32, t=8, backend="fused", planner="fused"),
    _entry(nb=14, mix="long", c=16, t=16, backend="eager",
           long_cutoff=3_000),
)


class TestTunedBuild:
    @pytest.mark.parametrize("mix", ["mixed", "long", "short"])
    @pytest.mark.parametrize("with_positions", [False, True])
    def test_build_and_answers_as_the_reference(self, mix, with_positions):
        cache, jcache = _pair(*BUILD_DOC)
        rng = np.random.default_rng(7)
        n = 30_000
        x = rng.integers(-4, 4, n).astype(np.float32)   # heavy ties
        r = RMQ.build(x, c="auto", tuning=cache, span_mix=mix,
                      with_positions=with_positions, device="cpu")
        jr = JRMQ.build(x, c="auto", tuning=jcache, span_mix=mix,
                        with_positions=with_positions)
        _same_plan(r.plan, jr.plan)
        assert r.backend == FROM_REF[jr.backend]
        for name in ("base", "upper", "upper_pos"):
            got, want = (getattr(r.hierarchy, name),
                         getattr(jr.hierarchy, name))
            if want is None:
                assert got is None
            else:
                _same(got, want, name)
        ls, rs = _spans(rng, n)
        _same(r.query(ls, rs), jr.query(ls, rs), "values")
        if with_positions:
            _same(r.query_index(ls, rs), jr.query_index(ls, rs),
                  "positions")

    def test_hit_adopts_geometry_and_backend(self):
        cache, _ = _pair(*BUILD_DOC)
        x = np.random.default_rng(1).random(30_000).astype(np.float32)
        rmq = RMQ.build(x, c="auto", tuning=cache, device="cpu")
        assert (rmq.plan.c, rmq.plan.t) == (32, 8)
        assert rmq.backend == "fused"
        assert rmq.plan.level_split.fused
        # an explicit backend is not overridden by the cache
        assert RMQ.build(x, c="auto", tuning=cache, backend="eager",
                         device="cpu").backend == "eager"

    @pytest.mark.parametrize("tuning", ["empty", "other_platform"])
    def test_miss_is_bit_identical_to_the_default(self, tuning):
        cache = TuningCache() if tuning == "empty" else _pair(
            *[dict(e, platform="cuda:NVIDIA H100 80GB HBM3")
              for e in BUILD_DOC])[0]
        rng = np.random.default_rng(0)
        x = rng.integers(-4, 4, 30_000).astype(np.float32)
        default = RMQ.build(x, with_positions=True, device="cpu")
        tuned = RMQ.build(x, c="auto", with_positions=True, tuning=cache,
                          device="cpu")
        assert tuned.plan == default.plan
        assert tuned.backend == default.backend == "eager"
        for name in ("base", "upper", "upper_pos"):
            _same(getattr(tuned.hierarchy, name),
                  getattr(default.hierarchy, name), name)
        jdefault = JRMQ.build(x, with_positions=True)
        _same(tuned.hierarchy.upper, jdefault.hierarchy.upper)

    def test_auto_smoke_against_the_committed_cache(self):
        # the committed cache is keyed by the card: a CPU build misses
        x = np.random.default_rng(5).random(4_000).astype(np.float32)
        rmq = RMQ.build(x, c="auto", device="cpu")
        assert (rmq.plan.c, rmq.plan.t) == (128, 64)
        v = rmq.query(np.array([7], np.int32), np.array([3_999], np.int32))
        assert float(v[0]) == x[7:].min()


ENGINE_KEYS = ("source", "long_cutoff", "scan_chunks", "long_enabled",
               "bulk_crossover", "planner", "c", "t", "n")


def _engine_cache(n, **over):
    kw = dict(c=32, t=8, backend="fused", planner="fused")
    kw.update(over)
    return _pair(_entry(nb=n_bucket(n), **kw))


def _same_tuned(e, je):
    for key in ENGINE_KEYS:
        assert e.tuned[key] == je.tuned[key], key
    assert e.backend == FROM_REF[je.backend]
    assert e.tuned["backend"] == FROM_REF[je.tuned["backend"]]


ENGINE_CASES = {
    "fused_hit": (dict(), dict()),
    "routed_hit": (dict(backend="eager", planner="routed",
                        long_cutoff=3_000, bulk_crossover=5_000,
                        scan_chunks=1), dict()),
    "no_sparse_top": (dict(backend="eager", planner="routed",
                           sparse_top=False), dict()),
    "override": (dict(backend="eager", planner="routed",
                      long_cutoff=3_000), dict(long_cutoff=1_234)),
    "explicit_backend": (dict(), dict(backend="eager")),
    "explicit_bulk": (dict(bulk_crossover=64), dict(bulk_crossover=99)),
}


class TestEngineSelfConfig:
    @pytest.mark.parametrize("case", list(ENGINE_CASES))
    def test_resolves_as_the_reference(self, case):
        over, kw = ENGINE_CASES[case]
        n = 20_000
        cache, jcache = _engine_cache(n, **over)
        x = np.random.default_rng(2).random(n).astype(np.float32)
        rmq = RMQ.build(x, c=32, t=8, with_positions=True, device="cpu")
        jrmq = JRMQ.build(x, c=32, t=8, with_positions=True,
                          backend="jax")
        jkw = dict(kw)
        if "backend" in jkw:
            jkw["backend"] = TO_REF[jkw["backend"]]
        e = QueryEngine(rmq, cache_size=0, tuning=cache, **kw)
        je = JEngine(jrmq, cache_size=0, tuning=jcache, **jkw)
        _same_tuned(e, je)
        assert repr(e.planner) == repr(je.planner)
        ls, rs = _spans(np.random.default_rng(3), n, 300)
        _same(e.query(ls, rs), je.query(ls, rs), "values")
        _same(e.query_index(ls, rs), je.query_index(ls, rs), "positions")

    def test_adopts_tuned_backend_over_any_build(self):
        n = 20_000
        cache, _ = _engine_cache(n)
        x = np.random.default_rng(2).random(n).astype(np.float32)
        rmq = RMQ.build(x, c=32, t=8, backend="eager", device="cpu")
        engine = QueryEngine(rmq, cache_size=0, tuning=cache)
        assert engine.backend == "fused"
        assert engine.planner.fused
        assert engine.tuned["source"] == "cache"
        ls = np.array([0, 5, 100], np.int32)
        rs = np.array([n - 1, 4_000, 131], np.int32)
        np.testing.assert_array_equal(
            engine.query(ls, rs).numpy(),
            [x[l:r + 1].min() for l, r in zip(ls, rs)])

    def test_explicit_kwargs_outrank_cache(self):
        n = 20_000
        cache, _ = _engine_cache(n)
        x = np.random.default_rng(2).random(n).astype(np.float32)
        rmq = RMQ.build(x, c=32, t=8, backend="eager", device="cpu")
        engine = QueryEngine(rmq, cache_size=0, tuning=cache,
                             backend="eager")
        assert engine.backend == "eager"
        assert not engine.planner.fused

    def test_config_recorded_in_registry_and_metrics(self):
        n = 21_017
        cache, _ = _engine_cache(n)
        x = np.random.default_rng(2).random(n).astype(np.float32)
        rmq = RMQ.build(x, c=32, t=8, backend="eager", device="cpu")
        m = Metrics()
        with launch_registry() as reg, count_launches() as counts:
            engine = QueryEngine(rmq, cache_size=0, tuning=cache,
                                 metrics=m.scope("engine"))
            engine.query(np.array([0], np.int32),
                         np.array([n - 1], np.int32))
        configs = reg.as_dict()["configs"]
        assert configs and configs[0]["name"] == "engine_tuned_config"
        assert configs[0]["backend"] == "fused"
        assert configs[0]["source"] == "cache"
        # config records never reach the launch counts
        assert counts == {"rmq_fused": 1}
        prom = m.to_prometheus()
        assert 'repro_engine_tuned_config{' in prom
        assert 'backend="fused"' in prom
        assert engine.stats()["tuned"]["backend"] == "fused"

    def test_plan_level_split_configures_untuned_engine(self):
        n = 20_000
        cache, jcache = _engine_cache(n, backend="eager", planner="routed",
                                      long_cutoff=3_000)
        x = np.random.default_rng(3).random(n).astype(np.float32)
        rmq = RMQ.build(x, c="auto", tuning=cache, device="cpu")
        engine = QueryEngine(rmq, cache_size=0)
        assert engine.planner.effective_long_cutoff() == 3_000
        assert engine.tuned["source"] == "plan"
        je = JEngine(JRMQ.build(x, c="auto", tuning=jcache), cache_size=0)
        _same_tuned(engine, je)

    def test_reattach_adopts_another_tuned_backend(self):
        """A successor in another size bucket adopts that bucket's
        backend, and the executor table is rebuilt for it."""
        cache, jcache = _pair(
            _entry(nb=11, c=32, t=8, backend="fused", planner="fused"),
            _entry(nb=13, c=32, t=8, backend="eager"))
        rng = np.random.default_rng(4)
        x = rng.random(3_000).astype(np.float32)
        tail = rng.random(6_000).astype(np.float32)
        r = RMQ.build(x, c=32, t=8, capacity=10_000, with_positions=True,
                      device="cpu")
        jr = JRMQ.build(x, c=32, t=8, capacity=10_000,
                        with_positions=True, backend="jax")
        e = QueryEngine(r, cache_size=0, tuning=cache)
        je = JEngine(jr, cache_size=0, tuning=jcache)
        assert e.backend == "fused" and "fused" in e.executors
        r, jr = r.append(tail), jr.append(tail)
        e.attach(r)
        je.attach(jr)
        assert e.backend == "eager" and "fused" not in e.executors
        _same_tuned(e, je)
        ls, rs = _spans(rng, r.n)
        _same(e.query_index(ls, rs), je.query_index(ls, rs))


class TestMissFallbackDifferential:
    @pytest.mark.parametrize("kind", ("rmq", "streaming", "hybrid"))
    def test_empty_cache_engine_matches_numpy_oracle(self, kind):
        # the reference's fourth kind, the distributed index, is A10
        rng = np.random.default_rng(len(kind))
        n, c, t = 6_000, 16, 8
        x = rng.integers(-4, 4, n).astype(np.float32)  # heavy ties
        if kind == "rmq":
            idx = RMQ.build(x, c=c, t=t, with_positions=True, device="cpu")
            jidx = JRMQ.build(x, c=c, t=t, with_positions=True)
        elif kind == "streaming":
            idx = StreamingRMQ.from_array(x, c=c, t=t, with_positions=True,
                                          device="cpu")
            jidx = JStreaming.from_array(x, c=c, t=t, with_positions=True)
        else:
            idx = HybridRMQ.build(x, c=c, t=t, with_positions=True,
                                  device="cpu")
            jidx = None
        tuned_engine = QueryEngine(idx, cache_size=0, tuning=TuningCache())
        plain_engine = QueryEngine(idx, cache_size=0)
        assert tuned_engine.backend == plain_engine.backend
        assert tuned_engine.tuned == plain_engine.tuned
        assert tuned_engine.tuned["source"] == "default"
        ls, rs = _spans(rng, n, 300)
        expect_v = np.array(
            [x[l:r + 1].min() for l, r in zip(ls, rs)], np.float32)
        expect_i = np.array(
            [l + int(np.argmin(x[l:r + 1])) for l, r in zip(ls, rs)],
            np.int32)
        _same(tuned_engine.query(ls, rs), expect_v)
        _same(tuned_engine.query_index(ls, rs), expect_i)
        _same(tuned_engine.query(ls, rs), plain_engine.query(ls, rs))
        if jidx is not None:
            je = JEngine(jidx, cache_size=0,
                         tuning=jtune.TuningCache())
            _same_tuned(tuned_engine, je)


# ---------------------------------------------------------------------------
# the autotuner itself (tiny, on the CPU)
# ---------------------------------------------------------------------------
class TestAutotuner:
    def test_tiny_search_produces_valid_cache(self, tmp_path):
        tuner = Autotuner(geometries=TINY_GEOMETRIES, m=128, repeats=1,
                          crossover_points=2, device="cpu")
        assert tuner.backends == ("eager", "fused")
        cache, report = tuner.search([2**11], platform="cpu")
        assert len(cache) == 4
        for mix in ("short", "mid", "long", "mixed"):
            cfg = cache.lookup("cpu", 2**11, mix)
            assert cfg is not None and cfg.ns_per_query > 0
            assert cfg.backend in ("eager", "fused")
            assert (cfg.planner == "fused") == (cfg.backend == "fused")
            assert cfg.long_cutoff is None or cfg.backend != "fused"
        assert len(report["measurements"]) == 3 * 2 * 4
        assert all(m["ns_per_query"] > 0 for m in report["measurements"])
        path = str(tmp_path / "cache.json")
        cache.save(path)
        assert len(TuningCache.load(path)) == 4
        # the platform defaults to the device's key
        assert Autotuner(device="cpu").search([])[1]["platform"] == "cpu"

    def test_skipped_configs_as_the_reference(self):
        kw = dict(geometries=((8, 8), (32, 8)), m=64, repeats=1,
                  crossover_points=2, span_mixes=("mixed",))
        _, report = Autotuner(backends=("eager",), device="cpu",
                              **kw).search([256], platform="cpu")
        _, jreport = jtune.Autotuner(backends=("jax",), **kw).search(
            [256], platform="cpu")
        assert report["skipped"] == jreport["skipped"]
        assert len(report["skipped"]) == 1
        skip = report["skipped"][0]
        assert (skip["c"], skip["t"]) == (32, 8)
        assert "c*t" in skip["reason"]

    @pytest.mark.parametrize("n", [300, 513, 2**11, 2**18, 2**30])
    def test_reference_c_as_the_reference(self, n):
        assert Autotuner(device="cpu").reference_c(n) == \
            jtune.Autotuner().reference_c(n)
        assert Autotuner(device="cpu").reference_c(2**18) == 128

    def test_default_grids_are_the_reference(self):
        assert DEFAULT_GEOMETRIES == jtune.DEFAULT_GEOMETRIES
        assert TINY_GEOMETRIES == jtune.TINY_GEOMETRIES

    @pytest.mark.parametrize("kind", ["short", "mid", "long", "mixed"])
    @pytest.mark.parametrize("n,m,c,seed", [(2**11, 128, 128, 1),
                                            (2**20, 4096, 128, 4),
                                            (5_000, 333, 32, 7)])
    def test_workloads_have_the_reference_bits(self, kind, n, m, c, seed):
        for got, want in zip(
                measure.make_span_queries(n, m, c, kind, seed=seed),
                jtune.make_span_queries(n, m, c, kind, seed=seed)):
            _same(got, want)
        _same(measure.make_input_array(n, seed), jtune.make_input_array(
            n, seed))

    def test_time_fn_median_and_calls(self):
        calls = []

        def fn():
            calls.append(1)
            return torch.ones(4), (torch.zeros(2), {"a": torch.ones(1)})

        secs = time_fn(fn, repeats=4)
        assert secs > 0
        assert len(calls) == 5   # one untimed warm-up, then the repeats

    def test_cli_tiny_on_the_cpu(self, tmp_path):
        out = tmp_path / "cache.json"
        report = tmp_path / "report.json"
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.tune", "--tiny",
             "--device", "cpu", "--out", str(out), "--report",
             str(report)],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        assert res.returncode == 0, res.stdout + res.stderr
        cache = TuningCache.load(str(out))
        assert len(cache) == 4
        assert cache.lookup("cpu", 2**13) is not None
        assert json.loads(report.read_text())["platform"] == "cpu"
