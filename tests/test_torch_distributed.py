"""The port's segment-sharded index against the JAX package's, on the CPU.

``repro_torch.core.DistributedRMQ``, the ``DistributedExecutor`` and the
engine's segment routing, held to ``repro.core.distributed`` on a (1, 1)
mesh in this process and on a (2, 4) ``("data", "model")`` mesh: four
segments, which the port simulates in this process and the reference
runs once for the whole module in one subprocess with 8 fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_distributed_rmq.py`` does, so the flag never reaches this
process).  Inputs come from seeds here and go to the subprocess in an
``.npz``; its answers come back the same way.  The geometries have two
levels (c = 16, t = 8 or 16): the reference's first compile of a deeper
distributed walk is slow on CPU XLA.

Positions are compared exactly; values as integer views, except that
-0.0 equals +0.0 where the reference's ``pmin`` may pick either sign.
No NaN goes to the reference.  Against the port's own single-device
``RMQ`` (zero-heavy and NaN input) everything is an integer view.  A
world of 2 on gloo (two processes, a ``FileStore``) answers bit for bit
as the one-process simulation, its collectives counted.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import bf16_input, nan_input, zero_heavy
from repro.core.distributed import DistributedRMQ as JDistributedRMQ
from repro.qe import QueryService as JQueryService
from repro_torch.core import RMQ, DistributedRMQ
from repro_torch.core import distributed as dist_mod
from repro_torch.kernels.profiling import count_launches
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.qe import CROSSING, SEG_LOCAL, QueryEngine, QueryService

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ("eager", "fused", "cuda")


def _mesh(shape=(2, 4)):
    return make_test_mesh(shape, device="cpu")


def _spans(rng, n, m):
    ls = rng.integers(0, n, m)
    rs = np.minimum(ls + rng.integers(0, n, m), n - 1)
    return (np.minimum(ls, rs).astype(np.int32),
            np.maximum(ls, rs).astype(np.int32))


def _bits(a: np.ndarray) -> np.ndarray:
    """The integer view of a float array (bf16 arrives as uint16 bits)."""
    if a.dtype == np.uint16:
        return a.view(np.int16)
    return a.view({4: np.int32, 8: np.int64}[a.dtype.itemsize])


def _host_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return _bits(t.numpy())


def _unsigned_zero(b: np.ndarray) -> np.ndarray:
    """Integer views with both zeros as +0.0."""
    return np.where((b & np.iinfo(b.dtype).max) == 0, 0, b)


def _same_values(got: torch.Tensor, want: np.ndarray, what=""):
    """Values equal as integer views, -0.0 taken for +0.0."""
    g, w = _unsigned_zero(_host_bits(got)), _unsigned_zero(_bits(want))
    assert g.dtype == w.dtype and np.array_equal(g, w), what


def _same_bits(got: torch.Tensor, want: torch.Tensor, what=""):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert np.array_equal(_host_bits(got), _host_bits(want)), what


def _same_positions(got: torch.Tensor, want, what=""):
    assert np.array_equal(np.asarray(got).astype(np.int64),
                          np.asarray(want).astype(np.int64)), what


def _brute(x, ls, rs):
    return (np.array([x[l:r + 1].min() for l, r in zip(ls, rs)], x.dtype),
            np.array([l + np.argmin(x[l:r + 1]) for l, r in zip(ls, rs)]))


# ---------------------------------------------------------------------------
# the (2, 4) reference, once a module, in one subprocess
# ---------------------------------------------------------------------------
_REF_PROG = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.core.distributed import DistributedRMQ

inp = np.load(sys.argv[1])
cases = json.loads(open(sys.argv[2]).read())
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}

def host(a):
    if a.dtype == jnp.bfloat16:
        a = jax.lax.bitcast_convert_type(a, jnp.uint16)
    return np.asarray(a)

def run(name, case):
    x = inp[name + "/x"]
    if case.get("bf16"):
        x = jax.lax.bitcast_convert_type(jnp.asarray(x), jnp.bfloat16)
    d = DistributedRMQ.build(x, mesh, **case["kw"])
    for i, op in enumerate(case.get("steps", [])):
        if op == "update":
            d = d.update(inp[f"{name}/i{i}"], inp[f"{name}/u{i}"])
        else:
            d = d.append(inp[f"{name}/a{i}"])
    ls, rs = inp[name + "/ls"], inp[name + "/rs"]
    out[name + "/v"] = host(d.query(ls, rs))
    if d.with_positions:
        out[name + "/p"] = host(d.query_index(ls, rs))
    if case.get("engine"):
        eng = d.engine(cache_size=0)
        out[name + "/ev"] = host(eng.query(ls, rs))
        out[name + "/ep"] = host(eng.query_index(ls, rs))
        cc = eng.stats()["class_counts"]
        out[name + "/cc"] = np.array([cc["seg_local"], cc["crossing"]])

for name, case in cases.items():
    if case.get("x64"):
        with jax.enable_x64(True):
            run(name, case)
    else:
        run(name, case)
np.savez(sys.argv[3], **out)
print("REFERENCE_OK")
"""

GEO = dict(c=16, t=16, with_positions=True)
MUT = dict(c=16, t=16, with_positions=True, capacity=4000)


def _ragged_x(rng):
    return rng.random(10001).astype(np.float32)


def _mutation_case(rng):
    """n = 2901 (ragged over 4 segments) with cross-segment ties; an
    update with a duplicate index, then a 300-entry append that fills
    slots 2901..3200 across the boundary at 3000."""
    n = 2901
    x = rng.random(n).astype(np.float32)
    x[rng.integers(0, n, 600)] = 0.25
    idxs = rng.integers(0, n, 64).astype(np.int32)
    idxs[5] = idxs[4]
    vals = (rng.random(64) - 0.5).astype(np.float32)
    tail = (rng.random(300) - 0.2).astype(np.float32)
    return x, idxs, vals, tail


def _interleaved_steps(rng, n):
    """Three rounds of (update 32 indices, append 40)."""
    steps, arrays, live = [], {}, n
    for r in range(3):
        arrays[f"i{2 * r}"] = rng.integers(0, live, 32).astype(np.int32)
        arrays[f"u{2 * r}"] = (rng.random(32) - 0.5).astype(np.float32)
        arrays[f"a{2 * r + 1}"] = rng.random(40).astype(np.float32)
        steps += ["update", "append"]
        live += 40
    return steps, arrays


def _reference_cases():
    """``{name: (case spec, arrays)}`` for the subprocess, from seeds."""
    cases = {}
    rng = np.random.default_rng(2)
    x = _ragged_x(rng)
    ls, rs = _spans(rng, x.shape[0], 128)
    cases["ragged"] = (dict(kw=GEO, engine=True),
                       dict(x=x, ls=ls, rs=rs))
    xz = np.zeros(8000, np.float32)
    ls, rs = _spans(np.random.default_rng(3), 8000, 96)
    ls[:2], rs[:2] = (100, 3000), (7999, 7999)
    cases["zeros"] = (dict(kw=GEO), dict(x=xz, ls=ls, rs=rs))
    rng = np.random.default_rng(5)
    x, idxs, vals, tail = _mutation_case(rng)
    ls, rs = _spans(rng, x.shape[0] + tail.shape[0], 192)
    cases["mutation"] = (dict(kw=MUT, steps=["update", "append"],
                              engine=True),
                         dict(x=x, i0=idxs, u0=vals, a1=tail, ls=ls, rs=rs))
    rng = np.random.default_rng(9)
    x = rng.random(2000).astype(np.float32)
    steps, arrays = _interleaved_steps(rng, 2000)
    ls, rs = _spans(rng, 2000 + 120, 128)
    cases["interleaved"] = (dict(kw=dict(MUT), steps=steps),
                            dict(x=x, ls=ls, rs=rs, **arrays))
    rng = np.random.default_rng(11)
    x = zero_heavy(rng, 6000)
    ls, rs = _spans(rng, 6000, 128)
    for name, extra in (("packed", dict(packed_pos=True)),
                        ("bf16sum", dict(summary_dtype="bfloat16"))):
        cases[name] = (dict(kw=dict(GEO, **extra)),
                       dict(x=x, ls=ls, rs=rs))
    xb = bf16_input("ties_across_segments", np.random.default_rng(12),
                    6000, 16)
    cases["bf16"] = (dict(kw=GEO, bf16=True),
                     dict(x=xb.view(torch.int16).numpy().view(np.uint16),
                          ls=ls, rs=rs))
    x64 = np.random.default_rng(13).random(6000)
    x64[::97] = 0.125
    cases["f64"] = (dict(kw=dict(GEO, capacity=6400), x64=True),
                    dict(x=x64, ls=ls, rs=rs))
    return cases


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``(cases, answers)``: every (2, 4) case run once by the JAX
    package in a subprocess with 8 fake CPU devices."""
    cases = _reference_cases()
    tmp = tmp_path_factory.mktemp("reference")
    arrays = {f"{name}/{k}": v for name, (_, a) in cases.items()
              for k, v in a.items()}
    np.savez(tmp / "in.npz", **arrays)
    (tmp / "cases.json").write_text(
        json.dumps({name: spec for name, (spec, _) in cases.items()}))
    res = subprocess.run(
        [sys.executable, "-c", _REF_PROG, str(tmp / "in.npz"),
         str(tmp / "cases.json"), str(tmp / "out.npz")],
        capture_output=True, text=True, cwd=ROOT, timeout=240,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    assert "REFERENCE_OK" in res.stdout, res.stdout + res.stderr
    return cases, dict(np.load(tmp / "out.npz"))


def _port(cases, name, backend="eager"):
    """The port's index of a reference case on the simulated (2, 4) mesh,
    after the case's mutations."""
    spec, a = cases[name]
    x = a["x"]
    if spec.get("bf16"):
        x = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    d = DistributedRMQ.build(x, _mesh(), backend=backend, **spec["kw"])
    for i, op in enumerate(spec.get("steps", [])):
        d = (d.update(a[f"i{i}"], a[f"u{i}"]) if op == "update"
             else d.append(a[f"a{i}"]))
    return d, a["ls"], a["rs"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["ragged", "zeros", "mutation",
                                  "interleaved", "packed", "bf16sum",
                                  "bf16", "f64"])
def test_2x4_answers_match_the_reference(reference, name, backend):
    cases, want = reference
    d, ls, rs = _port(cases, name, backend)
    assert d.num_segments == 4 and len(d.segments) == 4
    _same_values(d.query(ls, rs), want[name + "/v"], name)
    _same_positions(d.query_index(ls, rs), want[name + "/p"], name)


@pytest.mark.parametrize("name", ["ragged", "mutation"])
def test_2x4_engine_classes_match_the_reference(reference, name):
    cases, want = reference
    d, ls, rs = _port(cases, name, "fused")
    eng = d.engine(cache_size=0)
    _same_values(eng.query(ls, rs), want[name + "/ev"], name)
    _same_positions(eng.query_index(ls, rs), want[name + "/ep"], name)
    cc = eng.stats()["class_counts"]
    assert [cc[SEG_LOCAL], cc[CROSSING]] == want[name + "/cc"].tolist()
    assert cc[SEG_LOCAL] > 0 and cc[CROSSING] > 0
    assert eng.planner is None and eng.tuned is None
    assert not eng.supports_mixed


def test_2x4_mutation_against_a_fresh_build():
    rng = np.random.default_rng(5)
    x, idxs, vals, tail = _mutation_case(rng)
    mesh = _mesh()
    for backend in BACKENDS:
        d = DistributedRMQ.build(x, mesh, backend=backend, **MUT)
        assert d.num_segments == 4 and d.segment_capacity == 1000
        d2 = d.update(idxs, vals).append(tail)
        assert d2.generation == 2 and d2.n == x.shape[0] + 300
        x2 = x.copy()
        for i, v in zip(idxs, vals):  # in order: the last write wins
            x2[i] = v
        x2 = np.concatenate([x2, tail])
        ref = DistributedRMQ.build(x2, mesh, backend=backend, **MUT)
        for got, fresh in zip(d2.segments, ref.segments):
            for g, f in ((got.base, fresh.base), (got.upper, fresh.upper),
                         (got.upper_pos, fresh.upper_pos)):
                _same_bits(g, f, backend)
        # the predecessor answers for its own data
        ls, rs = _spans(rng, x.shape[0], 64)
        wv, wp = _brute(x, ls, rs)
        _same_values(d.query(ls, rs), wv)
        _same_positions(d.query_index(ls, rs), wp)


def test_2x4_launches_and_combines():
    x = np.random.default_rng(4).random(9000).astype(np.float32)
    mesh = _mesh()
    ls, rs = _spans(np.random.default_rng(5), 9000, 64)
    dist_mod.COMBINES.reset()
    dist_mod.COLLECTIVES.reset()
    with count_launches() as counts:
        d = DistributedRMQ.build(x, mesh, backend="fused", **GEO)
    assert counts == {"hierarchy_fused": 1}
    with count_launches() as counts:
        d.query(ls, rs)
        d.query_index(ls, rs)
    assert counts == {"rmq_fused": 8}
    assert dist_mod.COMBINES.launches == 2
    gl = np.zeros((4, 16), np.int32)
    with count_launches() as counts:
        d._query_grouped(gl, gl, track_pos=True)
    assert counts == {"rmq_fused": 4} and dist_mod.COMBINES.launches == 2
    with count_launches() as counts:
        dc = DistributedRMQ.build(x, mesh, backend="cuda", **GEO)
        dc.query_index(ls, rs)
        dc.update(np.array([1, 5000]), np.array([-1.0, -2.0], np.float32))
    levels = dc.plan.num_levels
    assert counts == {"hierarchy_build": 4 * (levels - 1), "rmq_scan": 8,
                      "hierarchy_update": 4 * (levels - 1)}
    assert dist_mod.COLLECTIVES.launches == 0  # no group, no collective


def test_port_matches_its_single_device_rmq_bit_for_bit():
    """Zero-heavy and NaN input, integer views everywhere: the keyed
    combine gives the leftmost minimal entry's own bits."""
    rng = np.random.default_rng(21)
    n, c = 5000, 16
    for x in (zero_heavy(rng, n), nan_input(rng, n, c),
              zero_heavy(rng, n, np.float64)):
        one = RMQ.build(x, c=c, t=8, with_positions=True, device="cpu")
        ls, rs = _spans(rng, n, 256)
        ls[:3] = (1249, 1250, 0)   # spans across the boundary at 1250
        rs[:3] = (1250, 3750, n - 1)
        want_v, want_p = one.query(ls, rs), one.query_index(ls, rs)
        for backend in BACKENDS:
            d = DistributedRMQ.build(x, _mesh(), c=c, t=8,
                                     with_positions=True, backend=backend)
            _same_bits(d.query(ls, rs), want_v, backend)
            _same_bits(d.query_index(ls, rs), want_p, backend)
            eng = d.engine(cache_size=0)
            _same_bits(eng.query(ls, rs), want_v, backend)
            _same_bits(eng.query_bulk(ls, rs, "index"), want_p, backend)


def test_combine_keys_order_as_the_port():
    v = torch.tensor([float("nan"), -float("inf"), -1.0, -0.0, 0.0, 2.0**-133,
                      1.0, float("inf")])
    k = dist_mod.order_key(v)
    assert k[0] < k[1] < k[2] < k[3] and k[3] == k[4]
    assert k[4] < k[5] < k[6] < k[7] < torch.iinfo(torch.int64).max
    for dtype in (torch.float64, torch.bfloat16):
        assert torch.equal(dist_mod.order_key(v.to(dtype)), k)


def test_planted_boundary_ties():
    """Equal minima on both sides of a boundary, -0.0 left of +0.0, a
    NaN on each side: the leftmost wins, with its own bits."""
    x = np.ones(4000, np.float32)
    mesh = _mesh()
    x[999], x[1000] = 0.5, 0.5
    x[1999], x[2000] = -0.0, 0.0
    x[2999], x[3000] = np.float32("nan"), -np.float32("nan")
    ls = np.array([990, 1990, 2990, 0], np.int32)
    rs = np.array([1010, 2010, 3010, 3999], np.int32)
    one = RMQ.build(x, c=16, t=8, with_positions=True, device="cpu")
    for backend in BACKENDS:
        d = DistributedRMQ.build(x, mesh, c=16, t=8, with_positions=True,
                                 backend=backend)
        pos = d.query_index(ls, rs)
        assert pos.tolist() == [999, 1999, 2999, 2999]
        _same_bits(d.query(ls, rs), one.query(ls, rs))
        assert np.signbit(d.query(ls[1:2], rs[1:2]).numpy()).all()


# ---------------------------------------------------------------------------
# the (1, 1) mesh against the reference in this process
# ---------------------------------------------------------------------------
N, CAP = 800, 1000
GEOM_1 = dict(c=16, t=4, with_positions=True)


@pytest.fixture(scope="module")
def one_by_one():
    rng = np.random.default_rng(7)
    x = rng.random(N).astype(np.float32)
    x[rng.integers(0, N, N // 4)] = 0.25  # plant ties
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    return (x, DistributedRMQ.build(x, _mesh((1, 1)), capacity=CAP,
                                    **GEOM_1),
            JDistributedRMQ.build(x, jmesh, capacity=CAP, **GEOM_1))


def _both(d, jd, ls, rs):
    _same_values(d.query(ls, rs), np.asarray(jd.query(ls, rs)))
    _same_positions(d.query_index(ls, rs), np.asarray(jd.query_index(ls, rs)))


def test_1x1_matches_the_reference_and_naive():
    rng = np.random.default_rng(1)
    n = 4096
    x = rng.random(n).astype(np.float32)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jd = JDistributedRMQ.build(x, jmesh, c=16, t=8, with_positions=True)
    d = DistributedRMQ.build(x, _mesh((1, 1)), c=16, t=8,
                             with_positions=True, backend="fused")
    ls, rs = _spans(rng, n, 64)
    _both(d, jd, ls, rs)
    wv, wp = _brute(x, ls, rs)
    _same_values(d.query(ls, rs), wv)
    _same_positions(d.query_index(ls, rs), wp)


def test_1x1_mutations_match_the_reference(one_by_one):
    x, d, jd = one_by_one
    rng = np.random.default_rng(8)
    for _ in range(3):
        idxs = rng.integers(0, d.n, 32).astype(np.int32)
        idxs[3] = idxs[2]
        vals = (rng.random(32) - 0.5).astype(np.float32)
        tail = rng.random(40).astype(np.float32)
        d, jd = d.update(idxs, vals).append(tail), jd.update(
            idxs, vals).append(tail)
        assert d.generation == jd.generation and d.n == jd.n
        _both(d, jd, *_spans(rng, d.n, 128))


def test_1x1_layout_refusals_and_noops(one_by_one):
    _, d, _ = one_by_one
    assert d.capacity == d.segment_capacity * d.num_segments >= CAP
    assert d.length == N and d.distributed and d.plan.capacity == CAP
    assert d.memory_bytes_per_device() == d.segments[0].memory_bytes()
    with pytest.raises(ValueError, match="overflows capacity"):
        d.append(np.zeros(CAP - N + 1, np.float32))
    assert d.update(np.zeros(0, np.int32), np.zeros(0, np.float32)) is d
    assert d.append(np.zeros(0, np.float32)) is d
    assert d.query(np.zeros(0, np.int32), np.zeros(0, np.int32)).shape == (0,)
    with pytest.raises(ValueError, match="capacity"):
        DistributedRMQ.build(np.zeros(8, np.float32), _mesh((1, 1)),
                             capacity=4)
    with pytest.raises(ValueError, match="query axis"):
        DistributedRMQ.build(np.zeros(8, np.float32), _mesh((1, 1)),
                             query_axes=("pod",))
    # a kernel backend refuses a segment past int32 before allocating it
    for backend in ("fused", "cuda"):
        with pytest.raises(ValueError, match="int32 index space"):
            DistributedRMQ.build(np.zeros(8, np.float32), _mesh((1, 1)),
                                 c=16, t=4, capacity=2**31, backend=backend)
    v = DistributedRMQ.build(np.random.default_rng(0).random(300)
                             .astype(np.float32), _mesh((1, 1)), c=16, t=4)
    with pytest.raises(ValueError, match="without positions"):
        v.query_index(np.array([0]), np.array([10]))
    with pytest.raises(ValueError, match="without positions"):
        v.engine().query_index(np.array([0]), np.array([10]))


def test_1x1_engine_parity_and_stale_cache(one_by_one):
    x, d, jd = one_by_one
    rng = np.random.default_rng(3)
    engine = d.engine()
    ls, rs = _spans(rng, N, 160)
    ls[10:30], rs[10:30] = ls[0], rs[0]  # dedup scatter-back
    _same_bits(engine.query(ls, rs), d.query(ls, rs))
    _same_bits(engine.query_index(ls, rs), d.query_index(ls, rs))
    counts = engine.stats()["class_counts"]
    assert counts[SEG_LOCAL] > 0 and counts[CROSSING] == 0
    assert "distributed" in engine.stats()["executors"]
    l, r = 100, 700
    assert float(engine.query([l], [r])[0]) == x[l:r + 1].min()
    hits = engine.cache.hits
    engine.query([l], [r])
    assert engine.cache.hits == hits + 1
    d2 = d.update(np.array([300]), np.array([-5.0], np.float32))
    engine.attach(d2)
    assert float(engine.query([l], [r])[0]) == -5.0
    assert int(engine.query_index([l], [r])[0]) == 300
    v0 = float(engine.query([0], [N - 1])[0])
    d3 = d2.append(np.array([-7.0], np.float32))
    engine.attach(d3)
    assert float(engine.query([0], [N - 1])[0]) == v0
    assert float(engine.query([0], [N])[0]) == -7.0
    assert int(engine.query_index([0], [N])[0]) == N


def test_service_register_attach_surface(one_by_one):
    x, d, jd = one_by_one
    svc, jsvc = QueryService(), JQueryService()
    svc.register("dist", d)
    jsvc.register("dist", jd)
    assert float(svc.query("dist", [0], [N - 1])[0]) == x.min()
    hi = int(np.argmax(x))
    d2 = d.update(np.array([hi]), np.array([-2.0], np.float32))
    jd2 = jd.update(np.array([hi]), np.array([-2.0], np.float32))
    svc.attach("dist", d2)
    jsvc.attach("dist", jd2)
    assert float(svc.query("dist", [0], [N - 1])[0]) == -2.0
    t, jt = (s.submit("dist", np.array([3]), np.array([40]), op="index")
             for s in (svc, jsvc))
    svc.flush()
    jsvc.flush()
    assert int(svc.take(t)[0]) == int(np.asarray(jsvc.take(jt))[0])


def test_engine_refuses_a_global_capacity_past_int32():
    """The engine refuses a distributed index whose global capacity
    passes int32, as the reference's does (the index is not limited)."""
    d = DistributedRMQ.build(np.zeros(64, np.float32), _mesh((1, 1)),
                             c=16, t=4)
    wide = dataclasses.replace(d, mesh=_mesh((1, 2**26)))
    assert wide.capacity == 2**32
    with pytest.raises(ValueError, match="int32 index space"):
        QueryEngine(wide)


# ---------------------------------------------------------------------------
# two ranks on gloo against the one-process simulation
# ---------------------------------------------------------------------------
_RANK_PROG = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.core import DistributedRMQ
from repro_torch.core import distributed as D
from repro_torch.launch.mesh import make_test_mesh

rank, store_path, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                        rank=rank, world_size=2)
mesh = make_test_mesh((2, 4), device="cpu", group=dist.group.WORLD)
inp = np.load(sys.argv[4])
res, coll = {}, []
for name in ("f32", "bf16"):
    x = inp[name + "/x"]
    if name == "bf16":
        x = torch.from_numpy(x).view(torch.bfloat16)
    d = DistributedRMQ.build(x, mesh, c=16, t=8, with_positions=True,
                             capacity=12000, backend="fused")
    assert len(d.segments) == 2
    ls, rs = inp["ls"], inp["rs"]
    for step in ("built", "mutated"):
        if step == "mutated":
            d = d.update(inp["idx"], inp["val"]).append(inp["tail"])
            coll.append(D.COLLECTIVES.launches)
        res[f"{name}/{step}/v"] = d.query(ls, rs).view(torch.int16 if
            name == "bf16" else torch.int32).numpy()
        res[f"{name}/{step}/p"] = d.query_index(ls, rs).numpy()
        coll.append(D.COLLECTIVES.launches)
    eng = d.engine(cache_size=0)
    res[name + "/ep"] = eng.query_index(ls, rs).numpy()
    gv, gp = d._query_grouped(inp["gl"], inp["gl"], True)
    res[name + "/gp"] = gp.numpy()
np.savez(out, coll=np.array(coll), **res)
dist.destroy_process_group()
"""


def test_two_ranks_on_gloo_match_the_simulation(tmp_path):
    rng = np.random.default_rng(31)
    n = 10001
    x = zero_heavy(rng, n)
    xb = bf16_input("nan", rng, n, 16)
    ls, rs = _spans(rng, n, 96)
    ls[:2], rs[:2] = (2999, 5990), (3000, 9000)
    inp = dict(ls=ls, rs=rs, idx=np.array([5, 9000, 5]),
               val=np.array([-1.0, -2.0, -3.0], np.float32),
               tail=np.full(1500, -0.0, np.float32),
               gl=np.tile(np.arange(16, dtype=np.int32), (4, 1)))
    inp["f32/x"] = x
    inp["bf16/x"] = xb.view(torch.int16).numpy()
    np.savez(tmp_path / "in.npz", **inp)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_PROG, str(r), str(tmp_path / "store"),
         str(tmp_path / f"out{r}.npz"), str(tmp_path / "in.npz")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    ranks = [np.load(tmp_path / f"out{r}.npz") for r in (0, 1)]
    # three all_reduce calls a monolithic batch (query, query_index),
    # none for a mutation
    assert ranks[0]["coll"].tolist()[:3] == [6, 6, 12]
    for name, xs in (("f32", x), ("bf16", xb)):
        d = DistributedRMQ.build(torch.as_tensor(xs), _mesh(), c=16, t=8,
                                 with_positions=True, capacity=12000,
                                 backend="fused")
        want = {}
        for step in ("built", "mutated"):
            if step == "mutated":
                d = d.update(inp["idx"], inp["val"]).append(inp["tail"])
            want[f"{name}/{step}/v"] = _host_bits(d.query(ls, rs))
            want[f"{name}/{step}/p"] = d.query_index(ls, rs).numpy()
        want[name + "/ep"] = d.query_index(ls, rs).numpy()
        want[name + "/gp"] = d._query_grouped(inp["gl"], inp["gl"],
                                              True)[1].numpy()
        for key, w in want.items():
            for r in ranks:
                assert np.array_equal(r[key], w), key
