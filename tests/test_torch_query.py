"""The port's query answers against the reference's, bit for bit.

Values and leftmost positions (tolerance 0) from the plain walk and from
each query kernel module's CPU path, against the reference's fused batch
and its per-plane scan (both in interpret mode) and its core walk.  The
spans cover the paper's four range-size classes, the short / mid / long
engine classes, the ``capacity > n`` tail and ``l == r``; one case
queries a hierarchy that the JAX package built, carried over as numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import GEOMETRIES, brute_force, query_batch, tied_input
from repro.core.hierarchy import build_hierarchy as jbuild
from repro.core.plan import make_plan as jmake_plan
from repro.core.query import rmq_index_batch as jindex
from repro.core.query import rmq_value_batch as jvalue
from repro.kernels.rmq_fused.ops import rmq_fused_batch as jfused_batch
from repro.kernels.rmq_scan.ops import (
    rmq_index_batch_pallas,
    rmq_value_batch_pallas,
)
from repro_torch.core.hierarchy import build_hierarchy
from repro_torch.core.interop import hierarchy_from_reference
from repro_torch.core.plan import make_plan
from repro_torch.core.query import rmq_walk_batch
from repro_torch.kernels.profiling import count_launches
from repro_torch.kernels.rmq_fused import ops as fused_ops
from repro_torch.kernels.rmq_scan import ops as scan_ops
from repro_torch.tune.measure import make_queries, make_span_queries


def _workload(n, c, seed):
    """Every span class at once, inclusive int32 bounds."""
    rng = np.random.default_rng(seed)
    ls, rs = [], []
    for kind in ("large", "medium", "small", "mixed"):
        l, r = make_queries(n, 16, kind, seed=seed)
        ls.append(l)
        rs.append(r)
    kinds = ("short", "mid", "long") if n > 4 * c + 1 else ("short", "long")
    for kind in kinds:
        l, r = make_span_queries(n, 16, c, kind, seed=seed)
        ls.append(l)
        rs.append(r)
    l, r = query_batch(rng, n, c, m=32)
    ls.append(l)
    rs.append(r)
    return np.concatenate(ls), np.concatenate(rs)


def _port_answers(h, ls, rs):
    """(values, positions) from every port path that answers both."""
    lt, rt = torch.from_numpy(ls), torch.from_numpy(rs)
    walk_v, walk_p = rmq_walk_batch(h, lt, rt, track_pos=True)
    fv, fp = fused_ops.rmq_fused_batch(h, lt, rt, track_pos=True)
    return {
        "walk": (walk_v, walk_p),
        "fused": (fv, fp),
        "fused_planes": (fused_ops.rmq_fused_value_batch(h, lt, rt),
                         fused_ops.rmq_fused_index_batch(h, lt, rt)),
        "scan": (scan_ops.rmq_value_batch_cuda(h, lt, rt),
                 scan_ops.rmq_index_batch_cuda(h, lt, rt)),
    }


def _reference_answers(jh, ls, rs):
    lj, rj = jnp.asarray(ls), jnp.asarray(rs)
    fv, fp = jfused_batch(jh, lj, rj, track_pos=True, interpret=True)
    return {
        "core": (jvalue(jh, lj, rj), jindex(jh, lj, rj)),
        "fused": (fv, fp),
        "scan": (rmq_value_batch_pallas(jh, lj, rj, interpret=True),
                 rmq_index_batch_pallas(jh, lj, rj, interpret=True)),
    }


def _assert_all_agree(refs, got, brute):
    bv, bp = brute
    for name, (v, p) in refs.items():
        v, p = np.asarray(v), np.asarray(p)
        np.testing.assert_array_equal(v, bv, err_msg=f"reference {name}")
        np.testing.assert_array_equal(p, bp, err_msg=f"reference {name}")
        for port, (gv, gp) in got.items():
            assert gv.numpy().dtype == v.dtype, port
            assert gp.numpy().dtype == p.dtype, port
            np.testing.assert_array_equal(gv.numpy(), v,
                                          err_msg=f"{port} vs {name}")
            np.testing.assert_array_equal(gp.numpy(), p,
                                          err_msg=f"{port} vs {name}")


@pytest.mark.parametrize("n,c,t,cap", GEOMETRIES)
def test_f32_answers_match_reference(n, c, t, cap):
    x = tied_input(np.random.default_rng(5 * n + c), n)
    ls, rs = _workload(n, c, seed=n)
    jh = jbuild(jnp.asarray(x), jmake_plan(n, c=c, t=t, capacity=cap),
                with_positions=True)
    h = build_hierarchy(torch.from_numpy(x),
                        make_plan(n, c=c, t=t, capacity=cap), True)
    _assert_all_agree(_reference_answers(jh, ls, rs),
                      _port_answers(h, ls, rs), brute_force(x, ls, rs))


@pytest.mark.parametrize("n,c,t,cap", [(777, 4, 2, 1024), (1000, 8, 2, None),
                                       (700, 128, 64, None)])
def test_f64_answers_match_reference(n, c, t, cap):
    x = tied_input(np.random.default_rng(9), n, np.float64)
    ls, rs = _workload(n, c, seed=3)
    with jax.enable_x64(True):
        jh = jbuild(jnp.asarray(x), jmake_plan(n, c=c, t=t, capacity=cap),
                    with_positions=True)
        refs = _reference_answers(jh, ls.astype(np.int32),
                                  rs.astype(np.int32))
        refs = {k: tuple(np.asarray(a) for a in v) for k, v in refs.items()}
    h = build_hierarchy(torch.from_numpy(x),
                        make_plan(n, c=c, t=t, capacity=cap), True)
    got = _port_answers(h, ls, rs)
    assert got["walk"][0].dtype == torch.float64
    _assert_all_agree(refs, got, brute_force(x, ls, rs))


@pytest.mark.parametrize("n,c,t,cap", [(12_345, 16, 4, None),
                                       (999, 2, 1, 1500)])
def test_reference_built_hierarchy_answers_in_the_port(n, c, t, cap):
    x = tied_input(np.random.default_rng(n), n)
    jplan = jmake_plan(n, c=c, t=t, capacity=cap)
    jh = jbuild(jnp.asarray(x), jplan, with_positions=True)
    h = hierarchy_from_reference(np.asarray(jh.base), np.asarray(jh.upper),
                                 np.asarray(jh.upper_pos), jplan, "cpu")
    ls, rs = _workload(n, c, seed=1)
    lj, rj = jnp.asarray(ls), jnp.asarray(rs)
    refs = {"core": (jvalue(jh, lj, rj), jindex(jh, lj, rj))}
    _assert_all_agree(refs, _port_answers(h, ls, rs), brute_force(x, ls, rs))


def test_value_only_hierarchy_answers_values():
    n, c, t = 5000, 8, 4
    x = tied_input(np.random.default_rng(2), n)
    ls, rs = _workload(n, c, seed=2)
    h = build_hierarchy(torch.from_numpy(x), make_plan(n, c=c, t=t), False)
    lt, rt = torch.from_numpy(ls), torch.from_numpy(rs)
    want = jvalue(jbuild(jnp.asarray(x), jmake_plan(n, c=c, t=t)),
                  jnp.asarray(ls), jnp.asarray(rs))
    for got in (fused_ops.rmq_fused_value_batch(h, lt, rt),
                scan_ops.rmq_value_batch_cuda(h, lt, rt),
                rmq_walk_batch(h, lt, rt, track_pos=False)[0]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for fn in (fused_ops.rmq_fused_index_batch,
               scan_ops.rmq_index_batch_cuda):
        with pytest.raises(ValueError, match="without positions"):
            fn(h, lt, rt)


def test_walk_slices_large_batches(monkeypatch):
    """A batch walked in many slices answers as one walked whole."""
    from repro_torch.core import query

    n, c = 3000, 8
    x = tied_input(np.random.default_rng(4), n)
    h = build_hierarchy(torch.from_numpy(x), make_plan(n, c=c, t=4), True)
    ls, rs = _workload(n, c, seed=4)
    lt, rt = torch.from_numpy(ls), torch.from_numpy(rs)
    whole = rmq_walk_batch(h, lt, rt, True)
    monkeypatch.setattr(query, "_WINDOW_ELEMS", 64)
    sliced = rmq_walk_batch(h, lt, rt, True)
    assert torch.equal(whole[0], sliced[0])
    assert torch.equal(whole[1], sliced[1])


def test_launch_counts_on_the_cpu_path():
    """One fused launch per batch (both planes with track_pos); one scan
    launch per plane; no CUDA kernel runs for a CPU hierarchy."""
    n = 4000
    x = tied_input(np.random.default_rng(8), n)
    h = build_hierarchy(torch.from_numpy(x), make_plan(n, c=8, t=4), True)
    ls, rs = _workload(n, 8, seed=8)
    hits = (fused_ops.LAUNCHES.launches, scan_ops.LAUNCHES.launches)
    with count_launches() as fused:
        fused_ops.rmq_fused_batch(h, ls, rs, track_pos=True)
    assert fused == {"rmq_fused": 1}
    with count_launches() as scan:
        scan_ops.rmq_value_batch_cuda(h, ls, rs)
        scan_ops.rmq_index_batch_cuda(h, ls, rs)
    assert scan == {"rmq_scan": 2}
    assert (fused_ops.LAUNCHES.launches,
            scan_ops.LAUNCHES.launches) == hits
