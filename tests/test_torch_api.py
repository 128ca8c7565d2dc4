"""The port's ``RMQ`` facade against ``repro.core.RMQ`` (backend "jax")."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import tied_input
from repro.core import RMQ as JRMQ
from repro_torch.core import RMQ, live_length, make_plan
from repro_torch.kernels.profiling import count_launches
from repro_torch.tune.measure import make_queries

BACKENDS = ["eager", "cuda", "fused"]


def _case(n=6000, seed=0):
    x = tied_input(np.random.default_rng(seed), n)
    ls, rs = make_queries(n, 200, "mixed", seed=seed + 1)
    return x, ls, rs


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("c,t,cap", [(128, 64, None), (8, 4, 9000),
                                     (16, 2, None)])
def test_facade_matches_reference(backend, c, t, cap):
    x, ls, rs = _case()
    ref = JRMQ.build(jnp.asarray(x), c=c, t=t, with_positions=True,
                     backend="jax", capacity=cap)
    got = RMQ.build(x, c=c, t=t, with_positions=True, backend=backend,
                    capacity=cap, device="cpu")
    assert got.backend == backend
    np.testing.assert_array_equal(got.query(ls, rs).numpy(),
                                  np.asarray(ref.query(ls, rs)))
    np.testing.assert_array_equal(got.query_index(ls, rs).numpy(),
                                  np.asarray(ref.query_index(ls, rs)))
    np.testing.assert_array_equal(
        got.query_value_batch(torch.from_numpy(ls), torch.from_numpy(rs))
        .numpy(), np.asarray(ref.query_value_batch(ls, rs)))
    np.testing.assert_array_equal(
        got.query_index_batch(ls, rs).numpy(),
        np.asarray(ref.query_index_batch(ls, rs)))
    assert (got.n, got.capacity, got.with_positions) == \
        (ref.n, ref.capacity, ref.with_positions)
    assert got.plan.level_lens == ref.plan.level_lens
    assert got.memory_bytes() == ref.memory_bytes()
    assert got.auxiliary_bytes() == ref.auxiliary_bytes()
    assert live_length(got) == live_length(ref) == len(x)


@pytest.mark.parametrize("backend", BACKENDS)
def test_value_dtypes_follow_the_reference(backend):
    x = np.arange(3000, 0, -1).astype(np.int32)  # ints become float32
    got = RMQ.build(x, c=8, t=4, backend=backend, device="cpu")
    assert got.value_dtype == torch.float32
    assert float(got.query([0], [2999])[0]) == 1.0
    x64 = np.linspace(1.0, 2.0, 3000)
    got = RMQ.build(x64, c=8, t=4, backend=backend, device="cpu")
    assert got.value_dtype == torch.float64


def test_auto_is_eager_on_the_cpu():
    x, _, _ = _case(500)
    assert RMQ.build(x, device="cpu").backend == "eager"


def test_launch_counts_through_the_facade():
    x, ls, rs = _case(5000)
    plan_levels = make_plan(5000, c=8, t=4).num_levels
    with count_launches() as counts:
        r = RMQ.build(x, c=8, t=4, with_positions=True, backend="cuda",
                      device="cpu")
        r.query(ls, rs)
        r.query_index(ls, rs)
    assert counts == {"hierarchy_build": plan_levels - 1, "rmq_scan": 2}
    with count_launches() as counts:
        r = RMQ.build(x, c=8, t=4, with_positions=True, backend="fused",
                      device="cpu")
        r.query(ls, rs)
        r.query_index(ls, rs)
    assert counts == {"hierarchy_fused": 1, "rmq_fused": 2}


@pytest.mark.parametrize("backend", BACKENDS)
def test_refusals(backend, monkeypatch):
    x, ls, rs = _case(3000)
    r = RMQ.build(x, c=8, t=4, backend=backend, device="cpu")
    with pytest.raises(ValueError, match="without positions"):
        r.query_index(ls, rs)
    with pytest.raises(TypeError, match="integers"):
        r.query(ls.astype(np.float32), rs)
    with pytest.raises(TypeError, match="integers"):
        r.query(ls, np.ones(len(rs), bool))
    with pytest.raises(ValueError, match="match in shape"):
        r.query(ls[:5], rs[:6])
    # out-of-range bounds pass unchecked unless debug checks are on
    r.query([0], [3000])
    monkeypatch.setenv("REPRO_RMQ_DEBUG", "1")
    for bad in (([0], [3000]), ([-1], [3]), ([5], [4])):
        with pytest.raises(ValueError, match="violates 0 <= l <= r < n"):
            r.query(*bad)
    r.query([0, 17], [2999, 17])


def test_build_refusals():
    x, _, _ = _case(3000)
    with pytest.raises(ValueError, match="unknown backend"):
        RMQ.build(x, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="capacity via make_plan"):
        RMQ.build(x, plan=make_plan(3000), capacity=4000, device="cpu")
    # bfloat16 input builds, keeping a bf16 level 0 (A3b); bf16 summaries
    # over it stay refused, as in the reference
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert RMQ.build(xb, device="cpu").hierarchy.base.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32 inputs only"):
        RMQ.build(xb, summary_dtype="bfloat16", with_positions=True,
                  device="cpu")
    with pytest.raises(ValueError, match="rank-1"):
        RMQ.build(x.reshape(2, -1), device="cpu")
    # c="auto" is served (A9): the committed cache is keyed by the card,
    # so a CPU build misses and takes the default geometry
    assert RMQ.build(x, c="auto", device="cpu").plan == make_plan(3000)
    # compact planes that could not answer exactly (A3): bf16 summaries
    # need positions and float32 input, as in the reference
    with pytest.raises(ValueError, match="requires with_positions=True"):
        RMQ.build(x, summary_dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError, match="float32 inputs only"):
        RMQ.build(x.astype(np.float64), summary_dtype="bfloat16",
                  with_positions=True, device="cpu")


def test_explicit_plan_and_capacity():
    x, ls, rs = _case(3000)
    plan = make_plan(3000, c=16, t=2, capacity=5000)
    r = RMQ.build(x, plan=plan, with_positions=True, device="cpu")
    assert r.plan is plan and r.hierarchy.base.shape == (5000,)
    assert torch.isinf(r.hierarchy.base[3000:]).all()
    ref = JRMQ.build(jnp.asarray(x), c=16, t=2, capacity=5000,
                     with_positions=True, backend="jax")
    np.testing.assert_array_equal(r.query_index(ls, rs).numpy(),
                                  np.asarray(ref.query_index(ls, rs)))


def _assert_same_planes(port_h, ref_h):
    for name in ("base", "upper", "upper_pos"):
        got = getattr(port_h, name).numpy()
        want = np.asarray(getattr(ref_h, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("backend", BACKENDS)
def test_float16_input_is_cast_as_the_reference_casts_it(backend):
    x = tied_input(np.random.default_rng(16), 5000, np.float16)
    ls, rs = make_queries(5000, 300, "mixed", seed=17)
    ref = JRMQ.build(jnp.asarray(x), c=16, t=4, with_positions=True,
                     backend="jax")
    got = RMQ.build(x, c=16, t=4, with_positions=True, backend=backend,
                    device="cpu")
    assert got.value_dtype == torch.float32
    _assert_same_planes(got.hierarchy, ref.hierarchy)
    np.testing.assert_array_equal(got.query(ls, rs).numpy(),
                                  np.asarray(ref.query(ls, rs)))
    np.testing.assert_array_equal(got.query_index(ls, rs).numpy(),
                                  np.asarray(ref.query_index(ls, rs)))


def test_float16_input_through_streaming_from_array():
    from repro.streaming import StreamingRMQ as JStreaming
    from repro_torch.streaming import StreamingRMQ

    x = tied_input(np.random.default_rng(18), 3000, np.float16)
    ls, rs = make_queries(3000, 300, "mixed", seed=19)
    ref = JStreaming.from_array(jnp.asarray(x), c=8, t=2, capacity=4096,
                                with_positions=True, backend="jax")
    got = StreamingRMQ.from_array(x, c=8, t=2, capacity=4096,
                                  with_positions=True, device="cpu")
    _assert_same_planes(got.hierarchy, ref.hierarchy)
    np.testing.assert_array_equal(got.query(ls, rs).numpy(),
                                  np.asarray(ref.query(ls, rs)))
    np.testing.assert_array_equal(got.query_index(ls, rs).numpy(),
                                  np.asarray(ref.query_index(ls, rs)))
