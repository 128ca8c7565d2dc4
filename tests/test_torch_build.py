"""The port's builds against the reference's, bit for bit (tolerance 0).

Min and argmin are exact, so the plain build and each kernel module's CPU
path must give the reference's ``base``, ``upper`` and ``upper_pos``
entry for entry, padding included, in float32 and float64.  The
reference side runs its Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import GEOMETRIES, tied_input
from repro.core.hierarchy import build_hierarchy as jbuild
from repro.core.plan import make_plan as jmake_plan
from repro.kernels.hierarchy_build.ops import build_hierarchy_pallas
from repro.kernels.hierarchy_fused.ops import build_hierarchy_fused as jfused
from repro_torch.core.hierarchy import build_hierarchy, pos_dtype_for
from repro_torch.core.interop import (
    hierarchy_from_reference,
    hierarchy_to_reference,
)
from repro_torch.core.plan import make_plan
from repro_torch.kernels.hierarchy_build import ops as build_ops
from repro_torch.kernels.hierarchy_build.ops import build_hierarchy_percall
from repro_torch.kernels.hierarchy_fused import ops as fused_ops
from repro_torch.kernels.hierarchy_fused.ops import build_hierarchy_fused
from repro_torch.kernels.profiling import count_launches, launch_registry

PORT_BUILDS = {
    "plain": build_hierarchy,
    "fused": build_hierarchy_fused,
    "percall": build_hierarchy_percall,
}


def _assert_planes_equal(ref, got):
    """``ref``: a reference Hierarchy; ``got``: the port's."""
    np.testing.assert_array_equal(np.asarray(ref.base), got.base.numpy())
    assert got.base.numpy().dtype == np.asarray(ref.base).dtype
    np.testing.assert_array_equal(np.asarray(ref.upper), got.upper.numpy())
    assert got.upper.numpy().dtype == np.asarray(ref.upper).dtype
    assert ref.with_positions == got.with_positions
    if ref.with_positions:
        want = np.asarray(ref.upper_pos)
        assert got.upper_pos.numpy().dtype == want.dtype
        np.testing.assert_array_equal(want, got.upper_pos.numpy())


def _reference_builds(xj, plan, with_pos):
    return (
        jbuild(xj, plan, with_positions=with_pos),
        jfused(xj, plan, with_positions=with_pos, interpret=True),
        build_hierarchy_pallas(xj, plan, with_positions=with_pos,
                               interpret=True),
    )


@pytest.mark.parametrize("n,c,t,cap", GEOMETRIES)
@pytest.mark.parametrize("with_pos", [False, True])
@pytest.mark.parametrize("build", sorted(PORT_BUILDS))
def test_f32_builds_match_reference(n, c, t, cap, with_pos, build):
    x = tied_input(np.random.default_rng(n + c), n)
    refs = _reference_builds(jnp.asarray(x), jmake_plan(n, c=c, t=t,
                                                        capacity=cap),
                             with_pos)
    got = PORT_BUILDS[build](torch.from_numpy(x),
                             make_plan(n, c=c, t=t, capacity=cap), with_pos)
    for ref in refs:
        _assert_planes_equal(ref, got)


@pytest.mark.parametrize("n,c,t,cap", [(777, 4, 2, 1024), (1000, 8, 2, None),
                                       (700, 128, 64, None)])
@pytest.mark.parametrize("build", sorted(PORT_BUILDS))
def test_f64_builds_match_reference(n, c, t, cap, build):
    x = tied_input(np.random.default_rng(7), n, np.float64)
    with jax.enable_x64(True):
        refs = _reference_builds(jnp.asarray(x),
                                 jmake_plan(n, c=c, t=t, capacity=cap), True)
        assert refs[0].upper.dtype == jnp.float64
        refs = [jax.tree_util.tree_map(np.asarray, r) for r in refs]
    got = PORT_BUILDS[build](torch.from_numpy(x),
                             make_plan(n, c=c, t=t, capacity=cap), True)
    assert got.upper.dtype == torch.float64
    for ref in refs:
        _assert_planes_equal(ref, got)


@pytest.mark.parametrize("n,c,t,cap", GEOMETRIES)
def test_reference_hierarchy_carries_over_both_ways(n, c, t, cap):
    x = tied_input(np.random.default_rng(n), n)
    jplan = jmake_plan(n, c=c, t=t, capacity=cap)
    ref = jbuild(jnp.asarray(x), jplan, with_positions=True)
    carried = hierarchy_from_reference(
        np.asarray(ref.base), np.asarray(ref.upper),
        np.asarray(ref.upper_pos), jplan, device="cpu")
    _assert_planes_equal(ref, carried)
    mine = build_hierarchy(torch.from_numpy(x),
                           make_plan(n, c=c, t=t, capacity=cap), True)
    back = hierarchy_to_reference(mine)
    assert back["plan_fields"]["level_lens"] == jplan.level_lens
    for key in ("base", "upper", "upper_pos"):
        np.testing.assert_array_equal(back[key], np.asarray(getattr(ref, key)))
    assert mine.memory_bytes() == ref.memory_bytes()
    assert mine.auxiliary_bytes() == ref.auxiliary_bytes()


def test_launch_counts_on_the_cpu_path():
    """One fused launch per build, one per upper level on the per-call
    path, none for a single-level plan; no CUDA kernel runs on the CPU."""
    n, c, t = 4999, 8, 4
    plan = make_plan(n, c=c, t=t)
    assert plan.num_levels == 4
    x = torch.from_numpy(np.random.default_rng(0).random(n, np.float32))
    hits = (fused_ops.LAUNCHES.launches, build_ops.LAUNCHES.launches)
    with count_launches() as fused:
        build_hierarchy_fused(x, plan)
    assert fused == {"hierarchy_fused": 1}
    with count_launches() as per_level:
        build_hierarchy_percall(x, plan, with_positions=True)
    assert per_level == {"hierarchy_build": plan.num_levels - 1}
    single = make_plan(701, c=128, t=64)
    with count_launches() as none:
        h = build_hierarchy_fused(x[:701], single, with_positions=True)
        build_hierarchy_percall(x[:701], single, with_positions=True)
    assert none == {}
    assert h.upper.shape == (0,) and h.upper_pos.shape == (0,)
    assert (fused_ops.LAUNCHES.launches,
            build_ops.LAUNCHES.launches) == hits


def test_launch_registry_records_every_level():
    plan = make_plan(4999, c=8, t=4)
    x = torch.from_numpy(np.random.default_rng(0).random(4999, np.float32))
    with launch_registry() as reg:
        build_hierarchy_percall(x, plan, with_positions=False)
        build_hierarchy_fused(x, plan)
    assert reg.counts == {"hierarchy_build": 3, "hierarchy_fused": 1}
    assert [r.meta["level"] for r in reg.records[:3]] == [1, 2, 3]
    level_bytes = sum(4 * n for n in plan.level_lens[:-1])
    assert reg.operand_bytes() == {"hierarchy_build": level_bytes,
                                   "hierarchy_fused": 4 * plan.capacity}


@pytest.mark.parametrize("build", sorted(PORT_BUILDS))
@pytest.mark.parametrize("case", ["value_only", "float64"])
def test_compact_planes_are_refused(build, case):
    """Every build refuses the bf16 summaries that could not answer
    exactly (no positions to re-read level 0 through, or a float64
    input), with the reference's error; the compact builds themselves
    are held to the reference in tests/test_torch_compact.py."""
    plan = make_plan(5000, c=8, t=4, summary_dtype="bfloat16")
    x = torch.zeros(5000, dtype=torch.float64 if case == "float64"
                    else torch.float32)
    with_pos = case == "float64"
    with pytest.raises(ValueError, match="bfloat16"):
        PORT_BUILDS[build](x, plan, with_pos)
    if case == "value_only":  # float64 needs x64 on the reference side
        with pytest.raises(ValueError, match="bfloat16"):
            jbuild(jnp.asarray(x.numpy()),
                   jmake_plan(5000, c=8, t=4, summary_dtype="bfloat16"),
                   with_positions=False)


def test_position_dtype_switches_at_2_pow_31():
    assert pos_dtype_for(2**31 - 1) == torch.int32
    assert pos_dtype_for(2**31) == torch.int64


@pytest.mark.parametrize("build", sorted(PORT_BUILDS))
def test_build_input_is_checked(build):
    plan = make_plan(100, c=8, t=2)
    with pytest.raises(ValueError, match="n=100"):
        PORT_BUILDS[build](torch.zeros(99), plan, False)
    with pytest.raises(TypeError):
        PORT_BUILDS[build](torch.zeros(100, dtype=torch.float16), plan,
                           False)
    # bfloat16 is a value dtype (A3b): bf16 planes, 2 bytes an entry
    h = PORT_BUILDS[build](torch.zeros(100, dtype=torch.bfloat16), plan,
                           False)
    assert h.base.dtype == h.upper.dtype == torch.bfloat16
