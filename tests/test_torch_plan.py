"""The port's plan geometry against the reference's, field for field."""

import dataclasses

import jax  # noqa: F401  (both frameworks at the top; JAX stays on the CPU)
import pytest

from _torch_cases import GEOMETRIES
from repro.core.plan import LevelSplit as JLevelSplit
from repro.core.plan import make_plan as jmake_plan
from repro_torch.core.interop import plan_from_reference
from repro_torch.core.plan import LevelSplit, make_plan

PLAN_GEOMETRIES = GEOMETRIES + [
    (1 << 20, 128, 64, None),
    (1 << 20, 4, 64, None),
    ((1 << 27) - 777, 128, 64, 1 << 27),
    (5, 2, 1, None),
    (1 << 30, 128, 64, None),
    (100, 128, 64, 2**31 + 5),  # past int32: int64 position bytes
]

PROPERTIES = ("num_levels", "num_upper_levels", "upper_size", "top_len",
              "top_padded_len")
METHODS = ("max_scanned_entries", "memory_bound_entries",
           "auxiliary_entries", "overhead_fraction", "pos_bits",
           "input_bytes", "value_plane_bytes", "position_plane_bytes")


@pytest.mark.parametrize("n,c,t,cap", PLAN_GEOMETRIES)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("summary", ["float32", "bfloat16"])
def test_geometry_and_bytes_match_reference(n, c, t, cap, packed, summary):
    ref = jmake_plan(n, c=c, t=t, capacity=cap, packed_pos=packed,
                     summary_dtype=summary)
    got = make_plan(n, c=c, t=t, capacity=cap, packed_pos=packed,
                    summary_dtype=summary)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for name in PROPERTIES:
        assert getattr(got, name) == getattr(ref, name), name
    for name in METHODS:
        assert getattr(got, name)() == getattr(ref, name)(), name
    for with_pos in (False, True):
        assert got.auxiliary_bytes_planned(with_pos) == \
            ref.auxiliary_bytes_planned(with_pos)
    for level in range(1, got.num_levels):
        assert got.level_slice(level) == ref.level_slice(level)


@pytest.mark.parametrize("n,c,t,cap", PLAN_GEOMETRIES)
def test_plan_carried_from_reference(n, c, t, cap):
    split = JLevelSplit(scan_chunks=1, sparse_top=False, long_cutoff=99)
    ref = jmake_plan(n, c=c, t=t, capacity=cap, level_split=split)
    got = plan_from_reference(dataclasses.asdict(ref))
    assert got == make_plan(n, c=c, t=t, capacity=cap,
                            level_split=LevelSplit(1, False, 99, False))
    assert plan_from_reference(ref) == got


def test_the_c2_plan_has_ten_upper_levels():
    plan = make_plan(999, c=2, t=1, capacity=1500)
    assert plan.num_upper_levels == 10
    assert plan.level_lens == jmake_plan(999, c=2, t=1,
                                         capacity=1500).level_lens


@pytest.mark.parametrize("kwargs", [dict(tuned=True), dict(c="auto")])
def test_tuned_plans_wait_for_the_autotuner(kwargs):
    with pytest.raises(NotImplementedError, match="A9"):
        make_plan(1000, **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(n=0), dict(n=10, c=3), dict(n=10, c=1), dict(n=10, t=0),
    dict(n=10, capacity=5), dict(n=10, summary_dtype="float16"),
])
def test_invalid_plans_raise_like_the_reference(kwargs):
    with pytest.raises(ValueError):
        jmake_plan(**kwargs)
    with pytest.raises(ValueError):
        make_plan(**kwargs)


@pytest.mark.parametrize("kwargs", [dict(scan_chunks=3), dict(long_cutoff=0)])
def test_level_split_validation(kwargs):
    with pytest.raises(ValueError):
        LevelSplit(**kwargs)
