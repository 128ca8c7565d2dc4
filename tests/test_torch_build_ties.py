"""The builds' tie rule on zero-heavy input, bit for bit (integer views).

Every chunk reduce of the port returns the bits of the chunk's leftmost
minimal entry, zeros of either sign included, in value-only builds as in
position builds.  ``np.testing.assert_array_equal`` and ``torch.equal``
take -0.0 for +0.0, so these tests compare the float planes as integer
views.  On inputs where a third of the entries are -0.0 or +0.0 (and a
-0.0 sits right before a +0.0, or a +0.0 before a -0.0, in some pairs):

* the port's three builds on the CPU (plain, fused, per-call) against the
  reference's jnp build (``repro.core.hierarchy.build_hierarchy``: argmin,
  then a gather, so the leftmost entry's bits), float32 and float64,
  value-only and with positions;
* the port's plain update and append (and the CUDA route's CPU path)
  against the reference's jnp ``update_hierarchy`` / ``append_hierarchy``;
* a CPU rehearsal of the CUDA kernels' lane reduce (``rmq_common.cuh``
  ``pick_index``, ``build_hopper.cuh`` ``pick_chunk``): each lane's first
  minimum in index order, the value minimum M, the smallest index among
  the lanes that hold M, the winner's own bits; at the run layout (lane j
  holds vector j of the chunk) and part by part (lane-strided), against
  the plain reduce; with the rule the builds had before as a control that
  must differ.

The reference's Pallas builds are left out of the bit comparison: its
fused build and its value-only per-level build take ``jnp.min`` for the
value, as its update kernel does, and on the CPU ``jnp.min`` returns -0.0
whenever a -0.0 is among a chunk's zeros, wherever it stands
(``ROADMAP.md`` C6).  ``tests/test_torch_build.py`` holds the port to
them with -0.0 equal to +0.0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import GEOMETRIES, zero_heavy
from repro.core.hierarchy import build_hierarchy as jbuild
from repro.core.plan import make_plan as jmake_plan
from repro.streaming import append_hierarchy as jappend
from repro.streaming import update_hierarchy as jupdate
from repro_torch.core.hierarchy import build_hierarchy, reduce_level
from repro_torch.core.plan import make_plan
from repro_torch.kernels.hierarchy_build.ops import build_hierarchy_percall
from repro_torch.kernels.hierarchy_fused.ops import build_hierarchy_fused
from repro_torch.kernels.hierarchy_update import ops as upd_ops
from repro_torch.streaming import updates as U

PORT_BUILDS = {
    "plain": build_hierarchy,
    "fused": build_hierarchy_fused,
    "percall": build_hierarchy_percall,
}
DTYPES = {"float32": np.float32, "float64": np.float64}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def _assert_same_bits(ref, got):
    """``ref``: a reference Hierarchy (numpy leaves); ``got``: the port's."""
    for key in ("base", "upper"):
        want, mine = np.asarray(getattr(ref, key)), getattr(got, key).numpy()
        assert mine.dtype == want.dtype and mine.shape == want.shape, key
        np.testing.assert_array_equal(_bits(mine), _bits(want), err_msg=key)
    assert (ref.upper_pos is None) == (got.upper_pos is None)
    if got.upper_pos is not None:
        np.testing.assert_array_equal(got.upper_pos.numpy(),
                                      np.asarray(ref.upper_pos))


def _x64(dtype):
    return jax.enable_x64(dtype == "float64")


def _input(n, c, dtype):
    return zero_heavy(np.random.default_rng(n + c), n, DTYPES[dtype])


@functools.lru_cache(maxsize=None)
def _reference_build(n, c, t, cap, dtype, with_pos):
    x = _input(n, c, dtype)
    with _x64(dtype):
        ref = jbuild(jnp.asarray(x), jmake_plan(n, c=c, t=t, capacity=cap),
                     with_positions=with_pos)
        return jax.tree_util.tree_map(np.asarray, ref)


@pytest.mark.parametrize("n,c,t,cap", GEOMETRIES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("with_pos", [False, True])
@pytest.mark.parametrize("build", sorted(PORT_BUILDS))
def test_builds_keep_the_leftmost_zero(n, c, t, cap, dtype, with_pos,
                                       build):
    ref = _reference_build(n, c, t, cap, dtype, with_pos)
    got = PORT_BUILDS[build](torch.from_numpy(_input(n, c, dtype)),
                             make_plan(n, c=c, t=t, capacity=cap), with_pos)
    _assert_same_bits(ref, got)


def test_zero_heavy_input_has_both_zero_orders():
    """The helper puts -0.0 before +0.0 and +0.0 before -0.0, and the
    reference's upper entries carry both signs."""
    x = zero_heavy(np.random.default_rng(0), 4096)
    neg = np.signbit(x) & (x == 0)
    pos = ~np.signbit(x) & (x == 0)
    assert (neg[:-1] & pos[1:]).any() and (pos[:-1] & neg[1:]).any()
    ref = _reference_build(4096, 8, 2, 8192, "float32", False)
    upper = np.asarray(ref.upper)
    assert (np.signbit(upper) & (upper == 0)).any()
    assert (~np.signbit(upper) & (upper == 0)).any()


def _update(route, h, idxs, vals):
    if route == "eager":
        return U.update_hierarchy(h, idxs, vals)
    return upd_ops.update_hierarchy_cuda(h, idxs, vals)


def _append(route, h, vals, start):
    if route == "eager":
        return U.append_hierarchy(h, vals, start)
    return upd_ops.append_hierarchy_cuda(h, vals, start)


@pytest.mark.parametrize("n,c,t,cap", GEOMETRIES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("with_pos", [False, True])
@pytest.mark.parametrize("route", ["eager", "cuda"])
def test_updates_keep_the_leftmost_zero(n, c, t, cap, dtype, with_pos,
                                        route):
    """Zero-heavy batches (zeros of either sign written over zeros and
    over values) through the port's update and append: the reference's jnp
    update path, bit for bit."""
    rng = np.random.default_rng(3 * n + c)
    x = _input(n, c, dtype)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    h = build_hierarchy(torch.from_numpy(x), plan, with_pos)
    idxs = rng.integers(0, plan.capacity, 200)
    idxs[:30] = idxs[30:60]  # duplicates: the last one wins
    vals = zero_heavy(rng, 200, DTYPES[dtype], share=0.5)
    tail = zero_heavy(rng, min(plan.capacity - n, 150), DTYPES[dtype],
                      share=0.5)
    got = _update(route, h, torch.from_numpy(idxs), torch.from_numpy(vals))
    if tail.size:
        got_a = _append(route, got, torch.from_numpy(tail), n)
    with _x64(dtype):
        jh = jbuild(jnp.asarray(x), jmake_plan(n, c=c, t=t, capacity=cap),
                    with_positions=with_pos)
        jh = jupdate(jh, jnp.asarray(idxs, jnp.int32), jnp.asarray(vals))
        want = jax.tree_util.tree_map(np.asarray, jh)
        if tail.size:
            want_a = jax.tree_util.tree_map(np.asarray, jappend(
                jh, jnp.asarray(tail), jnp.int32(n)))
    _assert_same_bits(want, got)
    if tail.size:
        _assert_same_bits(want_a, got_a)


# ---------------------------------------------------------------------------
# The kernels' lane reduce, rehearsed on the CPU
# ---------------------------------------------------------------------------
def lane_reduce(chunks: torch.Tensor, layout: str):
    """``(values, index in the chunk)`` of each row of ``chunks`` (m, c)
    in the order the CUDA kernels reduce it.

    ``runs`` (``build_hopper.cuh``, c = 32 V): lane j holds entries
    [jV, jV + V) and starts from its first one.  ``parts``
    (``rmq_common.cuh``): lanes = min(c, 32), lane j holds entries j,
    j + lanes, ... and starts from (+inf, j).  Each lane keeps the first
    index of its minimum (a strict <); M is the lanes' value minimum;
    the winner is the smallest index among the lanes that hold M; the
    answer is the winning lane's own value."""
    m, c = chunks.shape
    if layout == "runs":
        vec = c // 32
        held = torch.arange(c).view(32, vec)
        v, idx = chunks[:, held[:, 0]], held[:, 0].expand(m, -1)
        first = 1
    else:
        lanes = min(c, 32)
        held = torch.arange(c).view(c // lanes, lanes).T
        v = torch.full((m, lanes), float("inf"), dtype=chunks.dtype)
        idx = held[:, 0].expand(m, -1)
        first = 0
    for e in range(first, held.shape[1]):
        x = chunks[:, held[:, e]]
        lower = x < v
        v = torch.where(lower, x, v)
        idx = torch.where(lower, held[:, e].expand(m, -1), idx)
    best = v.amin(dim=1, keepdim=True)  # the sign of a zero M plays no part
    key = torch.where(v == best, idx, torch.full_like(idx, c))
    w = key.min(dim=1).values
    owner = w // (c // 32) if layout == "runs" else w % held.shape[0]
    return v.gather(1, owner[:, None])[:, 0], w


def old_lane_reduce(chunks: torch.Tensor):
    """The value-only reduce the builds had before (``take_min``): each
    lane's strict-< minimum, then a butterfly that keeps a lane's own value
    unless its partner's is strictly lower; lane 0's answer."""
    m, c = chunks.shape
    lanes = min(c, 32)
    held = torch.arange(c).view(c // lanes, lanes).T
    v = torch.full((m, lanes), float("inf"), dtype=chunks.dtype)
    for e in range(held.shape[1]):
        x = chunks[:, held[:, e]]
        v = torch.where(x < v, x, v)
    o = lanes // 2
    while o:
        partner = v[:, torch.arange(lanes) ^ o]
        v = torch.where(partner < v, partner, v)
        o //= 2
    return v[:, 0]


def _zero_chunks(c, dtype, m=4096):
    x = zero_heavy(np.random.default_rng(c), m * c, DTYPES[dtype])
    return torch.from_numpy(x)


@pytest.mark.parametrize("c,layout,dtype", [
    (4, "parts", "float32"), (32, "parts", "float32"),
    (128, "parts", "float32"), (128, "runs", "float32"),
    (4, "parts", "float64"), (32, "parts", "float64"),
    (64, "runs", "float64"),
])
def test_lane_reduce_is_the_plain_reduce(c, layout, dtype):
    x = _zero_chunks(c, dtype)
    m = x.numel() // c
    want_v, want_p = reduce_level(x, None, c, m, True)
    got_v, got_w = lane_reduce(x.view(m, c), layout)
    np.testing.assert_array_equal(_bits(got_v.numpy()),
                                  _bits(want_v.numpy()))
    np.testing.assert_array_equal(
        (got_w + torch.arange(m) * c).numpy(), want_p.numpy())
    # the input decides the sign: both signs are answers
    zeros = got_v == 0
    assert torch.signbit(got_v[zeros]).any()
    assert (~torch.signbit(got_v[zeros])).any()


@pytest.mark.parametrize("c", [4, 32, 128])
def test_old_lane_reduce_is_a_control(c):
    """The rule the value-only builds had before differs in sign from the
    plain reduce on the same chunks, while -0.0 == +0.0 hides it."""
    x = _zero_chunks(c, "float32")
    m = x.numel() // c
    want = reduce_level(x, None, c, m, False)[0]
    old = old_lane_reduce(x.view(m, c))
    assert torch.equal(old, want)
    assert (_bits(old.numpy()) != _bits(want.numpy())).any()
