"""A CPU rehearsal of B6's sorted-run update (``csrc/hierarchy_update.cu``).

The kernel takes the update batch sorted once at its static size
(``updates.sort_batch``: a stable sort, indices outside ``[0, capacity)``
set to ``capacity`` at the end) and never dedupes.  At every upper level a
slice of 32 sorted entries flags the entries whose chunk differs from
their predecessor's (each starts a chunk's run) and owns the chunks whose
runs start in it, however far a run reaches; at the run layout four warps
share a slice, eight flagged chunks each.  The level-1 launch also writes
each run of equal indices' last entry into level 0.  Here:

* :func:`emulate_slices` replays that control flow slice by slice, so the
  ownership rule can be checked: every touched chunk reduced once, every
  surviving write stored once, and nothing else;
* :func:`update_sorted_plain`, the same semantics in plain PyTorch, is
  held bit for bit (integer views) to the deduped plain update
  ``update_hierarchy`` (what the CUDA wrapper runs on a CPU hierarchy), on
  duplicates, negative and past-capacity indices, a level with fewer
  chunks than the batch, appends, NaN, subnormal and zero-heavy input;
  and on NaN-free input to the JAX package's update.

The card tests hold the kernel to the same plain versions on the same
cases (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import edge_input, tied_input, zero_heavy
from repro.core import build_hierarchy as jbuild
from repro.core import make_plan as jmake_plan
from repro.streaming import append_hierarchy as jappend
from repro.streaming import update_hierarchy as jupdate
from repro_torch.core import build_hierarchy, make_plan
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.kernels.hierarchy_update import ops as upd_ops
from repro_torch.kernels.profiling import count_launches
from repro_torch.streaming import updates as U

# (n, c, t, capacity): the default chunk, a deep sub-warp plan, a ragged
# capacity, a plan whose top level has fewer chunks than the batch, and a
# single-level plan.
PLANS = [
    (70_000, 128, 4, 1 << 17),
    (9_000, 4, 4, 1 << 14),
    (12_345, 16, 4, 20_000),
    (4096, 8, 2, None),
    (999, 2, 1, 2048),
    (700, 128, 64, None),
]
KINDS = ("tied", "nan", "subnormals", "zero_heavy")


def _input(kind, rng, n, c, dtype):
    if kind == "tied":
        return tied_input(rng, n, dtype)
    if kind == "zero_heavy":
        return zero_heavy(rng, n, dtype)
    return edge_input(kind, rng, n, c, dtype)


def _batch(rng, cap, size, dtype, kind):
    """Indices with duplicates (runs of one index, some across 32-entry
    slices), negatives and indices past capacity; values of ``kind``."""
    idxs = rng.integers(-4, cap + 4, size)
    idxs[: size // 4] = idxs[size // 4: 2 * (size // 4)]
    idxs[-70:] = idxs[-71]  # one index 71 times: a run over three slices
    vals = _input(kind, rng, size, 4, dtype) - 0.75
    return idxs.astype(np.int64), vals.astype(dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a.view(np.int64) if a.dtype == np.float64 else a


def _same(got, want):
    for key in ("base", "upper", "upper_pos"):
        g, w = getattr(got, key), getattr(want, key)
        if w is None:
            assert g is None, key
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=key)


def update_sorted_plain(h, keys, vals):
    """The update kernel's semantics on the plain path, from the sorted
    batch of ``updates.sort_batch``: level 0 takes the last entry of each
    run of equal indices; upper level k re-reduces the chunk of every
    entry that starts a run at that level (an in-range entry whose
    level-k chunk differs from its predecessor's), each chunk once."""
    plan, cap = h.plan, h.plan.capacity
    upper = h.upper.clone()
    upper_pos = None if h.upper_pos is None else h.upper_pos.clone()
    base = h.base.clone()
    k = keys.to(torch.int64).reshape(-1)
    valid = k < cap
    nxt = torch.cat([k[1:], k.new_full((1,), cap)])
    win = valid & (nxt != k)
    base[k[win]] = vals.reshape(-1)[win]
    ids = k
    for level in range(1, plan.num_levels):
        ids = ids // plan.c
        prev = torch.cat([ids.new_full((1,), -1), ids[:-1]])
        first = valid & (ids != prev)
        U.repair_plain(plan, base, upper, upper_pos, level, ids[first])
    return Hierarchy(base=base, upper=upper, upper_pos=upper_pos, plan=plan)


def emulate_slices(keys, cap: int, c: int, levels: int):
    """The kernel's control flow on a sorted batch: ``(reduced, stored)``,
    the chunk ids each level's warps reduce (in launch order, repeats
    kept) and the batch positions whose entries level 1 stores."""
    s = c.bit_length() - 1
    count = len(keys)
    at = lambda q: keys[q] if q < count else cap  # noqa: E731
    reduced = {k: [] for k in range(1, levels)}
    stored = []
    for k in range(1, levels):
        sh = k * s

        def chunk(key):
            return 0 if sh >= 31 else key >> sh

        for q0 in range(0, count, 32):
            lanes = range(q0, q0 + 32)
            first = [at(q) < cap and (q == 0 or chunk(at(q - 1))
                                      != chunk(at(q))) for q in lanes]
            if not any(first):
                continue  # every entry continues an earlier slice's run
            owned = lanes[first.index(True):]
            if k == 1:
                stored += [q for q in owned
                           if at(q) < cap and at(q + 1) != at(q)]
                last = q0 + 31
                cid = chunk(at(last))
                if at(last) < cap and at(last + 1) < cap \
                        and chunk(at(last + 1)) == cid:
                    p = q0 + 32  # the spill: the run goes on
                    while True:
                        inside = [at(q) < cap and chunk(at(q)) == cid
                                  for q in range(p, p + 32)]
                        stored += [q for q, i in zip(range(p, p + 32),
                                                     inside)
                                   if i and at(q + 1) != at(q)]
                        if not all(inside):
                            break
                        p += 32
            reduced[k] += [chunk(at(q)) for q, f in zip(lanes, first) if f]
            # the run layout's warps: eight flags each, and the entries
            # from a warp's first flag to the next warp's partition the
            # owned entries
            flags = [q for q, f in zip(lanes, first) if f]
            starts = flags[::8] + [q0 + 32]
            parts = [range(a, b) for a, b in zip(starts, starts[1:])]
            assert sorted(q for p in parts for q in p) == list(owned)
    return reduced, stored


@pytest.mark.parametrize("size", [1, 31, 33, 4000])
@pytest.mark.parametrize("n,c,t,cap", PLANS)
def test_slices_reduce_every_touched_chunk_once(n, c, t, cap, size):
    """Each touched chunk of each level is reduced by exactly one warp and
    each surviving write (the last of its run of equal indices) is stored
    exactly once, whatever the slices cut."""
    rng = np.random.default_rng(n + size)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    h = build_hierarchy(torch.from_numpy(tied_input(rng, n)), plan, True)
    idxs, vals = _batch(rng, plan.capacity, max(size, 72), np.float32,
                        "tied")
    idxs, vals = idxs[:size], vals[:size]
    keys, _ = U.sort_batch(h, idxs, vals)
    assert keys.shape == (size,) and keys.dtype == torch.int32
    keys = keys.tolist()
    reduced, stored = emulate_slices(keys, plan.capacity, c,
                                     plan.num_levels)
    valid = [i for i in idxs.tolist() if 0 <= i < plan.capacity]
    for k in range(1, plan.num_levels):
        assert reduced[k] == sorted({i // c ** k for i in valid}), k
    if plan.num_levels == 1:
        return  # no launch: the host scatters (updates.scatter_base)
    assert sorted(keys[q] for q in stored) == sorted(set(valid))
    # the stored entry of an index is its last write in batch order
    order = np.argsort(np.where((idxs >= 0) & (idxs < plan.capacity),
                                idxs, plan.capacity), kind="stable")
    for q in stored:
        i = keys[q]
        assert order[q] == np.flatnonzero(idxs == i)[-1]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_pos", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,c,t,cap", PLANS)
def test_sorted_runs_equal_the_plain_update(n, c, t, cap, dtype, with_pos,
                                            kind):
    """:func:`update_sorted_plain` on the sorted batch equals the deduped
    plain update bit for bit, and so does the CUDA wrapper on the CPU,
    recording one launch a level."""
    rng = np.random.default_rng(3 * n + c)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    h = build_hierarchy(torch.from_numpy(_input(kind, rng, n, c, dtype)),
                        plan, with_pos)
    idxs, vals = _batch(rng, plan.capacity, 700, dtype, kind)
    it, vt = torch.from_numpy(idxs), torch.from_numpy(vals)
    want = U.update_hierarchy(h, it, vt)
    keys, svals = U.sort_batch(h, it, vt)
    _same(update_sorted_plain(h, keys, svals), want)
    with count_launches() as counts:
        got = upd_ops.update_hierarchy_cuda(h, it, vt)
    _same(got, want)
    assert counts == ({"hierarchy_update": plan.num_levels - 1}
                      if plan.num_levels > 1 else {})


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,c,t,cap", [p for p in PLANS
                                       if p[3] is not None])
def test_sorted_runs_append(n, c, t, cap, dtype, kind):
    """An append passes its arange indices through the same path: equal to
    the plain append, bit for bit, and a second append after it."""
    rng = np.random.default_rng(5 * n + c)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    h = build_hierarchy(torch.from_numpy(_input(kind, rng, n, c, dtype)),
                        plan, True)
    tail = torch.from_numpy(_input(kind, rng, min(cap - n, 300), c, dtype))
    got = upd_ops.append_hierarchy_cuda(h, tail, n)
    want = U.append_hierarchy(h, tail, n)
    _same(got, want)
    more = tail[: min(cap - n - tail.numel(), 5)] - 2
    _same(upd_ops.append_hierarchy_cuda(got, more, n + tail.numel()),
          U.append_hierarchy(want, more, n + tail.numel()))


def test_sorted_runs_on_a_level_smaller_than_the_batch():
    """A batch of 20000 over a plan whose upper levels hold 512, 64 and 8
    chunks: every chunk of the small levels is touched many times and
    reduced once; the result equals the plain update."""
    rng = np.random.default_rng(1)
    plan = make_plan(4096, c=8, t=2)
    assert min(plan.level_lens[1:]) < 20000
    h = build_hierarchy(torch.from_numpy(tied_input(rng, 4096)), plan, True)
    idxs, vals = _batch(rng, plan.capacity, 20000, np.float32, "tied")
    _same(upd_ops.update_hierarchy_cuda(h, idxs, vals),
          U.update_hierarchy(h, torch.from_numpy(idxs),
                             torch.from_numpy(vals)))


@pytest.mark.parametrize("n,c,t,cap", PLANS)
def test_sorted_runs_equal_the_reference(n, c, t, cap):
    """On NaN-free input the sorted-run path equals the JAX package's
    update and append (values, positions, padding)."""
    rng = np.random.default_rng(7 * n)
    x = tied_input(rng, n)
    plan = make_plan(n, c=c, t=t, capacity=cap)
    h = build_hierarchy(torch.from_numpy(x), plan, True)
    jh = jbuild(jnp.asarray(x), jmake_plan(n, c=c, t=t, capacity=cap),
                with_positions=True)
    idxs, vals = _batch(rng, plan.capacity, 500, np.float32, "tied")
    got = upd_ops.update_hierarchy_cuda(h, idxs, vals)
    jh = jupdate(jh, jnp.asarray(idxs.astype(np.int32)), jnp.asarray(vals))
    if plan.capacity > n:
        tail = (rng.random(min(plan.capacity - n, 100)) - 0.5).astype(
            np.float32)
        got = upd_ops.append_hierarchy_cuda(got, tail, n)
        jh = jappend(jh, jnp.asarray(tail), n)
    for key in ("base", "upper", "upper_pos"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(jh, key)),
                                      err_msg=key)


@pytest.mark.parametrize("size", [1, 33, 500])
def test_scatter_sorted_writes_the_last_of_each_run(size):
    """The base scatter (no host sync), on the batch as given and on the
    sorted batch a single-level update hands it, equals writing the batch
    one entry after another, out-of-range indices dropped."""
    rng = np.random.default_rng(size)
    plan = make_plan(700, c=128, t=64)
    h = build_hierarchy(torch.from_numpy(tied_input(rng, 700)), plan)
    idxs, vals = _batch(rng, plan.capacity, max(size, 72), np.float32,
                        "nan")
    idxs, vals = idxs[:size], vals[:size]
    want = h.base.numpy().copy()
    for i, v in zip(idxs, vals):
        if 0 <= i < plan.capacity:
            want[i] = v
    it, vt = torch.from_numpy(idxs), torch.from_numpy(vals)
    keys, svals = U.sort_batch(h, it, vt)
    for got in (U.scatter_base(h.base, it, vt),
                U.scatter_base(h.base, keys, svals)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), want.view(np.int32))


def test_sort_batch_keeps_the_static_size():
    """The sorted batch has the batch's size and dtype int32; out-of-range
    indices become capacity at the end; equal indices keep batch order."""
    plan = make_plan(100, c=4, t=2)
    h = build_hierarchy(torch.zeros(100), plan)
    idxs = torch.tensor([7, -1, 3, 7, 100, 3, 7, 250])
    vals = torch.arange(8, dtype=torch.float32)
    keys, svals = U.sort_batch(h, idxs, vals)
    assert keys.tolist() == [3, 3, 7, 7, 7, 100, 100, 100]
    assert svals.tolist() == [2.0, 5.0, 0.0, 3.0, 6.0, 1.0, 4.0, 7.0]
