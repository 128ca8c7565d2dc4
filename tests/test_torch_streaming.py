"""The port's mutation path against the reference's, bit for bit.

Updates, appends and retires on the port (every backend, on the CPU)
against the JAX package's ``update_hierarchy`` / ``append_hierarchy``,
its Pallas update kernels in interpret mode, and its ``StreamingRMQ`` /
``RMQ`` facades, from the same numpy inputs: whole hierarchies (values,
leftmost positions, +inf / PAD_POS padding) at tolerance 0, with
duplicates in a batch, negative and out-of-range indices, ragged n and
capacity > n.  Error text is held byte for byte against the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import brute_force, query_batch, tied_input
from repro.core import RMQ as JRMQ
from repro.core import build_hierarchy as jbuild
from repro.core import make_plan as jmake_plan
from repro.kernels.hierarchy_update import kernel as jkernel
from repro.kernels.hierarchy_update.ops import (
    append_hierarchy_pallas,
    update_hierarchy_pallas,
)
from repro.streaming import StreamingRMQ as JStreaming
from repro.streaming import append_hierarchy as jappend
from repro.streaming import update_hierarchy as jupdate
from repro_torch.core import RMQ, build_hierarchy, make_plan
from repro_torch.core import protocol as px
from repro_torch.kernels.hierarchy_update import ops as upd_ops
from repro_torch.kernels.profiling import count_launches
from repro_torch.streaming import StreamingRMQ
from repro_torch.streaming import updates as U

PLANS = [
    (100_000, 128, 64, None),
    (4096, 8, 2, None),
    (999, 2, 1, 2048),
    (12_345, 16, 4, 20_000),
    (257, 4, 1, 257),
    (700, 128, 64, None),    # single-level plan: nothing to repair
]
BACKENDS = ["eager", "cuda", "fused"]


def _assert_same(port_h, ref_h, with_pos=True):
    """Planes of a port hierarchy equal a reference hierarchy's exactly."""
    for name in ("base", "upper") + (("upper_pos",) if with_pos else ()):
        got = getattr(port_h, name).numpy()
        want = np.asarray(getattr(ref_h, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _batch(rng, cap, size):
    """Indices with duplicates, negatives and indices past capacity."""
    idxs = rng.integers(-4, cap + 4, size)
    idxs[: size // 4] = idxs[size // 4: 2 * (size // 4)]
    return idxs.astype(np.int64), rng.random(size).astype(np.float32) - 0.5


def _update(backend, h, idxs, vals):
    if backend == "eager":
        return U.update_hierarchy(h, idxs, vals)
    return upd_ops.update_hierarchy_cuda(h, idxs, vals)


class TestUpdateMatchesReference:
    @pytest.mark.parametrize("n,c,t,cap", PLANS)
    @pytest.mark.parametrize("backend", ["eager", "cuda"])
    def test_random_update_batches(self, n, c, t, cap, backend):
        rng = np.random.default_rng(n + c)
        x = tied_input(rng, n)
        plan = make_plan(n, c=c, t=t, capacity=cap)
        h = build_hierarchy(torch.from_numpy(x), plan, True)
        jh = jbuild(jnp.asarray(x), jmake_plan(n, c=c, t=t, capacity=cap),
                    with_positions=True)
        for _ in range(3):
            idxs, vals = _batch(rng, plan.capacity, int(rng.integers(1, 300)))
            h = _update(backend, h, torch.from_numpy(idxs),
                        torch.from_numpy(vals))
            jh = jupdate(jh, jnp.asarray(idxs, jnp.int32), jnp.asarray(vals))
            _assert_same(h, jh)
        # ... and a fresh build of the mutated level 0 (the batches wrote
        # into the reserved tail too, so it is built at full capacity)
        fresh = build_hierarchy(h.base.clone(),
                                make_plan(plan.capacity, c=c, t=t), True)
        _assert_same(fresh, jh)

    @pytest.mark.parametrize("n,c,t,cap", [(4096, 8, 2, None),
                                           (999, 2, 1, 2048)])
    def test_kernel_path_matches_reference_kernels(self, n, c, t, cap):
        """The port's cuda route (plain per level on the CPU) against the
        reference's Pallas update kernels in interpret mode."""
        rng = np.random.default_rng(3 * n)
        x = tied_input(rng, n)
        jplan = jmake_plan(n, c=c, t=t, capacity=cap)
        h = build_hierarchy(torch.from_numpy(x),
                            make_plan(n, c=c, t=t, capacity=cap), True)
        jh = jbuild(jnp.asarray(x), jplan, with_positions=True)
        idxs, vals = _batch(rng, jplan.capacity, 150)
        idxs = idxs.clip(0, jplan.capacity - 1)
        got = upd_ops.update_hierarchy_cuda(h, idxs, vals)
        want = update_hierarchy_pallas(jh, jnp.asarray(idxs, jnp.int32),
                                       jnp.asarray(vals), interpret=True)
        _assert_same(got, want)
        tail = rng.random(min(jplan.capacity - n, 100)).astype(np.float32)
        if tail.size:
            got = upd_ops.append_hierarchy_cuda(got, tail, n)
            want = append_hierarchy_pallas(want, jnp.asarray(tail),
                                           jnp.int32(n), interpret=True)
            _assert_same(got, want)

    @pytest.mark.parametrize("backend", ["eager", "cuda"])
    def test_duplicate_indices_last_wins(self, backend):
        n = 1000
        x = np.zeros(n, np.float32) + 0.5
        plan = make_plan(n, c=8, t=2)
        h = build_hierarchy(torch.from_numpy(x), plan, True)
        idxs = np.array([7, 7, 7, 123, 123], np.int64)
        vals = np.array([0.1, 0.9, 0.3, 0.8, 0.2], np.float32)
        h = _update(backend, h, torch.from_numpy(idxs),
                    torch.from_numpy(vals))
        assert float(h.base[7]) == np.float32(0.3)
        assert float(h.base[123]) == np.float32(0.2)
        jh = jupdate(jbuild(jnp.asarray(x), jmake_plan(n, c=8, t=2),
                            with_positions=True),
                     jnp.asarray(idxs, jnp.int32), jnp.asarray(vals))
        _assert_same(h, jh)

    @pytest.mark.parametrize("backend", ["eager", "cuda"])
    def test_update_without_positions(self, backend):
        rng = np.random.default_rng(3)
        n = 5000
        x = rng.random(n).astype(np.float32)
        h = build_hierarchy(torch.from_numpy(x), make_plan(n, c=16, t=2))
        idxs = rng.integers(0, n, 64)
        vals = rng.random(64).astype(np.float32)
        got = _update(backend, h, torch.from_numpy(idxs),
                      torch.from_numpy(vals))
        assert got.upper_pos is None
        jh = jupdate(jbuild(jnp.asarray(x), jmake_plan(n, c=16, t=2)),
                     jnp.asarray(idxs, jnp.int32), jnp.asarray(vals))
        _assert_same(got, jh, with_pos=False)

    @pytest.mark.parametrize("n,c,t,cap", [(777, 4, 2, 1024),
                                           (1000, 8, 2, None)])
    def test_f64_update_and_append(self, n, c, t, cap):
        rng = np.random.default_rng(17)
        x = tied_input(rng, n, np.float64)
        idxs, vals = _batch(rng, n, 120)
        vals = vals.astype(np.float64)
        tail = rng.random(min((cap or n) - n, 99)) - 0.7
        with jax.enable_x64(True):
            jplan = jmake_plan(n, c=c, t=t, capacity=cap)
            jh = jupdate(jbuild(jnp.asarray(x), jplan, with_positions=True),
                         jnp.asarray(idxs), jnp.asarray(vals))
            if tail.size:
                jh = jappend(jh, jnp.asarray(tail), n)
            want = {k: np.asarray(getattr(jh, k))
                    for k in ("base", "upper", "upper_pos")}
        plan = make_plan(n, c=c, t=t, capacity=cap)
        for backend in ("eager", "cuda"):
            h = build_hierarchy(torch.from_numpy(x), plan, True)
            h = _update(backend, h, torch.from_numpy(idxs),
                        torch.from_numpy(vals))
            if tail.size:
                h = upd_ops.append_hierarchy_cuda(h, tail, n)
            assert h.base.dtype == torch.float64
            for k, w in want.items():
                got = getattr(h, k).numpy()
                # positions: int32 in both (x64 keeps int32 below 2^31)
                np.testing.assert_array_equal(got, w.astype(got.dtype))


class TestStreamingStructure:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_update_append_retire_match_reference(self, backend):
        rng = np.random.default_rng(11)
        n, cap, c, t = 1500, 6000, 8, 2
        x = tied_input(rng, n)
        s = StreamingRMQ.from_array(x, c=c, t=t, capacity=cap,
                                    with_positions=True, backend=backend,
                                    device="cpu")
        js = JStreaming.from_array(x, c=c, t=t, capacity=cap,
                                   with_positions=True, backend="jax")
        for round_ in range(7):
            if round_ % 3 == 0:
                tail = rng.random(int(rng.integers(1, 64))).astype(
                    np.float32)
                s, js = s.append(tail), js.append(jnp.asarray(tail))
            elif round_ % 3 == 1:
                idxs, vals = _batch(rng, s.length, int(rng.integers(1, 99)))
                idxs = idxs.clip(0, s.length - 1)
                s = s.update(idxs, vals)
                js = js.update(jnp.asarray(idxs, jnp.int32),
                               jnp.asarray(vals))
            else:
                s, js = s.retire(37), js.retire(37)
            assert (s.length, s.start, s.generation) == (
                js.length, js.start, js.generation)
            _assert_same(s.hierarchy, js.hierarchy)
        ls, rs = query_batch(rng, s.length, c)
        a = np.asarray(js.hierarchy.base)[: s.length]
        bv, bp = brute_force(a, ls, rs)
        np.testing.assert_array_equal(s.query(ls, rs).numpy(), bv)
        np.testing.assert_array_equal(s.query_index(ls, rs).numpy(), bp)
        np.testing.assert_array_equal(s.query(ls, rs).numpy(),
                                      np.asarray(js.query(ls, rs)))

    def test_retire_slides_window(self):
        rng = np.random.default_rng(5)
        n = 800
        x = rng.random(n).astype(np.float32)
        s = StreamingRMQ.from_array(x, c=8, t=2, with_positions=True,
                                    device="cpu").retire(100)
        assert s.start == 100
        arr = x.copy()
        arr[:100] = np.inf
        assert float(s.query([0], [n - 1])[0]) == arr.min()
        assert int(s.query_index([50], [n - 1])[0]) == 100 + int(
            np.argmin(arr[100:]))
        _assert_same(s.hierarchy, jbuild(jnp.asarray(arr), jmake_plan(
            n, c=8, t=2), with_positions=True))

    def test_predecessor_answers_its_own_data(self):
        rng = np.random.default_rng(6)
        n = 3000
        x = tied_input(rng, n)
        s0 = StreamingRMQ.from_array(x, c=16, t=4, with_positions=True,
                                     backend="cuda", device="cpu")
        planes = [t.clone() for t in (s0.hierarchy.base, s0.hierarchy.upper,
                                      s0.hierarchy.upper_pos)]
        s1 = s0.update(np.arange(0, n, 7), np.full(len(range(0, n, 7)),
                                                   -1.0, np.float32))
        s2 = s1.retire(500)
        ls, rs = query_batch(rng, n, 16)
        bv, bp = brute_force(x, ls, rs)
        np.testing.assert_array_equal(s0.query(ls, rs).numpy(), bv)
        np.testing.assert_array_equal(s0.query_index(ls, rs).numpy(), bp)
        for before, after in zip(planes, (s0.hierarchy.base,
                                          s0.hierarchy.upper,
                                          s0.hierarchy.upper_pos)):
            assert torch.equal(before, after)
        assert (s0.generation, s1.generation, s2.generation) == (0, 1, 2)

    def test_append_overflow_raises(self):
        s = StreamingRMQ.from_array(np.ones(10, np.float32), c=4, t=1,
                                    capacity=12, device="cpu")
        s = s.append(np.ones(2, np.float32))
        with pytest.raises(ValueError, match="capacity"):
            s.append(np.ones(1, np.float32))

    def test_empty_update_and_append_are_noops(self):
        s = StreamingRMQ.from_array(np.ones(100, np.float32), c=4, t=1,
                                    device="cpu")
        assert s.update(np.zeros(0, np.int32), np.zeros(0, np.float32)) is s
        assert s.append(np.zeros(0, np.float32)) is s
        assert s.retire(0) is s

    def test_plan_and_capacity_conflict_rejected(self):
        plan = make_plan(100, c=4, t=1)
        with pytest.raises(ValueError, match="make_plan"):
            StreamingRMQ.from_array(np.ones(100, np.float32), plan=plan,
                                    capacity=200, device="cpu")

    def test_runs_on_the_card_by_default(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamingRMQ.from_array(np.ones(100, np.float32))


class TestUpdateKernelUnits:
    """The B6 plain version against the reference's three kernels."""

    @pytest.mark.parametrize("c,m,b", [(128, 16, 5), (8, 64, 17),
                                       (256, 4, 4)])
    def test_update_level(self, c, m, b):
        rng = np.random.default_rng(c)
        x = rng.random(c * m).astype(np.float32)
        ids = rng.integers(0, m, b).astype(np.int32)
        want = jkernel.update_level(jnp.asarray(x), jnp.asarray(ids), c=c,
                                    interpret=True)
        got, _ = upd_ops.repair_level_plain(
            torch.from_numpy(x), torch.zeros(c * m, dtype=torch.int32),
            torch.from_numpy(ids), c, track=False)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_update_level_with_positions(self):
        rng = np.random.default_rng(1)
        c, m, b = 16, 32, 9
        x = rng.integers(0, 3, c * m).astype(np.float32)  # many ties
        p = np.arange(c * m, dtype=np.int32)
        ids = rng.integers(0, m, b).astype(np.int32)
        wv, wp = jkernel.update_level_with_positions(
            jnp.asarray(x), jnp.asarray(p), jnp.asarray(ids), c=c,
            interpret=True)
        gv, gp = upd_ops.repair_level_plain(
            torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(ids),
            c, track=True)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))

    def test_update_level0_with_positions(self):
        rng = np.random.default_rng(2)
        c, m, cap, b = 8, 16, 123, 11  # capacity not chunk-aligned
        x = rng.integers(0, 2, cap).astype(np.float32)
        padded = np.full(c * m, np.inf, np.float32)
        padded[:cap] = x
        ids = rng.integers(0, m, b).astype(np.int32)
        wv, wp = jkernel.update_level0_with_positions(
            jnp.asarray(padded), jnp.asarray(ids), c=c, cap=cap,
            pos_dtype=jnp.int32, interpret=True)
        gv, gp = upd_ops.repair_level_plain(
            torch.from_numpy(x), None, torch.from_numpy(ids), c, track=True)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))

    @pytest.mark.parametrize("n,c,t,cap", PLANS)
    def test_one_launch_per_upper_level(self, n, c, t, cap):
        """The cuda route records hierarchy_update L - 1 times per update
        and per append (the plain path on the CPU records the same)."""
        rng = np.random.default_rng(n)
        plan = make_plan(n, c=c, t=t, capacity=cap)
        h = build_hierarchy(torch.from_numpy(tied_input(rng, n)), plan, True)
        idxs, vals = _batch(rng, plan.capacity, 64)
        before = upd_ops.LAUNCHES.launches
        with count_launches() as counts:
            h = upd_ops.update_hierarchy_cuda(h, idxs, vals)
        assert counts == ({"hierarchy_update": plan.num_levels - 1}
                          if plan.num_levels > 1 else {})
        if plan.capacity > n:
            with count_launches() as counts:
                upd_ops.append_hierarchy_cuda(h, vals[:5], n)
            assert counts == {"hierarchy_update": plan.num_levels - 1}
        with count_launches() as counts:
            U.update_hierarchy(h, idxs, vals)  # the eager route: no kernel
        assert counts == {}
        assert upd_ops.LAUNCHES.launches == before  # no CUDA launch here

    def test_facade_routes(self):
        """cuda mutates through B6; fused through cuda on a card and eager
        on the CPU; eager never launches."""
        assert px.mutation_backend("fused", "cpu") == "eager"
        assert px.mutation_backend("fused", "cuda") == "cuda"
        assert px.mutation_backend("cuda", "cpu") == "cuda"
        x = tied_input(np.random.default_rng(0), 3000)
        for backend, want in (("cuda", 2), ("fused", 0), ("eager", 0)):
            r = RMQ.build(x, c=16, t=4, backend=backend, device="cpu")
            with count_launches() as counts:
                r.update([1, 2], [0.0, 0.0])
            assert counts.get("hierarchy_update", 0) == want, backend


class TestRMQFacadeStreaming:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_update_and_append_via_facade(self, backend):
        rng = np.random.default_rng(21)
        n, cap = 3000, 5000
        x = tied_input(rng, n)
        r = RMQ.build(x, c=16, t=8, with_positions=True, backend=backend,
                      capacity=cap, device="cpu")
        jr = JRMQ.build(x, c=16, t=8, with_positions=True, backend="jax",
                        capacity=cap)
        idxs, vals = _batch(rng, n, 40)
        idxs = idxs.clip(0, n - 1)
        r2 = r.update(idxs, vals)
        jr2 = jr.update(jnp.asarray(idxs, jnp.int32), jnp.asarray(vals))
        tail = rng.random(500).astype(np.float32)
        r3, jr3 = r2.append(tail), jr2.append(jnp.asarray(tail))
        assert (r3.n, r3.generation) == (jr3.n, jr3.generation) == (3500, 2)
        _assert_same(r3.hierarchy, jr3.hierarchy)
        ls, rs = query_batch(rng, r3.n, 16)
        np.testing.assert_array_equal(r3.query(ls, rs).numpy(),
                                      np.asarray(jr3.query(ls, rs)))
        np.testing.assert_array_equal(r3.query_index(ls, rs).numpy(),
                                      np.asarray(jr3.query_index(ls, rs)))
        # the predecessor still answers for its own data
        lq, rq = query_batch(rng, n, 16)
        np.testing.assert_array_equal(r.query(lq, rq).numpy(),
                                      brute_force(x, lq, rq)[0])

    def test_append_without_capacity_raises(self):
        r = RMQ.build(np.ones(64, np.float32), c=8, t=1, device="cpu")
        with pytest.raises(ValueError, match="capacity"):
            r.append(np.ones(1, np.float32))


class TestOutOfRangeUpdates:
    @pytest.mark.parametrize("backend", ["eager", "cuda"])
    def test_oob_update_is_a_noop(self, backend):
        rng = np.random.default_rng(9)
        n, c, t = 4096, 16, 4
        x = rng.random(n).astype(np.float32)
        x[1600] = 0.01
        plan = make_plan(n, c=c, t=t)
        h0 = build_hierarchy(torch.from_numpy(x), plan, True)
        oob = torch.tensor([n + 100, -5, 2 * n, -1, -n])
        h1 = _update(backend, h0, oob, torch.full((5,), 0.5))
        for name in ("base", "upper", "upper_pos"):
            assert torch.equal(getattr(h0, name), getattr(h1, name))
        jh = jupdate(jbuild(jnp.asarray(x), jmake_plan(n, c=c, t=t),
                            with_positions=True),
                     jnp.asarray(oob.numpy(), jnp.int32),
                     jnp.full((5,), 0.5, jnp.float32))
        _assert_same(h1, jh)

    def test_mixed_oob_and_valid_updates(self):
        rng = np.random.default_rng(10)
        n = 1000
        x = rng.random(n).astype(np.float32)
        plan = make_plan(n, c=8, t=2)
        h = build_hierarchy(torch.from_numpy(x), plan, True)
        h = U.update_hierarchy(h, torch.tensor([5, n + 7, 900, -2]),
                               torch.tensor([0.001, 0.002, 0.003, 0.004]))
        x[5], x[900] = 0.001, 0.003
        _assert_same(h, jbuild(jnp.asarray(x), jmake_plan(n, c=8, t=2),
                               with_positions=True))


class TestValidationMessages:
    """The shared validators' text, byte for byte the reference's."""

    @pytest.fixture(scope="class")
    def pairs(self):
        x = np.random.default_rng(2).random(900).astype(np.float32)
        return [
            (RMQ.build(x, c=16, t=4, capacity=1200, device="cpu"),
             JRMQ.build(x, c=16, t=4, backend="jax", capacity=1200)),
            (StreamingRMQ.from_array(x, c=16, t=4, capacity=1200,
                                     device="cpu"),
             JStreaming.from_array(x, c=16, t=4, backend="jax",
                                   capacity=1200)),
        ]

    @pytest.mark.parametrize("exc,call", [
        (ValueError, lambda i: i.update(np.array([1, 2]),
                                        np.array([0.5], np.float32))),
        (TypeError, lambda i: i.update(np.array([0.5], np.float32),
                                       np.array([1.0], np.float32))),
        (ValueError, lambda i: i.update(np.zeros((3, 1), np.int32),
                                        np.zeros((3, 1), np.float32))),
        (ValueError, lambda i: i.append(np.zeros(301, np.float32))),
        (ValueError, lambda i: i.append(np.zeros((2, 2), np.float32))),
    ])
    def test_message_identical(self, pairs, exc, call):
        for port, ref in pairs:
            with pytest.raises(exc) as got:
                call(port)
            with pytest.raises(exc) as want:
                call(ref)
            assert str(got.value) == str(want.value)

    def test_oob_rejected_in_debug_mode(self, pairs, monkeypatch):
        monkeypatch.setenv("REPRO_RMQ_DEBUG", "1")
        for port, ref in pairs:
            for idx in ([1000], [-1]):
                with pytest.raises(ValueError, match="out of range") as got:
                    port.update(np.asarray(idx, np.int32),
                                np.asarray([0.5], np.float32))
                with pytest.raises(ValueError) as want:
                    ref.update(jnp.asarray(idx, jnp.int32),
                               jnp.asarray([0.5], jnp.float32))
                assert str(got.value) == str(want.value)
