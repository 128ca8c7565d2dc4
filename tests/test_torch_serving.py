"""The port's serving tier against the reference's, on the CPU.

Mirrors ``tests/test_serving.py`` class by class.  Each scenario runs
once through ``repro.serving`` and once through ``repro_torch.serving``
under its own ``FakeClock`` following one script (submits, mutations,
clock advances, manual ``step`` / ``drain``), over fused indexes built
from the same numpy input.  The scenario returns what it observed: every
answer (compared as integer views, tolerance 0: min and argmin are
exact), the sequence of ``FlushEvent`` s (tenant, generation, reason,
requests, applied mutations), every ``Backpressure`` (reason and
``retry_after``), ticket generations and the tier's counters and
histograms; all must be equal between the two packages.  The threaded
stress test races real threads against the port alone and checks every
ticket against a numpy replay of the mutation log at the ticket's
generation.  The launch contract, one ``rmq_fused`` launch per drained
flush of a mixed backlog, is counted by the port's ``count_launches`` on
the plain path.
"""

import asyncio
import sys
import threading
import time
import types

import jax  # noqa: F401  (both frameworks at the top; JAX stays on the CPU)
import numpy as np
import pytest
import torch

import repro.serving as jserving
from repro.core.api import RMQ as JRMQ
from repro.qe import QueryService as JService
from repro.serving.aio import AsyncServingTier as JAsyncTier
import repro_torch.serving as serving
from repro_torch.core import RMQ
from repro_torch.kernels.profiling import count_launches
from repro_torch.qe import QueryService
from repro_torch.serving import AsyncServingTier

INDEX, VALUE = "index", "value"


def _ref_build(x, with_positions=True):
    return JRMQ.build(x, c=8, t=2, with_positions=with_positions,
                      backend="fused")


def _port_build(x, with_positions=True):
    return RMQ.build(x, c=8, t=2, with_positions=with_positions,
                     backend="fused", device="cpu")


REF = types.SimpleNamespace(build=_ref_build, QueryService=JService,
                            AsyncServingTier=JAsyncTier, **{
                                k: getattr(jserving, k)
                                for k in jserving.__all__
                                if k != "AsyncServingTier"})
PORT = types.SimpleNamespace(build=_port_build, QueryService=QueryService,
                             AsyncServingTier=AsyncServingTier, **{
                                 k: getattr(serving, k)
                                 for k in serving.__all__
                                 if k != "AsyncServingTier"})


def _tied_values(rng, n):
    """Integer-valued floats: ties make leftmost-position breaks decisive."""
    return rng.integers(-4, 4, n).astype(np.float32)


def _random_spans(rng, n, m):
    ls = rng.integers(0, n, m)
    rs = np.minimum(ls + rng.integers(0, n, m), n - 1)
    return (np.minimum(ls, rs).astype(np.int32),
            np.maximum(ls, rs).astype(np.int32))


class FakeClock:
    def __init__(self, now=0.0):
        self.now = float(now)

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt
        return self.now


def _ints(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    a = np.asarray(a)
    return a.view({4: np.int32, 8: np.int64}[a.itemsize]) \
        if a.dtype.kind == "f" else a


def _event(ev):
    return (ev.tenant, ev.generation, ev.reason, ev.requests,
            ev.applied_mutations)


def _tier_state(tier):
    """The tier's counters and histograms, the snapshot slots' state and
    the service's counters (engine internals left out)."""
    s = tier.stats()
    svc = {k: v for k, v in s["service"].items() if k != "engines"}
    return {"steps": s["steps"], "flusher_errors": s["flusher_errors"],
            "tenants": s["tenants"], "service": svc}


def both(scenario):
    """Run ``scenario(P)`` for both packages; every observation equal."""
    got, want = scenario(PORT), scenario(REF)
    assert set(got) == set(want)
    for key in got:
        g, w = got[key], want[key]
        if key.startswith("answer"):
            assert len(g) == len(w), key
            for k, (a, b) in enumerate(zip(g, w)):
                if isinstance(a, torch.Tensor):
                    assert a.device.type == "cpu"
                np.testing.assert_array_equal(_ints(a), _ints(b),
                                              err_msg=f"{key}[{k}]")
        else:
            assert g == w, key
    return got


def _oracle_replay(base, mutation_log):
    """generation -> quiesced array, applying staged batches in order
    (sequential writes: duplicate indices are last-wins)."""
    snaps = {0: base.copy()}
    arr = base.copy()
    for gen, (idxs, vals) in enumerate(mutation_log, start=1):
        arr = arr.copy()
        for i, v in zip(idxs, vals):
            arr[int(i)] = v
        snaps[gen] = arr
    return snaps


# ---------------------------------------------------------------------------
# SnapshotSlot: the double buffer on its own
# ---------------------------------------------------------------------------
class TestSnapshotSlot:
    def test_stage_is_invisible_until_swap(self):
        x = _tied_values(np.random.default_rng(0), 300)

        def scenario(P):
            slot = P.SnapshotSlot(P.build(x))
            old_front = slot.front
            slot.stage_update(np.array([3], np.int32),
                              np.array([-99.0], np.float32))
            slot.stage_update(np.array([7], np.int32),
                              np.array([-98.0], np.float32))
            assert slot.front is old_front
            staged = slot.staged
            front, applied = slot.swap()
            assert front is slot.front is not old_front
            assert slot.swap() == (front, 0)        # idempotent when empty
            return {"staged": staged, "applied": applied,
                    "stats": slot.stats(),
                    "answer": [front.query(np.array([0, 3, 7]),
                                           np.array([299, 3, 7]))]}

        got = both(scenario)
        assert got["stats"]["generation"] == 2 and got["applied"] == 2

    def test_pinned_reader_keeps_old_front_across_swap(self):
        x = _tied_values(np.random.default_rng(1), 300)

        def scenario(P):
            slot = P.SnapshotSlot(P.build(x))
            snap = slot.pin()
            pins = slot.pins
            slot.stage_update(np.array([0], np.int32),
                              np.array([-99.0], np.float32))
            slot.swap()
            assert snap.index is not slot.front
            out = {"pins": pins, "snap_gen": snap.generation,
                   "slot_gen": slot.generation,
                   "answer": [snap.index.query(np.array([0]),
                                               np.array([0])),
                              slot.front.query(np.array([0]),
                                               np.array([0]))]}
            snap.release()
            out["after"] = slot.pins
            return out

        got = both(scenario)
        assert (got["pins"], got["snap_gen"], got["slot_gen"],
                got["after"]) == (1, 0, 1, 0)

    def test_release_without_pin_raises(self):
        for P in (PORT, REF):
            slot = P.SnapshotSlot(P.build(np.zeros(64, np.float32)))
            with pytest.raises(RuntimeError, match="matching pin"):
                slot._release()

    def test_replace_supersedes_earlier_staged_ops(self):
        rng = np.random.default_rng(2)
        x, y = _tied_values(rng, 300), _tied_values(rng, 300)

        def scenario(P):
            slot = P.SnapshotSlot(P.build(x))
            slot.stage_update(np.array([0], np.int32),
                              np.array([-99.0], np.float32))
            slot.stage_replace(P.build(y))
            slot.stage_update(np.array([5], np.int32),
                              np.array([-77.0], np.float32))
            front, applied = slot.swap()
            return {"applied": applied, "stats": slot.stats(),
                    "answer": [front.query(np.array([0, 5]),
                                           np.array([0, 5]))]}

        got = both(scenario)
        assert got["applied"] == 2
        assert _ints(got["answer"][0]).tolist() == _ints(
            np.array([y[0], -77.0], np.float32)).tolist()


# ---------------------------------------------------------------------------
# deterministic scheduler: fake clock + manual step()
# ---------------------------------------------------------------------------
def _tier(P, clock, x=None, events=None, **tenant_kw):
    tier = P.ServingTier(clock=clock, on_flush=(
        None if events is None else lambda ev: events.append(_event(ev))))
    if x is not None:
        tier.register_tenant("a", P.build(x), **tenant_kw)
    return tier


class TestDeadlineScheduler:
    def test_deadline_flush_fires_at_slo_not_before(self):
        x = _tied_values(np.random.default_rng(3), 500)

        def scenario(P):
            clock, events = FakeClock(), []
            tier = _tier(P, clock, x, events, slo_ms=5.0)
            tk = tier.submit("a", np.array([0]), np.array([499]))
            nxt = tier.step(clock.advance(0.004))
            early = tk.done()
            tier.step(clock.advance(0.0015))
            return {"next": nxt, "early": early, "events": events,
                    "answer": [tk.result(0)], "state": _tier_state(tier)}

        got = both(scenario)
        assert got["next"] == pytest.approx(0.005) and not got["early"]
        t = got["state"]["tenants"]["a"]
        assert (t["flushes"], t["flushes_deadline"], t["flushes_size"]) == (
            1, 1, 0)

    def test_size_flush_fires_before_deadline(self):
        rng = np.random.default_rng(4)
        x = _tied_values(rng, 500)
        ls, rs = _random_spans(rng, 500, 8)

        def scenario(P):
            clock, events = FakeClock(), []
            tier = _tier(P, clock, x, events, slo_ms=1000.0, max_queue=64,
                         max_batch=8)
            tks = [tier.submit("a", ls[i:i + 4], rs[i:i + 4])
                   for i in (0, 4)]
            tier.step(clock.now)
            assert all(tk.done() for tk in tks)
            return {"events": events,
                    "answer": [tk.result(0) for tk in tks],
                    "state": _tier_state(tier)}

        got = both(scenario)
        assert got["events"] == [("a", 0, "size", 2, 0)]

    def test_mutation_only_flush_swaps_on_slo(self):
        x = _tied_values(np.random.default_rng(5), 500)
        pos = int(np.argmin(x))

        def scenario(P):
            clock, events = FakeClock(), []
            tier = _tier(P, clock, x, events, slo_ms=5.0)
            tier.update("a", np.array([pos], np.int32),
                        np.array([50.0], np.float32))
            tier.step(clock.advance(0.003))
            swaps_early = tier.stats()["tenants"]["a"]["snapshot_swaps"]
            tier.step(clock.advance(0.003))
            tk = tier.submit("a", np.array([0]), np.array([499]))
            tier.drain("a")
            return {"early": swaps_early, "events": events,
                    "generation": tk.generation, "answer": [tk.result(0)],
                    "state": _tier_state(tier)}

        got = both(scenario)
        assert got["early"] == 0 and got["generation"] == 1
        assert got["events"] == [("a", 1, "mutation", 0, 1),
                                 ("a", 1, "forced", 1, 0)]

    def test_step_reports_earliest_deadline_across_tenants(self):
        rng = np.random.default_rng(6)
        xs = _tied_values(rng, 200), _tied_values(rng, 200)

        def scenario(P):
            clock = FakeClock()
            tier = P.ServingTier(clock=clock)
            idle = tier.step(clock.now)
            tier.register_tenant("slow", P.build(xs[0]), slo_ms=50.0)
            tier.register_tenant("fast", P.build(xs[1]), slo_ms=2.0)
            tier.submit("slow", np.array([0]), np.array([10]))
            tier.submit("fast", np.array([0]), np.array([10]))
            return {"idle": idle, "next": tier.step(clock.now)}

        got = both(scenario)
        assert got["idle"] is None and got["next"] == pytest.approx(0.002)

    def test_drain_resolves_everything_now(self):
        rng = np.random.default_rng(7)
        x = _tied_values(rng, 500)
        ls, rs = _random_spans(rng, 500, 6)

        def scenario(P):
            clock, events = FakeClock(), []
            tier = _tier(P, clock, x, events, slo_ms=1000.0)
            tk_v = tier.submit("a", ls, rs, VALUE)
            tk_i = tier.submit("a", ls, rs, INDEX)
            drained = tier.drain("a")
            again = tier.drain("a")
            return {"drained": (drained, again), "events": events,
                    "answer": [tk_v.result(0), tk_i.result(0)],
                    "state": _tier_state(tier)}

        got = both(scenario)
        assert got["drained"] == (2, 0)
        np.testing.assert_array_equal(
            got["answer"][1].numpy(),
            [l + int(np.argmin(x[l:r + 1])) for l, r in zip(ls, rs)])

    def test_drained_mixed_flush_is_one_fused_launch(self):
        """A drained flush of a mixed backlog of up to max_batch =
        max_bucket spans on a fused tenant is ONE rmq_fused launch."""
        rng = np.random.default_rng(8)
        n = 5000
        x = _tied_values(rng, n)
        clock = FakeClock()
        tier = PORT.ServingTier(clock=clock)
        tier.register_tenant("a", _port_build(x), slo_ms=5.0,
                             max_batch=4096, max_queue=8192, cache_size=0)
        reqs = []
        for i in range(64):
            ls, rs = _random_spans(rng, n, 64)
            op = INDEX if i % 2 else VALUE
            reqs.append((tier.submit("a", ls, rs, op), ls, rs, op))
        with count_launches() as counts:
            tier.step(clock.now)
        assert counts == {"rmq_fused": 1}
        tier.update("a", np.array([5], np.int32),
                    np.array([-9.0], np.float32))
        for tk, ls, rs, op in reqs[:4]:
            got = tk.result(0).numpy()
            want = ([x[l:r + 1].min() for l, r in zip(ls, rs)]
                    if op == VALUE else
                    [l + int(np.argmin(x[l:r + 1])) for l, r in zip(ls, rs)])
            np.testing.assert_array_equal(got, want)
        # a staged update swaps in first, then one launch answers
        tk = tier.submit("a", np.array([0, 3]), np.array([n - 1, 9]), INDEX)
        with count_launches() as counts:
            tier.drain("a")
        assert counts == {"rmq_fused": 1}
        assert tk.generation == 1 and int(tk.result(0)[1]) == 5
        assert tk._event is None          # CPU answers need no event


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------
class TestAdmission:
    def test_tenant_config_validation(self):
        for P in (PORT, REF):
            with pytest.raises(ValueError, match="slo_ms"):
                P.TenantConfig(slo_ms=0.0)
            with pytest.raises(ValueError, match="max_batch"):
                P.TenantConfig(max_queue=4, max_batch=8)
            with pytest.raises(ValueError, match="quota_qps"):
                P.TenantConfig(quota_qps=-1.0)
        assert (PORT.TenantConfig().__dict__ == REF.TenantConfig().__dict__)

    def test_queue_bound_rejects_with_retry_after(self):
        rng = np.random.default_rng(9)
        x = _tied_values(rng, 300)
        ls, rs = _random_spans(rng, 300, 8)

        def scenario(P):
            clock = FakeClock()
            tier = _tier(P, clock, x, slo_ms=5.0, max_queue=8, max_batch=8)
            tier.submit("a", ls, rs)
            clock.advance(0.001)
            with pytest.raises(P.Backpressure) as ei:
                tier.submit("a", np.array([0]), np.array([1]))
            tier.drain("a")
            tk = tier.submit("a", np.array([0]), np.array([1]))
            tier.drain("a")
            e = ei.value
            return {"rejection": (e.tenant, e.reason, e.retry_after,
                                  str(e)),
                    "answer": [tk.result(0)], "state": _tier_state(tier)}

        got = both(scenario)
        assert got["rejection"][1] == "queue_full"
        assert 0 < got["rejection"][2] <= 0.006

    def test_quota_token_bucket_refills_with_clock(self):
        rng = np.random.default_rng(10)
        x = _tied_values(rng, 300)
        ls, rs = _random_spans(rng, 300, 4)

        def scenario(P):
            clock = FakeClock()
            tier = _tier(P, clock, x, quota_qps=100.0, quota_burst=4.0)
            tier.submit("a", ls, rs)
            with pytest.raises(P.Backpressure) as ei:
                tier.submit("a", np.array([0]), np.array([1]))
            clock.advance(0.05)
            tier.submit("a", ls, rs)
            return {"rejection": (ei.value.reason, ei.value.retry_after),
                    "state": _tier_state(tier)}

        got = both(scenario)
        assert got["rejection"] == ("quota", pytest.approx(0.01))

    def test_registry_errors(self):
        rng = np.random.default_rng(11)
        x = _tied_values(rng, 200)
        for P in (PORT, REF):
            tier = P.ServingTier()
            tier.register_tenant("a", P.build(x))
            with pytest.raises(ValueError, match="already registered"):
                tier.register_tenant("a", P.build(x))
            with pytest.raises(KeyError, match="no tenant"):
                tier.submit("nope", np.array([0]), np.array([1]))
            with pytest.raises(KeyError):
                tier.tenant_config("nope")
            with pytest.raises(ValueError, match="tuning"):
                P.ServingTier(service=P.QueryService(), tuning=object())

    def test_unregister_drains_then_rejects(self):
        x = _tied_values(np.random.default_rng(12), 300)

        def scenario(P):
            tier = _tier(P, FakeClock(), x, slo_ms=1000.0)
            tk = tier.submit("a", np.array([0]), np.array([299]))
            tier.unregister_tenant("a")
            with pytest.raises(KeyError):
                tier.submit("a", np.array([0]), np.array([1]))
            return {"answer": [tk.result(0)], "tenants": list(
                tier.stats()["tenants"])}

        assert float(both(scenario)["answer"][0][0]) == x.min()


# ---------------------------------------------------------------------------
# oversized read-only submissions: bulk routing instead of rejection
# ---------------------------------------------------------------------------
class TestOversizedSubmissions:
    def test_oversized_submission_resolves_via_bulk(self):
        rng = np.random.default_rng(30)
        n = 600
        x = _tied_values(rng, n)
        ls, rs = _random_spans(rng, n, 256)

        def scenario(P):
            tier = _tier(P, FakeClock(), x, max_queue=64, max_batch=32,
                         bulk_crossover=1, cache_size=0)
            tk = tier.submit("a", ls, rs)
            done = tk.done()
            tk_i = tier.submit("a", ls, rs, INDEX)
            return {"done": done, "generations": (tk.generation,
                                                  tk_i.generation),
                    "answer": [tk.result(0), tk_i.result(0)],
                    "state": _tier_state(tier)}

        got = both(scenario)
        assert got["done"] and got["generations"] == (0, 0)
        t = got["state"]["tenants"]["a"]
        assert (t["bulk_routed"], t["flushes"], t["queued_queries"]) == (
            2, 0, 0)

    def test_oversized_reads_current_generation_not_staged(self):
        rng = np.random.default_rng(31)
        n = 500
        x = _tied_values(rng, n)
        pos = int(np.argmin(x))
        ls, rs = np.zeros(64, np.int32), np.full(64, n - 1, np.int32)

        def scenario(P):
            tier = _tier(P, FakeClock(), x, max_batch=16,
                         bulk_crossover=1, cache_size=0)
            tier.update("a", np.array([pos], np.int32),
                        np.array([99.0], np.float32))
            tk = tier.submit("a", ls, rs)
            staged = tier.stats()["tenants"]["a"]["snapshot"]["staged"]
            tier.drain("a")
            tk2 = tier.submit("a", ls, rs)
            return {"staged": staged,
                    "generations": (tk.generation, tk2.generation),
                    "answer": [tk.result(0), tk2.result(0)],
                    "state": _tier_state(tier)}

        got = both(scenario)
        assert got["staged"] == 1 and got["generations"] == (0, 1)

    def test_oversized_still_pays_quota(self):
        rng = np.random.default_rng(32)
        x = _tied_values(rng, 300)
        ls, rs = _random_spans(rng, 300, 32)

        def scenario(P):
            tier = _tier(P, FakeClock(), x, max_batch=8, quota_qps=100.0,
                         quota_burst=16.0)
            with pytest.raises(P.Backpressure) as ei:
                tier.submit("a", ls, rs)
            return {"rejection": (ei.value.reason, ei.value.retry_after),
                    "state": _tier_state(tier)}

        got = both(scenario)
        assert got["rejection"][0] == "quota"
        assert got["state"]["tenants"]["a"]["bulk_routed"] == 0

    def test_small_submissions_still_queue_alongside_bulk(self):
        rng = np.random.default_rng(33)
        n = 400
        x = _tied_values(rng, n)
        big_ls, big_rs = _random_spans(rng, n, 64)

        def scenario(P):
            clock, events = FakeClock(), []
            tier = _tier(P, clock, x, events, slo_ms=5.0, max_batch=16,
                         bulk_crossover=1, cache_size=0)
            small = tier.submit("a", np.array([0]), np.array([n - 1]))
            big = tier.submit("a", big_ls, big_rs)
            assert big.done() and not small.done()
            tier.step(clock.advance(0.006))
            return {"events": events,
                    "answer": [small.result(0), big.result(0)],
                    "state": _tier_state(tier)}

        got = both(scenario)
        assert got["events"] == [("a", 0, "deadline", 1, 0)]


# ---------------------------------------------------------------------------
# snapshot isolation
# ---------------------------------------------------------------------------
class TestSnapshotIsolation:
    def test_mutation_admitted_mid_flush_does_not_change_answers(self):
        x = _tied_values(np.random.default_rng(12), 600)
        pos = int(np.argmin(x))

        def scenario(P):
            clock, events = FakeClock(), []
            holder = {}

            def mid_flush(ev):
                events.append(_event(ev))
                if len(events) == 1:
                    # admitted mid-flush: this flush pinned generation 0
                    holder["tier"].update("a", np.array([pos], np.int32),
                                          np.array([99.0], np.float32))

            tier = P.ServingTier(clock=clock, on_flush=mid_flush)
            holder["tier"] = tier
            tier.register_tenant("a", P.build(x), slo_ms=5.0)
            tk1 = tier.submit("a", np.array([0]), np.array([599]))
            tier.step(clock.advance(0.006))
            tk2 = tier.submit("a", np.array([0]), np.array([599]))
            tier.step(clock.advance(0.006))
            return {"events": events,
                    "generations": (tk1.generation, tk2.generation),
                    "answer": [tk1.result(0), tk2.result(0)],
                    "state": _tier_state(tier)}

        got = both(scenario)
        assert got["generations"] == (0, 1)
        assert got["events"] == [("a", 0, "deadline", 1, 0),
                                 ("a", 1, "deadline", 1, 1)]
        assert float(got["answer"][0][0]) == x.min()

    def test_threaded_stress_differential_vs_generation_oracle(self):
        """Real threads, real clock, the port alone: concurrent submitters
        and a mutator against the running tier; every ticket equals a
        numpy oracle replayed at its recorded generation."""
        rng = np.random.default_rng(13)
        n = 1500
        x = _tied_values(rng, n)
        tier = serving.ServingTier(idle_tick=0.001)
        tier.register_tenant("a", _port_build(x), slo_ms=2.0,
                             max_queue=1 << 14, cache_size=0)
        mutation_log, answered = [], []
        ans_lock = threading.Lock()
        stop = threading.Event()

        def mutator():
            mrng = np.random.default_rng(14)
            while not stop.is_set():
                idxs = mrng.integers(0, n, 4).astype(np.int32)
                vals = _tied_values(mrng, 4)
                mutation_log.append((idxs, vals))
                tier.update("a", idxs, vals)
                time.sleep(0.002)

        def reader(seed):
            rrng = np.random.default_rng(seed)
            got = []
            for j in range(8):
                ls, rs = _random_spans(rrng, n, 6)
                op = INDEX if j % 2 else VALUE
                tk = tier.submit("a", ls, rs, op)
                got.append((tk, ls, rs, op,
                            tk.result(timeout=30.0).numpy()))
            with ans_lock:
                answered.extend(got)

        readers = [threading.Thread(target=reader, args=(20 + i,))
                   for i in range(3)]
        mut = threading.Thread(target=mutator)
        t0 = time.monotonic()
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)   # switch threads often: shake races
        try:
            with tier:
                mut.start()
                for r in readers:
                    r.start()
                for r in readers:
                    r.join(30.0)
                stop.set()
                mut.join(30.0)
        finally:
            sys.setswitchinterval(interval)
        assert not mut.is_alive()
        assert not any(r.is_alive() for r in readers)
        assert time.monotonic() - t0 < 10.0
        snaps = _oracle_replay(x, mutation_log)
        for tk, ls, rs, op, res in answered:
            arr = snaps[tk.generation]
            for l, r, v in zip(ls, rs, res):
                want = (arr[l:r + 1].min() if op == VALUE
                        else l + int(np.argmin(arr[l:r + 1])))
                assert v == want, (tk.generation, op, l, r, v, want)
        assert len(answered) == 24
        s = tier.stats()
        assert s["tenants"]["a"]["snapshot_swaps"] > 0
        assert s["flusher_errors"] == 0

    def test_async_pump_two_tenants(self):
        """The asyncio front end: two tenants, a mutator, every answer
        against the oracle at its generation (both packages)."""
        rng = np.random.default_rng(40)
        n = 600
        xa, xb = _tied_values(rng, n), _tied_values(rng, n)

        def scenario(P):
            tier = P.ServingTier(idle_tick=0.002)
            tier.register_tenant("a", P.build(xa), slo_ms=2.0)
            tier.register_tenant("b", P.build(xb), slo_ms=20.0)
            aio = P.AsyncServingTier(tier)
            log, muts = [], []

            async def main():
                stop = asyncio.Event()
                pump = asyncio.create_task(aio.pump(stop))
                qrng = np.random.default_rng(41)
                for j in range(12):
                    idxs = qrng.integers(0, n, 3).astype(np.int32)
                    vals = _tied_values(qrng, 3)
                    muts.append((idxs, vals))
                    aio.update("b", idxs, vals)
                    for name in ("a", "b"):
                        ls, rs = _random_spans(qrng, n, 5)
                        op = INDEX if j % 2 else VALUE
                        t = aio.submit(name, ls, rs, op=op)
                        log.append((name, t, ls, rs, op, await aio.wait(t)))
                    res = await aio.query("a", np.array([0]),
                                          np.array([n - 1]))
                    assert float(res[0]) == xa.min()
                stop.set()
                await pump

            asyncio.run(main())
            snaps = _oracle_replay(xb, muts)
            for name, t, ls, rs, op, res in log:
                arr = xa if name == "a" else snaps[t.generation]
                for l, r, v in zip(ls, rs, np.asarray(res)):
                    want = (arr[l:r + 1].min() if op == VALUE
                            else l + int(np.argmin(arr[l:r + 1])))
                    assert v == want
            with pytest.raises(RuntimeError, match="one driver"):
                tier.start()
                try:
                    asyncio.run(aio.pump())
                finally:
                    tier.stop()
            return {"requests": len(log)}

        assert both(scenario)["requests"] == 24


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
class TestTelemetry:
    def test_metrics_shim_is_the_obs_registry(self):
        from repro_torch.obs import metrics as obs_metrics
        from repro_torch.serving import metrics as shim

        assert shim.__all__ == jserving.metrics.__all__
        for name in shim.__all__:
            assert getattr(shim, name) is getattr(obs_metrics, name)
        m = shim.Metrics()
        h = m.histogram("lat", (0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 0.5, 20.0):
            h.record(v)
        jm = jserving.Metrics()
        jh = jm.histogram("lat", (0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 0.5, 20.0):
            jh.record(v)
        assert m.as_dict() == jm.as_dict()

    def test_tier_stats_and_prometheus_text(self):
        x = _tied_values(np.random.default_rng(15), 400)

        def scenario(P):
            clock = FakeClock()
            tier = _tier(P, clock, x, slo_ms=5.0)
            tk = tier.submit("a", np.array([0, 5]), np.array([9, 50]))
            tier.step(clock.advance(0.01))
            tk.result(0)
            prom = tier.metrics.to_prometheus()
            names = sorted({line.split("{")[0].split(" ")[0]
                            for line in prom.splitlines()
                            if not line.startswith("#")})
            return {"names": names, "answer": [tk.result(0)],
                    "state": _tier_state(tier)}

        got = both(scenario)
        t = got["state"]["tenants"]["a"]
        assert (t["submits"], t["submitted_queries"], t["flushes"]) == (
            1, 2, 1)
        assert t["snapshot"]["pins"] == 0
        assert got["state"]["service"]["flushes"] == 1
        assert "repro_tenants_latency_s_bucket" in got["names"]

    def test_tier_counts_service_result_drops(self):
        x = _tied_values(np.random.default_rng(16), 400)

        def scenario(P):
            svc = P.QueryService(auto_flush=False, max_unclaimed=1)
            tier = P.ServingTier(service=svc)
            tier.register_tenant("a", P.build(x))
            for i in range(3):
                svc.submit("a", np.array([i]), np.array([i + 5]))
                svc.flush(names=("a",))
            return {"state": _tier_state(tier)}

        got = both(scenario)
        assert got["state"]["tenants"]["a"]["dropped_results"] == 2

    def test_tier_flush_span_tree(self):
        from repro.obs.trace import Tracer as JTracer
        from repro.obs.trace import use_tracer as juse
        from repro_torch.obs.trace import Tracer, use_tracer

        x = np.random.default_rng(3).random(256).astype(np.float32)

        def scenario(P):
            clock = FakeClock()
            tracer, use = ((Tracer(clock=clock), use_tracer) if P is PORT
                           else (JTracer(clock=clock), juse))
            tier = _tier(P, clock, x, slo_ms=5.0, cache_size=0)
            with use(tracer):
                for op in (VALUE, INDEX):
                    tier.submit("a", np.array([1, 9], np.int32),
                                np.array([6, 200], np.int32), op)
                    clock.advance(0.001)
                tier.drain("a")
            return {"spans": [(s.name, s.start, s.end) for s in
                              tracer.spans()]}

        names = {s[0] for s in both(scenario)["spans"]}
        assert {"submit", "admission", "queue", "flush", "snapshot_swap",
                "service_flush", "plan", "execute", "scatter"} <= names


# ---------------------------------------------------------------------------
# QueryService regressions, through the tier's service
# ---------------------------------------------------------------------------
class TestServiceRegressions:
    def test_selective_flush_leaves_other_tenants_queued(self):
        rng = np.random.default_rng(21)
        xa, xb = _tied_values(rng, 400), _tied_values(rng, 400)

        def scenario(P):
            svc = P.QueryService(auto_flush=False)
            svc.register("a", P.build(xa))
            svc.register("b", P.build(xb))
            t_a = svc.submit("a", np.array([0]), np.array([399]))
            t_b = svc.submit("b", np.array([0]), np.array([399]))
            res = svc.flush(names=("a",))
            pending = svc.stats()["pending_requests"]
            with pytest.raises(KeyError):
                svc.take(t_b)
            svc.flush(names=("b",))
            return {"keys": sorted(res), "pending": pending,
                    "answer": [res[t_a], svc.take(t_b)]}

        got = both(scenario)
        assert got["pending"] == 1 and len(got["keys"]) == 1

    def test_mixed_retry_with_real_op_failure_through_the_tier(self):
        """A value-only successor lands after admission: the tier resolves
        the healthy value tickets and fails the index tickets with the
        flush error, in both packages."""
        rng = np.random.default_rng(19)
        x = _tied_values(rng, 900)

        def scenario(P):
            clock, events = FakeClock(), []
            tier = _tier(P, clock, x, events, slo_ms=5.0, cache_size=0)
            t_v = tier.submit("a", np.array([0]), np.array([899]))
            t_i = tier.submit("a", np.array([1]), np.array([50]), INDEX)
            tier.replace_index("a", P.build(x, with_positions=False))
            tier.step(clock.advance(0.006))
            err = t_i.exception(0)
            return {"events": events, "answer": [t_v.result(0)],
                    "error": type(err).__name__,
                    "state": _tier_state(tier)}

        got = both(scenario)
        t = got["state"]["tenants"]["a"]
        # late validation at the flush: the swapped-in index has no
        # positions, so the index request fails in the caller's hands
        assert got["error"] == "ValueError"
        assert t["failed_requests"] == 1
