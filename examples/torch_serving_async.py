"""Async serving tier (the PyTorch / CUDA port): two tenants, two SLOs,
one live mutator.

    PYTHONPATH=src python examples/torch_serving_async.py [--device cpu]

A single event loop serves two tenants from one fused-backend
``QueryService`` through ``repro_torch.serving``:

* ``trading``: a tight 2 ms SLO, small bursts of short range-min probes;
* ``analytics``: a relaxed 25 ms SLO, bigger mixed value / index scans
  (the deadline batcher coalesces many requests into one ``rmq_fused``
  launch a flush).

A background task mutates the ``analytics`` array the whole time:
updates stage in O(1) and swap in between flushes (``RMQ.update``, the
``hierarchy_update`` kernel on the card), so every response equals some
single generation of the array, which the example checks against numpy
replays of the staged mutations.  ``--n`` and ``--rounds`` shrink it for
the host.
"""

import argparse
import asyncio

import numpy as np

from repro_torch.core import RMQ
from repro_torch.serving import ServingTier
from repro_torch.serving.aio import AsyncServingTier


def build_tier(n: int = 1 << 14, seed: int = 0, device=None):
    """Two fused-backend tenants on one tier."""
    rng = np.random.default_rng(seed)
    trading = rng.integers(-1000, 1000, n).astype(np.float32)
    analytics = rng.integers(-1000, 1000, n).astype(np.float32)
    tier = ServingTier(idle_tick=0.002)
    tier.register_tenant(
        "trading", RMQ.build(trading, c=64, t=16, with_positions=True,
                             backend="fused", device=device),
        slo_ms=2.0, max_queue=4096)
    tier.register_tenant(
        "analytics", RMQ.build(analytics, c=64, t=16, with_positions=True,
                               backend="fused", device=device),
        slo_ms=25.0, max_queue=8192)
    return tier, trading, analytics


def oracle_snapshots(base: np.ndarray, mutations):
    """generation -> array, replaying the staged mutation log."""
    snaps = {0: base.copy()}
    arr = base.copy()
    for gen, (idxs, vals) in enumerate(mutations, start=1):
        arr = arr.copy()
        arr[np.asarray(idxs)] = np.asarray(vals)
        snaps[gen] = arr
    return snaps


async def run(n: int = 1 << 14, rounds: int = 40, seed: int = 0,
              device=None) -> dict:
    tier, trading, analytics = build_tier(n, seed, device)
    aio = AsyncServingTier(tier)
    rng = np.random.default_rng(seed + 1)
    stop = asyncio.Event()
    pump = asyncio.create_task(aio.pump(stop))
    mutation_log = []

    async def mutator():
        """Stages an update batch every ~5 ms for the analytics tenant."""
        while not stop.is_set():
            idxs = rng.integers(0, n, 32).astype(np.int32)
            vals = rng.integers(-1000, 1000, 32).astype(np.float32)
            mutation_log.append((idxs.copy(), vals.copy()))
            aio.update("analytics", idxs, vals)
            await asyncio.sleep(0.005)

    async def trading_client():
        checked = 0
        for _ in range(rounds):
            ls = rng.integers(0, n - 64, 4).astype(np.int32)
            rs = ls + rng.integers(1, 64, 4).astype(np.int32)
            t = aio.submit("trading", ls, rs)
            res = (await aio.wait(t)).cpu().numpy()
            for l, r, v in zip(ls, rs, res):
                assert v == trading[l:r + 1].min()   # tenant is unmutated
            checked += len(ls)
            await asyncio.sleep(0.001)
        return checked

    async def analytics_client():
        """Mixed value / index scans, verified against the generation the
        tier answered from (the pinned snapshot, not the live array)."""
        log = []
        span = min(2048, n // 2)
        for _ in range(rounds):
            ls = rng.integers(0, n - span, 16).astype(np.int32)
            rs = ls + rng.integers(16, span, 16).astype(np.int32)
            op = "index" if rng.random() < 0.5 else "value"
            t = aio.submit("analytics", ls, rs, op=op)
            log.append((t, ls, rs, op, (await aio.wait(t)).cpu().numpy()))
            await asyncio.sleep(0.002)
        return log

    mut = asyncio.create_task(mutator())
    n_trading, analytics_log = await asyncio.gather(trading_client(),
                                                    analytics_client())
    stop.set()
    await asyncio.gather(pump, mut)

    # snapshot isolation: every analytics answer equals the quiesced
    # oracle at the ticket's generation
    snaps = oracle_snapshots(analytics, mutation_log)
    for t, ls, rs, op, res in analytics_log:
        arr = snaps[t.generation]
        for l, r, v in zip(ls, rs, res):
            want = (arr[l:r + 1].min() if op == "value"
                    else l + int(np.argmin(arr[l:r + 1])))
            assert v == want, (t.generation, op, l, r, v, want)

    return {
        "stats": tier.stats(),
        "trading_checked": n_trading,
        "analytics_requests": len(analytics_log),
        "generations_seen": sorted({t.generation
                                    for t, *_ in analytics_log}),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 14)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the host")
    args = ap.parse_args(argv)
    out = asyncio.run(run(args.n, args.rounds, device=args.device))
    for name in ("trading", "analytics"):
        t = out["stats"]["tenants"][name]
        print(f"tenant {name:10s} submits={t['submits']:4d} "
              f"flushes={t['flushes']:4d} swaps={t['snapshot_swaps']:3d} "
              f"p50={t['latency_s']['p50'] * 1e3:6.2f}ms "
              f"p99={t['latency_s']['p99'] * 1e3:6.2f}ms")
    gens = out["generations_seen"]
    print(f"analytics answered from {len(gens)} snapshot generations "
          f"(first {gens[0]}, last {gens[-1]}); every answer equal to its "
          "generation's quiesced oracle: snapshot isolation OK")


if __name__ == "__main__":
    main()
