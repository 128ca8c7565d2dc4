"""Adaptive batched query engine (the PyTorch / CUDA port): span routing,
caching, multi-index serving.

    PYTHONPATH=src python examples/torch_query_engine.py [--device cpu]

Walks the port's ``repro_torch.qe`` layer end to end: build an index,
route a mixed-span workload through the engine (on the card: short spans
to ``rmq_short``, mid spans to ``rmq_scan``, long spans to the hybrid
top), watch the dedup and cache counters, mutate the index and see the
generation-keyed cache invalidate, serve two indexes through the
micro-batching ``QueryService`` (and index three more in one batched
build with ``register_many``), then answer a value + index mix on the
fused backend in one ``rmq_fused`` launch.  ``--n`` shrinks it for the
host.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import RMQ
from repro_torch.core.query import rmq_value_batch
from repro_torch.kernels.profiling import count_launches
from repro_torch.qe import QueryService


def mixed_workload(rng, n, c, m):
    """Bounds drawn from all three span classes, shuffled together."""
    spans = np.concatenate([
        rng.integers(1, 2 * c + 1, m // 3),             # short
        rng.integers(4 * c, max(n // 8, 4 * c + 1), m // 3),   # mid
        rng.integers(n // 2, n + 1, m - 2 * (m // 3)),  # long
    ])
    rng.shuffle(spans)
    ls = (rng.random(m) * (n - spans + 1)).astype(np.int64)
    rs = ls + spans - 1
    return ls.astype(np.int32), rs.astype(np.int32)


def run(n: int = 1 << 18, device=None, seed: int = 0, log=print) -> dict:
    """The walkthrough; returns its counters for the caller to check."""
    rng = np.random.default_rng(seed)
    c = 128
    x = rng.random(n, dtype=np.float32)
    out = {}

    # --- one index, one engine -------------------------------------------
    rmq = RMQ.build(x, c=c, t=64, with_positions=True, device=device)
    engine = rmq.engine()
    log(f"index: n={n} on {rmq.device} ({rmq.backend}), "
        f"{rmq.plan.num_levels} levels, long cutoff = "
        f"{engine.planner.effective_long_cutoff()}")
    ls, rs = mixed_workload(rng, n, c, 4096)
    ls[100:400] = ls[0]  # duplicate queries (hot keys)
    rs[100:400] = rs[0]
    vals = engine.query(ls, rs)
    # bit-identical to the plain walk
    want = rmq_value_batch(rmq.hierarchy, torch.from_numpy(ls).to(rmq.device),
                           torch.from_numpy(rs).to(rmq.device))
    assert torch.equal(vals.view(torch.int32), want.view(torch.int32))
    s = engine.stats()
    out["class_counts"] = s["class_counts"]
    out["dedup_saved"] = s["dedup_saved"]
    log(f"routed {s['queries']} queries: class split {s['class_counts']}, "
        f"dedup saved {s['dedup_saved']}")

    # --- repeat traffic hits the result cache ----------------------------
    engine.query(ls[:512], rs[:512])
    out["cache_hits"] = engine.stats()["cache"]["hits"]
    log(f"repeat batch: {out['cache_hits']} cache hits")

    # --- mutations invalidate by generation ------------------------------
    l0, r0, at = n // 256, n * 3 // 4, n // 2
    before = float(engine.query(np.array([l0]), np.array([r0]))[0])
    rmq = rmq.update(np.array([at]), np.array([-1.0], np.float32))
    engine.attach(rmq)     # successor: generation 0 -> 1
    after = float(engine.query(np.array([l0]), np.array([r0]))[0])
    assert after == -1.0 and before >= 0.0
    out["generation"] = engine.generation
    log(f"update invalidated cached min: {before:.4f} -> {after:.1f} "
        f"(generation {engine.generation})")

    # --- many indexes, micro-batched requests ----------------------------
    svc = QueryService(max_pending=8192)
    svc.register("scores", rmq)
    small = rng.random(1 << 14, dtype=np.float32)
    svc.register("latencies", RMQ.build(small, c=64, t=64,
                                        with_positions=True, device=device))
    tickets = [svc.submit("scores", *mixed_workload(rng, n, c, 64))
               for _ in range(16)]
    tickets.append(svc.submit("latencies", np.array([10]), np.array([5000]),
                              op="index"))
    results = svc.flush()     # one coalesced execution per (index, op)
    assert all(t in results for t in tickets)
    assert int(results[tickets[-1]][0]) == 10 + int(np.argmin(
        small[10:5001]))
    st = svc.stats()
    out["coalesced_batches"] = st["coalesced_batches"]
    log(f"service: {st['requests']} requests -> "
        f"{st['engines']['scores']['batches']} engine batch(es) for "
        f"'scores', coalesced {st['coalesced_batches']} group(s)")
    arrays = {f"shard{i}": rng.random(1 << 14, dtype=np.float32)
              for i in range(3)}
    with count_launches() as counts:
        svc.register_many(arrays, c=64, t=64, with_positions=True,
                          device=device)
    out["register_many_launches"] = dict(counts)
    for name, arr in arrays.items():
        assert float(svc.query(name, np.array([0]),
                               np.array([len(arr) - 1]))[0]) == arr.min()
    log(f"register_many: 3 arrays in {dict(counts)}")

    # --- fused backend: the whole mix, ONE launch per batch --------------
    fused = RMQ.build(x, c=c, t=64, with_positions=True, backend="fused",
                      device=device)
    fused_engine = fused.engine(cache_size=0)
    ls_m, rs_m = mixed_workload(rng, n, c, 1024)
    is_index = rng.random(1024) < 0.5
    with count_launches() as counts:
        vals_mx, poss_mx = fused_engine.query_mixed(ls_m, rs_m, is_index)
    out["mixed_launches"] = dict(counts)
    vals_mx, poss_mx = vals_mx.cpu().numpy(), poss_mx.cpu().numpy()
    for i in range(0, 1024, 64):       # spot-check against the naive scan
        seg = x[ls_m[i]:rs_m[i] + 1]
        if is_index[i]:
            assert poss_mx[i] == ls_m[i] + int(np.argmin(seg))
        else:
            assert vals_mx[i] == seg.min()
    log(f"fused backend: a value + index batch of 1024 in {dict(counts)}")
    log("query engine demo OK")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the host")
    args = ap.parse_args(argv)
    run(args.n, device=args.device)


if __name__ == "__main__":
    main()
