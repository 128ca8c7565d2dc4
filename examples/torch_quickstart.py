"""Quickstart (the PyTorch / CUDA port): build a GPU-RMQ index on the card
and answer batched queries.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

``c="auto"`` takes the geometry from the tuning cache measured for the
build's device (``results/tuning_cache_torch.json``, written by
``python -m repro_torch.tune`` on the card); on a miss, the CPU
included, it builds the default c=128, t=64.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import RMQ
from repro_torch.core.baselines import SparseTable


def run(n: int = 1 << 20, m: int = 4096, device=None, seed: int = 0):
    """Build over ``n`` random values and answer ``m`` spans; returns
    ``(x, ls, rs, values, positions, rmq)`` with the answers on the host."""
    rng = np.random.default_rng(seed)
    x = rng.random(n, dtype=np.float32)
    rmq = RMQ.build(x, c="auto", with_positions=True, device=device)
    ls = rng.integers(0, n, m).astype(np.int32)
    rs = np.minimum(ls + rng.integers(1, max(n // 2, 2), m),
                    n - 1).astype(np.int32)
    vals = rmq.query(ls, rs).cpu().numpy()
    idxs = rmq.query_index(ls, rs).cpu().numpy()
    return x, ls, rs, vals, idxs, rmq


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the host")
    args = ap.parse_args(argv)

    x, ls, rs, vals, idxs, rmq = run(args.n, device=args.device)
    plan = rmq.plan
    print(f"n = {args.n} on {rmq.device}: geometry c={plan.c}, t={plan.t} "
          f"(tuned: {plan.level_split is not None}, backend "
          f"{rmq.backend}), {plan.num_levels} levels, level sizes "
          f"{plan.level_lens}")
    print(f"auxiliary memory: {rmq.auxiliary_bytes() / 2**20:.2f} MiB "
          f"({100 * plan.overhead_fraction():.2f}% of the input; paper "
          f"bound n/(c-1) = {100 / (plan.c - 1):.2f}%)")
    print(f"answered {len(ls)} RMQs; example: RMQ({ls[0]}, {rs[0]}) = "
          f"{float(vals[0]):.6f} at position {int(idxs[0])}")

    for i in range(len(ls)):
        want = x[ls[i]:rs[i] + 1]
        assert vals[i] == want.min()
        assert idxs[i] == ls[i] + int(np.argmin(want))
    print("every answer equals the naive scan: OK")

    sparse = SparseTable.build(torch.from_numpy(x).to(rmq.device))
    print(f"sparse table (LCA-profile) memory: "
          f"{sparse.memory_bytes() / 2**20:.0f} MiB "
          f"({sparse.memory_bytes() / rmq.auxiliary_bytes():.0f}x ours)")


if __name__ == "__main__":
    main()
