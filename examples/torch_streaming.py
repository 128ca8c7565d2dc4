"""Streaming RMQ (the PyTorch / CUDA port): keep a minima hierarchy in
sync with a mutating array.

    PYTHONPATH=src python examples/torch_streaming.py [--device cpu]

Batched point updates, appends into reserved capacity and sliding-window
retirement, each returning a successor index; the incrementally
maintained index is checked against a fresh rebuild.  On the card the
update batch stays there and the update never waits for it.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import build_hierarchy, make_plan
from repro_torch.core.api import resolve_device
from repro_torch.streaming import StreamingRMQ


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def run(n: int = 1 << 18, capacity: int = 1 << 19, device=None,
        seed: int = 0, log=print):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = rng.random(n, dtype=np.float32)

    s = StreamingRMQ.from_array(x, c=128, t=64, capacity=capacity,
                                with_positions=True, device=dev)
    log(f"built over n={n} with capacity={capacity} on {dev} "
        f"({s.plan.num_levels} levels, backend {s.backend})")

    # batched point updates: one chunk re-reduction per level per index
    bsz = 256
    idxs = rng.integers(0, n, bsz)
    vals = rng.random(bsz).astype(np.float32)
    t0 = time.perf_counter()
    s = s.update(torch.from_numpy(idxs).to(dev),
                 torch.from_numpy(vals).to(dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log(f"updated {bsz} points in "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms (the first call "
        "includes building the kernels)")
    for i, v in zip(idxs, vals):   # last wins on duplicates
        x[i] = v

    tail = rng.random(4096).astype(np.float32)
    s = s.append(torch.from_numpy(tail).to(dev))
    x = np.concatenate([x, tail])
    log(f"appended {tail.size}: live length {s.length}")

    s = s.retire(1024)
    x[:1024] = np.inf
    log(f"retired 1024: live window [{s.start}, {s.length})")

    plan = make_plan(s.length, c=128, t=64, capacity=capacity)
    ref = build_hierarchy(torch.from_numpy(x).to(dev), plan,
                          with_positions=True)
    assert _same_bits(ref.upper, s.hierarchy.upper)
    assert torch.equal(ref.upper_pos, s.hierarchy.upper_pos)

    ls = rng.integers(s.start, s.length, 1024).astype(np.int32)
    rs = np.minimum(ls + rng.integers(1, 4096, 1024),
                    s.length - 1).astype(np.int32)
    got = s.query(ls, rs).cpu().numpy()
    for i in range(len(ls)):
        assert got[i] == x[ls[i]:rs[i] + 1].min()
    log(f"answered {ls.size} queries over the live window; incremental "
        "index == rebuild, every answer == the naive scan: OK")
    return s, x


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the host")
    args = ap.parse_args(argv)
    run(args.n, 2 * args.n, device=args.device)


if __name__ == "__main__":
    main()
