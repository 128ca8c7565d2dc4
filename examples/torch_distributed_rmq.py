"""Distributed RMQ (the PyTorch / CUDA port): shard an array into segments
on a mesh and answer batches with per-segment hierarchies and one keyed
min combine.

    PYTHONPATH=src python examples/torch_distributed_rmq.py [--device cpu]

The mesh is (2, 4) over ("data", "model"): four segments along "model".
With no process group one process holds all four (on one card they are
the rows of one tensor, built by one ``hierarchy_fused`` launch); with a
``torch.distributed`` group each rank holds its block.  Each segment
keeps its own hierarchy, so the footprint a device holds falls with the
number of segments, and a batch costs one combine of (batch,) answers
whatever n is.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import DistributedRMQ
from repro_torch.launch.mesh import make_test_mesh


def run(n: int = 1 << 22, m: int = 1 << 12, device=None, seed: int = 0,
        log=print):
    mesh = make_test_mesh((2, 4), ("data", "model"), device=device)
    rng = np.random.default_rng(seed)
    x = rng.random(n, dtype=np.float32)

    d = DistributedRMQ.build(x, mesh, segment_axis="model",
                             query_axes=("data",), c=128, t=32,
                             with_positions=True, backend="fused")
    log(f"n = {n} sharded into {mesh.shape['model']} segments of "
        f"{d.segment_capacity} on {mesh.device}; per-device footprint "
        f"{d.memory_bytes_per_device() / 2**20:.1f} MiB")

    ls = rng.integers(0, n, m)
    rs = np.minimum(ls + rng.integers(1, n, m), n - 1)
    ls, rs = np.minimum(ls, rs), np.maximum(ls, rs)
    vals = d.query(ls, rs).cpu().numpy()
    idxs = d.query_index(ls, rs).cpu().numpy()
    for i in rng.integers(0, m, 16):  # spot checks against the scan
        span = x[ls[i]:rs[i] + 1]
        assert vals[i] == span.min()
        assert idxs[i] == ls[i] + int(np.argmin(span))
    log(f"answered {m} queries; spot checks OK")
    log(f"example: RMQ({ls[0]}, {rs[0]}) = {vals[0]:.6f} @ {idxs[0]} "
        f"(spans segments {ls[0] // d.segment_capacity}.."
        f"{rs[0] // d.segment_capacity})")

    # sharded updates: each segment re-reduces the indices it owns
    upd_at = rng.integers(0, n, 4096)
    d = d.update(upd_at, np.full(4096, 0.5, np.float32))
    d = d.update(np.array([n // 3]), np.array([-1.0], np.float32))
    v = d.query(np.array([0]), np.array([n - 1]))
    p = d.query_index(np.array([0]), np.array([n - 1]))
    assert float(v[0]) == -1.0 and int(p[0]) == n // 3
    log(f"sharded update batch applied (generation {d.generation}); "
        f"global min now {float(v[0])} @ {int(p[0])}")

    # the engine: contained spans answered segment-locally, no combine
    engine = d.engine()
    assert torch.equal(engine.query(ls, rs), d.query(ls, rs))
    assert torch.equal(engine.query_index(ls, rs), d.query_index(ls, rs))
    cc = engine.stats()["class_counts"]
    log(f"engine routed {cc['seg_local']} spans segment-locally (no "
        f"combine) and {cc['crossing']} through the combine; equal to the "
        "monolithic path")
    return d, cc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 22)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the host")
    args = ap.parse_args(argv)
    run(args.n, device=args.device)


if __name__ == "__main__":
    main()
