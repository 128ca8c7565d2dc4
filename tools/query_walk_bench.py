#!/usr/bin/env python3
"""Time the query-walk kernels B2 (``rmq_fused``) and B4 (``rmq_scan``) at
geometry A of ``chip_smoke.py`` on one CUDA card.

    python3 tools/query_walk_bench.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured
(default: this checkout's), so a second tree, such as an unpacked parent
commit, is timed by the same script.  Geometry A: n = 2^30,
``make_input_array(n, 0)`` float32, c = 128, t = 64, positions on, and
m = 2^24 spans, ``make_queries(n, m, "mixed", 1)``.  Prints the card (``nvidia-smi`` name and power
limit), the one-chunk-a-warp kernels' ``-Xptxas -v`` registers and
spills, the level-1 value and position planes' bytes beside the 50 MB
L2, each kernel's answers against the plain walk (torch.equal, values
and positions), and
one JSON line of CUDA-event times in milliseconds, each the mean of 10
launches, taken in two turns:

* ``rmq_fused``: one launch, both planes; ``rmq_fused value``: the value
  plane alone;
* ``rmq_scan value`` and ``rmq_scan index``: the two B4 launches;
* ``bound``: the level-0 sectors of the batch's partial chunks plus its
  bounds and answers at 3.35 TB/s, as ``chip_smoke.py`` computes it;
* ``by class``: ``rmq_fused`` (both planes) on m/3 spans of each paper
  §5.1 size class alone (``make_queries`` "small", "medium", "large"),
  each beside its own bound: where the mixed batch's time goes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (  # noqa: E402
    HBM_BYTES_PER_S,
    card_line,
    level0_bytes,
    ptxas_of,
    time_ms,
)

REPS = 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("query_walk_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import make_plan, rmq_walk_batch
    from repro_torch.kernels import _build
    from repro_torch.kernels.hierarchy_fused.ops import build_hierarchy_fused
    from repro_torch.kernels.rmq_fused.ops import rmq_fused_batch
    from repro_torch.kernels.rmq_scan.ops import (
        rmq_index_batch_cuda,
        rmq_value_batch_cuda,
    )
    from repro_torch.tune.measure import make_input_array, make_queries

    print(card_line())
    print(f"[{args.label}] src {args.src}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = _build.build_all(["rmq_fused", "rmq_scan", "hierarchy_fused"])
    print(f"[{args.label}] built in {time.perf_counter() - t0:.3f} s")
    for src in ("rmq_fused", "rmq_scan"):
        for dtype, vec in (("f", 4), ("d", 2)):
            for track in (0, 1):
                entry = f"{src}_kernelI{dtype}Lb{track}ELi{vec}ELb1E"
                print(f"[{args.label}] ptxas {entry}: "
                      f"{ptxas_of(reports.get(src, ''), entry)}")

    n, m, c, t = 1 << 30, 1 << 24, 128, 64
    x = torch.from_numpy(make_input_array(n, 0)).cuda()
    ls, rs = make_queries(n, m, "mixed", seed=1)
    ls, rs = torch.from_numpy(ls).cuda(), torch.from_numpy(rs).cuda()
    plan = make_plan(n, c=c, t=t)
    h = build_hierarchy_fused(x, plan, True)
    l1 = plan.level_lens[1] if plan.num_levels > 1 else 0
    print(f"[{args.label}] levels {plan.level_lens}; level-1 planes: values "
          f"{l1 * x.element_size()} bytes, positions {l1 * 4} bytes, "
          f"together {l1 * (x.element_size() + 4)} bytes; L2 50 MB")

    wv, wp = rmq_walk_batch(h, ls, rs, True)
    got = {
        "rmq_fused": rmq_fused_batch(h, ls, rs, True),
        "rmq_fused value": (rmq_fused_batch(h, ls, rs, False)[0], None),
        "rmq_scan": (rmq_value_batch_cuda(h, ls, rs),
                     rmq_index_batch_cuda(h, ls, rs)),
    }
    torch.cuda.synchronize()
    bad = []
    for key, (v, p) in got.items():
        if not torch.equal(v, wv):
            bad.append(f"{key} values")
        if p is not None and not torch.equal(p, wp):
            bad.append(f"{key} positions")
    print(f"[{args.label}] against the plain walk (torch.equal): "
          f"{'equal' if not bad else 'DIFFER: ' + ', '.join(bad)}")

    fns = {
        "rmq_fused": lambda: rmq_fused_batch(h, ls, rs, True),
        "rmq_fused value": lambda: rmq_fused_batch(h, ls, rs, False),
        "rmq_scan value": lambda: rmq_value_batch_cuda(h, ls, rs),
        "rmq_scan index": lambda: rmq_index_batch_cuda(h, ls, rs),
    }
    times = {k: [] for k in fns}
    for _ in range(2):
        for k, fn in fns.items():
            times[k].append(time_ms(torch, fn, REPS))
    item = x.element_size()
    moved = level0_bytes(torch, ls, rs, c, item) + m * (8 + item + 4)
    out = {k: sum(v) / len(v) for k, v in times.items()}
    out["rmq_scan pair"] = out["rmq_scan value"] + out["rmq_scan index"]
    out["bound"] = moved / HBM_BYTES_PER_S * 1e3
    out["turns"] = times
    print(f"[{args.label}] times (ms, CUDA events): {json.dumps(out)}")
    by_class = {}
    for kind in ("small", "medium", "large"):
        cl, cr = make_queries(n, m // 3, kind, seed=1)
        cl, cr = torch.from_numpy(cl).cuda(), torch.from_numpy(cr).cuda()
        cmoved = level0_bytes(torch, cl, cr, c, item) + cl.numel() * (
            8 + item + 4)
        by_class[kind] = {
            "ms": time_ms(torch, lambda: rmq_fused_batch(h, cl, cr, True),
                          REPS),
            "bound": cmoved / HBM_BYTES_PER_S * 1e3,
            "spans": cl.numel()}
    print(f"[{args.label}] rmq_fused by class (ms, CUDA events): "
          f"{json.dumps(by_class)}")
    print(card_line())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
