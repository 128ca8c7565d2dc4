#!/usr/bin/env python3
"""Time the query-walk kernels B2 (``rmq_fused``), B4 (``rmq_scan``), B5
(``rmq_short``) and B7 (``rmq_bulk``) at geometry A of ``chip_smoke.py``
on one CUDA card.

    python3 tools/query_walk_bench.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured
(default: this checkout's), so a second tree, such as an unpacked parent
commit, is timed by the same script.  Geometry A: n = 2^30,
``make_input_array(n, 0)`` float32, c = 128, t = 64, positions on, and
m = 2^24 spans, ``make_queries(n, m, "mixed", 1)``.  Prints the card (``nvidia-smi`` name and power
limit), the kernels' ``-Xptxas -v`` registers and spills (every
instance of B5 and B7, the one-chunk-a-warp ones of B2 and B4), the
level-1 value and position planes' bytes beside the 50 MB L2, B2's and
B4's answers against the plain walk (torch.equal, values and positions),
B5's and B7's against B2's on the same spans (bit for bit, integer
views), and one JSON line of CUDA-event times in milliseconds, each the
mean of 10 launches, taken in two turns:

* ``rmq_fused``: one launch, both planes; ``rmq_fused value``: the value
  plane alone;
* ``rmq_scan value`` and ``rmq_scan index``: the two B4 launches;
* ``bound``: the level-0 sectors of the batch's partial chunks plus its
  bounds and answers at 3.35 TB/s, as ``chip_smoke.py`` computes it;
* ``plain walk``: the plain version of B2 (``rmq_walk_batch``, both
  planes, also the eager backend's query path), the mean of 2 calls;
* ``by class``: ``rmq_fused`` (both planes) on m/3 spans of each paper
  §5.1 size class alone (``make_queries`` "small", "medium", "large"),
  each beside its own bound: where the mixed batch's time goes.

Then B7 and B5 (both planes a launch):

* ``rmq_bulk pass``: the batch sorted as the bulk executor sorts it, in
  2^20 buckets (16 launches), in turns with ``rmq_fused sorted`` (B2 on
  the same sorted spans, one launch); ``rmq_bulk launch`` is the pass over
  its launches; ``bulk bound``: the distinct level-0 boundary chunks plus
  bounds and answers at 3.35 TB/s; and the same by class, each class
  sorted;
* ``rmq_short``: the engine's short spans (``make_span_queries(n, 2^20,
  c, "mixed", 3)`` with r // c - l // c <= 1, as ``chip_smoke.py``'s
  engine phase) in one call and in the engine's buckets of 4096: device
  time per launch from torch.profiler (at that size CUDA events would
  time the host's wrapper), beside B2 on the same spans and buckets and
  the bound (the spans' sectors plus bounds and answers).
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
    bulk_order,
    bulk_pass,
    card_line,
    kernel_launch_ms,
    level0_bytes,
    partial_chunks,
    ptxas_all,
    ptxas_of,
    same_bits,
    span_bytes,
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
    reports = _build.build_all(["rmq_fused", "rmq_scan", "hierarchy_fused",
                                "rmq_short", "rmq_bulk"])
    print(f"[{args.label}] built in {time.perf_counter() - t0:.3f} s")
    for src in ("rmq_fused", "rmq_scan"):
        for dtype, vec in (("f", 4), ("d", 2)):
            for track in (0, 1):
                entry = f"{src}_kernelI{dtype}Lb{track}ELi{vec}ELb1E"
                print(f"[{args.label}] ptxas {entry}: "
                      f"{ptxas_of(reports.get(src, ''), entry)}")
    for src in ("rmq_short", "rmq_bulk"):
        for entry, regs in ptxas_all(reports.get(src, ""),
                                     f"{src}_kernel").items():
            print(f"[{args.label}] ptxas {entry}: {regs}")

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
    out["plain walk"] = time_ms(
        torch, lambda: rmq_walk_batch(h, ls, rs, True), 2, warmup=0)
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
    bad += bulk_and_short(args.label, torch, h, plan, ls, rs, n, m)
    print(card_line())
    return 1 if bad else 0


def sorted_batch(torch, ls, rs, plan):
    order = bulk_order(torch, ls, rs, plan.c, plan.capacity)
    return ls[order].contiguous(), rs[order].contiguous()


def bulk_bound(torch, bl, br, c, item):
    chunks = torch.unique(partial_chunks(torch, bl, br, c)).numel()
    moved = chunks * c * item + bl.numel() * (8 + item + 4)
    return moved / HBM_BYTES_PER_S * 1e3


def bulk_and_short(label, torch, h, plan, ls, rs, n, m):
    """B7 on the sorted batch and B5 on the engine's short spans; returns
    the names of the comparisons that failed."""
    from repro_torch.kernels.rmq_fused.ops import rmq_fused_batch
    from repro_torch.kernels.rmq_short.ops import rmq_short_batch
    from repro_torch.tune.measure import make_queries, make_span_queries

    c, item = plan.c, h.base.element_size()
    bad = []
    bl, br = sorted_batch(torch, ls, rs, plan)
    sl, sr = (torch.from_numpy(a).cuda() for a in
              make_span_queries(n, 1 << 20, c, "mixed", seed=3))
    keep = (sr // c) - (sl // c) <= 1
    sl, sr = sl[keep].contiguous(), sr[keep].contiguous()
    got = {"rmq_bulk": (bulk_pass(h, bl, br, True),
                        rmq_fused_batch(h, bl, br, True)),
           "rmq_short": (rmq_short_batch(h, sl, sr, True),
                         rmq_fused_batch(h, sl, sr, True))}
    torch.cuda.synchronize()
    for key, ((v, p), (fv, fp)) in got.items():
        if not same_bits(torch, [(v, fv), (p, fp)]):
            bad.append(f"{key} against rmq_fused")
    print(f"[{label}] rmq_bulk (sorted 2^24) and rmq_short (the engine's "
          f"short spans) against rmq_fused on the same spans, bit for bit: "
          f"{'equal' if not bad else 'DIFFER: ' + ', '.join(bad)}")

    launches = -(-m // (1 << 20))
    fns = {"rmq_bulk pass": lambda: bulk_pass(h, bl, br, True),
           "rmq_fused sorted": lambda: rmq_fused_batch(h, bl, br, True)}
    times = {k: [] for k in fns}
    for _ in range(2):
        for k, fn in fns.items():
            times[k].append(time_ms(torch, fn, REPS))
    out = {k: sum(v) / len(v) for k, v in times.items()}
    out["rmq_bulk launch"] = out["rmq_bulk pass"] / launches
    out["launches"] = launches
    out["bulk bound"] = bulk_bound(torch, bl, br, c, item)
    out["turns"] = times
    by_class = {}
    for kind in ("small", "medium", "large"):
        cl, cr = (torch.from_numpy(a).cuda()
                  for a in make_queries(n, m // 3, kind, seed=1))
        cl, cr = sorted_batch(torch, cl, cr, plan)
        by_class[kind] = {
            "rmq_bulk": time_ms(torch, lambda: bulk_pass(h, cl, cr, True),
                                REPS),
            "rmq_fused": time_ms(torch, lambda: rmq_fused_batch(
                h, cl, cr, True), REPS),
            "bound": bulk_bound(torch, cl, cr, c, item),
            "spans": cl.numel()}
    out["by class"] = by_class
    print(f"[{label}] rmq_bulk (ms, CUDA events, value + index): "
          f"{json.dumps(out)}")

    step = 4096

    def buckets(fn):
        return lambda: [fn(h, sl[s:s + step], sr[s:s + step], True)
                        for s in range(0, sl.numel(), step)]

    moved = span_bytes(torch, sl, sr, item) + sl.numel() * (8 + item + 4)
    nb = -(-sl.numel() // step)
    short = {
        "spans": sl.numel(), "launches": nb,
        "rmq_short call": time_ms(torch, lambda: rmq_short_batch(
            h, sl, sr, True), 20),
        "rmq_fused call": time_ms(torch, lambda: rmq_fused_batch(
            h, sl, sr, True), 20),
        "rmq_short launch": kernel_launch_ms(
            torch, buckets(rmq_short_batch), "rmq_short_kernel"),
        "rmq_fused launch": kernel_launch_ms(
            torch, buckets(rmq_fused_batch), "rmq_fused_kernel"),
        "rmq_short buckets (events, host included)": time_ms(
            torch, buckets(rmq_short_batch), 3) / nb,
        "call bound": moved / HBM_BYTES_PER_S * 1e3,
        "launch bound": moved / nb / HBM_BYTES_PER_S * 1e3,
    }
    print(f"[{label}] rmq_short (ms, value + index; 'launch': device time "
          f"per launch of a {step}-span bucket, torch.profiler): "
          f"{json.dumps(short)}")
    return bad


if __name__ == "__main__":
    sys.exit(main())
