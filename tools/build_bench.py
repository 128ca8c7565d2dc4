#!/usr/bin/env python3
"""Time the build kernels B1 (``hierarchy_fused``) and B3
(``hierarchy_build``) and the update kernel B6 (``hierarchy_update``) at
geometry A of ``chip_smoke.py`` on one CUDA card.

    python3 tools/build_bench.py [--src DIR] [--label NAME] [--rounds 5]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured
(default: this checkout's), so a second tree, such as an unpacked parent
commit, is timed by the same script; run it as parent, this tree, this
tree, parent in one call to compare the two on one card.  Geometry A:
n = 2^30, ``make_input_array(n, 0)`` float32, c = 128, t = 64.  Prints the
card (``nvidia-smi`` name and power limit), the ``-Xptxas -v`` registers
and spills of every build and update kernel instance, each build against
the plain build as integer views (values and positions), B6's successor
against the plain update, and one JSON line of CUDA-event times in
milliseconds, each the mean of 10 launches after a warm-up, taken in
``--rounds`` turns (each round times every item once, in order):

* ``B1 positions`` / ``B1 value-only``: ``build_hierarchy_fused``, one
  launch (the wrapper's +inf / PAD_POS fill of ``upper`` included, as a
  user's build pays it);
* ``B3 positions`` / ``B3 value-only``: ``build_hierarchy_percall``,
  L - 1 = 3 launches;
* ``torch.min`` and ``torch.amin``: ``torch.min(x.view(-1, c), dim=1)``
  (values and indices, the yardstick of a position build) and
  ``torch.amin(x.view(-1, c), dim=1)`` (values, of a value-only build):
  one level, timed only, never called by the port;
* ``B6``: the three launches of ``update_level_cuda`` that
  ``RMQ.update`` of 2^16 random indices (4096 of them repeated) makes,
  from the updated plain hierarchy's sources, and its yardstick
  ``B6 yardstick``: ``index_select`` of level 1's touched chunks +
  ``torch.min``, as ``chip_smoke.py`` times it.

Each time is printed beside its bound: the build's bytes (level 0 read
once, ``upper`` and, with positions, ``upper_pos`` written once) and B6's
bytes (``chip_smoke.py``'s ``update_launches``), at 3.35 TB/s; with the mean,
the smallest and the largest of the rounds.  The plain build is timed
once (3 launches).
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
    ptxas_all,
    same_bits,
    time_ms,
    update_launches,
)

REPS = 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("build_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import build_hierarchy, make_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.hierarchy_build.ops import (
        build_hierarchy_percall,
    )
    from repro_torch.kernels.hierarchy_fused.ops import build_hierarchy_fused
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.streaming import updates as U
    from repro_torch.tune.measure import make_input_array

    label = args.label
    print(card_line())
    print(f"[{label}] src {args.src}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    reports = _build.build_all(["hierarchy_fused", "hierarchy_build",
                                "hierarchy_update"])
    print(f"[{label}] built in {time.perf_counter() - t0:.3f} s")
    for src, stem in (("hierarchy_fused", "fused_"),
                      ("hierarchy_build", "build_level"),
                      ("hierarchy_update", "update_level")):
        for entry, regs in ptxas_all(reports.get(src, ""), stem).items():
            print(f"[{label}] ptxas {entry}: {regs}")

    n, c, t = 1 << 30, 128, 64
    x = torch.from_numpy(make_input_array(n, 0)).cuda()
    plan = make_plan(n, c=c, t=t)
    item = x.element_size()

    # -- correctness: every build against the plain one, bit for bit ------
    bad = []
    for pos in (False, True):
        want = build_hierarchy(x, plan, with_positions=pos)
        for key, build in (("B1", build_hierarchy_fused),
                           ("B3", build_hierarchy_percall)):
            got = build(x, plan, pos)
            pairs = [(got.upper, want.upper)]
            if pos:
                pairs.append((got.upper_pos, want.upper_pos))
            if not same_bits(torch, pairs):
                bad.append(f"{key} {'positions' if pos else 'value-only'}")
        del want
    torch.cuda.synchronize()

    # -- B6: the three launches of a 2^16-index update at A ----------------
    rng = np.random.default_rng(2)
    idxs = rng.integers(0, n, 1 << 16)
    idxs[:4096] = idxs[4096:8192]  # duplicates: the last one wins
    vals = (rng.random(1 << 16) - 0.5).astype(np.float32)
    idxs_t = torch.from_numpy(idxs).cuda()
    vals_t = torch.from_numpy(vals).cuda()
    h = build_hierarchy(x, plan, with_positions=True)
    got = upd_ops.update_hierarchy_cuda(h, idxs_t, vals_t)
    want = U.update_hierarchy(h, idxs_t, vals_t)
    if not same_bits(torch, [(got.upper, want.upper),
                             (got.upper_pos, want.upper_pos)]):
        bad.append("B6")
    del got, h
    update_kernels, update_yardstick, _, moved_b6, touched = update_launches(
        torch, plan, want, idxs_t)
    print(f"[{label}] against the plain versions (integer views): "
          f"{'equal' if not bad else 'DIFFER: ' + ', '.join(bad)}; B6 "
          f"touched chunks per level {touched}")

    fns = {
        "B1 positions": lambda: build_hierarchy_fused(x, plan, True),
        "B1 value-only": lambda: build_hierarchy_fused(x, plan, False),
        "B3 positions": lambda: build_hierarchy_percall(x, plan, True),
        "B3 value-only": lambda: build_hierarchy_percall(x, plan, False),
        "torch.min": lambda: torch.min(x.view(-1, c), dim=1),
        "torch.amin": lambda: torch.amin(x.view(-1, c), dim=1),
        "B6": update_kernels,
        "B6 yardstick": update_yardstick,
    }
    turns = {k: [] for k in fns}
    for _ in range(args.rounds):
        for k, fn in fns.items():
            turns[k].append(time_ms(torch, fn, REPS))
    pos_bytes = plan.capacity * item + plan.upper_size * (item + 4)
    val_bytes = plan.capacity * item + plan.upper_size * item
    bound = {"B1 positions": pos_bytes, "B1 value-only": val_bytes,
             "B3 positions": pos_bytes, "B3 value-only": val_bytes,
             "B6": moved_b6}
    out = {}
    for k, ms in turns.items():
        row = {"ms": sum(ms) / len(ms), "min": min(ms), "max": max(ms)}
        if k in bound:
            row["bound_ms"] = bound[k] / HBM_BYTES_PER_S * 1e3
        out[k] = row
    out["plain build"] = {"ms": time_ms(
        torch, lambda: build_hierarchy(x, plan, True), 3, warmup=1)}
    out["turns"] = turns
    print(f"[{label}] times (ms, CUDA events, {args.rounds} rounds of "
          f"{REPS} launches): {json.dumps(out)}")
    print(card_line())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
