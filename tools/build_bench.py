#!/usr/bin/env python3
"""Time the build kernels B1 (``hierarchy_fused``) and B3
(``hierarchy_build``), the update kernel B6 (``hierarchy_update``) and
the paths around it at geometry A of ``chip_smoke.py`` on one CUDA card.

    python3 tools/build_bench.py [--src DIR] [--label NAME] [--rounds 5]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured
(default: this checkout's), so a second tree, such as an unpacked parent
commit, is timed by the same script; run it as parent, this tree, this
tree, parent (and again) in one call to compare the two on one card.
Geometry A: n = 2^30, ``make_input_array(n, 0)`` float32, c = 128, t = 64.
Prints the card (``nvidia-smi`` name and power limit) first and last, the
``-Xptxas -v`` registers and spills of every build and update kernel
instance, each build against the plain build as integer views (values and
positions), B6's successor against the plain update, and one JSON line of
times in milliseconds, taken in ``--rounds`` turns (each round times every
item once, in order); CUDA events, each the mean of 10 calls after a
warm-up, unless named otherwise:

* ``B1 positions`` / ``B1 value-only``: ``build_hierarchy_fused``, one
  launch (the wrapper's +inf / PAD_POS fill of ``upper`` included, as a
  user's build pays it);
* ``B3 positions`` / ``B3 value-only``: ``build_hierarchy_percall``,
  L - 1 = 3 launches;
* ``torch.min`` and ``torch.amin``: ``torch.min(x.view(-1, c), dim=1)``
  (values and indices, the yardstick of a position build) and
  ``torch.amin(x.view(-1, c), dim=1)`` (values, of a value-only build):
  one level, timed only, never called by the port;
* ``B6``: the three launches of ``RMQ.update`` of 2^16 random indices
  (4096 of them repeated) on copies of the hierarchy's planes: this
  tree's one host call (``update_levels_cuda`` on the sorted batch), or a
  parent's three ``update_level_cuda`` calls on deduped chunk ids;
  ``B6 flushed``: the same call's event span with the L2 flushed before
  each call (a write of twice its 50 MB), one call at a time;
  ``B6 yardstick``: ``index_select`` of level 1's touched chunks +
  ``torch.min``;
* ``RMQ.update``: the whole call (the batch on the card); ``copy``: the
  successor's three clones alone;
* ``B2``: ``rmq_fused_batch`` over 2^24 "mixed" spans (value + index) on
  NaN-free input;
* ``eviction``: F's eviction rounds on the manager alone
  (``RMQEvictionManager(budget=1590, protected_window=16, c=16, t=4)``
  over 2120 score slots, the first round at 2049 live tokens, then 62
  rounds of one victim, random scores from a seed), host clock to the end
  of device work, ms a later round (and the first round alone).

Besides, once a process: each B6 launch's device time from
``torch.profiler`` over 10 calls with the L2 flushed before each
(``B6 kernel ms per level``).  Each time is printed beside its bound:
the build's bytes (level 0 read once, ``upper`` and, with positions,
``upper_pos`` written once) and B6's bytes (``chip_smoke.py``'s
``update_launches``: each touched chunk's entries read once, a 32-byte
sector for each scattered write and gather), at 3.35 TB/s; with the
mean, the smallest and the largest of the rounds.  The plain build is
timed once (3 launches).
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
    UPDATE_KERNELS,
    card_line,
    kernel_times_in_order,
    l2_flusher,
    ptxas_all,
    same_bits,
    time_flushed,
    time_ms,
    update_bytes,
    update_launches,
)

REPS = 10
# a parent's B6 (one launch a level over deduped ids)
PARENT_UPDATE_KERNELS = UPDATE_KERNELS + ("update_level_kernel",)


def parent_b6(torch, h, idxs):
    """A parent tree's B6 calls (``update_level_cuda`` per level over the
    chunk ids ``touched_chunk_ids`` dedupes), into copies of ``h``'s
    planes."""
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.streaming import updates as U

    plan, c = h.plan, h.plan.c
    base, upper, upos = h.base, h.upper.clone(), h.upper_pos.clone()
    ids = idxs.long() // c
    level_ids = []
    for level in range(1, plan.num_levels):
        ids = U.touched_chunk_ids(ids, plan.level_lens[level])
        level_ids.append(ids.to(torch.int32))
        ids = ids // c
    sources = [U.level_source(plan, base, upper, upos, k)
               for k in range(1, plan.num_levels)]
    outs = [(upper[o:o + p], upos[o:o + p])
            for o, p in zip(plan.offsets, plan.padded_lens)]

    def kernels():
        for (sv, sp), lid, (ov, op) in zip(sources, level_ids, outs):
            upd_ops.update_level_cuda(sv, sp, lid, c, ov, op)

    return kernels


def eviction_rounds(torch, rounds: int = 63):
    """F's eviction rounds on the manager alone: ``(first round ms, mean
    ms of the later rounds)`` on the host clock, each to the end of device
    work."""
    from repro_torch.serve.eviction import RMQEvictionManager

    mgr = RMQEvictionManager(budget=1590, protected_window=16, c=16, t=4)
    index = mgr.make_index(2120, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    slots = torch.arange(2120, device="cuda")
    live, times = 2049, []
    for _ in range(rounds):
        scores = torch.where(slots < live,
                             torch.rand(2120, generator=g, device="cuda"),
                             float("inf"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index, victims = mgr.plan_evictions_streaming(index, scores, live)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        live = live - int(victims.shape[0]) + 1
    return times[0], sum(times[1:]) / len(times[1:])


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
    from repro_torch.core import RMQ, build_hierarchy, make_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.hierarchy_build.ops import (
        build_hierarchy_percall,
    )
    from repro_torch.kernels.hierarchy_fused.ops import build_hierarchy_fused
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.kernels.rmq_fused.ops import rmq_fused_batch
    from repro_torch.streaming import updates as U
    from repro_torch.tune.measure import make_input_array, make_queries

    label = args.label
    print(card_line())
    print(f"[{label}] src {args.src}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    reports = _build.build_all(["hierarchy_fused", "hierarchy_build",
                                "hierarchy_update", "rmq_fused"])
    print(f"[{label}] built in {time.perf_counter() - t0:.3f} s")
    for src, stem in (("hierarchy_fused", "fused_"),
                      ("hierarchy_build", "build_level"),
                      ("hierarchy_update", "update_")):
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
    rc = RMQ.build(x, c=c, t=t, with_positions=True, backend="cuda")
    h = rc.hierarchy
    got = upd_ops.update_hierarchy_cuda(h, idxs_t, vals_t)
    want = U.update_hierarchy(h, idxs_t, vals_t)
    if not same_bits(torch, [(got.base, want.base),
                             (got.upper, want.upper),
                             (got.upper_pos, want.upper_pos)]):
        bad.append("B6")
    del got, want
    moved_b6, touched, level_ids = update_bytes(torch, plan, idxs_t, item)
    one_call = hasattr(upd_ops, "update_levels_cuda")
    b6 = update_launches(torch, h, idxs_t, vals_t)[0] if one_call \
        else parent_b6(torch, h, idxs_t)
    names = UPDATE_KERNELS if one_call else PARENT_UPDATE_KERNELS
    print(f"[{label}] against the plain versions (integer views): "
          f"{'equal' if not bad else 'DIFFER: ' + ', '.join(bad)}; B6 "
          f"touched chunks per level {touched}; B6 as "
          f"{'one host call' if one_call else 'three calls'}")
    ls, rs = (torch.from_numpy(a).cuda()
              for a in make_queries(n, 1 << 24, "mixed", seed=1))
    flush = l2_flusher(torch)
    evict_first = []

    def eviction():
        first, later = eviction_rounds(torch)
        evict_first.append(first)
        return later

    copies = lambda: (h.base.clone(), h.upper.clone(),  # noqa: E731
                      h.upper_pos.clone())
    fns = {
        "B1 positions": lambda: build_hierarchy_fused(x, plan, True),
        "B1 value-only": lambda: build_hierarchy_fused(x, plan, False),
        "B3 positions": lambda: build_hierarchy_percall(x, plan, True),
        "B3 value-only": lambda: build_hierarchy_percall(x, plan, False),
        "torch.min": lambda: torch.min(x.view(-1, c), dim=1),
        "torch.amin": lambda: torch.amin(x.view(-1, c), dim=1),
        "B6": b6,
        "B6 yardstick": lambda: torch.min(
            x.view(-1, c).index_select(0, level_ids[0]), dim=1),
        "RMQ.update": lambda: rc.update(idxs_t, vals_t),
        "copy": copies,
        "B2": lambda: rmq_fused_batch(h, ls, rs, True),
    }
    timed = {
        **{k: (lambda f=f: time_ms(torch, f, REPS)) for k, f in fns.items()},
        "B6 flushed": lambda: time_flushed(torch, b6, 2 * REPS, flush),
        "eviction": eviction,
    }
    turns = {k: [] for k in timed}
    for _ in range(args.rounds):
        for k, fn in timed.items():
            turns[k].append(fn())
    per_call = kernel_times_in_order(torch, b6, names, 10, flush)
    pos_bytes = plan.capacity * item + plan.upper_size * (item + 4)
    val_bytes = plan.capacity * item + plan.upper_size * item
    bound = {"B1 positions": pos_bytes, "B1 value-only": val_bytes,
             "B3 positions": pos_bytes, "B3 value-only": val_bytes,
             "B6": moved_b6, "B6 flushed": moved_b6}
    out = {}
    for k, ms in turns.items():
        row = {"ms": sum(ms) / len(ms), "min": min(ms), "max": max(ms)}
        if k in bound:
            row["bound_ms"] = bound[k] / HBM_BYTES_PER_S * 1e3
        out[k] = row
    out["eviction"]["first_round_ms"] = evict_first
    out["B6 kernel ms per level"] = None if per_call is None else {
        "mean": [sum(col) / len(col) for col in zip(*per_call)],
        "min": [min(col) for col in zip(*per_call)],
        "max": [max(col) for col in zip(*per_call)],
        "calls": len(per_call)}
    out["plain build"] = {"ms": time_ms(
        torch, lambda: build_hierarchy(x, plan, True), 3, warmup=1)}
    out["turns"] = turns
    print(f"[{label}] times (ms, {args.rounds} rounds; CUDA events of "
          f"{REPS} calls unless named): {json.dumps(out)}")
    print(card_line())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
