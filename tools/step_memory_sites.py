#!/usr/bin/env python3
"""Where a train step's memory is at its peak: the live allocations at
that moment, summed by the innermost ``repro_torch`` source line that made
them, on the card and in the dry run's trace.

    python3 tools/step_memory_sites.py --arch hymba-1.5b --batch 4 \\
        --seq 2048 [--where card|trace|both] [--top 25]

The step is ``build_train_step`` of ``get_config(arch)`` with remat
``full`` at ``batch`` x ``seq`` tokens (a frontend model's behind its
prefix), as ``chip_smoke.py`` phases 26-29 (U-X) take it.

* ``card``: one step from ``init_train_state`` on the card under the
  caching allocator's history (``torch.cuda.memory._record_memory_history``
  with Python stacks); prints ``max_memory_allocated``, the requested
  bytes at their peak and, at the moment the step's own allocations peak,
  the live ones by site.  Allocations made on the autograd engine's
  device thread carry no Python frames and are summed under "?".
* ``trace``: ``launch/cells.py`` ``train_cell`` traced on fake tensors
  (the dry run's temps), with the live storages by site at the trace's
  peak.  A full-width trace takes tens of seconds and several GB of host
  memory: run it on the card's host, not on a small machine.

The two lists side by side show what the dry run's ``temp_bytes`` misses
or adds.  Prints the card's name and power limit first on the card.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import traceback
import weakref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def site(frames) -> str:
    """The innermost ``repro_torch`` frame outside the trace itself."""
    for f in frames:
        name = f["filename"] if isinstance(f, dict) else f.filename
        if "repro_torch" in name and "launch/cells.py" not in name:
            line = f["line"] if isinstance(f, dict) else f.lineno
            fn = f["name"] if isinstance(f, dict) else f.name
            return f"{name.split('repro_torch/')[-1]}:{line} {fn}"
    return "?"


def show(title: str, sizes, top: int) -> None:
    groups = collections.Counter()
    for n, where in sizes:
        groups[where] += n
    print(f"{title}: {sum(groups.values())} bytes")
    for where, n in groups.most_common(top):
        print(f"  {n:>14} {where}")


def on_card(torch, cfg, tc, top: int) -> None:
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.train.train_step import (
        build_train_step,
        init_train_state,
    )

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60)
    print(out.stdout.strip())
    state = init_train_state(cfg, tc, device="cuda")
    # as launch/train.py builds it: a frontend model's batch carries its
    # prefix
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticTokenDataset(
        cfg.vocab_size, tc.seq_len, tc.global_batch, seed=tc.seed,
        prefix_tokens=cfg.frontend_tokens if cfg.frontend else 0,
        d_model=cfg.d_model).batch_at(0).items()}
    step = build_train_step(cfg, tc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                             stacks="python")
    try:
        step(state, batch)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    print(f"card: max_memory_allocated {torch.cuda.max_memory_allocated()}, "
          f"requested bytes at their peak "
          f"{torch.cuda.memory_stats()['requested_bytes.all.peak']}")
    live, total, best, at_best = {}, 0, 0, {}
    for ev in snap["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], site(ev.get("frames", [])))
            total += ev["size"]
            if total > best:
                best, at_best = total, dict(live)
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            total -= live.pop(ev["addr"])[0]
    show("card: the step's own allocations at their peak",
         at_best.values(), top)


def in_trace(torch, cfg, tc, top: int) -> None:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import profiling
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.tree import tree_map

    fn, args, _ = cells.train_cell(
        cfg, Mesh(("data", "model"), (1, 1), torch.device("meta")),
        tc.seq_len, tc.global_batch, tc=tc)

    class Sites(cells._trace_mode()):
        """The dry run's trace, keeping each live storage's site."""

        def __init__(self, tensors):
            super().__init__(tensors)
            self.sites, self.at_peak = {}, {}

        def _track(self, t):
            key = t.untyped_storage()._cdata
            if key in self.known:
                return
            self.sites[key] = (t.untyped_storage().nbytes(),
                               site(reversed(traceback.extract_stack())))
            weakref.finalize(t.untyped_storage(),
                             lambda key=key: self.sites.pop(key, None))
            before = self.peak
            super()._track(t)
            if self.peak > before:
                self.at_peak = dict(self.sites)

    with FakeTensorMode(), profiling.dry_launches():
        fake = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), args)
        mode = Sites(cells._tensors(fake))
        with mode:
            fn(*fake)
    show("trace: temps at their peak", mode.at_peak.values(), top)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--seq", type=int, required=True)
    ap.add_argument("--where", choices=("card", "trace", "both"),
                    default="both")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.configs import TrainConfig, get_config

    cfg = get_config(args.arch)
    tc = TrainConfig(total_steps=3, warmup_steps=1, seq_len=args.seq,
                     global_batch=args.batch, remat_policy="full", seed=0)
    if args.where in ("card", "both"):
        if not torch.cuda.is_available():
            print("step_memory_sites: no CUDA device", file=sys.stderr)
            return 1
        on_card(torch, cfg, tc, args.top)
    if args.where in ("trace", "both"):
        in_trace(torch, cfg, tc, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
