"""Training entry point with restore-or-init, async checkpoints and the
failure drill.

The port of ``repro.launch.train`` for one process on one device, with
the reference's flags and defaults.  It runs on the card unless
``--device cpu`` is given; parameters come from a seeded generator, data
from :class:`repro_torch.data.SyntheticTokenDataset`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --smoke --steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --steps 5 --seq-len 2048 --global-batch 8 --remat full
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
      --smoke --steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm3-4b \\
      --smoke --steps 2 --device cpu

It trains every family; a frontend model's batches carry a ``"prefix"``
of synthetic embeddings.

Failure drill: ``--inject-failure-at N`` raises before step N; the loop
drains the checkpoint writer, restarts, restores the latest checkpoint
and continues, so the loss curve continues from the checkpointed step.
Model-parallel training (sharded parameters over the mesh, the
distributed start-up and the heartbeat monitor of the reference) waits
for ROADMAP A10b: ``--model-parallel`` other than 1 raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional


class SimulatedFailure(RuntimeError):
    pass


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="minimal")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--checkpoint-every", type=int, default=25,
                    help="steps between checkpoints (and one at the last "
                         "step); 0 writes none")
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def train_loop(args: argparse.Namespace) -> Dict:
    """One run from the latest checkpoint (or from init) to ``--steps``.

    Returns ``{"losses", "final_step", "steps"}``; ``steps`` holds each
    step's loss, grad norm, learning rate and host seconds to the end of
    its device work.
    """
    import torch

    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.configs.base import (
        TrainConfig,
        get_config,
        get_smoke_config,
    )
    from repro_torch.core.api import resolve_device
    from repro_torch.data.pipeline import SyntheticTokenDataset
    from repro_torch.train.train_step import (
        build_train_step,
        init_train_state,
    )

    if args.model_parallel != 1:
        raise NotImplementedError(
            "--model-parallel needs sharded training over the mesh, which "
            "is not ported yet (ROADMAP A10b); the port trains on one "
            "device")
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    tc = TrainConfig(
        total_steps=args.steps,
        warmup_steps=max(args.steps // 10, 1),
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        microbatches=args.microbatches,
        remat_policy=args.remat,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        seed=args.seed,
    )
    dev = resolve_device(args.device)
    step_fn = build_train_step(cfg, tc)
    dataset = SyntheticTokenDataset(
        vocab_size=cfg.vocab_size, seq_len=tc.seq_len,
        global_batch=tc.global_batch, seed=tc.seed,
        prefix_tokens=cfg.frontend_tokens if cfg.frontend else 0,
        d_model=cfg.d_model)
    ckpt = CheckpointManager(tc.checkpoint_dir, async_mode=tc.async_checkpoint)

    # restore-or-init (restart safety)
    state = init_train_state(cfg, tc, device=dev)
    start_step = ckpt.latest_step()
    if start_step is not None:
        state = restore_checkpoint(tc.checkpoint_dir, start_step, state)
        print(f"[train] restored checkpoint @ step {start_step}")
    else:
        start_step = 0

    losses, steps = [], []
    t_last = time.perf_counter()
    try:
        for i in range(start_step, tc.total_steps):
            if args.inject_failure_at is not None \
                    and i == args.inject_failure_at:
                raise SimulatedFailure(f"injected node failure at step {i}")
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in dataset.batch_at(i).items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])   # waits for the step's device work
            steps.append({"step": i + 1, "loss": loss,
                          "grad_norm": float(metrics["grad_norm"]),
                          "lr": float(metrics["lr"]),
                          "seconds": time.perf_counter() - t0})
            losses.append(loss)
            if tc.checkpoint_every > 0 and (
                    (i + 1) % tc.checkpoint_every == 0
                    or i + 1 == tc.total_steps):
                ckpt.save(i + 1, state)
            if (i + 1) % args.log_every == 0:
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                print(f"[train] step {i + 1}/{tc.total_steps} "
                      f"loss={loss:.4f} lr={steps[-1]['lr']:.2e} "
                      f"gnorm={steps[-1]['grad_norm']:.2f} "
                      f"({dt / args.log_every:.2f}s/step)")
    finally:
        # Drain in-flight async checkpoint writes on every exit (normal
        # completion, the injected failure, a real crash) before any
        # restart scans for the latest durable step.  Read before the inner
        # except: inside it sys.exc_info() would report the writer error.
        unwinding = sys.exc_info()[0] is not None
        try:
            try:
                ckpt.wait()
            except Exception as werr:  # noqa: BLE001
                # while unwinding another exception a buffered writer error
                # must not mask it; on a normal exit it is the failure
                if not unwinding:
                    raise
                print(f"[train] checkpoint writer error during teardown: "
                      f"{werr}")
        finally:
            ckpt.close()
    return {"losses": losses, "final_step": tc.total_steps, "steps": steps}


def run(args: argparse.Namespace) -> Dict:
    """:func:`train_loop` with the restart loop of the failure drill.
    Returns its result with ``restarts``; raises :class:`SimulatedFailure`
    once the restart budget is spent."""
    restarts = 0
    while True:
        try:
            out = train_loop(args)
        except SimulatedFailure as e:
            restarts += 1
            print(f"[train] FAILURE: {e} - restart {restarts}")
            if restarts > args.max_restarts:
                print("[train] restart budget exhausted")
                raise
            # the injected failure fires once; resume from the latest
            # checkpoint
            args.inject_failure_at = None
            continue
        if out["losses"]:
            print(f"[train] done: final loss {out['losses'][-1]:.4f}")
        out["restarts"] = restarts
        return out


def main(argv: Optional[List[str]] = None) -> int:
    try:
        run(parse_args(argv))
    except SimulatedFailure:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
