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

Failure drill: ``--inject-failure-at N`` raises before step N (on every
rank); the loop drains the checkpoint writer, restarts, restores the
latest checkpoint and continues, so the loss curve continues from the
checkpointed step.

Model parallelism.  The mesh is the reference's rule over the ranks of
the process group: ``model = min(--model-parallel, world)``, ``data =
world // model`` on ``("data", "model")``; one process with no group is
the ``(1, 1)`` mesh, which trains as ``--model-parallel 1`` does.  The
group comes from the caller (``run(args, group=...)``) or, with
``WORLD_SIZE`` > 1 in the environment, from ``env://``: NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``:

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --steps 10 \
      --seq-len 32 --global-batch 4 --model-parallel 2 --device cpu

With a group each rank stores its blocks of the parameters and of the
AdamW moments by the ``tp_sp`` specs
(:func:`repro_torch.distributed.shardings.train_state_shardings`) and
takes its rows of each micro-batch (:func:`~repro_torch.distributed.
shardings.batch_shardings`; a micro-batch the data axis does not divide
goes whole to every rank), so that micro-batch j of rank r is the r-th
part of the whole batch's micro-batch j.  The step
(:func:`repro_torch.train.train_step.build_train_step` with the mesh)
gathers the whole parameters and holds the whole gradients on every
rank, and init draws the whole masters before it cuts them, so a rank's
peak memory is not below about twice the float32 parameters: the blocks
save the moments' memory, not the weights'.  Rank 0
logs and writes the checkpoints, whose manifest holds every leaf's spec;
a restore cuts the current mesh's blocks, whatever mesh wrote them.  A
:class:`~repro_torch.distributed.fault_tolerance.HeartbeatMonitor` of one
host a rank hears each step.  A MoE model routes over the whole
micro-batch on a data axis > 1: the step passes the mesh and the batch's
data axes down to :func:`repro_torch.models.moe.moe_apply`, whose counts
cross the data ranks.
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


def _mesh_shape(model_parallel: int, world: int):
    """The reference's rule: ``(world // model, model)`` with ``model =
    min(model_parallel, world)``."""
    model = min(model_parallel, world)
    data = world // model
    if data * model != world:
        raise ValueError(f"--model-parallel {model_parallel} makes a "
                         f"({data}, {model}) mesh, which does not cover "
                         f"the {world} ranks")
    return data, model


def train_loop(args: argparse.Namespace, group=None) -> Dict:
    """One run from the latest checkpoint (or from init) to ``--steps``.

    ``group``: the ``torch.distributed`` process group (None: one
    process).  Returns ``{"losses", "final_step", "steps", "state",
    "specs", "mesh"}``; ``steps`` holds each step's loss, aux loss, grad
    norm, learning rate and host seconds to the end of its device work,
    ``state`` this rank's blocks after the last step and ``specs`` their
    specs on ``mesh``.
    """
    import torch

    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.configs.base import (
        TrainConfig,
        get_config,
        get_smoke_config,
    )
    from repro_torch.data.pipeline import SyntheticTokenDataset
    from repro_torch.distributed import sharded
    from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
    from repro_torch.distributed.shardings import (
        batch_shardings,
        entry_axes,
        guard,
        train_state_shardings,
    )
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.train_step import (
        build_train_step,
        init_train_state,
    )

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
    if tc.global_batch % tc.microbatches:
        raise ValueError(f"batch {tc.global_batch} is not a multiple of "
                         f"{tc.microbatches} microbatches")
    world = 1
    if group is not None:
        import torch.distributed as dist

        world = dist.get_world_size(group)
    data, model = _mesh_shape(args.model_parallel, world)
    mesh = make_test_mesh((data, model), ("data", "model"),
                          device=args.device, group=group)
    dev = mesh.device
    log = print if mesh.rank == 0 else (lambda *a, **k: None)
    dataset = SyntheticTokenDataset(
        vocab_size=cfg.vocab_size, seq_len=tc.seq_len,
        global_batch=tc.global_batch, seed=tc.seed,
        prefix_tokens=cfg.frontend_tokens if cfg.frontend else 0,
        d_model=cfg.d_model)
    ckpt = CheckpointManager(tc.checkpoint_dir, async_mode=tc.async_checkpoint,
                             mesh=mesh)
    monitor = HeartbeatMonitor(num_hosts=world)

    # restore-or-init (restart safety): the specs from the whole shapes,
    # then the whole masters cut to this rank's blocks before the moments
    # are made
    specs = train_state_shardings(mesh, init_train_state(cfg, tc,
                                                         device="meta"))
    state = init_train_state(cfg, tc, device=dev, blocks=lambda p:
                             sharded.local_blocks(p, specs.params, mesh))
    start_step = ckpt.latest_step()
    if start_step is not None:
        state = restore_checkpoint(tc.checkpoint_dir, start_step, state,
                                   specs=specs, mesh=mesh)
        log(f"[train] restored checkpoint @ step {start_step}")
    else:
        start_step = 0

    # each micro-batch's rows are split over the data axes; a micro-batch
    # they do not divide goes whole to every rank
    k = tc.microbatches
    micro = {name: v[: len(v) // k] for name, v in dataset.batch_at(0).items()}
    batch_specs = {name: (None,) + tuple(guard(spec, micro[name].shape, mesh))
                   for name, spec in batch_shardings(mesh, micro).items()}
    batch_axes = entry_axes(batch_specs["tokens"][1])
    step_fn = build_train_step(cfg, tc, mesh=mesh, param_specs=specs.params,
                               batch_axes=batch_axes)

    def local_batch(i):
        """This rank's rows of step i's micro-batches, micro-batch by
        micro-batch."""
        out = {}
        for name, v in dataset.batch_at(i).items():
            v = torch.from_numpy(v)
            v = v.reshape(k, len(v) // k, *v.shape[1:])
            v = sharded.local_block(v, batch_specs[name], mesh)
            out[name] = v.reshape(-1, *v.shape[2:]).to(dev)
        return out

    losses, steps = [], []
    t_last = time.perf_counter()
    try:
        for i in range(start_step, tc.total_steps):
            if args.inject_failure_at is not None \
                    and i == args.inject_failure_at:
                raise SimulatedFailure(f"injected node failure at step {i}")
            batch = local_batch(i)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])   # waits for the step's device work
            steps.append({"step": i + 1, "loss": loss,
                          "aux_loss": float(metrics["aux_loss"]),
                          "grad_norm": float(metrics["grad_norm"]),
                          "lr": float(metrics["lr"]),
                          "seconds": time.perf_counter() - t0})
            losses.append(loss)
            monitor.report(0, i)
            if tc.checkpoint_every > 0 and (
                    (i + 1) % tc.checkpoint_every == 0
                    or i + 1 == tc.total_steps):
                ckpt.save(i + 1, state, specs=specs)
            if (i + 1) % args.log_every == 0:
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                log(f"[train] step {i + 1}/{tc.total_steps} "
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
                log(f"[train] checkpoint writer error during teardown: "
                    f"{werr}")
        finally:
            ckpt.close()
    return {"losses": losses, "final_step": tc.total_steps, "steps": steps,
            "state": state, "specs": specs, "mesh": mesh}


def _group_from_env(args: argparse.Namespace):
    """The process group from ``env://`` when ``WORLD_SIZE`` > 1 (the
    variables ``torch.distributed.run`` sets), else None.  On the card
    ``--device`` becomes ``cuda:LOCAL_RANK``."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    import torch
    import torch.distributed as dist

    if args.device is not None and torch.device(args.device).type == "cpu":
        dist.init_process_group("gloo", init_method="env://")
        return dist.group.WORLD
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method="env://", device_id=device)
    args.device = str(device)
    return dist.group.WORLD


def run(args: argparse.Namespace, group=None) -> Dict:
    """:func:`train_loop` with the restart loop of the failure drill, over
    ``group`` (or the environment's, see the module doc).  Returns its
    result with ``restarts``; raises :class:`SimulatedFailure` once the
    restart budget is spent."""
    import torch.distributed as dist

    owned = group is None and _group_from_env(args) is not None
    if owned:
        group = dist.group.WORLD
    rank0 = group is None or dist.get_rank(group) == 0
    log = print if rank0 else (lambda *a, **k: None)
    restarts = 0
    try:
        while True:
            try:
                out = train_loop(args, group=group)
            except SimulatedFailure as e:
                restarts += 1
                log(f"[train] FAILURE: {e} - restart {restarts}")
                if restarts > args.max_restarts:
                    log("[train] restart budget exhausted")
                    raise
                # the injected failure fires once; resume from the latest
                # checkpoint
                args.inject_failure_at = None
                continue
            if out["losses"]:
                log(f"[train] done: final loss {out['losses'][-1]:.4f}")
            out["restarts"] = restarts
            return out
    finally:
        if owned:
            dist.destroy_process_group()


def main(argv: Optional[List[str]] = None) -> int:
    try:
        run(parse_args(argv))
    except SimulatedFailure:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
