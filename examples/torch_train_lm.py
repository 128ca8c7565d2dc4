"""End-to-end example (the PyTorch / CUDA port): train a ~100M-parameter
llama-style LM for a few hundred steps, with async checkpointing.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
                                                    [--device cpu]

The port's production substrate (the train step with remat and AdamW,
the deterministic synthetic data pipeline, the async checkpoint manager)
on one device, the card by default.  The model is dense float32, so its
attention forward runs the CUDA-core flash-attention kernel on the card
(its backward is the plain attention's).  ``--small`` swaps in a
two-layer model of the same family for a quick run on the host.
"""

import argparse
import math
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.api import resolve_device
from repro_torch.data.pipeline import SyntheticTokenDataset
from repro_torch.train import build_train_step, init_train_state


def lm_100m() -> ModelConfig:
    """~100M params: 12L, d=640, llama3-style."""
    return ModelConfig(
        name="llama-100m",
        family="dense",
        num_layers=12,
        d_model=640,
        num_heads=10,
        num_kv_heads=5,
        head_dim=64,
        d_ff=2048,
        vocab_size=32000,
        rope_theta=500_000.0,
        dtype="float32",
    )


def lm_small() -> ModelConfig:
    """The same family at two layers and d=64, for the host."""
    return ModelConfig(
        name="llama-small",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        rope_theta=500_000.0,
        dtype="float32",
    )


def run(cfg: ModelConfig, steps: int, seq_len: int, batch: int,
        ckpt_dir: str, device=None, log_every: int = 25, log=print):
    """Train ``steps`` steps; returns ``(first loss, last loss)``."""
    dev = resolve_device(device)
    tc = TrainConfig(
        learning_rate=6e-4,
        warmup_steps=max(min(30, steps // 10), 1),
        total_steps=steps,
        seq_len=seq_len,
        global_batch=batch,
        remat_policy="minimal",
        checkpoint_every=100,
        checkpoint_dir=ckpt_dir,
    )
    state = init_train_state(cfg, tc, device=dev)
    step = build_train_step(cfg, tc)
    data = SyntheticTokenDataset(vocab_size=cfg.vocab_size,
                                 seq_len=tc.seq_len,
                                 global_batch=tc.global_batch)
    ckpt = CheckpointManager(tc.checkpoint_dir, async_mode=True)
    t0 = time.perf_counter()
    first = loss = None
    try:
        for i in range(tc.total_steps):
            tokens = {k: torch.from_numpy(v).to(dev)
                      for k, v in data.batch_at(i).items()}
            state, metrics = step(state, tokens)
            loss = float(metrics["loss"])   # waits for the step's work
            if first is None:
                first = loss
            if (i + 1) % log_every == 0:
                toks = tc.global_batch * tc.seq_len * log_every
                dt = time.perf_counter() - t0
                t0 = time.perf_counter()
                log(f"step {i + 1:4d}  loss {loss:.4f}  "
                    f"lr {float(metrics['lr']):.2e}  "
                    f"{toks / dt:,.0f} tok/s")
            if (i + 1) % tc.checkpoint_every == 0:
                ckpt.save(i + 1, state)
        ckpt.wait()
    finally:
        ckpt.close()
    return first, loss


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--small", action="store_true",
                    help="a two-layer model of the same family")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the host")
    args = ap.parse_args(argv)

    cfg = lm_small() if args.small else lm_100m()
    print(f"model: {cfg.name}, ~{cfg.num_params() / 1e6:.0f}M params")
    first, loss = run(cfg, args.steps, args.seq_len, args.batch,
                      args.ckpt_dir, device=args.device)
    print(f"loss: {first:.3f} -> {loss:.3f} (random-chance NLL = "
          f"ln({cfg.vocab_size}) = {math.log(cfg.vocab_size):.2f})")
    assert loss < first, "training must reduce loss"


if __name__ == "__main__":
    main()
