"""Serve a small LM (the PyTorch / CUDA port) with batched requests and
RMQ-backed KV eviction.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
                                                    [--small]

During decode, per-token attention mass accumulates into importance
scores; when the live context passes the budget, the engine answers a
batch of RMQ_index queries over the scores to find the least important
tokens, evicts them, and keeps decoding.  Three modes: eviction off,
eviction through a private query engine, and eviction as the
``kv-eviction`` tenant of the serving tier (``repro_torch.serving``),
its flusher on a background thread.  Weights are random, from a seed.
``--small`` shrinks the model and the run for the host.
"""

import argparse
import time

import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core.api import resolve_device
from repro_torch.models.lm import init_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.serving import ServingTier


def small_lm() -> ModelConfig:
    return ModelConfig(
        name="serve-demo-60m",
        family="dense",
        num_layers=8,
        d_model=512,
        num_heads=8,
        num_kv_heads=2,
        head_dim=64,
        d_ff=1536,
        vocab_size=8192,
        dtype="float32",
    )


def tiny_lm() -> ModelConfig:
    """The same family at two layers, for the host."""
    return ModelConfig(
        name="serve-demo-tiny",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        dtype="float32",
    )


def run(cfg: ModelConfig, batch: int = 8, prompt_len: int = 64,
        max_new: int = 160, budget: int = 160, device=None,
        log=print) -> dict:
    """Generate in the three modes; returns ``{mode: output}`` with the
    tier's tenant stats under ``"tenant"``."""
    dev = resolve_device(device)
    params = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen).to(dev)
    outs = {}
    for mode in ("off", "engine", "serving-tier"):
        evict = mode != "off"
        sc = ServeConfig(
            seq_len=prompt_len + max_new + 8,
            batch=batch,
            kv_cache_dtype="float32",
            eviction_enabled=evict,
            eviction_budget=budget,
            eviction_window=32,
            rmq_chunk=16,
            rmq_threshold=4,
        )
        tier = ServingTier() if mode == "serving-tier" else None
        engine = ServeEngine(cfg, params, sc, serving_tier=tier)
        t0 = time.time()
        if tier is not None:
            with tier:                  # the deadline flusher thread
                out = engine.generate(prompts, max_new)
        else:
            out = engine.generate(prompts, max_new)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        total = batch * max_new
        log(f"[eviction {mode:12s}] {total} tokens in {dt:5.1f}s "
            f"({total / dt:6.1f} tok/s)  live_ctx={out['final_pos']:4d}  "
            f"evicted={out['evicted']}")
        if evict:
            assert out["final_pos"] <= budget + 1
            assert out["evicted"] > 0
        outs[mode] = out
        if tier is not None:
            t = tier.stats()["tenants"]["kv-eviction"]
            outs["tenant"] = t
            log(f"  tenant kv-eviction: flushes={t['flushes']} "
                f"snapshot_swaps={t['snapshot_swaps']} "
                f"p99={t['latency_s']['p99'] * 1e3:.2f}ms "
                f"rejected={t['rejected_queue_full']}")
    # the tenant answers every round as the private engine does
    assert torch.equal(outs["engine"]["tokens"],
                       outs["serving-tier"]["tokens"])
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the host")
    ap.add_argument("--small", action="store_true",
                    help="a two-layer model and a short run (the host)")
    args = ap.parse_args(argv)
    if args.small:
        run(tiny_lm(), batch=2, prompt_len=16, max_new=40, budget=32,
            device=args.device)
    else:
        run(small_lm(), device=args.device)


if __name__ == "__main__":
    main()
