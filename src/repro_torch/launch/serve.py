"""Serving driver: batched generation with optional RMQ-backed eviction.

The port of ``repro.launch.serve``, with the same flags and defaults
(``rmq_chunk=16``, ``rmq_threshold=4``, budget ``cache_len * 3 // 4``,
16 protected tokens).  It runs on the card unless ``--device cpu`` is
given; weights and prompts are random, from seeded generators.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --smoke --evict --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --evict --prompt-len 2048 --max-new 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --prompt-len 2048 --max-new 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b \\
      --evict --prompt-len 2048 --max-new 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b \\
      --evict --prompt-len 2048 --max-new 64

It serves every family, MLA (minicpm3) on its latent cache.  A frontend
model (internvl2, musicgen) gets ``synthetic_frontend_embeddings`` as its
prefix, and its cache holds the prefix's positions too.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--evict", action="store_true")
    ap.add_argument("--budget", type=int, default=0)
    ap.add_argument("--protected", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.base import (
        ServeConfig,
        get_config,
        get_smoke_config,
    )
    from repro_torch.core.api import resolve_device
    from repro_torch.models.frontends import synthetic_frontend_embeddings
    from repro_torch.models.lm import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    dev = resolve_device(args.device)
    f = cfg.frontend_tokens if cfg.frontend else 0
    cache_len = args.cache_len or (f + args.prompt_len + args.max_new + 8)
    sc = ServeConfig(
        seq_len=cache_len,
        batch=args.batch,
        kv_cache_dtype="float32" if args.smoke else "bfloat16",
        eviction_enabled=args.evict,
        eviction_budget=args.budget or (cache_len * 3 // 4),
        eviction_window=args.protected,
        rmq_chunk=16,
        rmq_threshold=4,
    )
    params = init_params(cfg, seed=0, device=dev)
    engine = ServeEngine(cfg, params, sc)

    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    prefix = synthetic_frontend_embeddings(cfg, args.batch, device=dev)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.max_new, prefix_embeddings=prefix)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = int(out["tokens"].numel())
    print(
        f"[serve] {args.arch} on {dev}: generated {toks} tokens in "
        f"{dt:.2f}s ({toks / dt:.1f} tok/s), evicted={out['evicted']}, "
        f"final_pos={out['final_pos']}")
    print(f"[serve] sample: {out['tokens'][0, :16].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
