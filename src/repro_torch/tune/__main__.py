"""CLI: run the autotuner on a device and write the port's tuning cache.

    python -m repro_torch.tune [--out results/tuning_cache_torch.json]
                               [--sizes 1048576 16777216 ...]
                               [--tiny] [--m 4096] [--repeats 3]
                               [--report PATH] [--platform NAME]
                               [--device cuda|cpu]

The search runs on the card by default (``--device cpu`` for a CPU
smoke).  ``--tiny`` is the smoke configuration: one small size, the
small-chunk geometries, one repeat; it drives the whole search and the
save in seconds and writes a valid (not representative) cache.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.tune.cache import DEFAULT_CACHE_PATH
from repro_torch.tune.search import TINY_GEOMETRIES, Autotuner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="Measure RMQ geometry/engine winners on a device and "
                    "persist them as a tuning cache.")
    ap.add_argument("--out", default=DEFAULT_CACHE_PATH,
                    help="cache JSON output path "
                         "(default: results/tuning_cache_torch.json)")
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[2**16, 2**18, 2**20],
                    help="array sizes to tune (default: 2^16 2^18 2^20)")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke: one tiny size, small geometries, "
                         "single repeat")
    ap.add_argument("--m", type=int, default=4096,
                    help="queries per measurement batch")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed repeats per measurement (median)")
    ap.add_argument("--report", default=None,
                    help="also write the full measurement report JSON")
    ap.add_argument("--platform", default=None,
                    help="cache platform key (default: the device's, "
                         "'cuda:<card name>' or 'cpu')")
    ap.add_argument("--device", default=None,
                    help="device to tune on (default: the card)")
    args = ap.parse_args(argv)

    kwargs = dict(m=args.m, repeats=args.repeats, log=print,
                  device=args.device)
    sizes = args.sizes
    if args.tiny:
        sizes = [2**13]
        kwargs.update(geometries=TINY_GEOMETRIES, m=min(args.m, 512),
                      repeats=1, crossover_points=3)

    t0 = time.perf_counter()
    tuner = Autotuner(**kwargs)
    cache, report = tuner.search(sizes, platform=args.platform)
    report["wall_s"] = time.perf_counter() - t0
    cache.save(args.out)
    print(f"wrote {len(cache)} entries to {args.out} "
          f"(search {report['wall_s']} s on {report['platform']})")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"wrote report to {args.report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
