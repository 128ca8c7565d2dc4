"""The multi-pod dry run: every (architecture x input shape) cell
traced on fake tensors over a production mesh.

The port of ``repro.launch.dryrun``.  For each cell
:func:`repro_torch.launch.cells.run_cell` runs the port's step once under
``FakeTensorMode`` on one rank's blocks of the meta production mesh
(``make_production_mesh``: 16 x 16, or 2 x 16 x 16 with ``--mesh
multi``) and records its FLOPs, bytes, memory and collective bytes a
device.  It needs no card and no process group: it runs on the CPU.
The reference's ``XLA_FLAGS`` prologue (512 fake host devices) has no
counterpart.  ``--no-sequence-sharding`` is accepted and recorded (as
``"sequence_sharding": false``); the port's ``make_sharder`` is an
identity, so it changes nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single \\
      --out results.jsonl
Each cell runs in-process; ``--subprocess`` runs each in its own process.
Every record is one JSON line with the reference's keys plus ``ok``; a
skipped cell is recorded as skipped, a cell that raises with ``ok``
false and its error.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import traceback


def _run_one(arch: str, shape: str, mesh_name: str, args) -> dict:
    from repro_torch.launch.cells import best_config, run_cell
    from repro_torch.launch.mesh import make_production_mesh

    if args.best:
        bc = best_config(arch, shape,
                         num_chips=512 if mesh_name == "multi" else 256)
        args.layout = bc["layout"]
        args.remat = bc["remat"]
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
    res = run_cell(
        arch, shape, mesh,
        mesh_desc=mesh_name,
        remat_policy=args.remat,
        microbatches=args.microbatches,
        layout=args.layout,
    )
    out = res.to_json()
    if args.calibrate and not res.skipped:
        from repro_torch.launch.cells import calibrate_cell

        out["calibrated"] = calibrate_cell(
            arch, shape, mesh, mesh_name,
            remat_policy=args.remat,
            microbatches=args.microbatches,
            layout=args.layout,
        )
    if args.no_sequence_sharding:
        out["sequence_sharding"] = False   # recorded; it changes nothing
    out["ok"] = True
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--subprocess", action="store_true")
    ap.add_argument("--no-sequence-sharding", action="store_true",
                    help="recorded; the port's sharder is an identity")
    ap.add_argument("--remat", default="minimal",
                    choices=["none", "minimal", "full", "names"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--layout", default="tp_sp",
                    choices=["tp_sp", "fsdp"])
    ap.add_argument("--best", action="store_true",
                    help="use the per-arch layout/remat of "
                         "launch.cells.BEST_CONFIG")
    ap.add_argument("--calibrate", action="store_true",
                    help="also trace 2- and 4-layer cells and extrapolate "
                         "per-layer FLOPs/bytes/collectives")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from repro_torch.configs.base import ARCH_IDS
    from repro_torch.launch.cells import SHAPES, cell_is_skipped

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            print("dryrun: --arch and --shape required unless --all",
                  file=sys.stderr)
            return 2
        cells = [(args.arch, args.shape)]

    rc = 0
    sink = open(args.out, "a") if args.out else None
    try:
        for arch, shape in cells:
            skip = cell_is_skipped(arch, shape)
            if skip:
                rec = {"arch": arch, "shape": shape, "mesh_desc": args.mesh,
                       "skipped": skip, "ok": True}
                print(f"[SKIP] {arch} x {shape}: {skip}")
            elif args.subprocess:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", args.mesh,
                       "--remat", args.remat, "--layout", args.layout,
                       "--microbatches", str(args.microbatches)]
                for flag in ("no_sequence_sharding", "best", "calibrate"):
                    if getattr(args, flag):
                        cmd.append("--" + flag.replace("_", "-"))
                if args.out:
                    cmd += ["--out", args.out]
                if subprocess.run(cmd).returncode != 0:
                    rc = 1
                continue
            else:
                try:
                    rec = _run_one(arch, shape, args.mesh, args)
                    print(
                        f"[OK]   {arch} x {shape} x {args.mesh}: "
                        f"flops/dev={rec['flops_per_device']:.3e} "
                        f"bytes/dev={rec['bytes_per_device']:.3e} "
                        f"args={rec['argument_bytes'] / 2**30:.2f}GiB "
                        f"temp={rec['temp_bytes'] / 2**30:.2f}GiB "
                        f"trace={rec['compile_seconds']:.1f}s")
                    colls = rec.get("collective_bytes", {})
                    if colls:
                        summary = ", ".join(
                            f"{k}={v / 2**20:.1f}MiB"
                            for k, v in sorted(colls.items()))
                        print(f"       collectives: {summary}")
                except Exception as e:  # noqa: BLE001 - recorded per cell
                    rec = {"arch": arch, "shape": shape,
                           "mesh_desc": args.mesh, "ok": False,
                           "error": f"{type(e).__name__}: {e}"}
                    print(f"[FAIL] {arch} x {shape} x {args.mesh}: {e}")
                    traceback.print_exc()
                    rc = 1
            if sink:
                sink.write(json.dumps(rec) + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())
