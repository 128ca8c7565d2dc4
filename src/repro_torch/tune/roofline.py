"""Roofline analysis of the dry run's records, with a card's constants.

The port of ``repro.tune.roofline``.  Reads the JSONL records of
``repro_torch.launch.dryrun`` (``--all``, optionally ``--calibrate``)
and derives, per (arch x shape):

  compute term    = FLOPs_per_device / peak_FLOPs
  memory term     = bytes_per_device / HBM_bw
  collective term = sum_k factor_k * collective_bytes_k_per_device / link_bw

with the reference's arithmetic, ring factors (all-reduce 2, the others
1), model-FLOP formulas and table format.

The constants are a card's, from :data:`DEVICES`, keyed by
``torch.cuda.get_device_name()``: spec-sheet figures, not measurements.
``NVIDIA H100 80GB HBM3`` (the SXM part): 989e12 FLOP/s bf16 dense,
3.35e12 B/s HBM, and 50e9 B/s a GPU across nodes (one 400 Gb/s NDR link
a GPU: a 16-wide mesh axis spans two nodes of eight, so the slowest link
on it is the network's); within a node NVLink gives 450e9 B/s a
direction (``nvlink_bw``, stated beside it, not used by the terms).
:func:`constants` reads the card's name from the device; a card not in
the table raises, naming it, and there is no default.  On the CPU the
caller names the entry (``constants("NVIDIA H100 80GB HBM3")``).  The
module-level ``PEAK_FLOPS`` / ``HBM_BW`` / ``ICI_BW`` are the H100's, as
the reference keeps its TPU's there; :func:`analyse_record` takes the
constants it is given, or the card's.

  PYTHONPATH=src python -m repro_torch.tune.roofline results.jsonl \
      --device "NVIDIA H100 80GB HBM3" [--chips 256]

renders a dry run's records as the reference's table.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

__all__ = [
    "PEAK_FLOPS", "HBM_BW", "ICI_BW",
    "model_flops_per_device", "analyse_record", "load_results",
    "render_table",
]

H100 = "NVIDIA H100 80GB HBM3"

# spec-sheet figures (NVIDIA's data sheet, SXM part, dense, at 700 W)
DEVICES: Dict[str, Dict[str, float]] = {
    H100: {
        "peak_flops": 989e12,     # bf16 tensor cores, dense
        "hbm_bw": 3.35e12,        # HBM3
        "ici_bw": 50e9,           # one 400 Gb/s NDR link a GPU
        "nvlink_bw": 450e9,       # NVLink 4, a direction, within a node
    },
}

PEAK_FLOPS = DEVICES[H100]["peak_flops"]
HBM_BW = DEVICES[H100]["hbm_bw"]
ICI_BW = DEVICES[H100]["ici_bw"]

_COLL_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def constants(device_name: Optional[str] = None) -> Dict[str, float]:
    """The table's entry for ``device_name`` (None: the name of the card
    ``torch.cuda.get_device_name()`` reports).  Raises for a card the
    table lacks, and without a card when no name is given."""
    if device_name is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "roofline: no CUDA device to read the constants of; name "
                f"the table's entry ({sorted(DEVICES)})")
        device_name = torch.cuda.get_device_name()
    if device_name not in DEVICES:
        raise KeyError(f"roofline: no constants for the card "
                       f"{device_name!r}; known: {sorted(DEVICES)}")
    return dict(DEVICES[device_name])


def model_flops_per_device(arch: str, shape: str, chips: int) -> float:
    from repro_torch.configs.base import get_config
    from repro_torch.launch.cells import SHAPES

    cfg = get_config(arch)
    spec = SHAPES[shape]
    n_active = cfg.num_active_params()
    seq, gb = spec["seq_len"], spec["global_batch"]
    if spec["kind"] == "train":
        total = 6.0 * n_active * (seq * gb)
    elif spec["kind"] == "prefill":
        total = 2.0 * n_active * (seq * gb)
    else:  # decode: one token per sequence
        total = 2.0 * n_active * gb
    return total / chips


def roofline_terms(flops: float, hbm_bytes: float,
                   collective_bytes: Mapping[str, float],
                   device: Mapping[str, float]) -> Dict[str, float]:
    """Seconds of the compute, memory and collective terms."""
    return {
        "compute": flops / device["peak_flops"],
        "memory": hbm_bytes / device["hbm_bw"],
        "collective": sum(_COLL_FACTOR.get(k, 1.0) * v
                          for k, v in collective_bytes.items())
        / device["ici_bw"],
    }


def analyse_record(rec: Dict, chips: int,
                   device: Optional[Mapping[str, float]] = None
                   ) -> Optional[Dict]:
    """The roofline terms of one record; ``device``: the constants
    (default :func:`constants` of the card this process sees)."""
    dev = device or constants()
    if rec.get("skipped"):
        return {
            "arch": rec["arch"], "shape": rec["shape"],
            "skipped": rec["skipped"],
        }
    if not rec.get("ok", False):
        return {
            "arch": rec["arch"], "shape": rec["shape"],
            "error": rec.get("error", "unknown"),
        }
    cal = rec.get("calibrated")
    flops = (cal or rec)["flops_per_device"]
    hbm_bytes = (cal or rec)["bytes_per_device"]
    colls = (cal or rec)["collective_bytes"]

    terms = roofline_terms(flops, hbm_bytes, colls, dev)
    t_compute, t_memory, t_coll = (terms["compute"], terms["memory"],
                                   terms["collective"])
    bottleneck = max(terms, key=terms.get)
    mf = model_flops_per_device(rec["arch"], rec["shape"], chips)
    t_ideal = max(mf / dev["peak_flops"], 1e-12)
    t_bound = max(terms.values())
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec.get("mesh_desc", "single"),
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "bottleneck": bottleneck,
        "model_flops_per_device": mf,
        "hlo_flops_per_device": flops,
        "useful_flops_ratio": mf / max(flops, 1.0),
        # fraction of the ideal (model-flops-only) roofline achieved if
        # the step runs at its binding term
        "roofline_fraction": t_ideal / t_bound if t_bound > 0 else 0.0,
        "calibrated": cal is not None,
        "temp_gib": rec.get("temp_bytes", 0) / 2**30,
        "args_gib": rec.get("argument_bytes", 0) / 2**30,
    }


def load_results(path: str) -> Dict:
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            out[(rec["arch"], rec["shape"])] = rec  # last write wins
    return out


def render_table(rows) -> str:
    hdr = ("| arch | shape | compute(s) | memory(s) | collective(s) | "
           "bottleneck | useful-FLOPs | roofline-frac | temp GiB |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        if "skipped" in r:
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | SKIP | — | — "
                f"| — |"
            )
            continue
        if "error" in r:
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | "
                f"ERROR: {r['error'][:40]} | — | — | — |"
            )
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"{r['bottleneck']} | {r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.2f} | {r['temp_gib']:.1f} |"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("results", help="the dry run's JSONL records")
    ap.add_argument("--device", default=None,
                    help="the table's entry (default: the card's name)")
    ap.add_argument("--chips", type=int, default=None,
                    help="devices of the mesh (default: 256 for a "
                         "'single' record, 512 for a 'multi' one)")
    args = ap.parse_args(argv)
    dev = constants(args.device)
    rows = [analyse_record(rec, args.chips or (
        512 if rec.get("mesh_desc") == "multi" else 256), dev)
        for rec in load_results(args.results).values()]
    print(render_table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
