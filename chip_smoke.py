#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and hold every kernel to
its plain PyTorch version.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout; it needs one card, ``nvcc`` and nothing
outside the repository.  Phases:

1. the card: name and power limit (``nvidia-smi``), no card -> exit 1;
2. the kernels: one ``nvcc`` per CUDA source, all at once, with the
   compiler's ``-Xptxas -v`` report (registers, shared memory, spills);
3. geometry A, the main path at the paper's scale: n = 2^30 float32 from
   ``make_input_array(seed)``, c=128, t=64, positions on.  ``RMQ.build``
   with ``backend="fused"`` and ``"cuda"``, then 2^24 ``make_queries``
   "mixed" spans through ``query`` and ``query_index`` on both, and one
   fused batch that returns both planes.  Launch counters are zeroed just
   before and read just after;
4. geometries B (n = 2^27 - 777, capacity 2^27: a full c*t = 8192 top),
   C (c=4, n=2^20: seven levels, sub-warp chunks), D (float64, c=32,
   capacity > n, value-only and position builds) and E (a single-level
   plan), each driven and read the same way;
5. every hierarchy and answer is held bit for bit (tolerance 0: min and
   argmin are exact) against the plain build and the plain walk on the
   card, and 256 sampled spans per geometry against torch.min / first
   argmin over the slice;
6. times at geometry A with CUDA events, warmed up, over many launches:
   each kernel beside its bound (bytes at 3.35 TB/s), its plain version
   and a one-call PyTorch yardstick where one exists.

The output ends with one ``{"kernels": [...]}`` line (per kernel: its
launches on geometry A's main path, its largest difference from the
plain version over all geometries, its times and bound) and, last,
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
before those lines.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
SECTOR = 32                # bytes of one device-memory access sector

KERNELS = {
    "hierarchy_fused": dict(
        source="src/repro_torch/csrc/hierarchy_fused.cu",
        replaces="src/repro/kernels/hierarchy_fused/kernel.py:128"),
    "rmq_fused": dict(
        source="src/repro_torch/csrc/rmq_fused.cu",
        replaces="src/repro/kernels/rmq_fused/kernel.py:221"),
    "hierarchy_build": dict(
        source="src/repro_torch/csrc/hierarchy_build.cu",
        replaces="src/repro/kernels/hierarchy_build/kernel.py:46"),
    "rmq_scan": dict(
        source="src/repro_torch/csrc/rmq_scan.cu",
        replaces="src/repro/kernels/rmq_scan/kernel.py:223"),
}


class SmokeFailure(Exception):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        kernels = run(torch, args.seed)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# helpers on the card
# ---------------------------------------------------------------------------
def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(torch, pairs) -> float:
    """Largest |got - want| over (got, want) pairs; equal infinities and
    equal positions count 0, a shape or dtype mismatch is infinite."""
    worst = 0.0
    for got, want in pairs:
        if got.shape != want.shape or got.dtype != want.dtype:
            return float("inf")
        if torch.equal(got, want):
            continue
        g, w = got.double(), want.double()
        diff = torch.where(g == w, torch.zeros_like(g), (g - w).abs())
        worst = max(worst, float(torch.nan_to_num(diff, nan=float("inf"))
                                 .max()))
    return worst


def level0_bytes(torch, ls, rs, c: int, itemsize: int) -> int:
    """Device-memory bytes a batch must read from level 0: the sectors of
    each query's partial chunks [l, ceil(l/c)*c) and [floor(r/c)*c, r]
    (their union when the span sits in one chunk).  Full chunks are
    answered from the upper levels, which stay in L2 and are not
    counted, so this is a lower bound."""
    lo = ls.long()
    hi = rs.long() + 1
    a_hi = torch.minimum(-((-lo) // c) * c, hi)
    b_lo = torch.maximum((hi // c) * c, lo)

    def sectors(s, e):
        n = (e * itemsize + SECTOR - 1) // SECTOR - (s * itemsize) // SECTOR
        return torch.where(e > s, n, torch.zeros_like(n))

    one = b_lo <= a_hi
    both = sectors(lo, a_hi) + sectors(b_lo, hi)
    union = sectors(torch.minimum(lo, b_lo), torch.maximum(a_hi, hi))
    return int(torch.where(one, union, both).sum()) * SECTOR


def bound_ms(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def brute_force_check(torch, x, ls, rs, vals, pos, samples: int, seed: int,
                      n: int) -> None:
    """Sampled spans against torch.min / the first argmin of the slice."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, ls.numel(), (samples,), generator=g)
    for i in idx.tolist():
        l, r = int(ls[i]), int(rs[i])
        require(0 <= l <= r < n, f"query {i} out of range")
        seg = x[l:r + 1]
        want_v = seg.min()
        want_p = l + int(torch.argmin(seg))
        require(bool(vals[i] == want_v), f"value of query {i} = ({l}, {r})")
        if pos is not None:
            require(int(pos[i]) == want_p,
                    f"position of query {i} = ({l}, {r}): "
                    f"{int(pos[i])} != {want_p}")


# ---------------------------------------------------------------------------
# the phases
# ---------------------------------------------------------------------------
def build_kernels() -> float:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    seconds = time.perf_counter() - t0
    for name in _build.SOURCES:
        print(f"== ptxas report: {name}.cu")
        for line in reports.get(name, "(already built)").splitlines():
            if ("Compiling entry" in line or "spill" in line
                    or "registers" in line):
                print("   " + line.strip())
    print(f"kernels built in {seconds:.3f} s (set-up)")
    return seconds


def counters():
    from repro_torch.kernels.hierarchy_build import ops as build_ops
    from repro_torch.kernels.hierarchy_fused import ops as fused_ops
    from repro_torch.kernels.rmq_fused import ops as qfused_ops
    from repro_torch.kernels.rmq_scan import ops as scan_ops

    return {k.name: k for k in (fused_ops.LAUNCHES, qfused_ops.LAUNCHES,
                                build_ops.LAUNCHES, scan_ops.LAUNCHES)}


def drive(torch, name, x, ls, rs, plan, with_positions, seed):
    """The main path at one geometry: both builds and every query entry
    point, counted; then everything held to the plain versions."""
    from repro_torch.core import RMQ, build_hierarchy, rmq_walk_batch
    from repro_torch.kernels.rmq_fused.ops import rmq_fused_batch

    count = counters()
    for k in count.values():
        k.reset()
    rf = RMQ.build(x, with_positions=with_positions, backend="fused",
                   plan=plan, device="cuda")
    rc = RMQ.build(x, with_positions=with_positions, backend="cuda",
                   plan=plan, device="cuda")
    out = {"fused_v": rf.query(ls, rs), "cuda_v": rc.query(ls, rs)}
    if with_positions:
        out["fused_p"] = rf.query_index(ls, rs)
        out["cuda_p"] = rc.query_index(ls, rs)
        out["both_v"], out["both_p"] = rmq_fused_batch(
            rf.hierarchy, ls, rs, track_pos=True)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in count.items()}

    levels = plan.num_levels
    want = {
        "hierarchy_fused": 1 if levels > 1 else 0,
        "hierarchy_build": levels - 1,
        "rmq_fused": 3 if with_positions else 1,
        "rmq_scan": 2 if with_positions else 1,
    }
    require(launches == want,
            f"{name}: launches {launches}, the contract says {want}")

    hp = build_hierarchy(x, plan, with_positions=with_positions)
    wv, wp = rmq_walk_batch(hp, ls, rs, track_pos=with_positions)
    torch.cuda.synchronize()
    require(wv.shape == ls.shape and bool(torch.isfinite(wv).all()),
            f"{name}: the plain walk's answers are not finite")
    if with_positions:
        require(bool(((wp >= ls) & (wp <= rs)).all()),
                f"{name}: a position lies outside its span")
    err = {}
    build_pairs = []
    for key, r in (("hierarchy_fused", rf), ("hierarchy_build", rc)):
        h = r.hierarchy
        pairs = [(h.base, hp.base), (h.upper, hp.upper)]
        if with_positions:
            pairs.append((h.upper_pos, hp.upper_pos))
        err[key] = max_abs_err(torch, pairs)
        build_pairs += pairs
    q_fused = [(out["fused_v"], wv)]
    q_scan = [(out["cuda_v"], wv)]
    if with_positions:
        q_fused += [(out["fused_p"], wp), (out["both_v"], wv),
                    (out["both_p"], wp)]
        q_scan += [(out["cuda_p"], wp)]
    err["rmq_fused"] = max_abs_err(torch, q_fused)
    err["rmq_scan"] = max_abs_err(torch, q_scan)
    require(all(e == 0.0 for e in err.values()),
            f"{name}: kernels disagree with their plain versions: {err}")
    brute_force_check(torch, x, ls, rs, wv, wp, 256, seed, plan.n)
    print(f"{name}: levels {plan.level_lens}, launches {launches}, "
          f"max_abs_err {err}, brute force 256/256 ok")
    return {"launches": launches, "err": err, "rf": rf, "rc": rc, "hp": hp}


def geometry(torch, n, m, seed, dtype="float32", capacity=None):
    """Input, bounds and plan of one geometry, drawn from the seed."""
    from repro_torch.tune.measure import make_input_array, make_queries

    t0 = time.perf_counter()
    x = torch.from_numpy(make_input_array(n, seed).astype(dtype)).cuda()
    ls, rs = make_queries(n, m, "mixed", seed=seed + 1)
    ls = torch.from_numpy(ls).cuda()
    rs = torch.from_numpy(rs).cuda()
    return x, ls, rs, time.perf_counter() - t0


def run(torch, seed: int):
    from repro_torch.core import build_hierarchy, make_plan, rmq_walk_batch
    from repro_torch.kernels.hierarchy_build.ops import (
        build_hierarchy_percall,
    )
    from repro_torch.kernels.hierarchy_fused.ops import build_hierarchy_fused
    from repro_torch.kernels.rmq_fused.ops import rmq_fused_batch
    from repro_torch.kernels.rmq_scan.ops import (
        rmq_index_batch_cuda,
        rmq_value_batch_cuda,
    )

    print(card_line())
    print(f"device: {torch.cuda.get_device_name(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels()

    # -- geometry A: the main path -----------------------------------------
    n, m, c, t = 1 << 30, 1 << 24, 128, 64
    x, ls, rs, setup = geometry(torch, n, m, seed)
    plan = make_plan(n, c=c, t=t)
    print(f"A: n=2^30 float32, m=2^24 mixed, data made in {setup:.3f} s")
    a = drive(torch, "A", x, ls, rs, plan, True, seed)
    main_launches = a["launches"]
    errors = dict(a["err"])
    h = a["rf"].hierarchy
    hp = a["hp"]
    del a

    ms = {
        "hierarchy_fused": time_ms(
            torch, lambda: build_hierarchy_fused(x, plan, True), 10),
        "hierarchy_build": time_ms(
            torch, lambda: build_hierarchy_percall(x, plan, True), 10),
        "rmq_fused": time_ms(
            torch, lambda: rmq_fused_batch(h, ls, rs, True), 10),
        "rmq_scan": time_ms(
            torch, lambda: (rmq_value_batch_cuda(h, ls, rs),
                            rmq_index_batch_cuda(h, ls, rs)), 10),
    }
    detail = {
        "rmq_fused value plane": time_ms(
            torch, lambda: rmq_fused_batch(h, ls, rs, False), 10),
        "rmq_scan value plane": time_ms(
            torch, lambda: rmq_value_batch_cuda(h, ls, rs), 10),
        "rmq_scan index plane": time_ms(
            torch, lambda: rmq_index_batch_cuda(h, ls, rs), 10),
        "build value-only fused": time_ms(
            torch, lambda: build_hierarchy_fused(x, plan, False), 10),
        "build value-only per-level": time_ms(
            torch, lambda: build_hierarchy_percall(x, plan, False), 10),
    }
    plain_build = time_ms(torch, lambda: build_hierarchy(x, plan, True), 3,
                          warmup=1)
    plain_walk = time_ms(
        torch, lambda: rmq_walk_batch(hp, ls, rs, True), 1, warmup=1)
    lib_min = time_ms(torch, lambda: torch.min(x.view(-1, c), dim=1), 10)
    lib_amin = time_ms(torch, lambda: torch.amin(x.view(-1, c), dim=1), 10)
    plain = {"hierarchy_fused": plain_build, "hierarchy_build": plain_build,
             "rmq_fused": plain_walk, "rmq_scan": plain_walk}
    library = {"hierarchy_fused": lib_min, "hierarchy_build": lib_min,
               "rmq_fused": None, "rmq_scan": None}

    item = x.element_size()
    build_bytes = plan.capacity * item + plan.upper_size * (item + 4)
    q_bytes = level0_bytes(torch, ls, rs, c, item) + m * (8 + item + 4)
    bounds = {
        "hierarchy_fused": bound_ms(build_bytes, plan.capacity),
        "hierarchy_build": bound_ms(build_bytes, plan.capacity),
        "rmq_fused": bound_ms(q_bytes, q_bytes / item),
        "rmq_scan": bound_ms(q_bytes, q_bytes / item),
    }
    print(f"A times (ms, CUDA events): {json.dumps(ms)}")
    print(f"A detail (ms): {json.dumps(detail)}")
    print(f"A plain (ms): build {plain_build}, walk {plain_walk}; "
          f"torch.min(x.view(-1, c), dim=1) {lib_min}, torch.amin {lib_amin}")
    print(f"A bounds (ms): {json.dumps(bounds)}; level-0 bytes of the "
          f"batch {q_bytes}")
    for key in ("fused", "cuda"):
        b = ms["hierarchy_fused" if key == "fused" else "hierarchy_build"]
        q = ms["rmq_fused" if key == "fused" else "rmq_scan"]
        print(f"A backend {key}: build {b} ms, value+index "
              f"{q * 1e6 / m} ns/query")
    del h, hp, x, ls, rs
    torch.cuda.empty_cache()

    # -- geometries B..E ---------------------------------------------------
    others = [
        ("B", dict(n=(1 << 27) - 777, m=1 << 22), dict(c=128, t=64,
                                                       capacity=1 << 27),
         True),
        ("C", dict(n=1 << 20, m=1 << 20), dict(c=4, t=64), True),
        ("D", dict(n=(1 << 20) + 333, m=1 << 18, dtype="float64"),
         dict(c=32, t=16, capacity=1 << 21), True),
        ("D value-only", dict(n=(1 << 20) + 333, m=1 << 18,
                              dtype="float64"),
         dict(c=32, t=16, capacity=1 << 21), False),
        ("E", dict(n=5000, m=1 << 16), dict(c=128, t=64), True),
    ]
    for name, data, geo, with_pos in others:
        x, ls, rs, _ = geometry(torch, data["n"], data["m"], seed,
                                data.get("dtype", "float32"))
        plan_g = make_plan(data["n"], **geo)
        r = drive(torch, name, x, ls, rs, plan_g, with_pos, seed)
        for key, e in r["err"].items():
            errors[key] = max(errors[key], e)
        if name == "B":
            hb = r["rf"].hierarchy
            tb = time_ms(torch, lambda: rmq_fused_batch(hb, ls, rs, True),
                         10)
            print(f"B: fused value+index {tb * 1e6 / data['m']} ns/query "
                  f"(top of {plan_g.top_len} entries staged)")
            del hb
        del r, x, ls, rs
        torch.cuda.empty_cache()

    out = []
    for name, meta in KERNELS.items():
        b, by = bounds[name]
        out.append({
            "name": name, "route": "cuda", **meta,
            "launches": main_launches[name], "max_abs_err": errors[name],
            "ms": ms[name], "plain_ms": plain[name], "bound_ms": b,
            "bound_by": by, "library_ms": library[name],
        })
    require(all(k["launches"] > 0 for k in out),
            "a kernel of the main path was never launched")
    return out


if __name__ == "__main__":
    sys.exit(main())
