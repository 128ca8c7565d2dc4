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
   and a one-call PyTorch yardstick where one exists;
7. mutation at geometry A: one batch of 2^16 random indices with
   duplicates through ``RMQ.update`` on the ``cuda`` and the ``fused``
   index (``hierarchy_update``, three launches each), held against the
   plain ``update_hierarchy`` on the card, sampled spans of the successor
   against torch.min, the predecessor against its own data;
8. the query engine at geometry A over 2^20 "mixed" spans (short buckets
   to ``rmq_short``, mid to ``rmq_scan``, long to the hybrid top), a
   fused engine's ``query_mixed`` (one ``rmq_fused`` launch per bucket)
   and ``query_bulk`` over the 2^24 batch with ``bulk_crossover=2**20``
   (``rmq_bulk``, one launch per bucket of 2^20); every answer against
   the facade on the same index, then ``attach`` of the updated index and
   the same spans against a rebuild.  The engines run with
   ``cache_size=0``: at 2^20 distinct spans the LRU only adds host time
   (the CPU tests cover it);
9. ``StreamingRMQ.append`` of 777 values, ``retire(1024)`` and a query
   batch at geometries B and D, against the plain path and a rebuild;
10. times of the three kernels of phases 7-9 at geometry A beside their
   bounds, their plain versions and the comparison each exists for
   (``rmq_fused`` on the same spans; for ``hierarchy_update`` the
   ``index_select`` + ``torch.min`` pair at level 1), and the whole
   ``RMQ.update`` call with and without the successor's copy.

Each phase sets every launch counter to 0 just before it drives its
path and reads them just after.  The output ends with one
``{"kernels": [...]}`` line (per kernel: its launches on its phase's
path, its largest difference from the plain version over all
geometries, its times and bound) and, last, ``{"ok": true, "device":
{...}}``.  Any failed phase exits non-zero before those lines.
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
    "hierarchy_update": dict(
        source="src/repro_torch/csrc/hierarchy_update.cu",
        replaces="src/repro/kernels/hierarchy_update/kernel.py:68"),
    "rmq_short": dict(
        source="src/repro_torch/csrc/rmq_short.cu",
        replaces="src/repro/kernels/rmq_short/kernel.py:112"),
    "rmq_bulk": dict(
        source="src/repro_torch/csrc/rmq_bulk.cu",
        replaces="src/repro/kernels/rmq_bulk/kernel.py:189"),
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


def wall(torch, fn):
    """``(fn(), seconds)`` on the host clock, to the end of device work."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


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


def span_bytes(torch, ls, rs, itemsize: int) -> int:
    """Device-memory bytes of the 32-byte sectors of each span [l, r]."""
    lo = ls.long() * itemsize // SECTOR
    hi = (rs.long() * itemsize + itemsize + SECTOR - 1) // SECTOR
    return int((hi - lo).sum()) * SECTOR


def partial_chunks(torch, ls, rs, c: int):
    """Level-0 chunk ids of each span's nonempty partial parts (the walk's
    left part [l, ceil(l/c)*c) and right part [floor(r/c)*c, r])."""
    lo = ls.long()
    hi = rs.long() + 1
    a_hi = torch.minimum(-((-lo) // c) * c, hi)
    b_lo = torch.maximum((hi // c) * c, a_hi)
    return torch.cat([(lo // c)[a_hi > lo], (hi // c)[hi > b_lo]])


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
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.kernels.rmq_bulk import ops as bulk_ops
    from repro_torch.kernels.rmq_fused import ops as qfused_ops
    from repro_torch.kernels.rmq_scan import ops as scan_ops
    from repro_torch.kernels.rmq_short import ops as short_ops

    return {k.name: k for k in (
        fused_ops.LAUNCHES, qfused_ops.LAUNCHES, build_ops.LAUNCHES,
        scan_ops.LAUNCHES, upd_ops.LAUNCHES, short_ops.LAUNCHES,
        bulk_ops.LAUNCHES)}


def zero_counts():
    """Set every launch counter to 0; returns them for :func:`read`."""
    count = counters()
    for k in count.values():
        k.reset()
    return count


def read(torch, count):
    torch.cuda.synchronize()
    return {k: c.launches for k, c in count.items()}


def expect(name, launches, **want):
    """The phase launched exactly ``want`` (every other kernel 0 times)."""
    require(set(want) <= set(launches), f"{name}: unknown kernels {want}")
    full = {k: want.get(k, 0) for k in launches}
    require(launches == full,
            f"{name}: launches {launches}, the contract says {full}")


def drive(torch, name, x, ls, rs, plan, with_positions, seed):
    """The main path at one geometry: both builds and every query entry
    point, counted; then everything held to the plain versions."""
    from repro_torch.core import RMQ, build_hierarchy, rmq_walk_batch
    from repro_torch.kernels.rmq_fused.ops import rmq_fused_batch

    count = zero_counts()
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
    launches = read(torch, count)

    levels = plan.num_levels
    expect(name, launches,
           hierarchy_fused=1 if levels > 1 else 0,
           hierarchy_build=levels - 1,
           rmq_fused=3 if with_positions else 1,
           rmq_scan=2 if with_positions else 1)

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
    return {"launches": launches, "err": err, "rf": rf, "rc": rc, "hp": hp,
            "wv": wv, "wp": wp}


def geometry(torch, n, m, seed, dtype="float32", capacity=None):
    """Input, bounds and plan of one geometry, drawn from the seed."""
    from repro_torch.tune.measure import make_input_array, make_queries

    t0 = time.perf_counter()
    x = torch.from_numpy(make_input_array(n, seed).astype(dtype)).cuda()
    ls, rs = make_queries(n, m, "mixed", seed=seed + 1)
    ls = torch.from_numpy(ls).cuda()
    rs = torch.from_numpy(rs).cuda()
    return x, ls, rs, time.perf_counter() - t0


def update_phase(torch, x, plan, rf, rc, seed):
    """Phase 7: one update batch through the facade on both indexes."""
    import numpy as np

    from repro_torch.streaming import updates as U

    rng = np.random.default_rng(seed + 2)
    n, levels = plan.n, plan.num_levels
    idxs = rng.integers(0, n, 1 << 16)
    idxs[:4096] = idxs[4096:8192]  # duplicates: the last one wins
    vals = (rng.random(1 << 16) - 0.5).astype(np.float32)
    idxs = torch.from_numpy(idxs).cuda()
    vals = torch.from_numpy(vals).cuda()

    count = zero_counts()
    rc2 = rc.update(idxs, vals)
    rf2 = rf.update(idxs, vals)
    launches = read(torch, count)
    expect("A update", launches, hierarchy_update=2 * (levels - 1))

    want = U.update_hierarchy(rc.hierarchy, idxs, vals)  # plain, on card
    pairs = []
    for r in (rc2, rf2):
        pairs += [(r.hierarchy.base, want.base), (r.hierarchy.upper,
                                                  want.upper),
                  (r.hierarchy.upper_pos, want.upper_pos)]
    err = max_abs_err(torch, pairs)
    require(err == 0.0, f"A update: kernel and plain disagree ({err})")
    require(rc2.generation == rf2.generation == 1, "A update: generation")
    require(torch.equal(rc.hierarchy.base, x),
            "A update: the predecessor's level 0 changed")
    from repro_torch.tune.measure import make_queries

    ql, qr = (torch.from_numpy(a).cuda() for a in
              make_queries(n, 4096, "mixed", seed=seed + 5))
    brute_force_check(torch, want.base, ql, qr, rf2.query(ql, qr),
                      rf2.query_index(ql, qr), 256, seed, n)
    brute_force_check(torch, x, ql, qr, rc.query(ql, qr),
                      rc.query_index(ql, qr), 256, seed, n)
    print(f"A update: 2^16 indices, launches {launches}, max_abs_err "
          f"{err}, successor and predecessor brute force 256/256 ok")
    return {"launches": launches, "err": err, "rc2": rc2, "want": want,
            "idxs": idxs, "vals": vals}


def time_update(torch, plan, rc, up):
    """Phase 10 for hierarchy_update: the three launches alone, the plain
    re-reduction, the level-1 index_select + torch.min pair, and the
    whole RMQ.update call with and without the successor copy."""
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.streaming import updates as U

    c = plan.c
    want = up["want"]
    base = want.base
    upper, upos = want.upper.clone(), want.upper_pos.clone()
    ids = up["idxs"].long() // c
    level_ids = []
    for level in range(1, plan.num_levels):
        ids = U.touched_chunk_ids(ids, plan.level_lens[level])
        level_ids.append(ids.to(torch.int32))
        ids = ids // c
    sources = [U.level_source(plan, base, upper, upos, k)
               for k in range(1, plan.num_levels)]
    outs = [(upper[o:o + p], upos[o:o + p])
            for o, p in zip(plan.offsets, plan.padded_lens)]

    def kernels():
        for (sv, sp), lid, (ov, op) in zip(sources, level_ids, outs):
            upd_ops.update_level_cuda(sv, sp, lid, c, ov, op)

    def plain():
        for k, lid in enumerate(level_ids, 1):
            U.repair_plain(plan, base, upper, upos, k, lid.long())

    h = rc.hierarchy
    idxs, vals = up["idxs"], up["vals"]
    ms = time_ms(torch, kernels, 20)
    out = {
        "ms": ms,
        "plain_ms": time_ms(torch, plain, 5),
        "library_ms": time_ms(torch, lambda: torch.min(
            base.view(-1, c).index_select(0, level_ids[0]), dim=1), 20),
        "call_ms": time_ms(torch, lambda: rc.update(idxs, vals), 5),
        "copy_ms": time_ms(torch, lambda: (h.base.clone(), h.upper.clone(),
                                           h.upper_pos.clone()), 5),
    }
    item = base.element_size()
    moved = 0
    for k, lid in enumerate(level_ids, 1):
        per = item + (4 if k > 1 else 0)  # level 1 synthesizes positions
        moved += lid.numel() * (c * per + item + 4 + 4)
    out["bound"] = bound_ms(moved, sum(lid.numel() * c
                                       for lid in level_ids))
    # the whole call's floor: the successor's planes read and written once
    planes = sum(t.numel() * t.element_size()
                 for t in (h.base, h.upper, h.upper_pos))
    out["call_bound"] = bound_ms(2 * planes + moved, 0)
    out["touched"] = [lid.numel() for lid in level_ids]
    return out


def engine_phase(torch, plan, rf, rc, rc2, ls, rs, wv, wp, seed):
    """Phase 8: the engine on the cuda index, the fused index's
    query_mixed and query_bulk, then attach of the updated index."""
    import numpy as np

    from repro_torch.core import RMQ
    from repro_torch.kernels.rmq_short import ops as short_ops
    from repro_torch.qe import FUSED, MID, SHORT
    from repro_torch.tune.measure import make_span_queries

    n, c = plan.n, plan.c
    m = 1 << 20
    el, er = make_span_queries(n, m, c, "mixed", seed=seed + 3)
    elt, ert = torch.from_numpy(el).cuda(), torch.from_numpy(er).cuda()
    err = {"rmq_short": 0.0, "rmq_scan": 0.0, "rmq_fused": 0.0,
           "rmq_bulk": 0.0}
    launches = {}

    def buckets(k):
        return -(-k // 4096)

    # -- routed engine on the cuda index -----------------------------------
    ec = rc.engine(cache_size=0)
    count = zero_counts()
    walls = {}
    v, walls["engine.query"] = wall(torch, lambda: ec.query(el, er))
    p, walls["engine.query_index"] = wall(
        torch, lambda: ec.query_index(el, er))
    got = read(torch, count)
    cls = {k: c_ // 2 for k, c_ in ec.stats()["class_counts"].items()}
    expect("A engine (cuda)", got, rmq_short=2 * buckets(cls[SHORT]),
           rmq_scan=2 * buckets(cls[MID]))
    require(cls[SHORT] > 0 and cls[MID] > 0 and cls["long"] > 0,
            f"A engine (cuda): a span class is empty: {cls}")
    launches["rmq_short"] = got["rmq_short"]
    labels = ec.planner.classify(el, er)
    fv, fp = rc.query(elt, ert), rc.query_index(elt, ert)
    for key, mask in (("rmq_short", labels == SHORT),
                      ("rmq_scan", labels != SHORT)):
        mt = torch.from_numpy(mask).cuda()
        err[key] = max(err[key], max_abs_err(
            torch, [(v[mt], fv[mt]), (p[mt], fp[mt])]))
    short = torch.from_numpy(labels == SHORT).cuda()
    sl, sr = elt[short], ert[short]
    kv, kp = short_ops.rmq_short_batch(rc.hierarchy, sl, sr, True)
    pv, pp = short_ops.rmq_short_batch_plain(rc.hierarchy.base, sl, sr, c,
                                             plan.capacity, True)
    err["rmq_short"] = max(err["rmq_short"], max_abs_err(
        torch, [(kv, pv), (kp, pp.to(kp.dtype))]))
    brute_force_check(torch, rc.hierarchy.base, elt, ert, v, p, 256, seed, n)

    # -- fused engine: value + index rows from one launch per bucket -------
    ef = rf.engine(cache_size=0)
    is_index = np.random.default_rng(seed + 4).random(el.shape[0]) < 0.5
    count = zero_counts()
    (mv, mp), walls["fused engine.query_mixed"] = wall(
        torch, lambda: ef.query_mixed(el, er, is_index))
    got = read(torch, count)
    expect("A engine (fused, mixed)", got,
           rmq_fused=buckets(ef.stats()["class_counts"][FUSED]))
    launches["rmq_fused_mixed"] = got["rmq_fused"]
    ii = torch.from_numpy(is_index).cuda()
    err["rmq_fused"] = max_abs_err(torch, [(mv[~ii], fv[~ii]),
                                           (mp[ii], fp[ii])])

    # -- bulk: 2^24 spans, one rmq_bulk launch per 2^20 bucket -------------
    eb = rf.engine(cache_size=0, bulk_crossover=m)
    count = zero_counts()
    bv, walls["engine.query_bulk 2^24"] = wall(
        torch, lambda: eb.query_bulk(ls, rs))
    bp, walls["engine.query_bulk 2^24 index"] = wall(
        torch, lambda: eb.query_bulk(ls, rs, "index"))
    got = read(torch, count)
    per_op = -(-ls.numel() // eb._bulk.max_bucket)
    expect("A engine (bulk)", got, rmq_bulk=2 * per_op)
    launches["rmq_bulk"] = got["rmq_bulk"]
    err["rmq_bulk"] = max_abs_err(torch, [(bv, wv), (bp, wp)])

    # -- attach the updated index: no answer of the old generation ---------
    ec.attach(rc2)
    count = zero_counts()
    v2, p2 = ec.query(el, er), ec.query_index(el, er)
    got = read(torch, count)
    expect("A engine after attach", got, rmq_short=2 * buckets(cls[SHORT]),
           rmq_scan=2 * buckets(cls[MID]))
    rb = RMQ.build(rc2.hierarchy.base.clone(), with_positions=True,
                   backend="cuda", plan=plan, device=rc2.device)
    rebuild = max_abs_err(torch, [(v2, rb.query(elt, ert)),
                                  (p2, rb.query_index(elt, ert))])
    require(rebuild == 0.0, f"A engine after attach: {rebuild} from a "
            "rebuild of the updated array")
    require(not torch.equal(v2, v), "A engine after attach: the update "
            "changed no answer")
    require(all(e == 0.0 for e in err.values()),
            f"A engine: kernels disagree with their plain versions: {err}")
    print(f"A engine: 2^20 mixed spans, classes {cls}, launches "
          f"{launches}, max_abs_err {err}; after attach equal to a "
          "rebuild; brute force 256/256 ok")
    print(f"A engine wall times (s, host clock to the end of device work, "
          f"cache_size=0): {json.dumps(walls)}")
    return {"launches": launches, "err": err, "short": (sl, sr)}


def time_queries(torch, plan, h, ls, rs, short, seed):
    """Phase 10 for rmq_short (the engine's short spans) and rmq_bulk (the
    2^24 batch, sorted as the bulk executor sorts it)."""
    from repro_torch.core import rmq_walk_batch
    from repro_torch.kernels.rmq_fused.ops import rmq_fused_batch
    from repro_torch.kernels.rmq_short import ops as short_ops

    c, item = plan.c, h.base.element_size()
    per_query = 8 + item + 4  # bounds in, value and position out
    sl, sr = short
    t_short = {
        "ms": time_ms(torch, lambda: short_ops.rmq_short_batch(
            h, sl, sr, True), 20),
        "plain_ms": time_ms(torch, lambda: short_ops.rmq_short_batch_plain(
            h.base, sl, sr, c, plan.capacity, True), 3, warmup=1),
        "fused_ms": time_ms(torch, lambda: rmq_fused_batch(h, sl, sr, True),
                            20),
        "queries": sl.numel(),
    }
    moved = span_bytes(torch, sl, sr, item) + sl.numel() * per_query
    t_short["bound"] = bound_ms(moved, moved / item)

    pair, bl, br = sorted_pair(torch, plan, h, ls, rs)
    chunks = torch.unique(partial_chunks(torch, bl, br, c)).numel()
    t_bulk = {
        "ms": pair["rmq_bulk"],
        "plain_ms": time_ms(torch, lambda: rmq_walk_batch(h, bl, br, True),
                            1, warmup=1),
        "fused_ms": pair["rmq_fused"],
        "chunks": chunks,
    }
    moved = chunks * c * item + bl.numel() * per_query
    t_bulk["bound"] = bound_ms(moved, moved / item)
    return t_short, t_bulk


def sorted_pair(torch, plan, h, ls, rs):
    """rmq_bulk in 2^20 buckets and rmq_fused in one launch, both on the
    batch sorted as the bulk executor sorts it (CUDA events)."""
    from repro_torch.kernels.rmq_bulk import ops as bulk_ops
    from repro_torch.kernels.rmq_fused.ops import rmq_fused_batch

    c = plan.c
    rows = -(-plan.capacity // c)
    order = torch.sort((ls.long() // c) * rows + rs.long() // c,
                       stable=True)[1]
    bl, br = ls[order].contiguous(), rs[order].contiguous()
    step = 1 << 20

    def bulk():
        for s in range(0, bl.numel(), step):
            bulk_ops.rmq_bulk_batch(h, bl[s:s + step], br[s:s + step], True)

    return {"rmq_bulk": time_ms(torch, bulk, 10),
            "rmq_fused": time_ms(torch, lambda: rmq_fused_batch(
                h, bl, br, True), 10)}, bl, br


def stream_phase(torch, name, x, plan, seed):
    """Phase 9: append 777 values, retire 1024, query the live window."""
    import numpy as np

    from repro_torch.core import build_hierarchy, make_plan, rmq_walk_batch
    from repro_torch.streaming import StreamingRMQ
    from repro_torch.streaming import updates as U
    from repro_torch.tune.measure import make_queries

    n, levels = plan.n, plan.num_levels
    s = StreamingRMQ.from_array(x, with_positions=True, backend="cuda",
                                plan=plan, device=x.device)
    rng = np.random.default_rng(seed + 6)
    tail = torch.from_numpy(rng.random(777).astype(
        np.dtype(str(x.dtype).replace("torch.", ""))) - 0.5).cuda()
    live = n + 777 - 1024
    ql, qr = (torch.from_numpy(a.astype(np.int64) + 1024).cuda()
              for a in make_queries(live, 1 << 16, "mixed", seed=seed + 7))
    count = zero_counts()
    s3 = s.append(tail).retire(1024)
    qv, qp = s3.query(ql, qr), s3.query_index(ql, qr)
    launches = read(torch, count)
    expect(f"{name} append/retire", launches,
           hierarchy_update=2 * (levels - 1), rmq_scan=2)
    require((s3.start, s3.length, s3.generation) == (1024, n + 777, 2),
            f"{name} append/retire: window {s3.start}..{s3.length}")

    want = U.append_hierarchy(s.hierarchy, tail, n)
    retired = torch.arange(1024, device=x.device)
    want = U.update_hierarchy(want, retired, torch.full(
        (1024,), float("inf"), dtype=x.dtype, device=x.device))
    fresh = build_hierarchy(want.base[:n + 777].clone(), make_plan(
        n + 777, c=plan.c, t=plan.t, capacity=plan.capacity), True)
    wv, wp = rmq_walk_batch(want, ql, qr, True)
    h = s3.hierarchy
    err_u = max_abs_err(torch, [(h.base, want.base), (h.upper, want.upper),
                                (h.upper_pos, want.upper_pos),
                                (h.upper, fresh.upper),
                                (h.upper_pos, fresh.upper_pos)])
    err_q = max_abs_err(torch, [(qv, wv), (qp, wp.to(qp.dtype))])
    require(err_u == 0.0 and err_q == 0.0,
            f"{name} append/retire: update {err_u}, queries {err_q}")
    brute_force_check(torch, want.base, ql, qr, qv, qp, 256, seed, n + 777)
    print(f"{name} append/retire: levels {plan.level_lens}, launches "
          f"{launches}, max_abs_err {err_u} (hierarchy, also against a "
          f"rebuild) {err_q} (queries), brute force 256/256 ok")
    return {"launches": launches,
            "err": {"hierarchy_update": err_u, "rmq_scan": err_q}}


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
    rf, rc, hp, wv, wp = a["rf"], a["rc"], a["hp"], a["wv"], a["wp"]
    h = rf.hierarchy
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
    # -- geometry A: mutation, the engine, and their kernels' times -------
    up = update_phase(torch, x, plan, rf, rc, seed)
    main_launches["hierarchy_update"] = up["launches"]["hierarchy_update"]
    errors["hierarchy_update"] = up["err"]
    eng = engine_phase(torch, plan, rf, rc, up["rc2"], ls, rs, wv, wp, seed)
    main_launches["rmq_short"] = eng["launches"]["rmq_short"]
    main_launches["rmq_bulk"] = eng["launches"]["rmq_bulk"]
    for key, e in eng["err"].items():
        errors[key] = max(errors.get(key, 0.0), e)
    t_up = time_update(torch, plan, rc, up)
    t_short, t_bulk = time_queries(torch, plan, rc.hierarchy, ls, rs,
                                   eng["short"], seed)
    for key, tm in (("hierarchy_update", t_up), ("rmq_short", t_short),
                    ("rmq_bulk", t_bulk)):
        ms[key] = tm["ms"]
        plain[key] = tm["plain_ms"]
        bounds[key] = tm["bound"]
    library["hierarchy_update"] = t_up["library_ms"]
    library["rmq_short"] = library["rmq_bulk"] = None
    print(f"A hierarchy_update (ms): {json.dumps(t_up)}; touched chunks "
          "per level as listed; call_ms is the whole RMQ.update, copy_ms "
          "the successor's three clones alone")
    print(f"A rmq_short (ms, {t_short['queries']} short spans, value + "
          f"index): {json.dumps(t_short)}")
    print(f"A rmq_bulk (ms, 2^24 sorted spans in 2^20 buckets, value + "
          f"index; distinct level-0 chunks {t_bulk['chunks']}): "
          f"{json.dumps(t_bulk)}; rmq_fused on the unsorted batch "
          f"{ms['rmq_fused']}")
    del h, hp, x, ls, rs, rf, rc, wv, wp, up, eng
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
            pair = sorted_pair(torch, plan_g, hb, ls, rs)[0]
            print(f"B bulk vs fused on the same sorted batch (ms, value + "
                  f"index, {data['m'] * plan_g.c / plan_g.capacity} spans "
                  f"per level-0 chunk): {json.dumps(pair)}")
            del hb
        del r
        if name in ("B", "D"):
            st = stream_phase(torch, name, x, plan_g, seed)
            for key, e in st["err"].items():
                errors[key] = max(errors[key], e)
        del x, ls, rs
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
