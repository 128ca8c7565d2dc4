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
   argmin are exact; the builds as integer views, so -0.0 and +0.0
   differ) against the plain build and the plain walk on the
   card, and 256 sampled spans per geometry against torch.min / first
   argmin over the slice; at every geometry ``rmq_short`` (the spans cut
   to the short class) and ``rmq_bulk`` (the batch sorted as the bulk
   executor sorts it, in 2^20 buckets) against their plain versions and
   against ``rmq_fused`` on the same spans, as integer views (so -0.0 and
   +0.0 differ);
6. times at geometry A with CUDA events, warmed up, over many launches:
   each kernel beside its bound (bytes at 3.35 TB/s), its plain version
   and a one-call PyTorch yardstick where one exists; the value-only
   builds beside ``torch.amin(x.view(-1, c), dim=1)`` (timed only);
   per-plane times of ``rmq_fused`` and ``rmq_scan``, the
   ``-Xptxas -v`` registers and spills of their kernels and of the
   builds' run instances (``build_hopper.cuh``), and the level-1 value
   and position planes' bytes beside the 50 MB L2;
7. mutation at geometry A: one batch of 2^16 random indices with
   duplicates, already on the card, through ``RMQ.update`` on the
   ``cuda`` and the ``fused`` index (``hierarchy_update``, three launches
   each, one host call), held against the plain ``update_hierarchy`` on
   the card, sampled spans of the successor against torch.min, the
   predecessor against its own data.  Both updates run under
   ``torch.cuda.set_sync_debug_mode("error")`` and must return while a
   sleep kernel queued before them still runs (they never wait for the
   card); control: the plain update raises under that mode and returns
   only after the sleep;
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
   and signed zeros at A and D: a copy of the input with a sixteenth of
   it set to -0.0 / +0.0, on which both builds (``hierarchy_fused`` and
   ``hierarchy_build``, value-only and with positions) equal the plain
   build as integer views, with a control (the plain upper plane with
   -0.0 set to +0.0) that must fail that check; ``rmq_bulk`` and
   ``rmq_short`` equal ``rmq_fused`` bit for bit (position builds; at D
   the value-only builds too), at D ``rmq_fused`` on each value-only
   build equals it on the position build in every answer's sign (a
   gate), and sampled spans are their leftmost minimal entry's bits, with
   a control (``rmq_fused``'s values with -0.0 set to +0.0) that must fail
   the bit check and pass ``torch.equal``; and NaNs at A (float32) and D
   (float64): a copy of the input with quiet NaNs of both signs and their
   own payloads (single, in runs, on chunk edges), on which every RMQ
   kernel (B1 / B3 builds, B2, B4, B5, B7 on the plain build, B6 writing
   NaNs over numbers and numbers over NaNs) equals its plain version as
   integer views (NaN is the least value: a span holding one answers its
   leftmost NaN); the reading (entries that differ) is a gate at 0, and
   the control (the plain versions with NaN mapped to +inf) must fail it
   for each kernel;
10. times of the three kernels of phases 7-9 at geometry A beside their
   bounds, their plain versions and the comparison each exists for
   (``rmq_fused`` on the same spans; for ``hierarchy_update`` the
   ``index_select`` + ``torch.min`` pair at level 1, timed in turns with
   the kernel), and the whole
   ``RMQ.update`` call with and without the successor's copy.
   ``hierarchy_update`` is also timed with the L2 flushed before each
   call, as an event span and as each launch's device time from
   torch.profiler; its bound counts each touched chunk's entries once
   and one 32-byte sector for each scattered write and position gather.
   ``rmq_short`` and ``rmq_bulk`` are timed per launch at the sizes the
   engine launches them (a 4096-span bucket: device time from
   torch.profiler; a 2^20 bucket: a pass of CUDA events over its
   launches), their bounds and plain times per launch likewise;
11. serving (F): llama3.2-3b at full width (28 layers, d_model 3072, 24
   heads over 8 KV heads, head_dim 128, vocab 128256), bf16 weights from
   a seeded ``torch.Generator`` on the card, through ``ServeEngine``:
   batch 4, a 2048-token prompt, 64 new tokens, cache 2120, eviction with
   ``launch/serve.py``'s settings (budget 1590, 16 protected, c = 16,
   t = 4).  ``flash_attention`` (B8) launches once per layer of the
   prefill; eviction runs ``hierarchy_build`` (B3), ``hierarchy_update``
   (B6) and ``rmq_short`` (B5).  Every round's victims are held to the
   plain (``eager``) manager's on the same scores and to a brute-force
   leftmost argmin per window; B8 to its plain version at the prefill
   shape (float32 within 2e-5, bfloat16 within 2e-2 and a max|diff| /
   rms gate, with a control that must fail that gate); the model's
   logits and greedy tokens with B8 to the same model with the plain
   attention.  Times: B8 beside its operations bound (with its achieved
   TFLOP/s and ``-Xptxas -v`` registers and spills at D 128), its plain
   version and ``scaled_dot_product_attention`` (timed only, in turns
   with the kernel; the port never calls it), prefill, decode per token,
   eviction rounds, tokens/s, memory, and a ``torch.profiler`` top-8 of a
   prefill and top-5 of a decode step;
12. training (G): mamba2-1.3b at full width and depth (48 layers, d_model
   2048, 64 SSD heads x 64, state 128, chunk 128, vocab 50280) through
   ``launch/train.py``: float32 masters from a seeded generator on the
   card, bf16 compute, float32 AdamW state, bf16 gradients, batch 8 x seq
   2048 from ``SyntheticTokenDataset(seed)`` (the reference's default is
   256 x 4096, cut for the run's time limit), remat ``full``, one warm-up
   step and four timed ones.  ``ssd_scan`` (B9) launches 96 times a step
   (48 in the forward, 48 in the remat recompute, none in the backward)
   and no other kernel runs.  B9 is held to its plain chunked version at
   the training shape (y and the final state, with and without an initial
   state, max|diff| / max|plain| under 1e-4, with a control that drops the
   carried state and must fail, and a second control, the plain version
   with one TF32 pass per product, which must fail too), the autograd
   wiring of its gradient
   (``SSDScan``'s backward is autograd of the plain version; the CPU tests
   hold the gradients to ``jax.grad``), the whole model's step 0 (loss,
   grad norm) to the same step through the plain scan (limits set between
   that reading and the same control's through the whole model, which
   must fail), and a restart drill (``--smoke``, a failure before step 2)
   to the final loss of an uninterrupted run.  Times: step
   time, tokens/s, model FLOPs and their share of the bf16 peak, B9 beside
   its bound at float32 accuracy on the tensor cores (its products split
   3xTF32: three TF32 passes at 495 TFLOP/s, or its bytes) and the
   CUDA-core figure, its three CUDA kernels' shares of a call
   (``torch.profiler``) with their ``-Xptxas -v`` registers and spills,
   its plain version, a ``torch.profiler`` top-12 of one step, peak
   memory;
13. the compact planes (H; run after phase 10, before 11), at geometry A's
   data: ``RMQ.build`` with ``packed_pos=True``, ``summary_dtype=
   "bfloat16"`` and both, through ``hierarchy_fused`` (1 launch) and
   ``hierarchy_build`` (L - 1), each plane equal to the plain compact
   build as integer views (packed words word for word, bf16 as int16),
   the unpacked plane to the classic build's; the 2^24 spans on the
   packed index through ``rmq_fused``, the ``rmq_scan`` pair, ``rmq_bulk``
   and ``rmq_short`` (counted), on the bf16 indexes through the
   exact-recovery walk on the card with no launch, all equal to the
   classic index's answers bit for bit, and a control (the walk without
   the level-0 re-compare) that must disagree; the engine over 2^20
   spans on the packed index; ``RMQ.update`` of 2^16 indices and a
   ``StreamingRMQ`` append / retire on packed + bf16 indexes (the plain
   update, no launch) against rebuilds; ``RMQ.build_out_of_core`` at n =
   2^31 + 4096 with packed positions from a host callable (slabs of 2^24
   made from the seed, one ``hierarchy_fused`` launch a slab) against the
   plain build of the same values on the card, queried through the eager
   walk (2^20 spans sampled against torch.min / first argmin, and 64
   spans that end past 2^31); the same call at A from a host numpy array
   against ``RMQ.build``, queried through ``rmq_fused``.  Printed: the
   builds' times (pack and cast included), ``memory_bytes`` /
   ``auxiliary_bytes`` of every layout beside the plan's, the unpack's
   time a call, the exact walk's time against B2 on the classic index,
   the update's, and the out-of-core build's time, launches and peak
   memory.

14. the autotuner (run after phase 13): ``Autotuner(device=card)`` at n =
   2^24 over the nine ``DEFAULT_GEOMETRIES``, backends ``cuda`` (the
   routed engine: ``rmq_short``, ``rmq_scan``, the hybrid top) and
   ``fused`` (``rmq_fused``), m = 4096, 3 repeats, 3 crossover points
   (``rmq_bulk`` in the bulk crossover), saved into a temporary directory
   and loaded back; a winner for every span mix, each rebuilt on the card
   and answering its mix's spans through an engine with the cache, equal
   to the default geometry (c = 128, t = 64) as integer views.  Then
   ``RMQ.build(x, c="auto", with_positions=True)`` at geometry A's data
   against the committed ``results/tuning_cache_torch.json``: with the
   card's key there, the plan is bucket 30's ``mixed`` winner, the engine
   with the cache adopts its backend (``source`` "cache"), the launches
   are the winner's (one ``hierarchy_fused`` for a fused build, L - 1
   ``hierarchy_build`` for a per-level one; one ``rmq_fused`` per bucket
   for a fused engine), and the 2^24 spans (the facade) and the first
   2^20 (the engine) answer as phase 3's, integer views; without the key,
   the miss path (c = 128, t = 64, no split, ``source`` "default").
   Control: a cache whose bucket-30 ``mixed`` entry names another
   geometry must move the plan off the committed winner (so it fails
   that gate).  Times, on the host clock to the end of device work, in
   turns with the default geometry: the build and an engine batch over
   2^20 mixed spans.

15. the serving tier (J; run after phase 14, on geometry A's data made
   again for both): J1 ``QueryService.register_many`` of 8 float32
   arrays of 2^24 (c = 128, t = 64, positions): one ``hierarchy_fused``
   launch with a row axis, every row equal to a solo B1 build as integer
   views (control: two rows swapped must fail), the batched build and the
   8 solo builds timed in turns beside the 8 rows' bytes bound; J2
   ``QueryService`` at A with a fused and a routed (``cuda``) tenant, 64
   requests of 64 of phase 3's spans each, value and index interleaved:
   the fused flush is one ``rmq_fused`` launch, every answer equal to
   phase 3's, and a request with out-of-range bounds fails its group
   alone; J3 ``ServingTier`` at A with an injected clock: an oversized
   submission of 2^22 spans (each op) answered by ``rmq_bulk`` against the
   front while an update of 2^16 indices is staged (equal to phase 3's
   B2, the update still staged), then a backlog of 4096 mixed spans whose
   flush makes ``hierarchy_update``'s three launches and one
   ``rmq_fused``, equal to B2 over ``RMQ.update``'s successor (control:
   the pre-swap front's answers must fail that gate); J4 the tier on its
   own thread at n = 2^24: four clients with 8 outstanding 256-span mixed
   requests each for 5 s, one reading under a side stream, a mutator
   staging 1024 updated indices every 20 ms; every 16th ticket equal to a
   numpy replay of the mutation log at its generation (``BlockOracle``),
   no failed ticket, no flusher error; spans a second, p50 / p99 latency,
   flushes by reason, deadline misses and ``rmq_fused`` launches a flush
   printed; J5 ``AsyncServingTier``: two tenants (SLOs 2 and 20 ms)
   driven by ``pump`` for 1 s, every answer checked; J6 (run inside phase
   11, on its model) ``ServeEngine(serving_tier=ServingTier())`` at F's
   full width with 8 new tokens: tokens and every round's victims equal
   to the direct path's, the ``kv-eviction`` tenant swapping once a round
   after the first.  The J launches are added to the kernels' counts.

Each phase sets every launch counter to 0 just before it drives its
path and reads them just after.  The output ends with one
``{"kernels": [...]}`` line (per kernel: its launches on its phase's
path, its largest difference from the plain version over all
geometries, its times and bound) and, last, ``{"ok": true, "device":
{...}}``.  Any failed phase exits non-zero before those lines.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12    # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
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
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:101"),
    "ssd_scan": dict(
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:76"),
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


def time_turns(torch, fns, iters: int, rounds: int = 2):
    """``{name: [ms, ...]}``: each ``fn`` timed by :func:`time_ms` in
    turns (a, b, a, b, ...), so a comparison is on one card and one
    stretch of its clocks."""
    out = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            out[name].append(time_ms(torch, fn, iters))
    return out


def mean(xs):
    return sum(xs) / len(xs)


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


def as_bits(torch, t):
    """The integer view of a float tensor (its bits; bf16 as int16) or of
    packed uint32 words (int32); others as they are."""
    if t.dtype in (torch.float32, torch.uint32):
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t


def same_bits(torch, pairs) -> bool:
    """Every (got, want) pair equal bit for bit: shape, dtype and the
    integer views, so -0.0 and +0.0 differ (torch.equal does not see it)."""
    return all(g.shape == w.shape and g.dtype == w.dtype
               and torch.equal(as_bits(torch, g), as_bits(torch, w))
               for g, w in pairs)


def short_of(torch, ls, rs, c: int):
    """Each span cut to the short class (r // c - l // c <= 1): its end
    clipped to the end of the chunk after l's."""
    return ls, torch.minimum(rs, (ls // c) * c + 2 * c - 1)


def bulk_order(torch, ls, rs, c: int, capacity: int):
    """The bulk executor's order: a stable sort on chunk(l) * rows +
    chunk(r)."""
    rows = -(-capacity // c)
    return torch.sort((ls.long() // c) * rows + rs.long() // c,
                      stable=True)[1]


def bulk_pass(h, ls, rs, track_pos: bool, step: int = 1 << 20):
    """``rmq_bulk`` over a batch in buckets of ``step``, as the bulk
    executor launches it: ``(values, positions or None)``."""
    import torch

    from repro_torch.kernels.rmq_bulk import ops as bulk_ops

    parts = [bulk_ops.rmq_bulk_batch(h, ls[s:s + step], rs[s:s + step],
                                     track_pos)
             for s in range(0, ls.numel(), step)]
    vals = torch.cat([p[0] for p in parts])
    return vals, (torch.cat([p[1] for p in parts]) if track_pos else None)


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


def bound_ms(bytes_moved: float, ops: float, ops_per_s=FP32_OPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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
def build_kernels():
    """Build every source; returns ``{name: ptxas report}``."""
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
    return reports


def ptxas_of(report: str, entry: str) -> str:
    """The registers and spill lines of the first kernel whose mangled
    name contains ``entry``, from a ``-Xptxas -v`` report."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and entry in line:
            rest = []
            for nxt in lines[i + 1:]:
                if "Compiling entry" in nxt:
                    break
                if "spill" in nxt or "registers" in nxt:
                    rest.append(nxt.split(":", 1)[-1].strip())
            return "; ".join(rest)
    return "not in the report (library already built)"


def ptxas_all(report: str, stem: str):
    """``{kernel: registers and spills}`` of every kernel in a
    ``-Xptxas -v`` report whose mangled name contains ``stem``, keyed by
    ``stem`` and its template arguments."""
    out = {}
    for line in report.splitlines():
        if "Compiling entry" in line and stem in line:
            name = stem + line.split(stem, 1)[1].split("EEEv", 1)[0]
            out[name] = ptxas_of(report, name)
    return out


def counters():
    from repro_torch.kernels.hierarchy_build import ops as build_ops
    from repro_torch.kernels.hierarchy_fused import ops as fused_ops
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.kernels.rmq_bulk import ops as bulk_ops
    from repro_torch.kernels.rmq_fused import ops as qfused_ops
    from repro_torch.kernels.rmq_scan import ops as scan_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmq_short import ops as short_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    return {k.name: k for k in (
        fused_ops.LAUNCHES, qfused_ops.LAUNCHES, build_ops.LAUNCHES,
        scan_ops.LAUNCHES, upd_ops.LAUNCHES, short_ops.LAUNCHES,
        bulk_ops.LAUNCHES, fa_ops.LAUNCHES, ssd_ops.LAUNCHES)}


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
    err["rmq_short"], err["rmq_bulk"] = short_bulk_check(
        torch, name, rf.hierarchy, ls, rs, plan, wv, wp)
    require(all(e == 0.0 for e in err.values()),
            f"{name}: kernels disagree with their plain versions: {err}")
    require(same_bits(torch, build_pairs),
            f"{name}: a build differs in bits from the plain build")
    brute_force_check(torch, x, ls, rs, wv, wp, 256, seed, plan.n)
    print(f"{name}: levels {plan.level_lens}, launches {launches}, "
          f"max_abs_err {err}, builds bit for bit, brute force 256/256 ok")
    return {"launches": launches, "err": err, "rf": rf, "rc": rc, "hp": hp,
            "wv": wv, "wp": wp}


def short_bulk_check(torch, name, h, ls, rs, plan, wv, wp):
    """``rmq_short`` (B5) on the batch's spans cut to the short class and
    ``rmq_bulk`` (B7) on the batch in the bulk executor's order and 2^20
    buckets, each bit for bit (integer views) against its plain version
    and against ``rmq_fused`` (B2) on the same spans.  Comparison launches:
    outside any counted window.  Returns their max_abs_err."""
    from repro_torch.kernels.rmq_fused.ops import rmq_fused_batch
    from repro_torch.kernels.rmq_short import ops as short_ops

    track = h.with_positions
    c = plan.c
    sl, sr = short_of(torch, ls, rs, c)
    kv, kp = short_ops.rmq_short_batch(h, sl, sr, True)
    kv_only = short_ops.rmq_short_value_batch(h, sl, sr)
    pv, pp = short_ops.rmq_short_batch_plain(h.base, sl, sr, c,
                                             plan.capacity, True)
    fv, fp = rmq_fused_batch(h, sl, sr, track)
    short_pairs = [(kv, pv), (kv_only, pv), (kp, pp.to(kp.dtype))]
    fused_pairs = [(kv, fv), (kv_only, fv)]
    if track:
        fused_pairs.append((kp, fp))

    order = bulk_order(torch, ls, rs, c, plan.capacity)
    bl, br = ls[order].contiguous(), rs[order].contiguous()
    bv, bp = bulk_pass(h, bl, br, track)
    bv_only = bulk_pass(h, bl, br, False)[0]
    gv, gp = rmq_fused_batch(h, bl, br, track)
    bulk_pairs = [(bv, wv[order]), (bv_only, wv[order])]
    if track:
        bulk_pairs.append((bp, wp[order]))
    bulk_fused = [(bv, gv), (bv_only, gv)] + ([(bp, gp)] if track else [])
    torch.cuda.synchronize()
    require(same_bits(torch, short_pairs) and same_bits(torch, fused_pairs),
            f"{name}: rmq_short differs in bits from its plain version or "
            "from rmq_fused on the same spans")
    require(same_bits(torch, bulk_pairs) and same_bits(torch, bulk_fused),
            f"{name}: rmq_bulk differs in bits from the plain walk or from "
            "rmq_fused on the same sorted spans")
    return (max_abs_err(torch, short_pairs + fused_pairs),
            max_abs_err(torch, bulk_pairs + bulk_fused))


def geometry(torch, n, m, seed, dtype="float32", capacity=None):
    """Input, bounds and plan of one geometry, drawn from the seed."""
    from repro_torch.tune.measure import make_input_array, make_queries

    t0 = time.perf_counter()
    x = torch.from_numpy(make_input_array(n, seed).astype(dtype)).cuda()
    ls, rs = make_queries(n, m, "mixed", seed=seed + 1)
    ls = torch.from_numpy(ls).cuda()
    rs = torch.from_numpy(rs).cuda()
    return x, ls, rs, time.perf_counter() - t0


def returns_while_busy(torch, fn, strict: bool,
                       cycles: int = 200_000_000):
    """Whether ``fn()`` returns while a sleep kernel of ``cycles`` clocks,
    queued on the stream just before it, still runs (so it never waited
    for the card), with ``fn`` under ``set_sync_debug_mode("error")``
    where ``strict`` (any host sync in it raises): ``{"busy", "call_s",
    "sleep_s"}``, the host seconds of the call and of the sleep alone."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    sleep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    if strict:
        torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    busy = not torch.cuda.current_stream().query()
    call_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"busy": busy, "call_s": call_s, "sleep_s": sleep_s}


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

    # the batch is on the card: the update must never wait for it.  Two
    # checks: any host sync raises under set_sync_debug_mode("error"), and
    # the calls return while a sleep kernel queued before them still runs.
    # Control: the plain update (its per-level torch.unique: the batch is
    # smaller than level 1) raises under the mode and returns only after
    # the sleep
    count = zero_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rc2 = rc.update(idxs, vals)
        rf2 = rf.update(idxs, vals)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = read(torch, count)
    expect("A update", launches, hierarchy_update=2 * (levels - 1))
    # the sleep check on a further call, after one that leaves the
    # allocator holding a successor's blocks (a fresh 4 GB allocation takes
    # host time of its own)
    returns_while_busy(torch, lambda: rc.update(idxs, vals), strict=True)
    free = returns_while_busy(torch, lambda: rc.update(idxs, vals),
                              strict=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        U.update_hierarchy(rc.hierarchy, idxs, vals)
        control_raised = False
    except RuntimeError:
        control_raised = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    control = returns_while_busy(
        torch, lambda: U.update_hierarchy(rc.hierarchy, idxs, vals),
        strict=False)
    require(free["busy"] and free["call_s"] < 0.9 * free["sleep_s"]
            and control["call_s"] >= 0.9 * control["sleep_s"]
            and control_raised,
            f"A update: the update waited for the card ({free}) or the "
            f"control did not ({control}, raised {control_raised})")

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
          f"{err}, successor and predecessor brute force 256/256 ok; both "
          f"updates ran under torch.cuda.set_sync_debug_mode('error') and "
          f"returned while the card was busy ({json.dumps(free)}); the "
          f"control (the plain update) raised under the mode and waited "
          f"({json.dumps(control)})")
    return {"launches": launches, "err": err, "rc2": rc2, "want": want,
            "idxs": idxs, "vals": vals}


def update_bytes(torch, plan, idxs, item: int):
    """``(bytes, touched, level_ids)`` of B6 for the update batch ``idxs``:
    what its launches must move (the sorted batch, int32 indices and
    values, read once; each touched chunk's c source entries read once;
    one 32-byte sector for each written summary and position, for each
    winning base entry and, above level 1, for the winner's carried
    position), the touched chunks per level and their ids."""
    c = plan.c
    idxs = idxs.long()
    valid = idxs[(idxs >= 0) & (idxs < plan.capacity)]
    level_ids = [torch.unique(valid // c ** level)
                 for level in range(1, plan.num_levels)]
    moved = idxs.numel() * (4 + item) + torch.unique(valid).numel() * SECTOR
    for k, lid in enumerate(level_ids, 1):
        moved += lid.numel() * (c * item + 2 * SECTOR
                                + (SECTOR if k > 1 else 0))
    return moved, [lid.numel() for lid in level_ids], level_ids


def update_launches(torch, h, idxs, vals):
    """B6's launches for the update batch ``idxs`` / ``vals`` of
    hierarchy ``h``: ``(kernels, yardstick, plain, bytes, touched)``.
    ``kernels()`` is ``update_levels_cuda``, one host call and one launch
    a level, into copies of ``h``'s planes (written again each call: the
    same writes and the same summaries); ``plain()`` the same work
    plainly (the winning entries' write and each level's re-reduction of
    its touched chunks); ``yardstick()`` the level-1 ``index_select`` +
    ``torch.min`` pair; ``bytes`` and ``touched`` from
    :func:`update_bytes`."""
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.streaming import updates as U

    plan, c = h.plan, h.plan.c
    keys, svals = U.sort_batch(h, idxs, vals)
    planes = (h.base.clone(), h.upper.clone(), h.upper_pos.clone())
    plain_planes = (h.base.clone(), h.upper.clone(), h.upper_pos.clone())
    # the winning writes (the last of each run of equal indices)
    k = keys.long()
    last = torch.cat([k[1:] != k[:-1], k.new_ones(1, dtype=torch.bool)])
    win = last & (k < plan.capacity)
    widx, wval = k[win], svals[win]
    moved, touched, level_ids = update_bytes(torch, plan, idxs,
                                             h.base.element_size())

    def kernels():
        upd_ops.update_levels_cuda(plan, *planes, keys, svals)

    def plain():
        base, upper, upos = plain_planes
        base[widx] = wval
        for k, lid in enumerate(level_ids, 1):
            U.repair_plain(plan, base, upper, upos, k, lid)

    def yardstick():
        return torch.min(h.base.view(-1, c).index_select(0, level_ids[0]),
                         dim=1)

    return kernels, yardstick, plain, moved, touched


def l2_flusher(torch):
    """A callable that overwrites a buffer of twice the 50 MB L2, so the
    next launch finds nothing of its operands in the cache."""
    buf = torch.empty(100 << 20, dtype=torch.uint8, device="cuda")
    return lambda: buf.fill_(1)


def time_flushed(torch, fn, iters: int, flush, warmup: int = 2):
    """Mean event span (ms) of ``fn()`` with the L2 flushed before each
    call: CUDA events around each call alone."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return mean([a.elapsed_time(b) for a, b in pairs])


def kernel_times_in_order(torch, fn, names, rounds: int, flush=None):
    """Device ms of each launch of a kernel whose name contains one of
    ``names``, per call of ``fn`` in launch order (a list per call), from
    a torch.profiler trace of ``rounds`` calls (the L2 flushed before
    each where ``flush``); None where the profiler fails or saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if getattr(e, "device_type", None) == DeviceType.CUDA
                  and any(n in e.name for n in names)]
        events.sort(key=lambda e: e.time_range.start)
        ms = [(e.time_range.end - e.time_range.start) / 1e3 for e in events]
    except Exception as exc:
        print(f"torch.profiler failed: {exc!r}")
        return None
    if not ms or len(ms) % rounds:
        return None
    per = len(ms) // rounds
    return [ms[i * per:(i + 1) * per] for i in range(rounds)]


# B6's kernels (hierarchy_update.cu), by the stems of their names
UPDATE_KERNELS = ("update_runs_kernel", "update_parts_kernel")


def time_update(torch, plan, rc, up):
    """Phase 10 for hierarchy_update: the one host call of three launches
    (CUDA events; with the L2 flushed before each call, the event span and
    each launch's kernel time from torch.profiler), the plain version, the
    level-1 index_select + torch.min pair, and the whole RMQ.update call
    with and without the successor copy."""
    h = rc.hierarchy
    idxs, vals = up["idxs"], up["vals"]
    kernels, yardstick, plain, moved, touched = update_launches(
        torch, h, idxs, vals)
    flush = l2_flusher(torch)
    turns = time_turns(torch, {"kernel": kernels, "library": yardstick}, 20)
    per_call = kernel_times_in_order(torch, kernels, UPDATE_KERNELS, 10,
                                     flush)
    out = {
        "ms": mean(turns["kernel"]),
        "library_ms": mean(turns["library"]),
        "turns_ms": turns,
        "span_flushed_ms": time_flushed(torch, kernels, 20, flush),
        "kernel_ms_per_level": None if per_call is None else [
            mean(col) for col in zip(*per_call)],
        "plain_ms": time_ms(torch, plain, 5),
        "call_ms": time_ms(torch, lambda: rc.update(idxs, vals), 5),
        "copy_ms": time_ms(torch, lambda: (h.base.clone(), h.upper.clone(),
                                           h.upper_pos.clone()), 5),
    }
    if per_call is not None:
        out["kernel_ms"] = sum(out["kernel_ms_per_level"])
    out["bound"] = bound_ms(moved, sum(touched) * plan.c)
    # the whole call's floor: the successor's planes read and written once
    planes = sum(t.numel() * t.element_size()
                 for t in (h.base, h.upper, h.upper_pos))
    out["call_bound"] = bound_ms(2 * planes + moved, 0)
    out["touched"] = touched
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
    """Phase 10 for rmq_short and rmq_bulk, per launch at the sizes the
    engine launches them: the engine's short spans in buckets of 4096
    (device time per launch from torch.profiler: at that size a launch
    takes microseconds and the host's wrapper time would hide it from
    CUDA events) and in one call; the 2^24 batch sorted as the bulk
    executor sorts it, one pass of 2^20 buckets (CUDA events) divided by
    its launches.  Each beside rmq_fused on the same spans, its bound and
    its plain version on the same share of the work."""
    from repro_torch.core import rmq_walk_batch
    from repro_torch.kernels.rmq_fused.ops import rmq_fused_batch
    from repro_torch.kernels.rmq_short import ops as short_ops

    c, item = plan.c, h.base.element_size()
    per_query = 8 + item + 4  # bounds in, value and position out
    sl, sr = short
    step = 4096
    buckets = -(-sl.numel() // step)

    def each_bucket(fn):
        return lambda: [fn(h, sl[s:s + step], sr[s:s + step], True)
                        for s in range(0, sl.numel(), step)]

    moved = span_bytes(torch, sl, sr, item) + sl.numel() * per_query
    call_ms = time_ms(torch, lambda: short_ops.rmq_short_batch(
        h, sl, sr, True), 20)
    launch = kernel_launch_ms(
        torch, each_bucket(short_ops.rmq_short_batch), "rmq_short_kernel")
    t_short = {
        "ms": launch if launch is not None else call_ms / buckets,
        "ms_from": "torch.profiler" if launch is not None else
                   "one call / launches (the profiler saw no kernel)",
        "call_ms": call_ms,
        "fused_launch_ms": kernel_launch_ms(
            torch, each_bucket(rmq_fused_batch), "rmq_fused_kernel"),
        "fused_call_ms": time_ms(torch, lambda: rmq_fused_batch(
            h, sl, sr, True), 20),
        "plain_ms": time_ms(torch, lambda: short_ops.rmq_short_batch_plain(
            h.base, sl, sr, c, plan.capacity, True), 3, warmup=1) / buckets,
        "queries": sl.numel(), "launches": buckets, "bucket": step,
        "call_bound": bound_ms(moved, moved / item),
    }
    t_short["bound"] = bound_ms(moved / buckets, moved / item / buckets)

    order = bulk_order(torch, ls, rs, c, plan.capacity)
    bl, br = ls[order].contiguous(), rs[order].contiguous()
    launches = -(-bl.numel() // (1 << 20))
    pass_ms = time_ms(torch, lambda: bulk_pass(h, bl, br, True), 10)
    chunks = torch.unique(partial_chunks(torch, bl, br, c)).numel()
    moved = chunks * c * item + bl.numel() * per_query
    t_bulk = {
        "ms": pass_ms / launches,
        "pass_ms": pass_ms,
        "fused_ms": time_ms(torch, lambda: rmq_fused_batch(h, bl, br, True),
                            10),
        "plain_ms": time_ms(torch, lambda: rmq_walk_batch(h, bl, br, True),
                            1, warmup=1) / launches,
        "chunks": chunks, "launches": launches,
        "pass_bound": bound_ms(moved, moved / item),
    }
    t_bulk["bound"] = bound_ms(moved / launches, moved / item / launches)
    return t_short, t_bulk


def sorted_pair(torch, plan, h, ls, rs):
    """rmq_bulk in 2^20 buckets and rmq_fused in one launch, both on the
    batch sorted as the bulk executor sorts it (CUDA events)."""
    from repro_torch.kernels.rmq_fused.ops import rmq_fused_batch

    order = bulk_order(torch, ls, rs, plan.c, plan.capacity)
    bl, br = ls[order].contiguous(), rs[order].contiguous()
    return {"rmq_bulk": time_ms(torch, lambda: bulk_pass(h, bl, br, True),
                                10),
            "rmq_fused": time_ms(torch, lambda: rmq_fused_batch(
                h, bl, br, True), 10)}


def zero_phase(torch, name, x, plan, ls, rs, seed, value_only=False):
    """Signed zeros: a copy of the geometry's input with a sixteenth of its
    entries set to -0.0 or +0.0 (and -0.0 right before +0.0 in half of
    them), so most spans' minimum is a zero and the leftmost one's sign is
    the answer's.  First the builds: fused (B1) and per-level (B3),
    value-only and with positions, each held to the plain build as integer
    views; control: the plain upper plane with each -0.0 set to +0.0 must
    fail the bit check while torch.equal passes it.  Then, on the position
    build (and with ``value_only`` on both value-only builds too): rmq_bulk
    (B7, sorted, 2^20 buckets) and rmq_short (B5, the spans cut to the
    short class) against rmq_fused (B2) on the same spans, bit for bit
    (integer views); sampled spans against the bits of their leftmost
    minimal entry.  Control: B2's values with each -0.0 set to +0.0 must
    fail the bit check while torch.equal passes them.  With
    ``value_only``, B2 on each value-only build against B2 on the position
    build: every answer's sign the same (a gate that expects 0).
    Comparison launches only; returns the kernels' max_abs_err
    ``(rmq_short, rmq_bulk, builds)``."""
    from repro_torch.core import RMQ, build_hierarchy
    from repro_torch.kernels.rmq_fused.ops import rmq_fused_batch
    from repro_torch.kernels.rmq_short import ops as short_ops

    n, c = plan.n, plan.c
    g = torch.Generator(device=x.device).manual_seed(seed + 8)
    z = x.clone()
    k = n // 16
    idx = torch.randint(0, n - 1, (k,), generator=g, device=x.device)
    neg = torch.rand(k, generator=g, device=x.device) < 0.5
    zero = torch.zeros(k, dtype=z.dtype, device=z.device)
    z[idx] = torch.where(neg, -zero, zero)
    half = idx[: k // 2]
    z[half] = -zero[: k // 2]  # -0.0 left of +0.0: the leftmost is -0.0
    z[half + 1] = zero[: k // 2]
    plain = build_hierarchy(z, plan, with_positions=True)
    builds = {(backend, pos): RMQ.build(
        z, with_positions=pos, backend=backend, plan=plan,
        device=x.device).hierarchy
        for backend in ("fused", "cuda") for pos in (False, True)}
    build_pairs = []
    for (_, pos), hb in builds.items():
        build_pairs.append((hb.upper, plain.upper))
        if pos:
            build_pairs.append((hb.upper_pos, plain.upper_pos))
    order = bulk_order(torch, ls, rs, c, plan.capacity)
    bl, br = ls[order].contiguous(), rs[order].contiguous()
    sl, sr = short_of(torch, ls, rs, c)
    h = builds[("fused", True)]
    gv, gp = rmq_fused_batch(h, bl, br, True)
    bv, bp = bulk_pass(h, bl, br, True)
    bv_only = bulk_pass(h, bl, br, False)[0]
    fv, fp = rmq_fused_batch(h, sl, sr, True)
    kv, kp = short_ops.rmq_short_batch(h, sl, sr, True)
    kv_only = short_ops.rmq_short_value_batch(h, sl, sr)
    pairs = [(bv, gv), (bv_only, gv), (bp, gp), (kv, fv), (kv_only, fv),
             (kp, fp)]
    upper_sign = 0
    if value_only:
        for backend in ("fused", "cuda"):
            hv = builds[(backend, False)]
            gvv = rmq_fused_batch(hv, bl, br, False)[0]
            pairs.append((bulk_pass(hv, bl, br, False)[0], gvv))
            pairs.append((short_ops.rmq_short_value_batch(hv, sl, sr), fv))
            # B2 on the value-only build against the position build
            upper_sign += int((as_bits(torch, gvv)
                               != as_bits(torch, gv)).sum())
    torch.cuda.synchronize()
    minus = as_bits(torch, torch.tensor(-0.0, dtype=z.dtype,
                                        device=z.device))
    require(same_bits(torch, build_pairs),
            f"{name} zeros: a build (fused or per-level, value-only or "
            "with positions) differs in bits from the plain build")
    up = plain.upper
    upper_minus = int((as_bits(torch, up) == minus).sum())
    control = torch.where(up == 0, torch.zeros_like(up), up)
    require(upper_minus > 0 and torch.equal(control, up)
            and not same_bits(torch, [(control, up)]),
            f"{name} zeros: the build control (-0.0 set to +0.0 in the "
            f"plain upper plane, {upper_minus} entries) did not fail the "
            "bit check as it must")
    signs = {"-0.0": int((as_bits(torch, gv) == minus).sum()),
             "+0.0": int(((gv == 0) & (as_bits(torch, gv) != minus)).sum()),
             "short -0.0": int((as_bits(torch, fv) == minus).sum())}
    require(same_bits(torch, pairs),
            f"{name} zeros: rmq_bulk / rmq_short differ in bits from "
            "rmq_fused on the same spans")
    require(upper_sign == 0,
            f"{name} zeros: rmq_fused on the value-only builds differs in "
            f"sign from the position build in {upper_sign} answers")
    control = torch.where(gv == 0, torch.zeros_like(gv), gv)
    require(signs["-0.0"] > 0 and torch.equal(bv, control)
            and not same_bits(torch, [(bv, control)]),
            f"{name} zeros: the control (-0.0 set to +0.0) did not fail the "
            f"bit check as it must ({signs})")
    for vals, pos, l_, r_ in ((bv, bp, bl, br), (kv, kp, sl, sr)):
        pick = torch.randint(0, l_.numel(), (256,), generator=g,
                             device=x.device).tolist()
        for i in pick:
            lo, hi = int(l_[i]), int(r_[i])
            p = lo + int(torch.argmin(z[lo:hi + 1]))
            require(int(pos[i]) == p and same_bits(
                torch, [(vals[i:i + 1], z[p:p + 1])]),
                f"{name} zeros: span ({lo}, {hi}) is not its leftmost "
                "minimal entry's bits")
    note = (f"; rmq_fused on the value-only builds (fused and per-level) "
            f"differs in sign from the position build in {upper_sign} "
            f"answers (gate: 0)" if value_only else "")
    print(f"{name} zeros: {k} zeros, answers {signs}; builds (fused and "
          f"per-level, value-only and with positions) equal the plain "
          f"build bit for bit ({upper_minus} upper entries -0.0), the build "
          f"control fails the bit check; rmq_bulk and rmq_short equal "
          f"rmq_fused bit for bit (position build"
          f"{' and value-only builds' if value_only else ''}); the control "
          f"fails the bit check, passes torch.equal; 2 x 256 spans are "
          f"their leftmost minimal entry's bits{note}")
    return (max_abs_err(torch, pairs[3:6]), max_abs_err(torch, pairs[:3]),
            max_abs_err(torch, build_pairs))


def with_nans(torch, x, c: int, g):
    """A copy of ``x`` with quiet NaNs of either sign, each with its own
    payload bits: about n / 4096 single ones, 64 runs of up to 2c and both
    sides of 64 chunk edges (of c and of c^2)."""
    n, dev = x.numel(), x.device

    def ri(hi, k):
        return torch.randint(0, hi, (k,), generator=g, device=dev)

    lane = torch.arange(2 * c, device=dev)
    runs = ri(n, 64)[:, None] + lane
    runs = runs[lane < ri(2 * c, 64)[:, None] + 1]
    edges = torch.cat([(ri(max(n // s, 1), 64) + 1) * s
                       for s in (c, c * c)])
    at = torch.cat([ri(n, max(n >> 12, 1)), runs, edges - 1, edges])
    at = at[at < n]
    k = at.numel()
    neg = ri(2, k).bool()
    z = x.clone()
    if x.dtype == torch.float32:
        bits = 0x7FC00000 + ri(1 << 22, k)
        bits = torch.where(neg, bits - (1 << 31), bits)  # sign bit set
        z.view(torch.int32)[at] = bits.to(torch.int32)
    else:
        bits = 0x7FF8000000000000 + ri(1 << 51, k)
        bits = torch.where(neg, bits | -(1 << 63), bits)
        z.view(torch.int64)[at] = bits
    return z


def bits_differ(torch, pairs) -> int:
    """Entries that differ in bits over (got, want) pairs (integer views;
    a shape or dtype mismatch counts every entry)."""
    out = 0
    for got, want in pairs:
        if got.shape != want.shape or got.dtype != want.dtype:
            out += max(got.numel(), want.numel())
        else:
            out += int((as_bits(torch, got) != as_bits(torch, want)).sum())
    return out


def nan_phase(torch, name, x, plan, ls, rs, seed, value_only=False):
    """C7, NaN is the least value: a chunk or span that holds a NaN answers
    its leftmost NaN, that entry's bits and index.  On a copy of the
    geometry's input with NaNs (:func:`with_nans`), every RMQ kernel
    against its plain version as integer views: B1 and B3 (with positions,
    and value-only where ``value_only``) against the plain build; on the
    plain position build B2 (both planes and value-only), B4 (both
    launches) and B7 (sorted, 2^20 buckets) against the plain walk over
    the first 2^20 spans, B5 against its plain version on those spans cut
    to the short class; B6, an update of 2^16 indices writing NaNs over
    numbers and numbers over NaNs, against the plain update.  The reading
    (entries that differ in bits) is a gate at 0; control: the same plain
    versions with every NaN mapped to +inf must fail it, kernel by kernel
    (every kernel's plain output holds a NaN here).  Comparison
    launches only; returns the reading by kernel."""
    from repro_torch.core import RMQ, build_hierarchy, rmq_walk_batch
    from repro_torch.kernels.hierarchy_update import ops as upd_ops
    from repro_torch.kernels.rmq_fused.ops import (
        rmq_fused_batch,
        rmq_fused_value_batch,
    )
    from repro_torch.kernels.rmq_scan.ops import (
        rmq_index_batch_cuda,
        rmq_value_batch_cuda,
    )
    from repro_torch.kernels.rmq_short import ops as short_ops
    from repro_torch.streaming import updates as U

    n, c, dev = plan.n, plan.c, x.device
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    z = with_nans(torch, x, c, g)
    nans = int(z.isnan().sum())
    pairs = {k: [] for k in ("hierarchy_fused", "hierarchy_build",
                             "rmq_fused", "rmq_scan", "rmq_short",
                             "rmq_bulk", "hierarchy_update")}
    h = build_hierarchy(z, plan, True)
    for pos in ((False, True) if value_only else (True,)):
        want = h if pos else build_hierarchy(z, plan, False)
        for backend, key in (("fused", "hierarchy_fused"),
                             ("cuda", "hierarchy_build")):
            hb = RMQ.build(z, with_positions=pos, backend=backend,
                           plan=plan, device=dev).hierarchy
            pairs[key].append((hb.upper, want.upper))
            if pos:
                pairs[key].append((hb.upper_pos, want.upper_pos))
        del want
    m = min(ls.numel(), 1 << 20)
    ql, qr = ls[:m].contiguous(), rs[:m].contiguous()
    wv, wp = rmq_walk_batch(h, ql, qr, True)
    fv, fp = rmq_fused_batch(h, ql, qr, True)
    pairs["rmq_fused"] += [(fv, wv), (fp, wp),
                           (rmq_fused_value_batch(h, ql, qr), wv)]
    pairs["rmq_scan"] += [(rmq_value_batch_cuda(h, ql, qr), wv),
                          (rmq_index_batch_cuda(h, ql, qr), wp)]
    order = bulk_order(torch, ql, qr, c, plan.capacity)
    bv, bp = bulk_pass(h, ql[order].contiguous(), qr[order].contiguous(),
                       True)
    pairs["rmq_bulk"] += [(bv, wv[order]), (bp, wp[order])]
    sl, sr = short_of(torch, ql, qr, c)
    kv, kp = short_ops.rmq_short_batch(h, sl, sr, True)
    pv, pp = short_ops.rmq_short_batch_plain(h.base, sl, sr, c,
                                             plan.capacity, True)
    pairs["rmq_short"] += [(kv, pv), (kp, pp)]
    idxs = torch.randint(0, n, (1 << 16,), generator=g, device=dev)
    at = torch.nonzero(z.isnan())[:, 0]  # numbers written over NaNs too
    idxs[: 1 << 12] = at[torch.randint(0, at.numel(), (1 << 12,),
                                       generator=g, device=dev)]
    vals = with_nans(torch, torch.rand(1 << 16, generator=g, device=dev,
                                       dtype=z.dtype) - 0.5, 4, g)
    got = upd_ops.update_hierarchy_cuda(h, idxs, vals)
    want = U.update_hierarchy(h, idxs, vals)
    pairs["hierarchy_update"] += [(got.base, want.base),
                                  (got.upper, want.upper),
                                  (got.upper_pos, want.upper_pos)]
    torch.cuda.synchronize()
    reading = {k: bits_differ(torch, p) for k, p in pairs.items()}
    inf = float("inf")
    control = {k: bits_differ(torch, [
        (got_, torch.where(want_.isnan(), inf, want_)
         if want_.is_floating_point() else want_)
        for got_, want_ in p]) for k, p in pairs.items()}
    holds = {k: any(bool(w.isnan().any()) for _, w in p
                    if w.is_floating_point()) for k, p in pairs.items()}
    answered = int(wv.isnan().sum())
    print(f"{name} NaN: {nans} NaNs in the input, {answered} of {m} spans "
          f"answer a NaN; entries that differ in bits from the plain "
          f"versions (gate: 0): {json.dumps(reading)}; control (the plain "
          f"versions with NaN mapped to +inf; each kernel whose plain "
          f"output holds a NaN must fail it): {json.dumps(control)}")
    require(answered > 0 and nans > 0, f"{name} NaN: no span met a NaN")
    require(sum(reading.values()) == 0,
            f"{name} NaN: kernels differ in bits from their plain versions: "
            f"{reading}")
    require(all(holds.values()), f"{name} NaN: a kernel's plain output "
            f"holds no NaN: {holds}")
    require(all(control[k] > 0 for k in pairs),
            f"{name} NaN: the control (NaN mapped to +inf) did not fail "
            f"the gate for every kernel: {control}")
    return reading


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


# ---------------------------------------------------------------------------
# phase 13: the compact planes (H)
# ---------------------------------------------------------------------------
LAYOUTS = {
    "packed": dict(packed_pos=True),
    "bf16": dict(summary_dtype="bfloat16"),
    "both": dict(packed_pos=True, summary_dtype="bfloat16"),
}
OOC_N = (1 << 31) + 4096   # past the int32 index space
OOC_SEGMENT = 1 << 24      # elements a slab
SLAB_BLOCK = 1 << 22       # the host generator's block: values by block id


def planes_of(h):
    return [h.base, h.upper, h.upper_pos]


def bits_differ_count(torch, got, want) -> int:
    """Entries whose bits differ (a shape or dtype mismatch: all)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return int(got.numel())
    return int((as_bits(torch, got) != as_bits(torch, want)).sum())


def compact_builds(torch, x, plan, classic_h):
    """``RMQ.build`` of each layout through B1 and B3, counted; every
    plane against the plain compact build as integer views; the unpacked
    plane against the classic build's.  Returns the indexes and times."""
    from repro_torch.core import RMQ, bitpack, build_hierarchy, make_plan

    levels = plan.num_levels
    out, times = {}, {}
    for name, lay in LAYOUTS.items():
        plan_l = make_plan(plan.n, c=plan.c, t=plan.t, **lay)
        hp = build_hierarchy(x, plan_l, with_positions=True)
        for backend, want in (("fused", dict(hierarchy_fused=1)),
                              ("cuda", dict(hierarchy_build=levels - 1))):
            count = zero_counts()
            r = RMQ.build(x, with_positions=True, backend=backend,
                          device="cuda", **lay)
            launches = read(torch, count)
            expect(f"H build {name} {backend}", launches, **want)
            require(same_bits(torch, list(zip(planes_of(r.hierarchy),
                                              planes_of(hp)))),
                    f"H build {name} {backend}: a plane differs in bits "
                    "from the plain compact build")
            out[(name, backend)] = r
            times[f"{name} {backend}"] = time_ms(
                torch, lambda: RMQ.build(x, with_positions=True,
                                         backend=backend, device="cuda",
                                         **lay), 5)
        times[f"{name} plain"] = time_ms(
            torch, lambda: build_hierarchy(x, plan_l, True), 2, warmup=1)
        h = out[(name, "fused")].hierarchy
        if plan_l.packed_pos:
            require(h.upper_pos.dtype == torch.uint32 and same_bits(torch, [
                (bitpack.resolve_positions(h.upper_pos, plan_l),
                 classic_h.upper_pos)]),
                    f"H build {name}: the unpacked plane differs from the "
                    "classic build's")
        if plan_l.summary_dtype == "bfloat16":
            require(same_bits(torch, [(h.upper, classic_h.upper.to(
                torch.bfloat16))]),
                    f"H build {name}: the bf16 plane is not the classic "
                    "plane cast")
    times["classic fused"] = time_ms(
        torch, lambda: RMQ.build(x, with_positions=True, backend="fused",
                                 device="cuda"), 5)
    return out, times


def compact_queries(torch, idx, classic, ls, rs, cv, cp):
    """The 2^24 spans on the packed index through B2, the B4 pair, B7 and
    B5 (counted), and on the bf16 indexes through the exact walk with no
    launch, each equal to the classic index's answers bit for bit; the
    control walk without the level-0 re-compare must disagree."""
    from repro_torch.core import bitpack, rmq_walk_batch
    from repro_torch.kernels.rmq_fused.ops import rmq_fused_batch
    from repro_torch.kernels.rmq_short import ops as short_ops

    c = classic.plan.c
    kf, kc = idx[("packed", "fused")], idx[("packed", "cuda")]
    order = bulk_order(torch, ls, rs, c, classic.capacity)
    bl, br = ls[order].contiguous(), rs[order].contiguous()
    sl, sr = short_of(torch, ls, rs, c)
    count = zero_counts()
    got = [(kf.query(ls, rs), cv), (kf.query_index(ls, rs), cp),
           (kc.query(ls, rs), cv), (kc.query_index(ls, rs), cp)]
    bv, bp = bulk_pass(kf.hierarchy, bl, br, True)
    sv, sp = short_ops.rmq_short_batch(kf.hierarchy, sl, sr, True)
    launches = read(torch, count)
    expect("H packed queries", launches, rmq_fused=2, rmq_scan=2,
           rmq_bulk=-(-ls.numel() // (1 << 20)), rmq_short=1)
    wsv, wsp = short_ops.rmq_short_batch(classic.hierarchy, sl, sr, True)
    got += [(bv, cv[order]), (bp, cp[order]), (sv, wsv), (sp, wsp)]
    require(same_bits(torch, got),
            "H packed queries differ from the classic index's")
    out = {"packed launches": launches}

    for name in ("bf16", "both"):
        rf, rc = idx[(name, "fused")], idx[(name, "cuda")]
        count = zero_counts()
        pairs = [(rf.query(ls, rs), cv), (rf.query_index(ls, rs), cp),
                 (rc.query_index(ls, rs), cp)]
        launches = read(torch, count)
        expect(f"H {name} queries", launches)
        require(same_bits(torch, pairs),
                f"H {name}: the exact walk differs from the classic index")
    h = idx[("bf16", "fused")].hierarchy
    lossy = type(h)(base=h.base, upper=h.upper.float(),
                    upper_pos=h.upper_pos, plan=h.plan)
    differ = bits_differ_count(
        torch, rmq_walk_batch(lossy, ls, rs, False)[0], cv)
    require(differ > 0, "H control: the walk without the level-0 "
            "re-compare agrees with the classic index")
    out["control differing answers"] = differ

    hk = kf.hierarchy
    out["unpack ms"] = time_ms(
        torch, lambda: bitpack.unpack_to_absolute(hk.upper_pos, hk.plan), 10)
    t = time_turns(torch, {
        "B2 classic": lambda: rmq_fused_batch(classic.hierarchy, ls, rs,
                                              True),
        "B2 packed (unpack included)": lambda: rmq_fused_batch(hk, ls, rs,
                                                               True)}, 5)
    out.update({k: mean(v) for k, v in t.items()})
    out["exact walk ms (value + index, bf16)"] = time_ms(
        torch, lambda: rmq_walk_batch(h, ls, rs, True), 1, warmup=1)
    out["plain walk ms (value + index, classic)"] = time_ms(
        torch, lambda: rmq_walk_batch(classic.hierarchy, ls, rs, True), 1,
        warmup=1)
    return out


def compact_mutation(torch, x, plan, seed):
    """``RMQ.update`` of 2^16 indices and a ``StreamingRMQ`` append /
    retire on packed + bf16 indexes (the plain update on the card, no B6
    launch), each against a rebuild; returns the update's time."""
    import numpy as np

    from repro_torch.core import RMQ, build_hierarchy, make_plan
    from repro_torch.streaming import StreamingRMQ
    from repro_torch.streaming import updates as U
    from repro_torch.tune.measure import make_queries

    both = LAYOUTS["both"]
    n = plan.n
    r = RMQ.build(x, with_positions=True, backend="cuda", device="cuda",
                  **both)
    rng = np.random.default_rng(seed + 13)
    idxs = torch.from_numpy(rng.integers(0, n, 1 << 16)).cuda()
    idxs[:4096] = idxs[4096:8192].clone()  # duplicates: the last wins
    vals = torch.from_numpy(
        (rng.random(1 << 16) - 0.5).astype(np.float32)).cuda()
    count = zero_counts()
    r2 = r.update(idxs, vals)
    launches = read(torch, count)
    expect("H update", launches)
    x2 = U.scatter_base(x, idxs, vals)
    fresh = build_hierarchy(x2, r.plan, True)
    require(same_bits(torch, list(zip(planes_of(r2.hierarchy),
                                      planes_of(fresh)))),
            "H update: the compact successor differs from a rebuild")
    ms = time_ms(torch, lambda: r.update(idxs, vals), 3)
    rc = RMQ.build(x, with_positions=True, backend="cuda", device="cuda")
    ms_classic = time_ms(torch, lambda: rc.update(idxs, vals), 3)
    del r2, x2, fresh, rc

    live0 = n - 4096
    s = StreamingRMQ.from_array(x[:live0], with_positions=True,
                                backend="cuda", capacity=n, device="cuda",
                                **both)
    tail = torch.from_numpy(rng.random(777).astype(np.float32) - 0.5).cuda()
    count = zero_counts()
    s3 = s.append(tail).retire(1024)
    launches_s = read(torch, count)
    expect("H append/retire", launches_s)
    want = torch.cat([x[:live0], tail])
    want[:1024] = float("inf")
    fresh = build_hierarchy(want, make_plan(live0 + 777, c=plan.c, t=plan.t,
                                            capacity=n, **both), True)
    require(same_bits(torch, list(zip(planes_of(s3.hierarchy),
                                      planes_of(fresh)))),
            "H append/retire: the compact successor differs from a rebuild")
    ql, qr = (torch.from_numpy(a.astype(np.int64) + 1024).cuda()
              for a in make_queries(live0 + 777 - 1024, 1 << 16, "mixed",
                                    seed=seed + 14))
    brute_force_check(torch, want, ql, qr, s3.query(ql, qr),
                      s3.query_index(ql, qr), 256, seed, live0 + 777)
    print(f"H mutation (packed + bf16): RMQ.update of 2^16 indices "
          f"{ms} ms on the plain update (classic on B6 {ms_classic} ms), "
          f"launches {launches}; append 777 / retire 1024 launches "
          f"{launches_s}; both equal a rebuild as integer views, brute "
          "force 256/256 ok")
    return ms, ms_classic


def compact_engine(torch, idx, seed):
    """``engine().query`` over 2^20 mixed spans on the packed index,
    against the facade."""
    from repro_torch.tune.measure import make_queries

    from repro_torch.core import RMQ

    r = idx[("packed", "cuda")]
    ql, qr = (torch.from_numpy(a).cuda()
              for a in make_queries(r.n, 1 << 20, "mixed", seed=seed + 15))
    e = r.engine(cache_size=0)
    count = zero_counts()
    (v, p), secs = wall(torch, lambda: (e.query(ql, qr),
                                        e.query_index(ql, qr)))
    launches = read(torch, count)
    require(same_bits(torch, [(v, r.query(ql, qr)),
                              (p, r.query_index(ql, qr))]),
            "H engine on the packed index differs from the facade")
    require(launches["rmq_scan"] > 0 and launches["rmq_short"] > 0,
            f"H engine: no kernel launched ({launches})")
    # the same engine over the classic index, in turns on the host clock
    rc = RMQ.build(r.hierarchy.base, with_positions=True, backend="cuda",
                   device="cuda")
    ec = rc.engine(cache_size=0)
    turns = {"classic": [], "packed": []}
    for name, eng in (("classic", ec), ("packed", e), ("packed", e),
                      ("classic", ec)):
        turns[name].append(wall(torch, lambda: (
            eng.query(ql, qr), eng.query_index(ql, qr)))[1])
    print(f"H engine (packed, 2^20 spans, value + index): {secs} s, "
          f"launches {launches}, equal to the facade; in turns (s, host "
          f"clock): {json.dumps(turns)}")
    return turns


def slab_source(seed: int):
    """A host callable ``slab(start, stop)``: float32 values in [0, 1)
    made block by block from the seed, so any slab is the same values
    whatever the slab size."""
    import numpy as np

    def block(b):
        return np.random.default_rng([seed, b]).random(SLAB_BLOCK,
                                                       np.float32)

    def slab(start, stop):
        out = np.empty(stop - start, np.float32)
        for b in range(start // SLAB_BLOCK, (stop - 1) // SLAB_BLOCK + 1):
            lo = max(start, b * SLAB_BLOCK)
            hi = min(stop, (b + 1) * SLAB_BLOCK)
            out[lo - start:hi - start] = block(b)[lo - b * SLAB_BLOCK:
                                                  hi - b * SLAB_BLOCK]
        return out

    return slab


def out_of_core_phase(torch, seed, x, plan, ls, rs, cp):
    """``RMQ.build_out_of_core`` at n = 2^31 + 4096 (packed positions)
    from a host callable, against the plain build of the same values on
    the card; queries through the eager walk; then the same call at
    geometry A from a host numpy array, queried through B2."""
    import numpy as np

    from repro_torch.core import RMQ, build_hierarchy

    n = OOC_N
    slab = slab_source(seed + 21)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    count = zero_counts()
    r, secs = wall(torch, lambda: RMQ.build_out_of_core(
        slab, n, with_positions=True, packed_pos=True,
        segment_size=OOC_SEGMENT, device="cuda"))
    launches = read(torch, count)
    peak = torch.cuda.max_memory_allocated() - before
    slabs = -(-n // OOC_SEGMENT)
    expect("H out of core", launches, hierarchy_fused=slabs)
    h = r.hierarchy
    require(r.backend == "eager" and h.upper_pos.dtype == torch.uint32,
            "H out of core: backend or plane")
    xb = torch.empty(n, dtype=torch.float32, device="cuda")

    def fill():  # the same slabs, made and copied without the build
        for s0 in range(0, n, OOC_SEGMENT):
            stop = min(s0 + OOC_SEGMENT, n)
            xb[s0:stop] = torch.from_numpy(slab(s0, stop)).cuda()

    fill_s = wall(torch, fill)[1]
    hp = build_hierarchy(xb, r.plan, with_positions=True)
    require(same_bits(torch, list(zip(planes_of(h), planes_of(hp)))),
            "H out of core: the hierarchy differs from the plain build")
    del hp
    g = torch.Generator(device="cuda").manual_seed(seed + 22)
    m = 1 << 20
    ql = torch.randint(0, n, (m,), device="cuda", generator=g)
    qr = torch.minimum(ql + torch.randint(0, n, (m,), device="cuda",
                                          generator=g), torch.tensor(n - 1))
    ql, qr = torch.minimum(ql, qr), torch.maximum(ql, qr)
    # spans that end past 2^31
    tl = (1 << 31) - torch.randint(1, 1 << 20, (64,), device="cuda",
                                   generator=g)
    tr = (1 << 31) + torch.randint(0, 4096, (64,), device="cuda",
                                   generator=g)
    ql, qr = torch.cat([ql, tl]), torch.cat([qr, tr])
    (qv, qp), q_secs = wall(torch, lambda: (r.query(ql, qr),
                                            r.query_index(ql, qr)))
    require(qp.dtype == torch.int64 and bool(((qp >= ql) & (qp <= qr)).all()),
            "H out of core: a position lies outside its span")
    brute_force_check(torch, xb, ql[:m], qr[:m], qv[:m], qp[:m], 256, seed,
                      n)
    brute_force_check(torch, xb, ql[m:], qr[m:], qv[m:], qp[m:], 64, seed,
                      n)
    mem = {"memory_bytes": r.memory_bytes(),
           "auxiliary_bytes": r.auxiliary_bytes(),
           "planned": r.plan.auxiliary_bytes_planned(True)}
    del r, h, xb, qv, qp
    torch.cuda.empty_cache()
    print(f"H out of core: n = 2^31 + 4096 float32 from a host callable, "
          f"packed positions, {slabs} slabs of 2^24: {secs} s on the host "
          f"clock (slab generation included; making and copying the same "
          f"slabs alone {fill_s} s), launches {launches}, peak "
          f"device memory {peak} bytes; equal to the plain build as "
          f"integer views; {m} + 64 spans (64 end past 2^31) through the "
          f"eager walk in {q_secs} s, brute force 256/256 and 64/64 ok; "
          f"{json.dumps(mem)}")

    host = x.cpu().numpy()
    count = zero_counts()
    ra, secs_a = wall(torch, lambda: RMQ.build_out_of_core(
        host, plan.n, with_positions=True, packed_pos=True,
        segment_size=OOC_SEGMENT, backend="fused", device="cuda"))
    launches_a = read(torch, count)
    expect("H out of core at A", launches_a,
           hierarchy_fused=-(-plan.n // OOC_SEGMENT))
    rb = RMQ.build(x, with_positions=True, packed_pos=True, backend="fused",
                   device="cuda")
    require(same_bits(torch, list(zip(planes_of(ra.hierarchy),
                                      planes_of(rb.hierarchy)))),
            "H out of core at A: the hierarchy differs from RMQ.build's")
    count = zero_counts()
    pa = ra.query_index(ls, rs)
    launches_q = read(torch, count)
    expect("H out of core at A, queries", launches_q, rmq_fused=1)
    require(same_bits(torch, [(pa, cp)]),
            "H out of core at A: B2's answers differ from the classic")
    print(f"H out of core at A: from a host numpy array in {secs_a} s, "
          f"launches {launches_a}; equal to RMQ.build's hierarchy; 2^24 "
          f"spans through B2 (launches {launches_q}) equal the classic "
          "index's")
    return {"ooc_s": secs, "ooc_fill_s": fill_s, "ooc_peak_bytes": peak,
            "ooc_query_s": q_secs,
            "ooc_a_s": secs_a, **{f"ooc {k}": v for k, v in mem.items()}}


def compact_phase(torch, seed):
    """Phase 13: the compact planes at geometry A and out of core."""
    from repro_torch.core import RMQ, make_plan

    n, m, c, t = 1 << 30, 1 << 24, 128, 64
    x, ls, rs, setup = geometry(torch, n, m, seed)
    plan = make_plan(n, c=c, t=t)
    print(f"H: n=2^30 float32, m=2^24 mixed (geometry A's data, made in "
          f"{setup:.3f} s)")
    classic = RMQ.build(x, with_positions=True, backend="fused",
                        device="cuda")
    from repro_torch.kernels.rmq_fused.ops import rmq_fused_batch

    cv, cp = rmq_fused_batch(classic.hierarchy, ls, rs, True)
    idx, build_ms = compact_builds(torch, x, plan, classic.hierarchy)
    mem = {"classic": (classic.memory_bytes(), classic.auxiliary_bytes(),
                       plan.auxiliary_bytes_planned(True))}
    for name, lay in LAYOUTS.items():
        r = idx[(name, "fused")]
        mem[name] = (r.memory_bytes(), r.auxiliary_bytes(),
                     r.plan.auxiliary_bytes_planned(True))
        require(mem[name][1] == mem[name][2],
                f"H {name}: auxiliary bytes differ from the plan's")
    big = {}
    for name, lay in [("classic", {})] + list(LAYOUTS.items()):
        p = make_plan(OOC_N, c=c, t=t, **lay)
        big[name] = p.auxiliary_bytes_planned(True)
    print(f"H builds (ms, CUDA events, pack / cast included): "
          f"{json.dumps(build_ms)}")
    print(f"H memory at n = 2^30 [memory_bytes, auxiliary_bytes, "
          f"plan.auxiliary_bytes_planned]: {json.dumps(mem)}; planned "
          f"auxiliary bytes at n = 2^31 + 4096: {json.dumps(big)}")
    q = compact_queries(torch, idx, classic, ls, rs, cv, cp)
    print(f"H queries (2^24 mixed spans; ms): {json.dumps(q)}")
    eng = compact_engine(torch, idx, seed)
    up_ms, up_classic = compact_mutation(torch, x, plan, seed)
    del idx
    torch.cuda.empty_cache()
    ooc = out_of_core_phase(torch, seed, x, plan, ls, rs, cp)
    return {"build_ms": build_ms, "memory": mem, "queries": q,
            "engine_s": eng, "update_ms": up_ms,
            "update_classic_ms": up_classic, **ooc}


# ---------------------------------------------------------------------------
# phase 14: the autotuner (A9) and c="auto" at geometry A
# ---------------------------------------------------------------------------
TUNE_N = 1 << 24          # the on-card search's size
TUNE_M = 4096             # spans a measured batch


def engine_launches(engine, fused: bool):
    """The launches an engine's value + index pair over one batch makes:
    one ``rmq_fused`` a bucket (fused), else one ``rmq_short`` a short
    bucket and one ``rmq_scan`` a mid one (the long class is the hybrid
    top, no kernel)."""
    from repro_torch.qe import FUSED, MID, SHORT

    cls = {k: v // 2 for k, v in engine.stats()["class_counts"].items()}
    per = engine.planner.max_bucket

    def buckets(k):
        return -(-k // per)

    if fused:
        return {"rmq_fused": 2 * buckets(cls[FUSED])}
    return {"rmq_short": 2 * buckets(cls[SHORT]),
            "rmq_scan": 2 * buckets(cls[MID])}


def build_and_facade_launches(r):
    """A build's launches and the facade's value + index pair over one
    batch: fused 1 + 2, per-level (cuda) L - 1 + 2."""
    if r.backend == "fused":
        return {"hierarchy_fused": 1, "rmq_fused": 2}
    return {"hierarchy_build": r.plan.num_levels - 1, "rmq_scan": 2}


def tuned_search(torch, seed):
    """The search at n = 2^24 on the card; every winner held to the
    default geometry's answers on its own workload."""
    from repro_torch.core import RMQ
    from repro_torch.qe import QueryEngine
    from repro_torch.tune import (
        DEFAULT_GEOMETRIES,
        SPAN_MIXES,
        Autotuner,
        TuningCache,
        current_platform,
        make_input_array,
        make_span_queries,
        n_bucket,
    )

    card = torch.device("cuda")
    platform = current_platform(card)
    lines = []
    tuner = Autotuner(geometries=DEFAULT_GEOMETRIES,
                      backends=("cuda", "fused"), m=TUNE_M, repeats=3,
                      crossover_points=3, seed=seed, log=lines.append,
                      device=card)
    t0 = time.perf_counter()
    cache, report = tuner.search([TUNE_N])
    t_search = time.perf_counter() - t0
    for line in lines:   # every measurement, crossover and winner
        print(f"I search: {line}")
    require(report["platform"] == platform,
            f"I: the search keyed {report['platform']}, not {platform}")
    ran = len(DEFAULT_GEOMETRIES) - len(report["skipped"])
    want = ran * len(tuner.backends) * len(SPAN_MIXES)
    require(len(report["measurements"]) == want,
            f"I: {len(report['measurements'])} measurements, not {want}")
    require(all(m["ns_per_query"] > 0 for m in report["measurements"]),
            "I: a measurement is not positive")
    entries = {(e["n_bucket"], e["span_mix"]): e
               for e in cache.as_json()["entries"]}
    require(set(entries) == {(n_bucket(TUNE_N), mix) for mix in SPAN_MIXES},
            f"I: winners {sorted(entries)}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tuning_cache.json")
        cache.save(path)
        require(TuningCache.load(path).as_json() == cache.as_json(),
                "I: the cache does not round-trip through save / load")

    x = torch.from_numpy(make_input_array(TUNE_N)).to(card)
    default = RMQ.build(x, with_positions=True, device=card)
    winners = {}
    for mix in SPAN_MIXES:
        w = cache.lookup(platform, TUNE_N, mix)
        ls, rs = make_span_queries(TUNE_N, TUNE_M,
                                   tuner.reference_c(TUNE_N), mix,
                                   seed=seed + 1)
        r = RMQ.build(x, c=w.c, t=w.t, with_positions=True,
                      backend=w.backend, device=card)
        e = QueryEngine(r, cache_size=0, tuning=cache, span_mix=mix)
        require(e.backend == w.backend and e.tuned["source"] == "cache",
                f"I {mix}: the engine did not adopt {w.backend}")
        got = [e.query(ls, rs), e.query_index(ls, rs)]
        want_ = [default.query(ls, rs), default.query_index(ls, rs)]
        require(same_bits(torch, list(zip(got, want_))),
                f"I {mix}: the winner ({w.c}, {w.t}, {w.backend}) answers "
                "differently from c = 128, t = 64")
        winners[mix] = dict(c=w.c, t=w.t, backend=w.backend,
                            long_cutoff=w.long_cutoff,
                            bulk_crossover=w.bulk_crossover,
                            ns_per_query=w.ns_per_query)
    print(f"I search at n = 2^24: {t_search} s, {len(lines)} log lines, "
          f"skipped {report['skipped']}; winners {json.dumps(winners)}, "
          "each equal to c = 128, t = 64 on its workload (integer views)")
    return {"search_s": t_search, "winners": winners}


def plan_gate(rmq, winner) -> bool:
    """Is ``rmq``'s plan the committed winner's (or, with no winner for
    this card, the default geometry's)?"""
    plan = rmq.plan
    if winner is None:
        return (plan.c, plan.t, plan.level_split) == (128, 64, None)
    return ((plan.c, plan.t) == (winner.c, winner.t)
            and plan.level_split == winner.level_split())


def autotune_phase(torch, seed, x, ls, rs, setup, want_v, want_p):
    """Phase 14: the on-card search, then c="auto" at A (``x``, ``ls``,
    ``rs``: geometry A's data, made again) against the committed cache,
    with its control."""
    from repro_torch.core import RMQ
    from repro_torch.qe import QueryEngine
    from repro_torch.tune import (
        DEFAULT_CACHE_PATH,
        TunedConfig,
        TuningCache,
        current_platform,
        default_cache,
    )

    out = tuned_search(torch, seed)
    card = torch.device("cuda")
    platform = current_platform(card)
    store = default_cache()
    require(store.source is not None
            and os.path.samefile(store.source, DEFAULT_CACHE_PATH),
            f"I: the default cache is {store.source}, not the committed "
            f"{DEFAULT_CACHE_PATH}")
    committed = {(e["platform"], e["n_bucket"], e["span_mix"])
                 for e in store.as_json()["entries"]}
    winner = (store.lookup(platform, 1 << 30, "mixed")
              if (platform, 30, "mixed") in committed else None)
    print(f"I: committed cache {DEFAULT_CACHE_PATH}, {len(store)} entries; "
          f"bucket 30 'mixed' for {platform!r}: "
          f"{winner.as_dict() if winner else 'absent (the miss path)'}")

    n, m_eng = x.numel(), 1 << 20
    count = zero_counts()
    rmq = RMQ.build(x, c="auto", with_positions=True)
    v, p = rmq.query(ls, rs), rmq.query_index(ls, rs)
    got = read(torch, count)
    expect("I c='auto' build + facade", got,
           **build_and_facade_launches(rmq))
    require(plan_gate(rmq, winner),
            f"I: c='auto' built ({rmq.plan.c}, {rmq.plan.t}, "
            f"{rmq.plan.level_split}), not the committed winner")
    require(rmq.backend == (winner.backend if winner else "cuda"),
            f"I: c='auto' chose backend {rmq.backend}")
    require(same_bits(torch, [(v, want_v), (p, want_p)]),
            "I: c='auto' at A answers differently from phase 3")
    el, er = ls[:m_eng].cpu().numpy(), rs[:m_eng].cpu().numpy()
    engine = QueryEngine(rmq, cache_size=0, tuning=store)
    require(engine.backend == rmq.backend
            and engine.tuned["source"] == ("cache" if winner else "default"),
            f"I: the engine resolved {engine.tuned}")
    count = zero_counts()
    ev, ep = engine.query(el, er), engine.query_index(el, er)
    got_e = read(torch, count)
    expect("I c='auto' engine", got_e,
           **engine_launches(engine, engine.backend == "fused"))
    require(same_bits(torch, [(ev, want_v[:m_eng]), (ep, want_p[:m_eng])]),
            "I: the tuned engine answers differently from phase 3")
    print(f"I c='auto' at A (data made in {setup:.3f} s): plan c="
          f"{rmq.plan.c} t={rmq.plan.t} split {rmq.plan.level_split}, "
          f"backend {rmq.backend}; launches {got} (build + facade over "
          f"2^24), engine over 2^20 {got_e}; tuned {engine.tuned}; answers "
          "equal to phase 3's (integer views)")

    # -- control: another geometry under the card's key must fail the gate
    base = winner or TunedConfig(c=128, t=64, backend="cuda")
    other = (32, 64) if (base.c, base.t) != (32, 64) else (128, 8)
    control_cache = TuningCache()
    control_cache.put(platform, n, "mixed", TunedConfig(
        c=other[0], t=other[1], backend=base.backend, planner=base.planner))
    control = RMQ.build(x, c="auto", with_positions=True,
                        tuning=control_cache)
    require((control.plan.c, control.plan.t) == other,
            f"I control: the plan ignored the cache ({control.plan.c}, "
            f"{control.plan.t})")
    require(not plan_gate(control, winner),
            "I control: a cache naming another geometry passed the gate")
    require(same_bits(torch, [(control.query(ls, rs), want_v)]),
            "I control: another geometry answers differently")
    print(f"I control: a cache naming {other} gives plan ({control.plan.c}, "
          f"{control.plan.t}), which fails the gate as it must; its answers "
          "equal phase 3's")
    del control

    # -- times, in turns with the default geometry --------------------------
    default = RMQ.build(x, with_positions=True)
    dengine = QueryEngine(default, cache_size=0)
    times = {"tuned build": [], "default build": [],
             "tuned engine 2^20": [], "default engine 2^20": []}
    for _ in range(2):
        times["tuned build"].append(wall(torch, lambda: RMQ.build(
            x, c="auto", with_positions=True))[1])
        times["default build"].append(wall(torch, lambda: RMQ.build(
            x, with_positions=True))[1])
        times["tuned engine 2^20"].append(
            wall(torch, lambda: engine.query(el, er))[1])
        times["default engine 2^20"].append(
            wall(torch, lambda: dengine.query(el, er))[1])
    print(f"I times (s, host clock to the end of device work, in turns; "
          f"tuned = {rmq.backend} at c={rmq.plan.c} t={rmq.plan.t}, default "
          f"= cuda at c=128 t=64; {card_line()}): {json.dumps(times)}")
    out.update(winner=winner.as_dict() if winner else None,
               plan=[rmq.plan.c, rmq.plan.t], backend=rmq.backend,
               times_s=times)
    return out


# ---------------------------------------------------------------------------
# phase 15: the serving tier (J)
# ---------------------------------------------------------------------------
J_ROWS, J_N = 8, 1 << 24      # J1: register_many; J4 / J5: tenant size
J_REQUESTS, J_SPANS = 64, 64  # J2 / J3: 4096 spans a flush
J_UPDATE = 1 << 16            # J3: staged update at A
J_BULK = 1 << 22              # J3: an oversized submission
J4_SECONDS, J4_CLIENTS, J4_SPANS, J4_WINDOW = 5.0, 4, 256, 4
J4_UPDATE, J4_UPDATE_EVERY = 1024, 0.02
J4_TRACED_SECONDS = 2.0      # J4's second stretch, under the tracer
J5_SECONDS = 1.0
J2_TRACED = 5                # J2: fused flushes traced (host, device)


class BlockOracle:
    """Leftmost range minima of a numpy array under point updates, by
    three levels of 128 (entries, chunk minima, superchunk minima): the
    replay oracle of J4 / J5, independent of the port.  ``query`` answers
    a batch at once (values and leftmost positions)."""

    B = 128

    def __init__(self, x):
        import numpy as np

        b = self.B
        if x.shape[0] % (b * b):
            raise ValueError("BlockOracle needs n to be a multiple of 128^2")
        self.np = np
        self.a = np.array(x, dtype=np.float32)
        self.cm = self.a.reshape(-1, b).min(1)
        self.sm = self.cm.reshape(-1, b).min(1)

    def update(self, idxs, vals) -> None:
        """``a[idxs] = vals``, the last of equal indices winning."""
        np, b = self.np, self.B
        idxs = np.asarray(idxs, np.int64)
        _, first = np.unique(idxs[::-1], return_index=True)
        keep = idxs.shape[0] - 1 - first
        self.a[idxs[keep]] = np.asarray(vals, np.float32)[keep]
        ch = np.unique(idxs // b)
        self.cm[ch] = self.a.reshape(-1, b)[ch].min(1)
        sc = np.unique(ch // b)
        self.sm[sc] = self.cm.reshape(-1, b)[sc].min(1)

    def _part(self, plane, start, lo, hi):
        """Entries ``start + [0, width)`` of ``plane`` that lie in [lo, hi]
        per row: (values with +inf outside, indexes)."""
        np = self.np
        width = self.B if plane is not self.sm else self.sm.shape[0]
        idx = start[:, None] + np.arange(width)[None, :]
        live = (idx >= lo[:, None]) & (idx <= hi[:, None])
        vals = np.where(live, plane[np.clip(idx, 0, plane.shape[0] - 1)],
                        np.float32(np.inf))
        return vals, idx

    def query(self, ls, rs):
        np, b = self.np, self.B
        ls = np.asarray(ls, np.int64)
        rs = np.asarray(rs, np.int64)
        cl, cr = ls // b, rs // b
        # level 0: l's chunk up to r, and r's chunk from l (once)
        left = self._part(self.a, cl * b, ls, np.minimum(rs, cl * b + b - 1))
        right = self._part(self.a, cr * b, np.where(cr > cl, cr * b, rs + 1),
                           rs)
        # level 1: whole chunks (cl, cr) within the superchunks of their
        # ends; level 2: whole superchunks between those
        ql, qr = cl + 1, cr - 1
        sl, sr = ql // b, qr // b
        mid_l = self._part(self.cm, sl * b, ql, np.minimum(qr, sl * b + b - 1))
        mid_r = self._part(self.cm, sr * b, np.where(sr > sl, sr * b, qr + 1),
                           qr)
        top = self._part(self.sm, np.zeros_like(sl), sl + 1, sr - 1)
        parts = [left, mid_l, top, mid_r, right]   # left to right
        val = np.min(np.stack([p[0].min(1) for p in parts]), axis=0)
        pos = np.full(ls.shape, -1, np.int64)
        for level, (vals, idx) in zip((0, 1, 2, 1, 0), parts):
            hit = (vals == val[:, None]) & (pos < 0)[:, None]
            rows = np.nonzero(hit.any(1))[0]
            if rows.shape[0] == 0:
                continue
            first = idx[rows, hit[rows].argmax(1)]
            # a superchunk to its leftmost chunk holding the minimum, a
            # chunk to its leftmost entry
            for lv in range(level, 0, -1):
                child = self.cm if lv == 2 else self.a
                sub = first[:, None] * b + np.arange(b)[None, :]
                first = sub[np.arange(rows.shape[0]),
                            (child[sub] == val[rows, None]).argmax(1)]
            pos[rows] = first
        # the leftmost minimal entry's own bits (-0.0 and +0.0 compare
        # equal, so the minimum alone does not say which)
        return self.a[pos], pos


def span_split(spans):
    """``{name: [count, mean ms, total s]}`` of a tracer's spans."""
    tot = {}
    for sp in spans:
        t = tot.setdefault(sp.name, [0, 0.0])
        t[0] += 1
        t[1] += sp.duration
    return {name: [c, d / c * 1e3, d] for name, (c, d) in tot.items()}


def device_split(torch, fn, rounds: int):
    """``{kernel or copy: [count, device ms]}`` a call of ``fn``, from a
    torch.profiler trace of ``rounds`` calls after one untraced call;
    None where the profiler fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds):
                fn()
            torch.cuda.synchronize()
        rows = kernel_rows(prof.key_averages())
    except Exception as exc:
        print(f"torch.profiler failed: {exc!r}")
        return None
    return {name[:60]: [cnt / rounds, ms / rounds]
            for name, ms, cnt in rows}


def host_profile(fn, rounds: int, top: int = 14):
    """``{function: [calls, own ms, cumulative ms]}`` a call of ``fn``
    for the ``top`` functions by own host time, from cProfile over
    ``rounds`` calls."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(rounds):
        fn()
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:top]
    return {f"{os.path.basename(f)}:{line}({name})":
            [nc / rounds, tt / rounds * 1e3, ct / rounds * 1e3]
            for (f, line, name), (_, nc, tt, ct, _) in rows}


class TimedLock:
    """A lock that keeps the seconds each acquire waited and each hold
    lasted, by the acquiring thread's role (its name up to a dash): how
    J4 reads the serving tier's service lock."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._local = threading.local()
        self.waits, self.holds = {}, {}

    @staticmethod
    def _role():
        import threading

        return threading.current_thread().name.split("-")[0]

    def acquire(self, blocking=True, timeout=-1):
        t0 = time.perf_counter()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._local.at = time.perf_counter()
            self.waits.setdefault(self._role(), []).append(
                self._local.at - t0)
        return ok

    def release(self):
        self.holds.setdefault(self._role(), []).append(
            time.perf_counter() - self._local.at)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def summary(self):
        """``{role: {...}}``: acquires, wait p50 / p99 / mean / total and
        hold mean / total (ms; totals in s)."""
        import numpy as np

        out = {}
        for role, w in self.waits.items():
            w = np.array(w) * 1e3
            h = np.array(self.holds.get(role, [0.0])) * 1e3
            out[role] = {"acquires": int(w.shape[0]),
                         "wait_p50_ms": float(np.percentile(w, 50)),
                         "wait_p99_ms": float(np.percentile(w, 99)),
                         "wait_mean_ms": float(w.mean()),
                         "wait_total_s": float(w.sum()) / 1e3,
                         "hold_mean_ms": float(h.mean()),
                         "hold_total_s": float(h.sum()) / 1e3}
        return out


def register_many_phase(torch, seed):
    """J1: 8 arrays of 2^24 through ``register_many``: one B1 launch, each
    row equal to a solo B1 build and to the plain build of that row; the
    batched build and the solo builds timed in turns, on the host clock
    (CUDA events around the calls) and on the device (torch.profiler)."""
    from repro_torch.core import build_hierarchy, build_many, make_plan
    from repro_torch.kernels.hierarchy_fused.ops import build_hierarchy_fused
    from repro_torch.qe import QueryService
    from repro_torch.tune.measure import make_input_array

    arrays = {f"row{i}": make_input_array(J_N, seed + 100 + i)
              for i in range(J_ROWS)}
    svc = QueryService()
    count = zero_counts()
    engines = svc.register_many(arrays, c=128, t=64, with_positions=True)
    launches = read(torch, count)
    expect("J1 register_many", launches, hierarchy_fused=1)
    plan = make_plan(J_N, c=128, t=64)
    xs = torch.stack([torch.from_numpy(a).cuda() for a in arrays.values()])
    solos = [build_hierarchy_fused(xs[i], plan, True) for i in range(J_ROWS)]
    plains = [build_hierarchy(xs[i], plan, True) for i in range(J_ROWS)]

    def rows_equal(hs):
        return all(same_bits(torch, [
            (getattr(engines[f"row{i}"].index.hierarchy, p),
             getattr(h, p)) for p in ("base", "upper", "upper_pos")])
            for i, h in enumerate(hs))

    require(rows_equal(solos),
            "J1: a row of register_many differs from its solo B1 build")
    require(rows_equal(plains),
            "J1: a row of register_many differs from the plain build")
    for hs in (solos, plains):
        require(not rows_equal([hs[1], hs[0]] + hs[2:]),
                "J1 control: two rows swapped passed the gate")
    fns = {"batched": lambda: build_many(xs, plan, True),
           "solo x8": lambda: [build_hierarchy_fused(xs[i], plan, True)
                               for i in range(J_ROWS)]}
    times = time_turns(torch, fns, iters=10)
    # device time of the B1 kernels a call (the host clock above also
    # holds the solo side's eight host launches)
    device = {name: kernel_launch_ms(torch, fn, "fused_") for name, fn
              in fns.items()}
    device["solo x8"] = (None if device["solo x8"] is None
                         else device["solo x8"] * J_ROWS)
    bound = bound_ms(J_ROWS * (plan.capacity * 4 + plan.upper_size * 8),
                     J_ROWS * plan.capacity)
    print(f"J1 register_many: {J_ROWS} x {J_N} float32, c=128 t=64, "
          f"positions; launches {launches}; every row equal to its solo B1 "
          f"build and to the plain build (integer views); control (rows 0 "
          f"and 1 swapped) fails both gates as it must")
    print(f"J1 times (ms a call, CUDA events, in turns; {card_line()}): "
          f"{json.dumps(times)}; B1 device ms a call (torch.profiler) "
          f"{json.dumps(device)}; bound of the {J_ROWS} rows {bound}")
    del svc, engines, xs, solos, plains
    return {"launches": launches, "ms": mean(times["batched"]),
            "solo_ms": mean(times["solo x8"]),
            "device_ms": device["batched"],
            "solo_device_ms": device["solo x8"], "bound": bound}


def service_phase(torch, x, ls, rs, want_v, want_p):
    """J2: ``QueryService`` at A: a fused and a routed tenant, 64 requests
    of 64 of phase 3's spans each, value and index interleaved."""
    from repro_torch.core import RMQ
    from repro_torch.qe import QueryService

    n = x.numel()
    svc = QueryService(auto_flush=False)
    svc.register("fused", RMQ.build(x, with_positions=True,
                                    backend="fused"), cache_size=0)
    svc.register("routed", RMQ.build(x, with_positions=True,
                                     backend="cuda"), cache_size=0)
    m = J_REQUESTS * J_SPANS
    lh, rh = ls[:2 * m].cpu().numpy(), rs[:2 * m].cpu().numpy()
    tickets = []
    for i in range(J_REQUESTS):
        op = "index" if i % 2 else "value"
        for name, base in (("fused", 0), ("routed", m)):
            s = base + i * J_SPANS
            tickets.append((svc.submit(name, lh[s:s + J_SPANS],
                                       rh[s:s + J_SPANS], op), s, op))
    count = zero_counts()
    t0 = time.perf_counter()
    svc.flush(names=("fused",))
    got_f = read(torch, count)
    t_fused = time.perf_counter() - t0
    expect("J2 fused flush", got_f, rmq_fused=1)
    count = zero_counts()
    t0 = time.perf_counter()
    svc.flush(names=("routed",))
    got_r = read(torch, count)
    t_routed = time.perf_counter() - t0
    require(got_r["rmq_fused"] == 0 and got_r["hierarchy_fused"] == 0
            and got_r["rmq_short"] + got_r["rmq_scan"] > 0,
            f"J2 routed flush: launches {got_r}")
    pairs = [(svc.take(tk), (want_p if op == "index" else want_v)
              [s:s + J_SPANS]) for tk, s, op in tickets]
    require(same_bits(torch, pairs),
            "J2: the service answers differently from phase 3")
    # where a fused flush's time goes: the same 64 requests flushed
    # again, under the tracer (host spans) and under torch.profiler
    # (device time by kernel and copy), each flush's answers gated
    from repro_torch.obs.trace import Tracer, use_tracer

    fused_reqs = [(s, op) for _, s, op in tickets if s < m]
    flushed = []

    def fused_flush():
        tks = [(svc.submit("fused", lh[s:s + J_SPANS], rh[s:s + J_SPANS],
                           op), s, op) for s, op in fused_reqs]
        svc.flush(names=("fused",))
        flushed.extend((svc.take(tk), (want_p if op == "index" else want_v)
                        [s:s + J_SPANS]) for tk, s, op in tks)

    tracer = Tracer()
    with use_tracer(tracer):
        for _ in range(J2_TRACED):
            fused_flush()
    host = span_split(tracer.spans())
    device = device_split(torch, fused_flush, J2_TRACED)
    calls = host_profile(fused_flush, J2_TRACED)
    require(same_bits(torch, flushed),
            "J2: a traced fused flush answers differently from phase 3")
    del flushed
    # a request with out-of-range bounds fails its group only.  The
    # engine checks bound values in debug mode alone (a read-back), and a
    # kernel must never see such bounds, so this flush runs in it
    bad_r = rh[:8].copy()
    bad_r[3] = n
    t_ok = svc.submit("routed", lh[:8], rh[:8], "value")
    t_bad = svc.submit("routed", lh[:8], bad_r, "index")
    os.environ["REPRO_RMQ_DEBUG"] = "1"
    try:
        svc.flush()
        failed = ""
    except RuntimeError as exc:
        failed = str(exc)
    finally:
        del os.environ["REPRO_RMQ_DEBUG"]
    require("claimable" in failed and f"tickets [{t_bad}]" in failed,
            f"J2: the bad group did not fail alone: {failed!r}")
    require(same_bits(torch, [(svc.take(t_ok), want_v[:8])]),
            "J2: the healthy group's answers were lost")
    try:
        svc.take(t_bad)
        require(False, "J2: the failed group's ticket has an answer")
    except KeyError:
        pass
    stats = {k: v for k, v in svc.stats().items() if k != "engines"}
    print(f"J2 QueryService at A ({card_line()}): {J_REQUESTS} requests "
          f"of {J_SPANS} spans a tenant; fused flush launches {got_f} in "
          f"{t_fused} s, "
          f"routed {got_r} in {t_routed} s (host clock); answers equal to "
          f"phase 3's (integer views); an out-of-range request failed its "
          f"group alone (debug mode), the value group claimable; stats "
          f"{stats}")
    print(f"J2 a fused flush of {m} spans, {J2_TRACED} traced: host spans "
          f"[count, mean ms, total s] {json.dumps(host)}; device [count, "
          f"ms] a flush (torch.profiler) {json.dumps(device)}; host "
          f"functions [calls, own ms, cumulative ms] a flush (cProfile) "
          f"{json.dumps(calls)} ({card_line()})")
    del svc
    launches = {k: got_f[k] + got_r[k] for k in got_f}
    return {"launches": launches, "fused_flush_s": t_fused,
            "routed_flush_s": t_routed, "traced_host": host,
            "traced_device": device, "host_calls": calls}


def tier_manual_phase(torch, x, ls, rs, want_v, want_p, seed):
    """J3: ``ServingTier`` at A with an injected clock: an oversized
    submission (B7) against the front while an update is staged, then a
    mixed backlog of 4096 spans flushed after the swap (B6's three, then
    one B2)."""
    import numpy as np

    from repro_torch.core import RMQ
    from repro_torch.kernels.rmq_fused.ops import rmq_fused_batch
    from repro_torch.serving import ServingTier

    n = x.numel()
    now = [0.0]
    events = []
    tier = ServingTier(clock=lambda: now[0], on_flush=events.append)
    front = RMQ.build(x, with_positions=True, backend="fused")
    levels = front.plan.num_levels
    tier.register_tenant("a", front, slo_ms=5.0, max_batch=4096,
                         max_queue=8192, cache_size=0,
                         bulk_crossover=min(1 << 20, J_BULK))
    rng = np.random.default_rng(seed + 30)
    idxs = torch.from_numpy(rng.integers(0, n, J_UPDATE)).cuda()
    # negative: every span holding an updated entry changes its answer
    vals = -torch.from_numpy(rng.random(J_UPDATE, dtype=np.float32)).cuda()
    tier.update("a", idxs, vals)

    # -- the oversized submission: B7 on the current front ---------------
    count = zero_counts()
    t0 = time.perf_counter()
    tv = tier.submit("a", ls[:J_BULK], rs[:J_BULK], "value")
    tp = tier.submit("a", ls[:J_BULK], rs[:J_BULK], "index")
    bv, bp = tv.result(0), tp.result(0)
    torch.cuda.synchronize()
    t_bulk = time.perf_counter() - t0
    got_b = read(torch, count)
    buckets = -(-J_BULK // (1 << 20))
    expect("J3 oversized", got_b, rmq_bulk=2 * buckets)
    snap = tier.stats()["tenants"]["a"]["snapshot"]
    require(tv.generation == tp.generation == 0 and snap["staged"] == 1
            and snap["swaps"] == 0,
            f"J3 oversized: generation {tv.generation}, slot {snap}")
    require(same_bits(torch, [(bv, want_v[:J_BULK]),
                              (bp, want_p[:J_BULK])]),
            "J3: B7 answers the oversized submission differently from B2")

    # -- the backlog, flushed after the swap -------------------------------
    m = J_REQUESTS * J_SPANS
    lh, rh = ls[:m].cpu().numpy(), rs[:m].cpu().numpy()
    reqs = []
    for i in range(J_REQUESTS):
        op = "index" if i % 2 else "value"
        s = i * J_SPANS
        reqs.append((tier.submit("a", lh[s:s + J_SPANS], rh[s:s + J_SPANS],
                                 op), s, op))
    # 4096 queued spans = max_batch: due by size at once
    count = zero_counts()
    t0 = time.perf_counter()
    tier.step()
    torch.cuda.synchronize()
    t_flush = time.perf_counter() - t0
    got_f = read(torch, count)
    expect("J3 flush", got_f, hierarchy_update=levels - 1, rmq_fused=1)
    succ = front.update(idxs, vals)
    sv, sp = rmq_fused_batch(succ.hierarchy, ls[:m], rs[:m], True)
    answers = [(tk.result(0), (sp if op == "index" else sv)[s:s + J_SPANS])
               for tk, s, op in reqs]
    require(all(tk.generation == 1 for tk, _, _ in reqs)
            and [(e.generation, e.reason, e.requests, e.applied_mutations)
                 for e in events] == [(1, "size", J_REQUESTS, 1)],
            f"J3: generations {[tk.generation for tk, _, _ in reqs][:4]}, "
            f"events {events}")
    require(same_bits(torch, answers),
            "J3: the flush answers differently from B2 over the successor")
    stale = [(got, (want_p if op == "index" else want_v)[s:s + J_SPANS])
             for (got, _), (_, s, op) in zip(answers, reqs)]
    require(not same_bits(torch, stale),
            "J3 control: answers against the pre-swap front passed the gate")
    moved = sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
                for g, w in stale)
    t = tier.stats()["tenants"]["a"]
    print(f"J3 ServingTier at A (injected clock; {card_line()}): {J_BULK} "
          f"spans oversized x 2 ops -> launches {got_b} in {t_bulk} s, "
          f"generation 0, the "
          f"update still staged, equal to B2 (phase 3); then {J_REQUESTS} "
          f"requests of {J_SPANS} + a staged update of {J_UPDATE} -> "
          f"launches {got_f} in {t_flush} s (host clock), generation 1, "
          f"equal to B2 over RMQ.update's successor; control: {moved} of "
          f"{m} answers differ from the pre-swap front's, which fails the "
          f"gate as it must; tenant counters: bulk_routed "
          f"{t['bulk_routed']}, flushes {t['flushes']}, swaps "
          f"{t['snapshot_swaps']}")
    del tier, front, succ, sv, sp, answers, stale, bv, bp
    launches = {k: got_b[k] + got_f[k] for k in got_b}
    return {"launches": launches, "bulk_s": t_bulk, "flush_s": t_flush}


def _check_tickets(torch, oracle_x, log, checked):
    """Every checked ticket against the oracle replayed, forward once in
    generation order, to the ticket's generation: mismatching spans."""
    import numpy as np

    oracle = BlockOracle(oracle_x)
    applied, bad = 0, 0
    for gen, ls, rs, op, res in sorted(checked, key=lambda c: c[0]):
        while applied < gen:
            oracle.update(*log[applied])
            applied += 1
        v, p = oracle.query(ls, rs)
        want = p.astype(np.int32) if op == "index" else v
        bad += int((res.view(np.int32) != want.view(np.int32)).sum())
    return bad


def _tier_thread_run(torch, base, seed, seconds, traced):
    """One stretch of J4: the tier on its own thread for ``seconds``,
    four clients and a mutator; every gate checked.  ``traced`` runs it
    under the tracer with the tier's service lock timed (TimedLock).
    Returns its launches, its readings and the split where traced."""
    import threading

    import numpy as np

    from repro_torch.core import RMQ
    from repro_torch.obs.trace import Tracer, use_tracer
    from repro_torch.serving import Backpressure, ServingTier
    from repro_torch.tune.measure import make_queries

    read_flushes = [0]

    def on_flush(ev):
        read_flushes[0] += ev.requests > 0

    tier = ServingTier(idle_tick=0.001, on_flush=on_flush)
    tier.register_tenant("a", RMQ.build(base, with_positions=True,
                                        backend="fused"),
                         slo_ms=5.0, max_batch=4096, max_queue=1 << 15,
                         cache_size=0)
    lock_timer = TimedLock() if traced else None
    if traced:
        tier._service_lock = lock_timer
    pools = [make_queries(J_N, 64 * J4_SPANS, "mixed", seed=seed + 40 + i)
             for i in range(J4_CLIENTS)]
    log, checked, failures, latencies = [], [], [], []
    spans = [0] * J4_CLIENTS
    rejected = [0]
    lock = threading.Lock()
    stop = threading.Event()
    deadline = [0.0]

    def client(i, side):
        stream = torch.cuda.Stream() if side else None
        ctx = (torch.cuda.stream(stream) if side
               else contextlib.nullcontext())
        pls, prs = pools[i]
        pending, k = [], 0
        try:
            with ctx:
                while time.monotonic() < deadline[0] or pending:
                    if time.monotonic() < deadline[0] and len(
                            pending) < J4_WINDOW:
                        j = k % 64
                        ls = pls[j * J4_SPANS:(j + 1) * J4_SPANS]
                        rs = prs[j * J4_SPANS:(j + 1) * J4_SPANS]
                        op = "index" if k % 2 else "value"
                        try:
                            tk = tier.submit("a", ls, rs, op)
                        except Backpressure as bp:
                            with lock:
                                rejected[0] += 1
                            time.sleep(bp.retry_after)
                            continue
                        pending.append((k, tk, ls, rs, op))
                        k += 1
                        continue
                    kk, tk, ls, rs, op = pending.pop(0)
                    res = tk.result(60.0)
                    if side:
                        res = res.clone()   # read on the side stream
                    spans[i] += ls.shape[0]
                    latencies.append(tk.completed_at - tk.submitted_at)
                    # every 16th ticket, value and index in turn
                    if kk % 32 in (0, 17):
                        with lock:
                            checked.append((tk.generation, ls, rs, op,
                                            res.cpu().numpy()))
        except Exception as exc:  # reported below; the gate fails
            with lock:
                failures.append(repr(exc))

    def mutator():
        mrng = np.random.default_rng(seed + 50)
        while not stop.is_set():
            idxs = mrng.integers(0, J_N, J4_UPDATE)
            vals = mrng.random(J4_UPDATE, dtype=np.float32)
            log.append((idxs, vals))
            tier.update("a", torch.from_numpy(idxs).cuda(),
                        torch.from_numpy(vals).cuda())
            stop.wait(J4_UPDATE_EVERY)

    threads = [threading.Thread(target=client, args=(i, i == 0),
                                name=f"client-{i}")
               for i in range(J4_CLIENTS)]
    mut = threading.Thread(target=mutator, name="mutator")
    tracer = Tracer(capacity=1 << 20)
    count = zero_counts()
    with (use_tracer(tracer) if traced else contextlib.nullcontext()):
        tier.start()
        t0 = time.monotonic()
        deadline[0] = t0 + seconds
        mut.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(seconds + 120)
        elapsed = time.monotonic() - t0
        stop.set()
        mut.join()
        tier.stop()
    launches = read(torch, count)
    require(not failures and not any(th.is_alive() for th in threads),
            f"J4: failed tickets {failures[:3]}")
    t0 = time.perf_counter()
    bad = _check_tickets(torch, base.cpu().numpy(), log, checked)
    t_check = time.perf_counter() - t0
    s = tier.stats()
    t = s["tenants"]["a"]
    require(s["flusher_errors"] == 0 and t["failed_requests"] == 0,
            f"J4: flusher errors {s['flusher_errors']}, failed "
            f"{t['failed_requests']}")
    require(bad == 0, f"J4: {bad} checked spans differ from the oracle")
    # each flush drains at most 4 x 4 x 256 = 4096 spans: one B2 launch
    # each that reads
    require(launches["rmq_fused"] == read_flushes[0],
            f"J4: {launches['rmq_fused']} rmq_fused launches for "
            f"{read_flushes[0]} flushes that read")
    total = sum(spans)
    flushes = {r: t[f"flushes_{r}"] for r in ("deadline", "size",
                                                "mutation", "forced")}
    lat = np.array(latencies) * 1e3
    out = {
        "seconds": seconds,
        "spans_per_s": total / elapsed,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "histogram_p50_ms": t["latency_s"]["p50"] * 1e3,
        "histogram_p99_ms": t["latency_s"]["p99"] * 1e3,
        "flushes": flushes,
        "read_flushes": read_flushes[0],
        "deadline_misses": t["deadline_misses"],
        "rmq_fused_per_flush": launches["rmq_fused"] / max(t["flushes"], 1),
        "rmq_fused_per_read_flush": (launches["rmq_fused"]
                                     / max(read_flushes[0], 1)),
        "swaps": t["snapshot_swaps"],
        "mutations": len(log),
        "tickets": t["submits"],
        "rejected": rejected[0],
        "checked_tickets": {op: sum(c[3] == op for c in checked)
                            for op in ("value", "index")},
        "check_s": t_check,
    }
    if traced:
        out["spans"] = span_split(tracer.spans())
        out["spans_dropped"] = tracer.dropped
        out["service_lock"] = lock_timer.summary()
    del tier
    return launches, out


def tier_thread_phase(torch, x, seed):
    """J4: the tier on its own thread: four clients, one reading under a
    side stream, and a mutator, for five seconds; then a shorter stretch
    under the tracer, with the tier's service lock timed, for where the
    time goes."""
    base = x[:J_N].clone()
    launches, out = _tier_thread_run(torch, base, seed, J4_SECONDS, False)
    launches_t, traced = _tier_thread_run(torch, base, seed + 1,
                                          J4_TRACED_SECONDS, True)
    for k, v in launches_t.items():
        launches[k] += v
    for name, o in (("", out), (" traced", traced)):
        print(f"J4 tier thread{name} at n={J_N} ({J4_CLIENTS} clients x "
              f"{J4_WINDOW} outstanding {J4_SPANS}-span requests for "
              f"{o['seconds']} s, client 0 under a side stream; "
              f"{J4_UPDATE} updated indices every {J4_UPDATE_EVERY * 1e3} "
              f"ms; {card_line()}): {json.dumps(o)}; every 16th ticket "
              f"equal to the replayed oracle at its generation, no ticket "
              f"failed, flusher_errors 0")
    del base
    return {"launches": launches, **out, "traced": traced}


def tier_async_phase(torch, x):
    """J5: ``AsyncServingTier``: two tenants (SLOs 2 and 20 ms) driven by
    ``pump`` for one second, every answer checked."""
    import asyncio

    import numpy as np

    from repro_torch.core import RMQ
    from repro_torch.serving import AsyncServingTier, ServingTier

    data = {"trading": x[:J_N], "analytics": x[J_N:2 * J_N]}
    tier = ServingTier(idle_tick=0.002)
    for name, slo in (("trading", 2.0), ("analytics", 20.0)):
        tier.register_tenant(name, RMQ.build(data[name], with_positions=True,
                                             backend="fused"), slo_ms=slo)
    aio = AsyncServingTier(tier)
    answers = []
    waits = {name: [] for name in data}

    async def client(name, seed, spans):
        rng = np.random.default_rng(seed)
        end = time.monotonic() + J5_SECONDS
        k = 0
        while time.monotonic() < end:
            ls = rng.integers(0, J_N - spans, 64)
            rs = ls + rng.integers(0, spans, 64)
            op = "index" if k % 2 else "value"
            tk = aio.submit(name, ls, rs, op=op)
            res = await aio.wait(tk)
            answers.append((name, ls, rs, op, res.cpu().numpy()))
            waits[name].append(tk.completed_at - tk.submitted_at)
            k += 1

    async def main():
        stop = asyncio.Event()
        pump = asyncio.create_task(aio.pump(stop))
        await asyncio.gather(client("trading", 60, 1 << 10),
                             client("analytics", 61, J_N // 4))
        stop.set()
        await pump

    count = zero_counts()
    asyncio.run(main())
    launches = read(torch, count)
    bad = 0
    for name in data:
        oracle = BlockOracle(data[name].cpu().numpy())
        for tenant, ls, rs, op, res in answers:
            if tenant != name:
                continue
            v, p = oracle.query(ls, rs)
            want = p.astype(np.int32) if op == "index" else v
            bad += int((res.view(np.int32) != want.view(np.int32)).sum())
    require(bad == 0, f"J5: {bad} answers differ from the oracle")
    s = tier.stats()
    out = {name: {"requests": s["tenants"][name]["submits"],
                  "p50_ms": float(np.percentile(waits[name], 50)) * 1e3,
                  "p99_ms": float(np.percentile(waits[name], 99)) * 1e3,
                  "flushes": s["tenants"][name]["flushes"],
                  "deadline_misses": s["tenants"][name]["deadline_misses"]}
           for name in data}
    print(f"J5 AsyncServingTier ({J5_SECONDS} s of pump, 64-span requests; "
          f"{card_line()}): {json.dumps(out)}; launches {launches}; all "
          f"{len(answers)} answers equal to the oracle")
    del tier, aio
    return {"launches": launches, **out}


def tier_phase(torch, seed, x, ls, rs, want_v, want_p):
    """Phase 15 (J): the serving tier at geometry A's data; returns its
    summary and its launches by kernel."""
    launches = {}
    summary = {}
    for name, fn in (
            ("J1", lambda: register_many_phase(torch, seed)),
            ("J2", lambda: service_phase(torch, x, ls, rs, want_v, want_p)),
            ("J3", lambda: tier_manual_phase(torch, x, ls, rs, want_v,
                                             want_p, seed)),
            ("J4", lambda: tier_thread_phase(torch, x, seed)),
            ("J5", lambda: tier_async_phase(torch, x))):
        t0 = time.perf_counter()
        out = fn()
        gc.collect()
        torch.cuda.empty_cache()
        for k, v in out.pop("launches").items():
            launches[k] = launches.get(k, 0) + v
        out["phase_s"] = time.perf_counter() - t0
        summary[name] = out
    return summary, launches


J6_NEW = 8  # new tokens of J6's generate


def tier_eviction_phase(torch, cfg, params, sc, prompts):
    """J6: ``ServeEngine(serving_tier=ServingTier())`` at F's full width
    against the direct path's run of the same seed and length: tokens and
    every round's victims equal; the kv-eviction tenant swaps once a round
    after the first."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.eviction import RMQEvictionManager
    from repro_torch.serving import ServingTier

    rounds = {"direct": [], "tier": []}
    mode = ["direct"]
    orig = RMQEvictionManager.plan_evictions_streaming

    def plan(self, index, scores, live):
        index, victims = orig(self, index, scores, live)
        rounds[mode[0]].append((live, victims.clone()))
        return index, victims

    RMQEvictionManager.plan_evictions_streaming = plan
    try:
        out_d, t_d = wall(torch, lambda: ServeEngine(
            cfg, params, sc).generate(prompts, J6_NEW))
        mode[0] = "tier"
        tier = ServingTier()
        count = zero_counts()
        out_t, t_t = wall(torch, lambda: ServeEngine(
            cfg, params, sc, serving_tier=tier).generate(prompts, J6_NEW))
        launches = read(torch, count)
    finally:
        RMQEvictionManager.plan_evictions_streaming = orig
    require(torch.equal(out_t["tokens"], out_d["tokens"])
            and (out_t["final_pos"], out_t["evicted"])
            == (out_d["final_pos"], out_d["evicted"]),
            f"J6: the tier's generate differs from the direct path's "
            f"({out_t['final_pos']}, {out_t['evicted']}) vs "
            f"({out_d['final_pos']}, {out_d['evicted']})")
    d, t = rounds["direct"], rounds["tier"]
    require(len(t) == len(d) > 1 and all(
        lt == ld and torch.equal(vt, vd)
        for (lt, vt), (ld, vd) in zip(t, d)),
        f"J6: {len(t)} tier rounds against {len(d)} direct; victims differ")
    tenant = tier.stats()["tenants"]["kv-eviction"]
    require(tenant["snapshot_swaps"] == len(t) - 1
            and tenant["flushes"] == len(t)
            and tenant["failed_requests"] == 0,
            f"J6: tenant {tenant['flushes']} flushes, "
            f"{tenant['snapshot_swaps']} swaps for {len(t)} rounds")
    require(launches["flash_attention"] == cfg.num_layers
            and launches["hierarchy_update"] > 0,
            f"J6: launches {launches}")
    print(f"J6 eviction as the kv-eviction tenant (F's full width, "
          f"{J6_NEW} new tokens; {card_line()}): tokens, final_pos "
          f"{out_t['final_pos']}, evicted {out_t['evicted']} and the "
          f"victims of all {len(t)} rounds equal to the direct path's; "
          f"tenant flushes {tenant['flushes']}, swaps "
          f"{tenant['snapshot_swaps']}, p99 "
          f"{tenant['latency_s']['p99'] * 1e3} ms; generate {t_t} s "
          f"against {t_d} s direct (host clock); launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 11: serving llama3.2-3b (F)
# ---------------------------------------------------------------------------
F_BATCH, F_PROMPT, F_NEW = 4, 2048, 64
# bf16 gate on max|diff| / rms(plain), besides allclose at 2e-2.  The plain
# version rounds its float32 result to bf16 once; the tensor-core kernel
# also rounds P to bf16 (8 bits of mantissa, relative 2^-9) before P v, so
# the two float32 results differ slightly, and their final roundings differ
# by one bf16 ulp where a value sits near a rounding boundary.  Measured on
# an "NVIDIA H100 80GB HBM3, 700.00 W": max|diff| 0.015625 (one ulp of the
# largest outputs, about 3) against an rms of about 0.09, reading
# 0.16969895362854004 (S 2048) and 0.1637355536222458 - 0.16715294122695923
# (window 1024, S 1971); tests/test_torch_attention.py holds a CPU
# emulation of the kernel's rounding to the same gate.  The limit is 1.8x
# the measured worst; hiding 64 keys from 64 rows (the control) reads
# 0.9333442449569702.
BF16_RMS_LIMIT = 0.3


def visible_pairs(s: int, window) -> int:
    """(query, key) pairs that causal attention over ``s`` rows visits."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def bf16_gate(torch, got, want):
    """``(allclose at 2e-2, max|diff| / rms(want), passes both)``."""
    g, w = got.float(), want.float()
    close = bool(torch.allclose(g, w, atol=2e-2, rtol=2e-2))
    ratio = float((g - w).abs().max() / w.pow(2).mean().sqrt())
    return close, ratio, close and ratio <= BF16_RMS_LIMIT


def attention_check(torch, seed):
    """B8 against its plain version on the card, at the prefill shape
    (and a ragged S), float32 and bfloat16, window None and 1024."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    b, hq, hkv, d = F_BATCH, 24, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for s in (F_PROMPT, F_PROMPT - 77):
            q, k, v = (torch.randn((b, h, s, d), generator=gen,
                                   device="cuda").to(dtype)
                       for h in (hq, hkv, hkv))
            for window in (None, 1024):
                got = fa_ops.attention(q, k, v, window=window)
                want = attention_ref(q, k, v, window=window)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                worst = max(worst, err)
                what = (f"F flash_attention vs plain: {dtype}, window "
                        f"{window}, S {s}: max_abs_err {err}")
                if dtype == torch.float32:
                    ok = bool(torch.allclose(got, want, atol=2e-5,
                                             rtol=2e-5))
                    require(ok, f"{what} (tolerance 2e-5)")
                    print(f"{what} (tolerance 2e-5)")
                    continue
                close, ratio, ok = bf16_gate(torch, got, want)
                require(ok, f"{what}: allclose 2e-2 {close}, max|diff|/rms "
                        f"{ratio} (limit {BF16_RMS_LIMIT})")
                print(f"{what}, allclose 2e-2 {close}, max|diff|/rms(plain) "
                      f"{ratio} (limit {BF16_RMS_LIMIT})")
                if s == F_PROMPT and window is None:
                    # control: the plain version with keys 0..63 hidden
                    # from the last 64 rows must fail the same gate
                    ctrl = want.clone()
                    ctrl[:, :, -64:] = attention_ref(
                        q[:, :, -64:], k[:, :, 64:], v[:, :, 64:])
                    c_close, c_ratio, c_ok = bf16_gate(torch, ctrl, want)
                    require(not c_ok, "F control: the bf16 gate accepted "
                            "attention with 64 keys hidden")
                    print(f"F control (plain, keys 0..63 hidden from the "
                          f"last 64 rows): rejected by the bf16 gate; "
                          f"allclose 2e-2 {c_close}, max|diff|/rms "
                          f"{c_ratio}")
            del q, k, v
    return worst


def time_attention(torch, seed):
    """B8 at the prefill shape beside its bound, its plain version and
    scaled_dot_product_attention (CUDA events; the bf16 kernel and SDPA
    in turns, kernel, SDPA, kernel, SDPA), with the achieved TFLOP/s and
    the bound's share of the kernel's time."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    b, hq, hkv, s, d = F_BATCH, 24, 8, F_PROMPT, 128
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for h in (hq, hkv, hkv))
    turns = time_turns(torch, {
        "kernel": lambda: fa_ops.flash_attention_cuda(q, k, v),
        "sdpa": lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)}, 20)
    out = {
        "ms": mean(turns["kernel"]),
        "library_ms": mean(turns["sdpa"]),
        "turns_ms": turns,
        "plain_ms": time_ms(torch, lambda: attention_ref(q, k, v), 3,
                            warmup=1),
    }
    q32, k32, v32 = q.float(), k.float(), v.float()
    out["float32_ms"] = time_ms(
        torch, lambda: fa_ops.flash_attention_cuda(q32, k32, v32), 5)
    sdpa = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          enable_gqa=True)
    out["sdpa_max_abs_err_vs_plain"] = float(
        (sdpa.float() - attention_ref(q, k, v).float()).abs().max())
    out["flops"] = visible_pairs(s, None) * b * hq * 4 * d
    # q, k, v read once and the output (q's shape) written once
    out["bytes"] = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    out["bound"] = bound_ms(out["bytes"], out["flops"], BF16_OPS_PER_S)
    out["tflops"] = out["flops"] / out["ms"] / 1e9
    out["sdpa_tflops"] = out["flops"] / out["library_ms"] / 1e9
    out["bound_share"] = out["bound"][0] / out["ms"]
    return out


def kernel_rows(averages):
    """``(name, device ms, launches)`` of each kernel in a profiler's
    ``key_averages()``."""
    from torch.autograd import DeviceType

    rows = []
    for e in averages:
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((e.key, t / 1e3, e.count))
    return rows


def kernel_launch_ms(torch, fn, name: str, rounds: int = 3):
    """Device milliseconds per launch of the kernels whose name contains
    ``name``, from a torch.profiler trace of ``rounds`` calls of ``fn``
    after one untraced call; None where the profiler fails or saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in kernel_rows(prof.key_averages()) if name in r[0]]
    except Exception as exc:
        print(f"torch.profiler failed: {exc!r}")
        return None
    launches = sum(r[2] for r in rows)
    return sum(r[1] for r in rows) / launches if launches else None


def profile_top(torch, fn, k: int = 5):
    """Kernel time on the device (ms), the wall time of the traced call,
    the device's idle share and the ``k`` kernels with the most time, from
    a torch.profiler trace of one call of ``fn``.  Only kernel events are
    summed (an operator's own device time repeats its kernels').  A trace
    is a reading, not a check: when the profiler itself fails this prints
    why and returns None, but an error raised by ``fn`` propagates."""
    from torch.profiler import ProfilerActivity, profile

    raised = []

    def call():
        try:
            fn()
        except BaseException as exc:
            raised.append(exc)
            raise

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        averages = prof.key_averages()
    except Exception as exc:
        if raised:
            raise
        print(f"torch.profiler failed: {exc!r}")
        return None
    rows = [(key[:60], t, count) for key, t, count in kernel_rows(averages)]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"kernel_ms": busy, "wall_ms": wall_ms,
            "idle_share": 1 - busy / wall_ms if rows else None,
            "kernels": len(rows), "top": rows[:k]}


def expected_rounds(sc, new_tokens: int):
    """Rounds, victims and final position by budget arithmetic alone."""
    pos, rounds, victims = F_PROMPT, 0, 0
    for _ in range(new_tokens - 1):
        pos += 1
        if pos > sc.eviction_budget:
            e = min(pos - sc.eviction_budget, pos - sc.eviction_window)
            if e > 0:
                rounds, victims, pos = rounds + 1, victims + e, pos - e
    return rounds, victims, pos


def serving_phase(torch, seed):
    """Phase 11: llama3.2-3b through ServeEngine with eviction."""
    import numpy as np

    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.models import lm
    from repro_torch.serve import engine as serve_engine
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.eviction import RMQEvictionManager

    cfg = get_config("llama3.2-3b")
    cache_len = F_PROMPT + F_NEW + 8
    sc = ServeConfig(seq_len=cache_len, batch=F_BATCH,
                     kv_cache_dtype="bfloat16", eviction_enabled=True,
                     eviction_budget=cache_len * 3 // 4, eviction_window=16,
                     rmq_chunk=16, rmq_threshold=4)
    torch.cuda.empty_cache()
    params, t_init = wall(torch, lambda: lm.init_params(
        cfg, seed=seed, device="cuda"))
    weights = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, list):
            stack.extend(node)
        else:
            weights += node.numel() * node.element_size()
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (F_BATCH, F_PROMPT),
                            generator=gen, device="cuda")
    engine = ServeEngine(cfg, params, sc)
    print(f"F: {cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV, head_dim "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}; bf16 weights "
          f"{weights} bytes made in {t_init:.3f} s; batch {F_BATCH}, "
          f"prompt {F_PROMPT}, {F_NEW} new tokens, cache {cache_len}, "
          f"budget {sc.eviction_budget}, protected {sc.eviction_window}, "
          f"c {sc.rmq_chunk}, t {sc.rmq_threshold}")

    # -- two runs; each eviction round timed (host clock, synchronized:
    # the engine's host round trips synchronize every round anyway).  Run
    # 1 also reads the launch counters around the prefill and around each
    # eviction round -------------------------------------------------------
    rounds, stages = [], []
    by_stage = {"prefill": {}, "eviction rounds": {}}
    orig_plan = RMQEvictionManager.plan_evictions_streaming
    orig_evict = ServeEngine._evict
    orig_prefill = serve_engine.prefill

    def counted(stage, fn, *args, **kwargs):
        if len(stages) != 1:
            return fn(*args, **kwargs)
        before = {k: c.launches for k, c in count.items()}
        out = fn(*args, **kwargs)
        acc = by_stage[stage]
        for k, c in count.items():
            acc[k] = acc.get(k, 0) + c.launches - before[k]
        return out

    def prefill(*args, **kwargs):
        return counted("prefill", orig_prefill, *args, **kwargs)

    def plan(self, index, scores, live):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index, victims = counted("eviction rounds", orig_plan, self, index,
                                 scores, live)
        torch.cuda.synchronize()
        stages[-1]["plan"].append(time.perf_counter() - t0)
        if len(stages) == 1:
            rounds.append((scores.clone(), live, victims.clone()))
        return index, victims

    def evict(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_evict(self, *args)
        torch.cuda.synchronize()
        stages[-1]["evict"].append(time.perf_counter() - t0)
        return out

    RMQEvictionManager.plan_evictions_streaming = plan
    ServeEngine._evict = evict
    serve_engine.prefill = prefill
    try:
        # run 1: counted, every round's scores and victims captured
        stages.append({"plan": [], "evict": []})
        count = zero_counts()
        out1, t_run1 = wall(torch, lambda: engine.generate(prompts, F_NEW))
        launches = read(torch, count)
        # run 2: warm, for tokens/s and memory
        stages.append({"plan": [], "evict": []})
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out2, t_run2 = wall(torch, lambda: engine.generate(prompts, F_NEW))
        peak = torch.cuda.max_memory_allocated()
    finally:
        RMQEvictionManager.plan_evictions_streaming = orig_plan
        ServeEngine._evict = orig_evict
        serve_engine.prefill = orig_prefill

    want_rounds, want_victims, want_pos = expected_rounds(sc, F_NEW)
    index_levels = engine.eviction.make_index(
        cache_len, device="cuda").plan.num_levels
    require(len(rounds) == want_rounds and out1["evicted"] == want_victims
            and out1["final_pos"] == want_pos,
            f"F generate: {len(rounds)} rounds, evicted {out1['evicted']}, "
            f"final_pos {out1['final_pos']}; budget arithmetic says "
            f"{want_rounds}, {want_victims}, {want_pos}")
    rest = {k: v - by_stage["prefill"][k] - by_stage["eviction rounds"][k]
            for k, v in launches.items()}
    expect("F prefill", by_stage["prefill"], flash_attention=cfg.num_layers)
    expect("F eviction rounds", {
        k: v for k, v in by_stage["eviction rounds"].items()
        if k not in ("rmq_short", "rmq_scan")},
        hierarchy_update=want_rounds * (index_levels - 1))
    expect("F decode and make_index", rest,
           hierarchy_build=index_levels - 1)
    require(by_stage["eviction rounds"]["rmq_short"] > 0,
            "F generate: rmq_short never ran")
    print(f"F launches by stage: {json.dumps(by_stage)}, decode and "
          f"make_index {json.dumps(rest)}")
    toks = out1["tokens"]
    require(toks.shape == (F_BATCH, F_NEW) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all()),
        f"F generate: tokens {tuple(toks.shape)} out of range")

    # -- every round's victims: the plain manager and brute force ---------
    plain = RMQEvictionManager(
        budget=sc.eviction_budget, protected_window=sc.eviction_window,
        c=sc.rmq_chunk, t=sc.rmq_threshold, backend="eager")
    pidx = plain.make_index(cache_len, device="cuda")
    same_plain = same_brute = total = 0
    for scores, live, victims in rounds:
        pidx, want = orig_plan(plain, pidx, scores, live)
        same_plain += int(torch.equal(want, victims))
        evictable, n_evict = plain._plan_round(live)
        ls, rs = plain._windows(evictable, n_evict)
        sn = scores.cpu().numpy()
        brute = np.sort([l + int(np.argmin(sn[l:r + 1]))
                         for l, r in zip(ls, rs)])
        same_brute += int(np.array_equal(victims.cpu().numpy(), brute))
        total += victims.numel()
    print(f"F eviction victims: {same_plain}/{len(rounds)} rounds equal to "
          f"the plain manager's (backend eager, same scores, on the card), "
          f"{same_brute}/{len(rounds)} equal to a brute-force leftmost "
          f"argmin per window; {total} victims")
    require(same_plain == same_brute == len(rounds),
            "F eviction: victims differ from the plain path or brute force")
    print(f"F generate: launches {launches}, eviction rounds {len(rounds)}, "
          f"evicted {out1['evicted']}, final_pos {out1['final_pos']}")

    times = {"generate_s": t_run2,
             "tokens_per_s": F_BATCH * F_NEW / t_run2,
             "generate_s_run1": t_run1}
    times["prefill_ms"] = time_ms(torch, lambda: lm.prefill(
        cfg, params, prompts, cache_len), 3, warmup=1)
    _, cache = lm.prefill(cfg, params, prompts, cache_len)
    token = toks[:, 0]
    times["decode_ms_per_token"] = time_ms(torch, lambda: lm.decode_step(
        cfg, params, token, cache, F_PROMPT, return_attn_mass=True), 8)
    for name, st in (("run1", stages[0]), ("run2", stages[1])):
        per = [1e3 * (a + b) for a, b in zip(st["plan"], st["evict"])]
        times[f"evict_ms_first_round_{name}"] = per[0]
        times[f"evict_ms_per_later_round_{name}"] = (
            sum(per[1:]) / max(len(per) - 1, 1))
        times[f"evict_plan_ms_first_round_{name}"] = 1e3 * st["plan"][0]
    print(f"F times (host clock to the end of device work; run 1 is the "
          f"first, counted run, run 2 the warm one): {json.dumps(times)}")
    print(f"F memory: weights {weights} bytes, held before run 2 {held}, "
          f"peak in run 2 {peak}; run 2 tokens equal run 1's: "
          f"{bool(torch.equal(out2['tokens'], toks))}")
    print("F prefill under torch.profiler: " + json.dumps(profile_top(
        torch, lambda: lm.prefill(cfg, params, prompts, cache_len), k=8)))
    print("F decode step under torch.profiler: " + json.dumps(profile_top(
        torch, lambda: lm.decode_step(cfg, params, token, cache, F_PROMPT,
                                      return_attn_mass=True))))
    del cache

    # -- the whole model with B8 against the same model, plain attention --
    logits_k, _ = lm.prefill(cfg, params, prompts, cache_len)
    logits_p, _ = lm.prefill(cfg, params, prompts, cache_len,
                             attn_impl="ref")
    rel = float((logits_k - logits_p).abs().max() / logits_p.abs().max())
    full_k = lm.forward(cfg, params, prompts)[0].argmax(-1)
    full_p = lm.forward(cfg, params, prompts, attn_impl="ref")[0].argmax(-1)
    agree = float((full_k == full_p).float().mean())
    require(bool(torch.isfinite(logits_k).all()), "F prefill: logits are "
            "not finite")
    print(f"F prefill last-position logits, kernel vs plain attention: "
          f"max|diff| / max|plain| = {rel}; greedy tokens that agree over "
          f"all {full_k.numel()} positions of forward: {agree}; generate's "
          f"first tokens are the kernel prefill's argmax: "
          f"{bool(torch.equal(logits_k.argmax(-1).to(toks.dtype), toks[:, 0]))}")
    require(rel < 5e-2 and agree > 0.8,
            f"F: the model with B8 strays from the plain attention "
            f"(logits {rel}, greedy agreement {agree})")
    del engine, logits_k, logits_p, full_k, full_p
    torch.cuda.empty_cache()
    # -- J6: the same eviction through the serving tier's tenant ----------
    tier_launches = tier_eviction_phase(torch, cfg, params, sc, prompts)
    del params
    torch.cuda.empty_cache()
    return launches, tier_launches


# ---------------------------------------------------------------------------
# phase 12: training mamba2-1.3b (G)
# ---------------------------------------------------------------------------
G_BATCH, G_SEQ, G_STEPS = 8, 2048, 5   # one warm-up step, then four timed
# B9 against its plain version: max|diff| / max|plain| of y and the final
# state.  Both compute the same chunk algebra at float32 accuracy (B9's
# products split 3xTF32) with sums in other orders; measured 2.6e-6 (y)
# and 1.5e-6 (state) at the training shape on an "NVIDIA H100 80GB HBM3,
# 700.00 W".  The limit is the reference's own SSD test tolerance, about
# 40x the measured value; the controls read 0.52 (the state carried into
# the middle chunk dropped) and 5.6e-4 (the plain version at one TF32
# pass per product).
SSD_REL_LIMIT = 1e-4
# The whole model with B9 against the same model with the plain scan, step
# 0: both run bf16 matmuls on the same weights and data; the scan outputs
# differ by about 1e-6 relative before they are rounded to bf16, so a bf16
# rounding flip now and then is carried through 48 layers.  Measured on an
# "NVIDIA H100 80GB HBM3, 700.00 W" (the same in every run of a kernel):
# with the CUDA-core B9 6.0e-6 (loss) and 1.6e-4 (grad norm) relative,
# with the 3xTF32 B9 2.6e-5 and 9.5e-6; the control (every layer's plain
# scan with the state carried into the middle chunk dropped) reads 2.8e-4
# and 1.8e-2, 7-12x above the limits.
G_LOSS_RTOL, G_GNORM_RTOL = 4e-5, 1.5e-3


def ssd_shape():
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-1.3b")
    return (G_BATCH, G_SEQ, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_chunk)


def ssd_inputs(torch, seed, b, l, h, p, n):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtx = torch.randn((b, l, h, p), generator=gen, device="cuda") * 0.1
    la = -torch.rand((b, l, h), generator=gen, device="cuda") * 0.2
    bm = torch.randn((b, l, n), generator=gen, device="cuda") * 0.3
    cm = torch.randn((b, l, n), generator=gen, device="cuda") * 0.3
    return dtx, la, bm, cm


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def dropped_state_scan(dtx, la, bm, cm, chunk):
    """A wrong scan for the controls: the plain chunked version with the
    state carried into the middle chunk dropped."""
    import torch

    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

    half = dtx.shape[1] // chunk // 2 * chunk
    y, _ = ssd_chunked_ref(dtx, la, bm, cm, chunk=chunk)
    cut, _ = ssd_chunked_ref(dtx[:, half:], la[:, half:], bm[:, half:],
                             cm[:, half:], chunk=chunk)
    return torch.cat([y[:, :half], cut], dim=1)


@contextlib.contextmanager
def ssm_scan(scan):
    """Every SSM block's SSD scan taken by ``scan(dtx, log_a, B, C,
    chunk)`` inside the block: the plain scan asked for, or a control."""
    from repro_torch.models import ssm

    kernel_scan = ssm.ssd
    ssm.ssd = lambda dtx, la, bm, cm, chunk, impl: scan(dtx, la, bm, cm,
                                                        chunk)
    try:
        yield
    finally:
        ssm.ssd = kernel_scan


def ssd_check(torch, seed):
    """B9 against its plain chunked version at the training shape: y and
    the final state, with and without an initial state; a control that
    must fail the limit; the gradient through SSDScan against autograd of
    the plain version."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

    b, l, h, p, n, q = ssd_shape()
    dtx, la, bm, cm = ssd_inputs(torch, seed + 30, b, l, h, p, n)
    worst = 0.0
    for init in (None, torch.randn((b, h, p, n), device="cuda") * 0.5):
        y, s = ssd_ops.ssd_scan_cuda(dtx, la, bm, cm, chunk=q,
                                     init_state=init, return_state=True)
        y_ref, s_ref = ssd_chunked_ref(dtx, la, bm, cm, chunk=q,
                                       init_state=init)
        torch.cuda.synchronize()
        ey, es = rel_err(y, y_ref), rel_err(s, s_ref)
        worst = max(worst, float((y - y_ref).abs().max()),
                    float((s - s_ref).abs().max()))
        print(f"G ssd_scan vs plain at {(b, l, h, p, n)}, chunk {q}, "
              f"init_state {init is not None}: max|diff|/max|plain| y {ey}, "
              f"final state {es} (limit {SSD_REL_LIMIT})")
        require(ey < SSD_REL_LIMIT and es < SSD_REL_LIMIT,
                "G: ssd_scan strays from its plain version")
        del y, s, y_ref, s_ref
    # control: the plain version with the state carried into the middle
    # chunk dropped must fail the same limit
    y_ref, _ = ssd_chunked_ref(dtx, la, bm, cm, chunk=q)
    c = rel_err(dropped_state_scan(dtx, la, bm, cm, q), y_ref)
    print(f"G control (plain, state into chunk {l // q // 2} dropped): "
          f"max|diff|/max|plain| {c}")
    require(c > SSD_REL_LIMIT, "G control: the ssd limit accepted a scan "
            "with its carried state dropped")
    # second control: the plain version with its products at one TF32 pass
    # (what the kernel would compute without its 3xTF32 split)
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y_tf32, s_tf32 = ssd_chunked_ref(dtx, la, bm, cm, chunk=q)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep
    _, s_ref = ssd_chunked_ref(dtx, la, bm, cm, chunk=q)
    one = max(rel_err(y_tf32, y_ref), rel_err(s_tf32, s_ref))
    print(f"G control (plain, allow_tf32 = True: one TF32 pass per product):"
          f" max|diff|/max|plain| y {rel_err(y_tf32, y_ref)}, final state "
          f"{rel_err(s_tf32, s_ref)}; allow_tf32 set back to {keep}")
    require(one > SSD_REL_LIMIT, "G control: the ssd limit accepted the "
            "plain version at one TF32 pass per product")
    del y_ref, y_tf32, s_tf32, s_ref

    # the gradient's autograd wiring: SSDScan's backward is autograd of the
    # plain version, so this reads 0 unless the wiring is wrong (the CPU
    # tests hold the gradients to jax.grad)
    wy = torch.randn((b, l, h, p), device="cuda")
    ws = torch.randn((b, h, p, n), device="cuda")
    init = torch.randn((b, h, p, n), device="cuda") * 0.5
    base = (dtx, la, bm, cm, init)

    def grads(fn):
        xs = [t.clone().requires_grad_(True) for t in base]
        y, s = fn(*xs)
        return torch.autograd.grad((y * wy).sum() + (s * ws).sum(), xs)

    got = grads(lambda *xs: ssd_ops.SSDScan.apply(*xs, q, True))
    want = grads(lambda *xs: ssd_chunked_ref(*xs[:4], chunk=q,
                                             init_state=xs[4]))
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    print(f"G ssd_scan gradient wiring (dtx, log_a, B, C, init_state) vs "
          f"autograd of the plain version: max|diff|/max|plain| {errs} "
          f"(limit {SSD_REL_LIMIT})")
    require(max(errs) < SSD_REL_LIMIT, "G: the ssd_scan gradient strays")
    return worst


def time_ssd(torch, seed, report: str):
    """B9 at the training shape beside its bound, the CUDA-core figure and
    its plain version; each CUDA kernel's share of a call from
    ``torch.profiler`` and its registers and spills from ``report``."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

    b, l, h, p, n, q = ssd_shape()
    dtx, la, bm, cm = ssd_inputs(torch, seed + 31, b, l, h, p, n)
    nc = l // q
    tri = q * (q + 1) // 2                # the causal pairs j <= i
    macs = (b * nc * tri * n              # C B^T once per (b, chunk)
            + b * nc * h * tri * p        # the causal in-chunk product
            + b * nc * h * q * n * p      # the carried-state term
            + b * nc * h * q * p * n)     # the state update
    nbytes = 4 * (2 * dtx.numel() + la.numel() + bm.numel() + cm.numel())
    out = {
        "ms": time_ms(torch, lambda: ssd_ops.ssd_scan_cuda(
            dtx, la, bm, cm, chunk=q), 10),
        "plain_ms": time_ms(torch, lambda: ssd_chunked_ref(
            dtx, la, bm, cm, chunk=q), 3, warmup=1),
        "flops": 2 * macs, "bytes": nbytes,
        # float32 accuracy on the tensor cores: three TF32 passes
        "bound": bound_ms(nbytes, 3 * 2 * macs, TF32_OPS_PER_S),
        "cuda_core_bound": bound_ms(nbytes, 2 * macs),
    }
    out["bound_share"] = out["bound"][0] / out["ms"]
    prof = profile_top(torch, lambda: [ssd_ops.ssd_scan_cuda(
        dtx, la, bm, cm, chunk=q) for _ in range(5)], k=8)
    if prof is not None:
        mine = [r for r in prof["top"] if "ssd::" in r[0]]
        busy = sum(r[1] for r in mine)
        out["kernel_shares"] = {r[0].split("(")[0].split("ssd::")[1]:
                                [r[1] / 5, r[1] / busy] for r in mine}
    out["ptxas"] = {k: ptxas_of(report, entry) for k, entry in (
        ("prep_kernel", "prep_kernel"),
        ("state_kernel<true>", "state_kernelILb1"),
        ("state_kernel<false>", "state_kernelILb0"),
        ("chunk_kernel<true>", "chunk_kernelILb1"),
        ("chunk_kernel<false>", "chunk_kernelILb0"))}
    # the backward a train step runs once per layer: the plain chunked
    # scan recomputed and differentiated
    xs = [t.requires_grad_(True) for t in (dtx, la, bm, cm)]
    y = ssd_ops.SSDScan.apply(*xs, None, q, False)
    gy = torch.randn_like(y)
    out["backward_ms"] = time_ms(torch, lambda: torch.autograd.grad(
        y, xs, gy, retain_graph=True), 3, warmup=1)
    return out


def train_args(*extra):
    from repro_torch.launch import train as train_cli

    return train_cli.parse_args(["--arch", "mamba2-1.3b", "--device",
                                 "cuda", *extra])


def restart_drill(torch):
    """launch/train.py --smoke on the card with --inject-failure-at 2 ends
    with the loss of an uninterrupted run."""
    from repro_torch.launch import train as train_cli

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        common = ["--smoke", "--steps", "4", "--seq-len", "256",
                  "--global-batch", "4", "--checkpoint-every", "1",
                  "--log-every", "1"]
        plain = train_cli.run(train_args(
            *common, "--checkpoint-dir", os.path.join(root, "plain")))
        drill = train_cli.run(train_args(
            *common, "--checkpoint-dir", os.path.join(root, "drill"),
            "--inject-failure-at", "2"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    a, b = plain["losses"][-1], drill["losses"][-1]
    print(f"G restart drill (mamba2-smoke on the card, 4 steps, failure "
          f"before step 2): restarts {drill['restarts']}, final loss "
          f"{b} against {a} uninterrupted (|diff| {abs(a - b)})")
    require(drill["restarts"] == 1 and len(drill["losses"]) == 2
            and abs(a - b) <= 1e-6 * abs(a),
            "G restart drill: the resumed run does not end as the "
            "uninterrupted one")


def training_phase(torch, seed, report: str):
    """Phase 12: mamba2-1.3b through launch/train.py on the card."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import train as train_cli
    from repro_torch.train.train_step import (
        build_train_step,
        init_train_state,
    )

    cfg = get_config("mamba2-1.3b")
    n_params = 1_344_052_224   # jax.eval_shape of the reference's init_params
    tokens = G_BATCH * G_SEQ
    # a fresh, empty checkpoint directory: restore-or-init must init
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_g_")
    args = train_args("--steps", str(G_STEPS), "--seq-len", str(G_SEQ),
                      "--global-batch", str(G_BATCH), "--remat", "full",
                      "--checkpoint-every", "0", "--log-every", "1",
                      "--seed", str(seed), "--checkpoint-dir", ckpt_dir)
    print(f"G: {cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.ssm_heads} SSD heads x {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}; "
          f"float32 masters and AdamW state, bf16 compute, bf16 gradients; "
          f"batch {G_BATCH} x seq {G_SEQ}, remat full, {G_STEPS} steps "
          f"(the first a warm-up), through launch/train.py")

    # -- the main path: the train CLI's loop, counted -----------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    count = zero_counts()
    out = train_cli.run(args)
    launches = read(torch, count)
    peak = torch.cuda.max_memory_allocated()
    per_step = 2 * cfg.num_layers
    expect("G train loop", launches, ssd_scan=per_step * G_STEPS)
    losses = out["losses"]
    require(len(losses) == G_STEPS and all(
        math.isfinite(x) for x in losses), f"G: losses {losses}")
    timed = [r["seconds"] for r in out["steps"][1:]]
    step_s = sum(timed) / len(timed)
    flops = {"6NT": 6 * n_params * tokens,
             "remat forward 2NT": 2 * n_params * tokens}
    b9 = time_ssd(torch, seed, report)
    flops["ssd_scan"] = per_step * b9["flops"]
    total = sum(flops.values())
    print(f"G train loop: launches {launches} ({per_step} ssd_scan a step: "
          f"{cfg.num_layers} in the forward, {cfg.num_layers} in the remat "
          f"recompute, none in the backward); steps "
          f"{json.dumps(out['steps'])}")
    print(f"G step time {step_s} s (mean of steps 2-{G_STEPS}), "
          f"{tokens / step_s} tokens/s; model FLOPs a step {total} "
          f"({json.dumps(flops)}), {total / step_s / BF16_OPS_PER_S} of the "
          f"989 TFLOP/s bf16 peak; peak memory {peak} bytes")

    # -- one step alone: exactly 96 launches, profiled ---------------------
    tc = TrainConfig(total_steps=G_STEPS, warmup_steps=1, seq_len=G_SEQ,
                     global_batch=G_BATCH, remat_policy="full", seed=seed)
    batch = {"tokens": torch.from_numpy(SyntheticTokenDataset(
        cfg.vocab_size, G_SEQ, G_BATCH, seed=seed).batch_at(0)["tokens"])
        .cuda()}
    state = init_train_state(cfg, tc, device="cuda")
    step = build_train_step(cfg, tc)
    count = zero_counts()
    state, m = step(state, batch)
    one = read(torch, count)
    expect("G one train step", one, ssd_scan=per_step)
    first = out["steps"][0]
    print(f"G one step from the same init and batch: loss {float(m['loss'])}"
          f", grad_norm {float(m['grad_norm'])} (the loop's step 1: "
          f"{first['loss']}, {first['grad_norm']}); launches {one}")
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], batch)

    print("G train step under torch.profiler: " + json.dumps(
        profile_top(torch, one_step, k=12)))
    del state, holder, step
    torch.cuda.empty_cache()

    # -- the whole model with B9 against the plain scan, step 0 ------------
    def step0(scan):
        fresh = init_train_state(cfg, tc, device="cuda")
        count = zero_counts()
        with ssm_scan(scan):
            _, mx = build_train_step(cfg, tc)(fresh, batch)
        expect(f"G step 0, {scan.__name__}", read(torch, count))
        del fresh
        torch.cuda.empty_cache()
        return {k: float(mx[k]) for k in ("loss", "grad_norm")}

    def plain_scan(dtx, la, bm, cm, chunk):
        return ssd_ops.ssd(dtx, la, bm, cm, chunk=chunk, impl="chunked_ref")

    mine = {k: float(m[k]) for k in ("loss", "grad_norm")}
    plain, wrong = step0(plain_scan), step0(dropped_state_scan)
    ok = {k: abs(mine[k] - plain[k]) / abs(plain[k]) for k in mine}
    ctrl = {k: abs(wrong[k] - plain[k]) / abs(plain[k]) for k in mine}
    print(f"G step 0, B9 vs the plain chunked scan: {mine} vs {plain}, rel "
          f"{ok} (limits loss {G_LOSS_RTOL}, grad_norm {G_GNORM_RTOL}); "
          f"control (the plain scan with the state carried into the middle "
          f"chunk dropped): {wrong}, rel {ctrl}")
    require(ok["loss"] <= G_LOSS_RTOL and ok["grad_norm"] <= G_GNORM_RTOL,
            "G: the model with B9 strays from the plain scan")
    require(ctrl["loss"] > G_LOSS_RTOL and ctrl["grad_norm"] > G_GNORM_RTOL,
            "G control: the step-0 limits accepted a model whose scan drops "
            "its carried state")

    # -- the CLI's own defaults at full width (remat minimal, 8 x 128) -----
    count = zero_counts()
    short = train_cli.run(train_args("--steps", "2", "--checkpoint-every",
                                     "0", "--log-every", "1",
                                     "--checkpoint-dir", ckpt_dir))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    got = read(torch, count)
    expect("G CLI defaults", got, ssd_scan=2 * per_step)
    require(all(math.isfinite(x) for x in short["losses"]),
            f"G CLI defaults: losses {short['losses']}")
    print(f"G CLI defaults (remat minimal, batch 8 x seq 128, 2 steps): "
          f"launches {got}, steps {json.dumps(short['steps'])}")
    restart_drill(torch)
    return launches, b9


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
    reports = build_kernels()

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
    print(f"A value-only builds (ms): fused "
          f"{detail['build value-only fused']}, per-level "
          f"{detail['build value-only per-level']}; their yardstick "
          f"torch.amin(x.view(-1, c), dim=1) {lib_amin} (timed only)")
    build_ptxas = {
        **ptxas_all(reports.get("hierarchy_build", ""), "build_level_runs"),
        **ptxas_all(reports.get("hierarchy_fused", ""), "fused_runs_kernel")}
    print(f"A builds (build_hopper.cuh run instances) ptxas: "
          f"{json.dumps(build_ptxas)}")
    walk_ptxas = {
        f"{src} {plane}": ptxas_of(reports.get(src, ""), f"{entry}Lb{track}"
                                   "ELi4ELb1E")
        for src, entry in (("rmq_fused", "rmq_fused_kernelIf"),
                           ("rmq_scan", "rmq_scan_kernelIf"))
        for plane, track in (("value", 0), ("index", 1))}
    l1 = plan.level_lens[1]
    print(f"A rmq_fused / rmq_scan (rmq_walk_hopper.cuh, float32, c = 128) "
          f"ptxas: {json.dumps(walk_ptxas)}; level-1 planes: values "
          f"{l1 * item} bytes, positions {l1 * 4} bytes (L2 50 MB)")
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
          "per level as listed; ms is the event span of the one host call "
          "(three launches) in turns with the yardstick, span_flushed_ms "
          "the same with the L2 flushed before each call, "
          "kernel_ms_per_level each launch's device time (torch.profiler, "
          "L2 flushed); call_ms is the whole RMQ.update, copy_ms the "
          "successor's three clones alone")
    print(f"A hierarchy_update ptxas: " + json.dumps({
        **ptxas_all(reports.get("hierarchy_update", ""),
                    "update_runs_kernel"),
        **ptxas_all(reports.get("hierarchy_update", ""),
                    "update_parts_kernel")}))
    print(f"A rmq_short (ms; ms, bound and plain_ms per launch of a "
          f"{t_short['bucket']}-span bucket, call_ms for all "
          f"{t_short['queries']} short spans in one call; value + index): "
          f"{json.dumps(t_short)}")
    print(f"A rmq_bulk (ms; ms, bound and plain_ms per launch of a 2^20 "
          f"bucket, pass_ms for the 2^24 sorted spans in "
          f"{t_bulk['launches']} launches, fused_ms for rmq_fused on the "
          f"same sorted spans in one; value + index; distinct level-0 "
          f"chunks {t_bulk['chunks']}): {json.dumps(t_bulk)}; rmq_fused on "
          f"the unsorted batch {ms['rmq_fused']}")
    zs, zb, zh = zero_phase(torch, "A", x, plan, ls, rs, seed)
    for key, e in (("rmq_short", zs), ("rmq_bulk", zb),
                   ("hierarchy_fused", zh), ("hierarchy_build", zh)):
        errors[key] = max(errors[key], e)
    nan_phase(torch, "A", x, plan, ls, rs, seed)
    a_answers = (wv, wp)   # phase 14 holds c="auto" at A to them
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
            pair = sorted_pair(torch, plan_g, hb, ls, rs)
            print(f"B bulk vs fused on the same sorted batch (ms, value + "
                  f"index, {data['m'] * plan_g.c / plan_g.capacity} spans "
                  f"per level-0 chunk): {json.dumps(pair)}")
            del hb
        del r
        if name == "D":
            zs, zb, zh = zero_phase(torch, name, x, plan_g, ls, rs, seed,
                                    value_only=True)
            for key, e in (("rmq_short", zs), ("rmq_bulk", zb),
                           ("hierarchy_fused", zh), ("hierarchy_build", zh)):
                errors[key] = max(errors[key], e)
            nan_phase(torch, name, x, plan_g, ls, rs, seed,
                      value_only=True)
        if name in ("B", "D"):
            st = stream_phase(torch, name, x, plan_g, seed)
            for key, e in st["err"].items():
                errors[key] = max(errors[key], e)
        del x, ls, rs
        torch.cuda.empty_cache()

    # -- phase 13: the compact planes ---------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    compact = compact_phase(torch, seed)
    print(f"H summary: {json.dumps(compact)}")
    gc.collect()
    torch.cuda.empty_cache()

    # -- phases 14 and 15 at geometry A's data, made again once --------------
    xa, lsa, rsa, setup = geometry(torch, 1 << 30, 1 << 24, seed)
    tuned = autotune_phase(torch, seed, xa, lsa, rsa, setup, *a_answers)
    print(f"I summary: {json.dumps(tuned)}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tier_summary, tier_launches = tier_phase(torch, seed, xa, lsa, rsa,
                                             *a_answers)
    print(f"J summary ({time.perf_counter() - t0} s; {card_line()}): "
          f"{json.dumps(tier_summary)}")
    for key, v in tier_launches.items():
        main_launches[key] = main_launches.get(key, 0) + v
    del xa, lsa, rsa, a_answers
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 11: serving llama3.2-3b -------------------------------------
    gc.collect()  # the earlier phases' engines hold their indexes in cycles
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("F: torch.backends.cuda.matmul.allow_tf32 = False and "
          "torch.backends.cudnn.allow_tf32 = False (plain versions in full "
          "float32)")
    errors["flash_attention"] = attention_check(torch, seed)
    t_fa = time_attention(torch, seed)
    print(f"F flash_attention at ({F_BATCH}, 24, {F_PROMPT}, 128) / "
          f"({F_BATCH}, 8, {F_PROMPT}, 128) bfloat16 (ms, CUDA events): "
          f"{json.dumps(t_fa)}")
    print(f"F flash_attention bf16: {t_fa['ms']} ms, {t_fa['tflops']} "
          f"TFLOP/s, bound {t_fa['bound'][0]} ms = {t_fa['bound_share']} "
          f"of its time; SDPA {t_fa['library_ms']} ms; ptxas at D 128: "
          + ptxas_of(reports.get("flash_attention", ""),
                     "flash_bf16_kernelILi128E"))
    ms["flash_attention"] = t_fa["ms"]
    plain["flash_attention"] = t_fa["plain_ms"]
    bounds["flash_attention"] = t_fa["bound"]
    library["flash_attention"] = t_fa["library_ms"]
    served, tier_evict = serving_phase(torch, seed)
    main_launches["flash_attention"] = served["flash_attention"]
    for key, v in tier_evict.items():
        main_launches[key] = main_launches.get(key, 0) + v

    # -- phase 12: training mamba2-1.3b ------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    errors["ssd_scan"] = ssd_check(torch, seed)
    trained, t_ssd = training_phase(torch, seed,
                                    reports.get("ssd_scan", ""))
    main_launches["ssd_scan"] = trained["ssd_scan"]
    print(f"G ssd_scan at {ssd_shape()[:5]}, chunk {ssd_shape()[5]} (ms, "
          f"CUDA events): {json.dumps(t_ssd)}")
    print(f"G ssd_scan: {t_ssd['ms']} ms, bound {t_ssd['bound'][0]} ms "
          f"({t_ssd['bound'][1]}; 3 x {t_ssd['flops']} flop at 495 TFLOP/s "
          f"TF32) = {t_ssd['bound_share']} of its time; CUDA-core figure "
          f"{t_ssd['cuda_core_bound'][0]} ms; per kernel [ms a call, share "
          f"of the kernels' time]: {json.dumps(t_ssd.get('kernel_shares'))}"
          f"; ptxas: {json.dumps(t_ssd['ptxas'])}")
    ms["ssd_scan"] = t_ssd["ms"]
    plain["ssd_scan"] = t_ssd["plain_ms"]
    bounds["ssd_scan"] = t_ssd["bound"]
    library["ssd_scan"] = None

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
    # again here: the first lines of a long log get cut
    print(f"device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(card_line())
    return out


if __name__ == "__main__":
    sys.exit(main())
