"""``QueryEngine``: span-routed, deduped, cached batched RMQ execution.

The port of ``repro.qe.engine``.  One engine serves one index (``RMQ``,
``StreamingRMQ``, ``HybridRMQ`` or the segment-sharded
``DistributedRMQ``).  The engine is host-side
orchestration: dedup, cache bookkeeping and planning run in numpy, as in
the reference; only the packed buckets go to the device, through the
executors (:mod:`repro_torch.qe.executors`).  Per batch::

    validate -> dedup (np.unique) -> LRU lookup -> planner buckets
             -> per-class executors -> scatter-back -> LRU insert

With the ``fused`` backend the planner degrades to one ``FUSED`` class,
each bucket is one ``rmq_fused`` launch, and :meth:`QueryEngine.query_mixed`
serves a batch that mixes value and index ops from that same launch.
:meth:`QueryEngine.query_bulk` is the offline path (``rmq_bulk``, one
launch per bucket of the endpoint-sorted batch) from ``bulk_crossover``
queries up.

Answers are bit-identical to the index's own ``query`` /
``query_index`` (values and leftmost positions) and come back as
tensors on the index's device.

Mutation protocol: ``update`` / ``append`` return a successor with
``generation + 1``; :meth:`QueryEngine.attach` binds it, and cached
results of older generations can never be served.  Attaching an index
that is not a successor (same plan, strictly larger generation) clears
the cache.

Compact planes, as in the reference: a packed index routes as a classic
one (each kernel unpacks the positions it reads); an index with bf16
summaries has no long class (the hybrid's table would compare quantized
values, so long spans take the exact mid walk) and :meth:`query_bulk`
bypasses B7 for the routed path.

Config precedence, resolved at every attach: explicit constructor
kwargs > the ``tuning`` cache (a :class:`repro_torch.tune.TuningCache`,
looked up by the index's device, live length and ``span_mix``) >
``plan.level_split`` (baked in by a tuned build) > analytic defaults;
``engine.tuned["source"]`` says which (``"cache"``, ``"plan"``,
``"default"``, with ``"+override"`` where an explicit ``long_cutoff``
won).

A distributed index has no planner: :attr:`QueryEngine.distributed`, a
:class:`repro_torch.qe.DistributedExecutor`, routes each miss batch by
segment containment (spans inside one segment answered segment-locally,
with no combine; crossing spans through the index's combine), takes no
tuning lookup, serves no mixed batch as one launch, and ``query_bulk``
goes through its ``run_bulk``.  Its global capacity must stay below
2^31, as every engine's must.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.protocol import (
    check_capacity_limit,
    is_distributed,
    live_length,
    runtime_backend,
)
from repro_torch.core.query import check_query_args
from repro_torch.kernels.profiling import record_config
from repro_torch.obs import trace
from repro_torch.obs.metrics import SIZE_BUCKETS, Metrics
from repro_torch.qe.cache import ResultCache
from repro_torch.qe.distributed import DistributedExecutor
from repro_torch.qe.executors import (
    INDEX,
    VALUE,
    BulkExecutor,
    FusedExecutor,
    LongSpanExecutor,
    MidSpanExecutor,
    ShortSpanExecutor,
)
from repro_torch.qe.executors import host_dtype as _np_dtype
from repro_torch.qe.executors import to_host as _to_host
from repro_torch.qe.planner import FUSED, LONG, MID, SHORT, QueryPlanner

__all__ = ["QueryEngine"]

_NO_POSITIONS = (
    "index was built without positions; rebuild it with "
    "with_positions=True to serve RMQ_index queries")


def _host_bounds(ls, rs, n: int):
    """Validated bounds as flat int32 numpy arrays."""
    ls, rs = check_query_args(ls, rs, n)
    return (ls.cpu().numpy().astype(np.int32, copy=False).ravel(),
            rs.cpu().numpy().astype(np.int32, copy=False).ravel())


def _to_device(a: np.ndarray, dtype: torch.dtype, dev) -> torch.Tensor:
    """A host plane (:func:`_np_dtype`) back on ``dev`` as ``dtype``."""
    return torch.from_numpy(a).to(dev).view(dtype)


class QueryEngine:
    """Adaptive batched execution over one RMQ index."""

    def __init__(
        self,
        index,
        cache_size: int = 8192,
        long_enabled: bool = True,
        long_cutoff: Optional[int] = None,
        min_bucket: int = 16,
        max_bucket: int = 4096,
        backend: Optional[str] = None,
        metrics: Optional[Metrics] = None,
        tuning=None,
        span_mix: str = "mixed",
        bulk_crossover: Optional[int] = None,
    ):
        # Config precedence, resolved per attach: explicit ctor kwargs >
        # ``tuning`` cache > plan.level_split (baked at build) > analytic
        # defaults.
        self._tuning = tuning
        self._span_mix = span_mix
        self._explicit_backend = backend
        self._long_enabled = long_enabled
        self._long_cutoff = long_cutoff
        self._min_bucket = min_bucket
        self._max_bucket = max_bucket
        self._bulk_crossover = bulk_crossover
        if bulk_crossover is not None and bulk_crossover < 1:
            raise ValueError(
                f"bulk_crossover must be >= 1, got {bulk_crossover}")
        self.bulk_crossover: int = 1  # resolved per attach
        self._bulk = BulkExecutor()
        self.cache = ResultCache(cache_size)
        self.tuned: Optional[dict] = None  # resolved config provenance
        self.backend = self._resolve_backend(index)
        self._configure_executors(self.backend)
        self.batches = 0
        self.queries_in = 0
        self.dedup_saved = 0
        self.class_counts = {SHORT: 0, MID: 0, LONG: 0, FUSED: 0}
        self._index = None
        self.planner: Optional[QueryPlanner] = None
        self.distributed: Optional[DistributedExecutor] = None
        self.metrics: Optional[Metrics] = None
        self._m_padding = None
        self._m_padded_lanes = None
        self._m_live_lanes = None
        self._m_tuned = None
        if metrics is not None:
            self._register_metrics(metrics)
        self.attach(index)

    # -- config resolution ------------------------------------------------
    def _tuned_lookup(self, index):
        """The tuning-cache entry for this index, or ``None``."""
        if self._tuning is None or is_distributed(index):
            return None
        from repro_torch.tune.cache import current_platform

        return self._tuning.lookup(current_platform(index.device),
                                   live_length(index), self._span_mix)

    def _resolve_backend(self, index) -> str:
        """Query lowering by the precedence ladder (hierarchies are
        bit-identical across backends, so a tuned backend may answer
        over any build)."""
        if self._explicit_backend is not None:
            return runtime_backend(self._explicit_backend)
        cfg = self._tuned_lookup(index)
        if cfg is not None:
            return runtime_backend(cfg.backend)
        split = getattr(index.plan, "level_split", None)
        if split is not None and split.fused:
            return "fused"
        return runtime_backend(index.backend)

    def _resolve_config(self, index) -> dict:
        """Planner knobs and their provenance."""
        cfg = self._tuned_lookup(index)
        split = getattr(index.plan, "level_split", None)
        source = "default"
        long_cutoff = self._long_cutoff
        scan_chunks = 2
        sparse_top = True
        if split is not None:
            source = "plan"
            scan_chunks = split.scan_chunks
            sparse_top = split.sparse_top
            if long_cutoff is None:
                long_cutoff = split.long_cutoff
        if cfg is not None:
            source = "cache"
            scan_chunks = cfg.scan_chunks
            sparse_top = cfg.sparse_top
            if self._long_cutoff is None:
                long_cutoff = cfg.long_cutoff
        if self._long_cutoff is not None and source != "default":
            source += "+override"
        # bf16 summaries: the hybrid's sparse-table top would compare
        # quantized values (HybridRMQ refuses one), so long spans take
        # the exact mid walk
        long_ok = not index.hierarchy.quantized
        return {
            "backend": self.backend,
            "planner": "fused" if self.backend == "fused" else "routed",
            "long_cutoff": long_cutoff,
            "scan_chunks": scan_chunks,
            "long_enabled": self._long_enabled and sparse_top and long_ok,
            "source": source,
        }

    def _resolve_bulk_crossover(self, index) -> int:
        """Batch size from which :meth:`query_bulk` leaves the fused path:
        the explicit kwarg, else the tuned cache's measured crossover,
        else the reference's analytic model (about log2(c) passes over
        the ``capacity / c`` chunk grid, at least 1024)."""
        if self._bulk_crossover is not None:
            return self._bulk_crossover
        cfg = self._tuned_lookup(index)
        if cfg is not None and cfg.bulk_crossover:
            return int(cfg.bulk_crossover)
        plan = index.plan
        rows = max(index.capacity // plan.c, 1)
        return max(1024, rows * max(plan.c.bit_length() - 1, 1))

    def _configure_executors(self, backend: str) -> None:
        """(Re)build the executor table for ``backend``: at construction
        and when an attach adopts another tuned backend."""
        self.executors = {
            SHORT: ShortSpanExecutor(backend),
            MID: MidSpanExecutor(backend),
            LONG: LongSpanExecutor(),
        }
        if backend == "fused":
            # the whole span mix in one launch per bucket
            self.executors[FUSED] = FusedExecutor()

    def _register_metrics(self, metrics: Metrics) -> None:
        """Export engine state into ``metrics``; gauges read the plain
        counters at export time, so the hot path takes no lock."""
        self.metrics = metrics
        cache = self.cache
        metrics.gauge("cache_hits", fn=lambda: cache.hits)
        metrics.gauge("cache_misses", fn=lambda: cache.misses)
        metrics.gauge("cache_hit_rate", fn=cache.hit_rate)
        metrics.gauge("cache_entries", fn=cache.__len__)
        metrics.gauge("cache_evictions", fn=lambda: cache.evictions)
        metrics.gauge("batches", fn=lambda: self.batches)
        metrics.gauge("queries", fn=lambda: self.queries_in)
        metrics.gauge("dedup_saved", fn=lambda: self.dedup_saved)
        for cls in (SHORT, MID, LONG, FUSED):
            metrics.gauge(f"span_class_{cls}",
                          fn=lambda c=cls: self.class_counts[c])
        self._m_padding = metrics.histogram(
            "bucket_padding_waste", SIZE_BUCKETS)
        self._m_padded_lanes = metrics.counter("padded_lanes")
        self._m_live_lanes = metrics.counter("live_lanes")
        self._m_tuned = metrics.info("tuned_config")
        if self.tuned is not None:
            self._m_tuned.set({k: str(v) for k, v in self.tuned.items()})

    def _note_bucket(self, bucket) -> None:
        self.class_counts[bucket.cls] += bucket.count
        if self._m_padding is not None:
            self._m_padding.record(bucket.padding)
            self._m_padded_lanes.inc(bucket.padding)
            self._m_live_lanes.inc(bucket.count)

    @classmethod
    def for_index(cls, index, **kwargs) -> "QueryEngine":
        return cls(index, **kwargs)

    # -- index binding ----------------------------------------------------
    @property
    def index(self):
        return self._index

    @property
    def generation(self) -> int:
        return getattr(self._index, "generation", 0)

    def attach(self, index, reset_cache: Optional[bool] = None) -> None:
        """Bind a (successor) index.

        ``reset_cache=None`` keeps cached results only when ``index``
        looks like a successor of the current binding: same plan and a
        strictly larger generation.  Pass ``True`` / ``False`` to
        override.
        """
        prev = self._index
        if reset_cache is None:
            reset_cache = not (
                prev is not None
                and index.plan == prev.plan
                and getattr(index, "generation", 0)
                > getattr(prev, "generation", 0))
        if reset_cache:
            self.cache.clear()
        plan = index.plan
        # Bounds and positions flow through int32 (planner packing, the
        # kernels, the numpy bucket arithmetic): refuse rather than wrap.
        # A distributed index's capacity is its global index space.
        check_capacity_limit(index.capacity)
        if is_distributed(index):
            # routed by segment containment: no planner, no span executor
            self.planner = None
            self.tuned = None
            self.bulk_crossover = self._resolve_bulk_crossover(index)
            if self.distributed is None:
                self.distributed = DistributedExecutor(
                    min_bucket=self._min_bucket,
                    max_bucket=self._max_bucket)
        else:
            self.distributed = None
            backend = self._resolve_backend(index)
            if backend != self.backend:
                self.backend = backend
                self._configure_executors(backend)
            resolved = self._resolve_config(index)
            self.bulk_crossover = self._resolve_bulk_crossover(index)
            resolved["bulk_crossover"] = self.bulk_crossover
            planner = QueryPlanner(
                c=plan.c,
                num_levels=plan.num_levels,
                long_cutoff=resolved["long_cutoff"],
                long_enabled=resolved["long_enabled"],
                min_bucket=self._min_bucket,
                max_bucket=self._max_bucket,
                fused=self.backend == "fused",
                scan_chunks=resolved["scan_chunks"],
            )
            if planner != self.planner:
                self.planner = planner
            self._record_tuned(index, resolved)
        self._index = index
        self.executors[LONG].invalidate()

    def _record_tuned(self, index, resolved: dict) -> None:
        """Expose the chosen config: ``stats()["tuned"]``, the launch
        registry (``engine_tuned_config``) and the metrics tree."""
        plan = index.plan
        tuned = {
            "c": plan.c,
            "t": plan.t,
            "n": live_length(index),
            **{k: resolved[k] for k in
               ("backend", "planner", "long_cutoff", "scan_chunks",
                "long_enabled", "bulk_crossover", "source")},
        }
        if tuned == self.tuned:
            return
        self.tuned = tuned
        record_config("engine_tuned_config", **tuned)
        if self._m_tuned is not None:
            self._m_tuned.set({k: str(v) for k, v in tuned.items()})

    # -- public query surface ---------------------------------------------
    def query(self, ls, rs) -> torch.Tensor:
        """Batched ``RMQ_value``; bit-identical to the index's own."""
        return self._execute(ls, rs, VALUE)

    def query_index(self, ls, rs) -> torch.Tensor:
        """Batched ``RMQ_index``; bit-identical to the index's own."""
        if not self._index.with_positions:
            raise ValueError(_NO_POSITIONS)
        return self._execute(ls, rs, INDEX)

    def query_bulk(self, ls, rs, op: str = VALUE) -> torch.Tensor:
        """Offline bulk batch (``op`` = ``"value"`` / ``"index"``).

        From :attr:`bulk_crossover` queries up the batch is sorted by
        ``(chunk(l), chunk(r))`` and answered one ``rmq_bulk`` launch per
        bucket (:class:`BulkExecutor`), without dedup or the LRU; smaller
        batches take :meth:`query` / :meth:`query_index`.  Bit-identical
        to them at any size.  On a distributed index the sort also groups
        the spans by owning segment
        (:meth:`~repro_torch.qe.DistributedExecutor.run_bulk`).
        """
        if op not in (VALUE, INDEX):
            raise ValueError(
                f"op must be {VALUE!r} or {INDEX!r}, got {op!r}")
        index = self._index
        if op == INDEX and not index.with_positions:
            raise ValueError(_NO_POSITIONS)
        n = live_length(index)
        ls, rs = check_query_args(ls, rs, n)
        if ls.numel() < self.bulk_crossover or (
                self.distributed is None and index.hierarchy.quantized):
            # bf16 summaries: the bulk sweep compares quantized values,
            # so they take the routed path, whose walks re-read level 0
            return self._execute(ls, rs, op)
        self.batches += 1
        self.queries_in += int(ls.numel())
        if self.distributed is not None:
            hl, hr = _host_bounds(ls, rs, n)
            dtype = torch.int32 if op == INDEX else index.value_dtype
            return _to_device(self.distributed.run_bulk(index, hl, hr, op),
                              dtype, index.device)
        return self._bulk.run(index.hierarchy, ls, rs, op)

    @property
    def supports_mixed(self) -> bool:
        """Can a value+index mix run as ONE launch per bucket?  (Never
        over a distributed index.)"""
        return FUSED in self.executors and self.distributed is None

    def query_mixed(self, ls, rs, is_index) -> tuple:
        """Answer a batch mixing ``RMQ_value`` and ``RMQ_index`` ops.

        ``is_index[i]`` selects row ``i``'s op.  Returns ``(values,
        positions)`` of the batch length (tensors on the index's device);
        only the plane that ``is_index`` selects is meaningful per row.
        On a fused engine the deduped misses run through
        :class:`FusedExecutor`, both planes from one launch per bucket;
        elsewhere one standard execution per op.
        """
        index = self._index
        dev = index.device
        is_index = np.asarray(
            torch.as_tensor(is_index).cpu(), bool).ravel()
        if is_index.any() and not index.with_positions:
            raise ValueError(_NO_POSITIONS)
        ls, rs = _host_bounds(ls, rs, live_length(index))
        if ls.shape != is_index.shape:
            raise ValueError(
                f"is_index must match the batch, got {is_index.shape} "
                f"vs {ls.shape}")
        m = ls.shape[0]
        val_dtype = _np_dtype(index.value_dtype)
        vals_out = np.zeros((m,), val_dtype)
        pos_out = np.zeros((m,), np.int32)

        def done(v, p):
            return (_to_device(v, index.value_dtype, dev),
                    torch.from_numpy(p).to(dev))

        if m == 0:
            return done(vals_out, pos_out)

        single_op = is_index.all() or not is_index.any()
        if not self.supports_mixed or single_op:
            vi = np.nonzero(~is_index)[0]
            ii = np.nonzero(is_index)[0]
            if vi.shape[0]:
                vals_out[vi] = _to_host(self._execute(ls[vi], rs[vi], VALUE))
            if ii.shape[0]:
                pos_out[ii] = _to_host(self._execute(ls[ii], rs[ii], INDEX))
            return done(vals_out, pos_out)

        self.batches += 1
        self.queries_in += m

        # dedup on (l, r): the fused launch computes both planes anyway
        uniq, inverse = np.unique(
            np.stack([ls, rs]), axis=1, return_inverse=True)
        uls, urs = uniq[0], uniq[1]
        k = uls.shape[0]
        self.dedup_saved += m - k
        inverse = inverse.ravel()
        uv = np.zeros((k,), val_dtype)
        up = np.zeros((k,), np.int32)
        need_val = np.zeros((k,), bool)
        need_pos = np.zeros((k,), bool)
        need_val[inverse[~is_index]] = True
        need_pos[inverse[is_index]] = True

        gen = self.generation
        if self.cache.capacity > 0:
            missing = np.zeros((k,), bool)
            for i in range(k):
                l, r = int(uls[i]), int(urs[i])
                if need_val[i]:
                    hit = self.cache.get(VALUE, gen, l, r)
                    if hit is None:
                        missing[i] = True
                    else:
                        uv[i] = hit
                if need_pos[i]:
                    hit = self.cache.get(INDEX, gen, l, r)
                    if hit is None:
                        missing[i] = True
                    else:
                        up[i] = hit
            miss_idx = np.nonzero(missing)[0]
        else:
            miss_idx = np.arange(k)

        tr = trace.current()
        if miss_idx.shape[0]:
            h = index.hierarchy
            fused = self.executors[FUSED]
            mls, mrs = uls[miss_idx], urs[miss_idx]
            sp = tr.begin("plan") if tr is not None else None
            buckets = self.planner.plan(mls, mrs)
            if tr is not None:
                tr.end(sp, misses=int(miss_idx.shape[0]),
                       buckets=len(buckets), op="mixed")
            for bucket in buckets:
                if bucket.count == 0:
                    continue
                self._note_bucket(bucket)
                sp = tr.begin("execute") if tr is not None else None
                bv, bp = fused.run_mixed(
                    h, torch.from_numpy(bucket.ls).to(dev),
                    torch.from_numpy(bucket.rs).to(dev))
                rows = miss_idx[bucket.idxs]
                uv[rows] = _to_host(bv[:bucket.count])
                up[rows] = _to_host(bp[:bucket.count])
                if tr is not None:
                    tr.end(sp, cls=bucket.cls, count=bucket.count,
                           shape=bucket.shape, op="mixed")
            if self.cache.capacity > 0:
                for i in miss_idx:
                    l, r = int(uls[i]), int(urs[i])
                    if need_val[i]:
                        self.cache.put(VALUE, gen, l, r, uv[i].item())
                    if need_pos[i]:
                        self.cache.put(INDEX, gen, l, r, int(up[i]))

        sp = tr.begin("scatter") if tr is not None else None
        out = done(uv[inverse], up[inverse])
        if tr is not None:
            tr.end(sp, queries=m, unique=k, op="mixed")
        return out

    # -- execution --------------------------------------------------------
    # query_mixed above carries a dual-plane variant of this pipeline;
    # cache or dedup semantics changed here must change there too.
    def _execute(self, ls, rs, op: str) -> torch.Tensor:
        index = self._index
        dev = index.device
        ls, rs = _host_bounds(ls, rs, live_length(index))
        m = ls.shape[0]
        dtype = torch.int32 if op == INDEX else index.value_dtype
        out_dtype = _np_dtype(dtype)
        if m == 0:
            return _to_device(np.zeros((0,), out_dtype), dtype, dev)

        self.batches += 1
        self.queries_in += m

        # -- within-batch dedup -------------------------------------------
        uniq, inverse = np.unique(
            np.stack([ls, rs]), axis=1, return_inverse=True)
        uls, urs = uniq[0], uniq[1]
        k = uls.shape[0]
        self.dedup_saved += m - k
        uniq_res = np.empty((k,), out_dtype)

        # -- LRU lookup ---------------------------------------------------
        gen = self.generation
        if self.cache.capacity > 0:
            missing = np.ones((k,), bool)
            for i in range(k):
                hit = self.cache.get(op, gen, int(uls[i]), int(urs[i]))
                if hit is not None:
                    uniq_res[i] = hit
                    missing[i] = False
            miss_idx = np.nonzero(missing)[0]
        else:
            miss_idx = np.arange(k)

        # -- plan + execute the misses ------------------------------------
        tr = trace.current()
        if miss_idx.shape[0]:
            mls, mrs = uls[miss_idx], urs[miss_idx]
            if self.distributed is not None:
                uniq_res[miss_idx] = self.distributed.run(
                    index, mls, mrs, op).astype(out_dtype, copy=False)
            else:
                self._execute_buckets(index.hierarchy, mls, mrs, op,
                                      out_dtype, uniq_res, miss_idx)
            if self.cache.capacity > 0:
                for i in miss_idx:
                    self.cache.put(op, gen, int(uls[i]), int(urs[i]),
                                   uniq_res[i].item())

        sp = tr.begin("scatter") if tr is not None else None
        out = _to_device(uniq_res[inverse.ravel()], dtype, dev)
        if tr is not None:
            tr.end(sp, queries=m, unique=k, op=op)
        return out

    def _execute_buckets(self, h, mls, mrs, op: str, out_dtype, uniq_res,
                         miss_idx) -> None:
        """The misses through the planner's buckets and the span
        executors, answers written into ``uniq_res[miss_idx]``."""
        dev = h.device
        tr = trace.current()
        sp = tr.begin("plan") if tr is not None else None
        buckets = self.planner.plan(mls, mrs)
        if tr is not None:
            tr.end(sp, misses=int(mls.shape[0]), buckets=len(buckets), op=op)
        for bucket in buckets:
            if bucket.count == 0:
                continue
            self._note_bucket(bucket)
            sp = tr.begin("execute") if tr is not None else None
            res = self.executors[bucket.cls].run(
                h, torch.from_numpy(bucket.ls).to(dev),
                torch.from_numpy(bucket.rs).to(dev), op)
            res = _to_host(res[:bucket.count]).astype(out_dtype, copy=False)
            if tr is not None:
                tr.end(sp, cls=bucket.cls, count=bucket.count,
                       shape=bucket.shape, op=op)
            uniq_res[miss_idx[bucket.idxs]] = res

    # -- introspection ----------------------------------------------------
    def stats(self) -> dict:
        counts = dict(self.class_counts)
        executors = {cls: ex.stats() for cls, ex in self.executors.items()}
        if self.distributed is not None:
            counts = dict(self.distributed.class_counts)
            executors = {"distributed": self.distributed.stats()}
        if self._bulk.calls:
            executors["bulk"] = self._bulk.stats()
        return {
            "backend": self.backend,
            "generation": self.generation,
            "batches": self.batches,
            "queries": self.queries_in,
            "dedup_saved": self.dedup_saved,
            "class_counts": counts,
            "cache": self.cache.stats(),
            "executors": executors,
            "tuned": dict(self.tuned) if self.tuned else None,
        }
