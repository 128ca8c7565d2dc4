"""Distributed executor: segment-aware routing for a sharded index.

The port of ``repro.qe.distributed``.  A
:class:`repro_torch.core.distributed.DistributedRMQ` has no single
hierarchy, so the span executors (short / mid / long) do not apply; the
engine routes its batches by whether a span stays inside one segment:

* ``SEG_LOCAL``: ``l // segment_capacity == r // segment_capacity``.
  The batch is grouped by owning segment on the host, localized, packed
  into one ``(S, k)`` array, and each segment answers its own row
  (:meth:`DistributedRMQ._query_grouped`): no combine at all.
* ``CROSSING``: the span straddles a segment boundary and takes the
  monolithic path (``DistributedRMQ.query`` / ``query_index``, one
  combine a batch), the engine's oracle.

Both give values and leftmost positions bit-identical to the monolithic
path.  Rows are padded to power-of-two widths (``(0, 0)`` spans, dropped
at scatter-back) bounded by ``max_bucket``, as the planner's buckets are,
so a skewed batch runs in several rounds of the same shapes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.obs import trace
from repro_torch.qe.executors import INDEX, host_dtype, to_host
from repro_torch.qe.planner import _next_pow2

__all__ = ["SEG_LOCAL", "CROSSING", "DistributedExecutor"]

SEG_LOCAL = "seg_local"
CROSSING = "crossing"


def _out_dtype(index, op: str) -> np.dtype:
    return np.dtype(np.int32) if op == INDEX else host_dtype(
        index.value_dtype)


class DistributedExecutor:
    """Routes one deduped miss batch over a segment-sharded index."""

    def __init__(self, min_bucket: int = 16, max_bucket: int = 4096):
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.calls = 0
        self.queries = 0
        self.class_counts: Dict[str, int] = {SEG_LOCAL: 0, CROSSING: 0}

    def run(self, index, ls: np.ndarray, rs: np.ndarray,
            op: str) -> np.ndarray:
        """Answer ``(ls, rs)`` (np.int32, deduped) against ``index``; the
        answers on the host (bf16 values as their int16 bits)."""
        self.calls += 1
        m = ls.shape[0]
        self.queries += m
        cap = index.segment_capacity
        out_dtype = _out_dtype(index, op)
        out = np.empty((m,), out_dtype)
        owner = ls // cap
        local = owner == (rs // cap)
        self.class_counts[SEG_LOCAL] += int(local.sum())
        self.class_counts[CROSSING] += int(m - local.sum())

        tr = trace.current()
        cross_idx = np.nonzero(~local)[0]
        if cross_idx.shape[0]:
            sp = tr.begin("execute") if tr is not None else None
            out[cross_idx] = self._run_crossing(
                index, ls[cross_idx], rs[cross_idx], op, out_dtype)
            if tr is not None:
                tr.end(sp, cls=CROSSING, count=int(cross_idx.shape[0]),
                       op=op)
        local_idx = np.nonzero(local)[0]
        if local_idx.shape[0]:
            sp = tr.begin("execute") if tr is not None else None
            out[local_idx] = self._run_seg_local(
                index, ls[local_idx], rs[local_idx], owner[local_idx], op,
                out_dtype)
            if tr is not None:
                tr.end(sp, cls=SEG_LOCAL, count=int(local_idx.shape[0]),
                       op=op)
        return out

    def run_bulk(self, index, ls: np.ndarray, rs: np.ndarray,
                 op: str) -> np.ndarray:
        """The bulk route: :meth:`run`'s predicate, with the contained
        spans sorted by ``(owner, chunk(l), chunk(r))`` in segment-local
        coordinates first, so each segment's row is endpoint-sorted and
        the grouping's stable owner sort is an identity pass.  The grouped
        path runs with no combine; only the crossing spans pay it.  No
        dedup, no LRU."""
        self.calls += 1
        m = ls.shape[0]
        self.queries += m
        cap = index.segment_capacity
        c = index.plan.c
        out_dtype = _out_dtype(index, op)
        out = np.empty((m,), out_dtype)

        tr = trace.current()
        sp = tr.begin("plan") if tr is not None else None
        owner = ls // cap
        local = owner == (rs // cap)
        n_local = int(local.sum())
        self.class_counts[SEG_LOCAL] += n_local
        self.class_counts[CROSSING] += m - n_local
        local_idx = np.nonzero(local)[0]
        lsub, rsub = ls[local_idx], rs[local_idx]
        osub = owner[local_idx]
        lloc = lsub - osub.astype(np.int32) * cap
        rloc = rsub - osub.astype(np.int32) * cap
        sort = np.lexsort((rloc // c, lloc // c, osub))
        if tr is not None:
            tr.end(sp, queries=m, seg_local=n_local,
                   crossing=m - n_local, op=op, strategy="bulk")

        cross_idx = np.nonzero(~local)[0]
        if cross_idx.shape[0]:
            sp = tr.begin("execute") if tr is not None else None
            out[cross_idx] = self._run_crossing(
                index, ls[cross_idx], rs[cross_idx], op, out_dtype)
            if tr is not None:
                tr.end(sp, cls=CROSSING, count=int(cross_idx.shape[0]),
                       op=op)
        if local_idx.shape[0]:
            sp = tr.begin("execute") if tr is not None else None
            res = self._run_seg_local(
                index, lsub[sort], rsub[sort], osub[sort], op, out_dtype)
            if tr is not None:
                tr.end(sp, cls=SEG_LOCAL, count=int(local_idx.shape[0]),
                       op=op)
            sp = tr.begin("scatter") if tr is not None else None
            out[local_idx[sort]] = res
            if tr is not None:
                tr.end(sp, queries=m, unique=m, op=op)
        return out

    # -- crossing spans: the combine, padded to bounded shapes ------------
    def _run_crossing(self, index, ls, rs, op, out_dtype) -> np.ndarray:
        k = ls.shape[0]
        shape = min(max(_next_pow2(k), self.min_bucket), self.max_bucket)
        res = np.empty((k,), out_dtype)
        for lo in range(0, k, shape):
            cnt = min(shape, k - lo)
            pl = np.zeros((shape,), np.int32)
            pr = np.zeros((shape,), np.int32)
            pl[:cnt] = ls[lo:lo + cnt]
            pr[:cnt] = rs[lo:lo + cnt]
            r = (index.query_index(pl, pr) if op == INDEX
                 else index.query(pl, pr))
            res[lo:lo + cnt] = to_host(r)[:cnt]
        return res

    # -- contained spans: grouped per owner, answered without a combine ---
    def _run_seg_local(self, index, ls, rs, owner, op,
                       out_dtype) -> np.ndarray:
        cap = index.segment_capacity
        s = index.num_segments
        # stable sort by owner -> contiguous per-segment runs; row_pos is
        # each query's slot inside its segment's row
        order = np.argsort(owner, kind="stable")
        so = owner[order]
        counts = np.bincount(so, minlength=s)
        starts = np.cumsum(counts) - counts
        row_pos = np.arange(so.shape[0]) - starts[so]
        lloc = ls[order] - so.astype(np.int32) * cap
        rloc = rs[order] - so.astype(np.int32) * cap
        picked = np.empty((so.shape[0],), out_dtype)
        # row width bounded at max_bucket: a skewed batch runs in several
        # rounds of the same shapes
        for lo in range(0, int(counts.max()), self.max_bucket):
            sel = (row_pos >= lo) & (row_pos < lo + self.max_bucket)
            rp = row_pos[sel] - lo
            k = max(_next_pow2(int(rp.max()) + 1), self.min_bucket)
            gl = np.zeros((s, k), np.int32)
            gr = np.zeros((s, k), np.int32)
            gl[so[sel], rp] = lloc[sel]
            gr[so[sel], rp] = rloc[sel]
            vals, poss = index._query_grouped(gl, gr,
                                              track_pos=(op == INDEX))
            picked[sel] = to_host(poss if op == INDEX else vals)[
                so[sel], rp].astype(out_dtype, copy=False)
        res = np.empty((ls.shape[0],), out_dtype)
        res[order] = picked
        return res

    def stats(self) -> dict:
        return {
            "calls": self.calls,
            "queries": self.queries,
            "class_counts": dict(self.class_counts),
        }

    def invalidate(self) -> None:
        """No per-index state to drop."""
