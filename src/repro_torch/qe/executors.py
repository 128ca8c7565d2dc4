"""Per-span-class executors of the query engine.

The port of ``repro.qe.executors``.  Each executor owns the dispatch of
one planner class and keeps a table of bound callables keyed by
``(op, bucket shape)``; PyTorch runs eagerly, so the table only counts
the distinct shapes seen (``specializations`` in the stats, as in the
reference).  Backend names as in :mod:`repro_torch.core.protocol`:

* ``cuda`` (the reference's ``pallas``): short spans go to the
  ``rmq_short`` kernel (B5), mid spans to the ``rmq_scan`` kernel (B4),
  one plane per launch;
* ``eager``: the plain versions;
* long spans take the :class:`~repro_torch.core.hybrid.HybridRMQ`
  sparse-table top on every backend (plain PyTorch, as the reference's
  is plain JAX);
* ``fused``: :class:`FusedExecutor` answers a whole bucket in one
  ``rmq_fused`` launch (B2), and :meth:`FusedExecutor.run_mixed` returns
  both planes from that launch.

:class:`BulkExecutor` is the offline bulk path: the batch is sorted by
``(chunk(l), chunk(r))``, cut into buckets, and each bucket answered by
one ``rmq_bulk`` launch (B7) on the card, the plain version on the CPU.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.hierarchy import Hierarchy, value_bits
from repro_torch.kernels.profiling import timed_dispatch
from repro_torch.obs import trace

__all__ = [
    "BulkExecutor",
    "FusedExecutor",
    "LongSpanExecutor",
    "MidSpanExecutor",
    "ShortSpanExecutor",
]

VALUE = "value"
INDEX = "index"
MIXED = "mixed"


def to_host(t: torch.Tensor) -> np.ndarray:
    """A result plane on the host, bf16 as its int16 bits (numpy has no
    bfloat16, and a round trip through float32 could change a NaN's
    bits)."""
    return value_bits(t).cpu().numpy()


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The host dtype that carries a plane of ``dtype`` (:func:`to_host`)."""
    return to_host(torch.empty((), dtype=dtype)).dtype


class _ExecutorBase:
    """Shared bookkeeping: the (op, shape) -> callable table and stats."""

    # dispatch-site label for the launch registry's timer
    label = "executor"

    def __init__(self):
        self._compiled: Dict[Tuple[str, int], Callable] = {}
        self.calls = 0
        self.queries = 0

    def _bind(self, op: str, shape: int, make: Callable) -> Callable:
        key = (op, shape)
        fn = self._compiled.get(key)
        if fn is None:
            fn = make()
            self._compiled[key] = fn
        return fn

    def run(self, h: Hierarchy, ls, rs, op: str) -> torch.Tensor:
        self.calls += 1
        self.queries += int(ls.shape[0])
        fn = self._bind(op, int(ls.shape[0]), lambda: self._make(h, op))
        return timed_dispatch(f"{self.label}:{op}", fn, h, ls, rs)

    def stats(self) -> dict:
        return {
            "calls": self.calls,
            "queries": self.queries,
            "specializations": len(self._compiled),
        }

    def invalidate(self) -> None:
        """Drop state tied to a particular index version (default: none)."""


class ShortSpanExecutor(_ExecutorBase):
    """Spans within two aligned chunks, from level 0 alone."""

    label = "short"

    def __init__(self, backend: str):
        super().__init__()
        self.backend = backend

    def _make(self, h: Hierarchy, op: str) -> Callable:
        from repro_torch.kernels.rmq_short import ops as short_ops

        if self.backend == "cuda":
            if op == VALUE:
                return short_ops.rmq_short_value_batch
            return short_ops.rmq_short_index_batch
        track = op != VALUE

        def plain(h, ls, rs):
            v, p = short_ops.rmq_short_batch_plain(
                h.base, ls, rs, h.plan.c, h.plan.capacity, track)
            return p if track else v

        return plain


class MidSpanExecutor(_ExecutorBase):
    """The standard hierarchy walk."""

    label = "mid"

    def __init__(self, backend: str):
        super().__init__()
        self.backend = backend

    def _make(self, h: Hierarchy, op: str) -> Callable:
        if self.backend == "cuda":
            from repro_torch.kernels.rmq_scan import ops as scan_ops

            if op == VALUE:
                return scan_ops.rmq_value_batch_cuda
            return scan_ops.rmq_index_batch_cuda
        from repro_torch.core.query import rmq_index_batch, rmq_value_batch

        return rmq_value_batch if op == VALUE else rmq_index_batch


class LongSpanExecutor(_ExecutorBase):
    """The hybrid sparse-table top: O(1) instead of the c·t top scan.

    The hybrid wraps the engine's live hierarchy (no rebuild), so the
    engine calls :meth:`invalidate` on every attach.
    """

    label = "long"

    def __init__(self):
        super().__init__()
        self._hybrid = None

    def invalidate(self) -> None:
        self._hybrid = None

    def _hybrid_for(self, h: Hierarchy):
        if self._hybrid is None or self._hybrid.hierarchy is not h:
            from repro_torch.core.hybrid import HybridRMQ

            self._hybrid = HybridRMQ.from_hierarchy(h)
        return self._hybrid

    def _make(self, h: Hierarchy, op: str) -> Callable:
        if op == VALUE:
            return lambda h, ls, rs: self._hybrid_for(h).query(ls, rs)
        return lambda h, ls, rs: self._hybrid_for(h).query_index(ls, rs)


class FusedExecutor(_ExecutorBase):
    """The whole span mix in one ``rmq_fused`` launch per bucket."""

    label = "fused"

    def _make(self, h: Hierarchy, op: str) -> Callable:
        from repro_torch.kernels.rmq_fused import ops as fused_ops

        if op == MIXED:
            # one launch, both planes (positions imply track_pos)
            return lambda h, ls, rs: fused_ops.rmq_fused_batch(
                h, ls, rs, track_pos=True)
        if op == VALUE:
            return fused_ops.rmq_fused_value_batch
        return fused_ops.rmq_fused_index_batch

    def run_mixed(self, h: Hierarchy, ls, rs):
        """``(values, positions)`` for the whole bucket, one launch."""
        self.calls += 1
        self.queries += int(ls.shape[0])
        fn = self._bind(MIXED, int(ls.shape[0]),
                        lambda: self._make(h, MIXED))
        return timed_dispatch(f"{self.label}:{MIXED}", fn, h, ls, rs)


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


class BulkExecutor(_ExecutorBase):
    """Offline bulk sweep: sort, bucket, one launch per bucket.

    The batch is sorted by ``(chunk(l), chunk(r))`` so queries that share
    boundary chunks sit side by side, cut into buckets of at most
    ``max_bucket`` (padded to a power of two with ``(0, 0)`` sentinel
    queries, whose answers are dropped), each answered by one
    ``rmq_bulk`` launch, and the answers put back in submission order.
    The sort runs where the bounds are (on the card for a card index):
    a stable sort on ``chunk(l) * rows + chunk(r)`` gives the
    reference's ``np.lexsort`` permutation.
    """

    label = "bulk"

    def __init__(self, max_bucket: int = 1 << 20, min_bucket: int = 16):
        super().__init__()
        if max_bucket < min_bucket or min_bucket < 1:
            raise ValueError(
                f"need max_bucket >= min_bucket >= 1, got "
                f"{max_bucket}, {min_bucket}")
        self.max_bucket = int(max_bucket)
        self.min_bucket = int(min_bucket)

    def _make(self, h: Hierarchy, op: str) -> Callable:
        from repro_torch.kernels.rmq_bulk import ops as bulk_ops

        if op == VALUE:
            return bulk_ops.rmq_bulk_value_batch
        return bulk_ops.rmq_bulk_index_batch

    def run(self, h: Hierarchy, ls, rs, op: str) -> torch.Tensor:
        """Answer the whole batch; results in submission order, on the
        hierarchy's device."""
        dev = h.device
        ls = torch.as_tensor(ls, device=dev).to(torch.int32).reshape(-1)
        rs = torch.as_tensor(rs, device=dev).to(torch.int32).reshape(-1)
        m = ls.shape[0]
        out_dtype = torch.int32 if op == INDEX else h.base.dtype
        if m == 0:
            return torch.zeros((0,), dtype=out_dtype, device=dev)
        c = h.plan.c
        rows = -(-h.plan.capacity // c)
        self.queries += m

        tr = trace.current()
        sp = tr.begin("plan") if tr is not None else None
        key = (ls.to(torch.int64) // c) * rows + rs.to(torch.int64) // c
        order = torch.sort(key, stable=True)[1]
        sls, srs = ls[order], rs[order]
        n_buckets = -(-m // self.max_bucket)
        if tr is not None:
            tr.end(sp, queries=m, buckets=n_buckets, op=op,
                   strategy="bulk")

        sorted_res = torch.empty((m,), dtype=out_dtype, device=dev)
        for start in range(0, m, self.max_bucket):
            stop = min(start + self.max_bucket, m)
            count = stop - start
            k = max(_next_pow2(count), self.min_bucket)
            bl = torch.zeros((k,), dtype=torch.int32, device=dev)
            br = torch.zeros((k,), dtype=torch.int32, device=dev)
            bl[:count] = sls[start:stop]
            br[:count] = srs[start:stop]
            self.calls += 1
            fn = self._bind(op, k, lambda: self._make(h, op))
            sp = tr.begin("execute") if tr is not None else None
            res = timed_dispatch(f"{self.label}:{op}", fn, h, bl, br)
            sorted_res[start:stop] = res[:count].to(out_dtype)
            if tr is not None:
                tr.end(sp, cls="bulk", count=count, shape=k, op=op)

        sp = tr.begin("scatter") if tr is not None else None
        out = torch.empty((m,), dtype=out_dtype, device=dev)
        out[order] = sorted_res
        if tr is not None:
            tr.end(sp, queries=m, unique=m, op=op)
        return out
