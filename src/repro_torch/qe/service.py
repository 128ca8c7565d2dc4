"""``QueryService``: a multi-index registry with micro-batching admission.

The port of ``repro.qe.service``.  Small requests are the enemy of
batched RMQ throughput (every dispatch pays the engine's fixed planning
and launch cost), so the service holds an admission queue: ``submit``
enqueues a request and returns a ticket; ``flush`` coalesces everything
pending for the same (index, op) pair into one engine execution (one
dedup pass, one set of padded buckets) and scatters each request's slice
back to its ticket.  On a fused engine the two op groups of an index
merge into one :meth:`QueryEngine.query_mixed` (value and index answers
from the same one-launch buckets: one ``rmq_fused`` launch for a flush
of up to ``max_bucket`` distinct spans).  ``submit`` auto-flushes once
the pending query count crosses ``max_pending``.

The serving tier (:mod:`repro_torch.serving`) drives flushes from
outside: ``auto_flush=False`` so ``submit`` never flushes behind the
scheduler's back, ``flush(names=...)`` for one tenant's requests,
``validate_request`` for admission-time checks, ``snapshot(name)`` for
the index serving a name, and ``on_dropped_result`` to observe
unclaimed-result evictions.

``attach(name, successor)`` follows a mutation; ``register_many`` indexes
many equal-length arrays through ONE batched build
(:func:`repro_torch.core.build_many`: one ``hierarchy_fused`` launch on
the card).  Answers are tensors on the index's device.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import trace
from repro_torch.obs.metrics import Metrics
from repro_torch.qe.engine import QueryEngine
from repro_torch.qe.executors import INDEX, VALUE

__all__ = ["QueryService"]


def _host(a) -> np.ndarray:
    """Bounds as a numpy array (a tensor on any device is read back)."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.atleast_1d(np.asarray(a))


@dataclasses.dataclass(frozen=True)
class _Request:
    ticket: int
    name: str
    op: str
    ls: np.ndarray
    rs: np.ndarray


class QueryService:
    """Named engines + a coalescing admission queue."""

    def __init__(
        self,
        max_pending: int = 4096,
        max_unclaimed: int = 4096,
        auto_flush: bool = True,
        on_dropped_result: Optional[Callable[[str, int], None]] = None,
        metrics: Optional[Metrics] = None,
        tuning=None,
        **engine_defaults,
    ):
        # a TuningCache flows into every engine the service constructs;
        # explicit per-engine kwargs still win
        if tuning is not None:
            engine_defaults.setdefault("tuning", tuning)
        self.max_pending = max_pending
        # Results stay claimable via take() after a flush, bounded PER
        # INDEX (FIFO eviction of the oldest unclaimed), so one tenant's
        # unclaimed flood cannot evict another tenant's results.
        self.max_unclaimed = max_unclaimed
        # auto_flush=False hands flush timing to an external scheduler
        self.auto_flush = auto_flush
        # called as on_dropped_result(name, ticket) for every unclaimed
        # result evicted past max_unclaimed (a warning hook, not a veto)
        self.on_dropped_result = on_dropped_result
        self._engine_defaults = engine_defaults
        self._engines: Dict[str, QueryEngine] = {}
        self._pending: List[_Request] = []
        self._pending_queries = 0
        self._results: Dict[str, "OrderedDict[int, torch.Tensor]"] = {}
        self._result_name: Dict[int, str] = {}
        self._next_ticket = 0
        self.flushes = 0
        self.coalesced_batches = 0
        self.mixed_retries = 0
        self.requests = 0
        self.dropped_results = 0
        # service counters export as read-through gauges; each engine
        # gets a child scope ({index="..."} in the Prometheus text)
        self.metrics = metrics
        self._engine_metrics: Optional[Metrics] = None
        if metrics is not None:
            self._engine_metrics = metrics.scope(
                "engines", child_label="index")
            metrics.gauge("requests", fn=lambda: self.requests)
            metrics.gauge("flushes", fn=lambda: self.flushes)
            metrics.gauge("coalesced_batches",
                          fn=lambda: self.coalesced_batches)
            metrics.gauge("mixed_retries", fn=lambda: self.mixed_retries)
            metrics.gauge("pending_queries",
                          fn=lambda: self._pending_queries)
            metrics.gauge("unclaimed_results",
                          fn=lambda: len(self._result_name))
            metrics.gauge("dropped_results",
                          fn=lambda: self.dropped_results)

    # -- registry ---------------------------------------------------------
    def register(self, name: str, index, **engine_kwargs) -> QueryEngine:
        """Create (or replace) the engine serving ``name``.

        Replacing a name whose queue still holds requests would answer
        those tickets against the wrong index, so that raises: flush
        first (use :meth:`attach` to follow a mutation of the same
        logical index).
        """
        if any(r.name == name for r in self._pending):
            raise ValueError(
                f"index {name!r} has pending requests; flush first")
        kwargs = {**self._engine_defaults, **engine_kwargs}
        if self._engine_metrics is not None and "metrics" not in kwargs:
            kwargs["metrics"] = self._engine_metrics.scope(name)
        engine = QueryEngine.for_index(index, **kwargs)
        self._engines[name] = engine
        return engine

    def register_many(
        self,
        arrays: Dict[str, object],
        c: int = 128,
        t: int = 64,
        with_positions: bool = False,
        backend: str = "auto",
        capacity: Optional[int] = None,
        device=None,
        **engine_kwargs,
    ) -> Dict[str, QueryEngine]:
        """Index many equal-length arrays in ONE batched build launch.

        All arrays share one plan (same ``n`` / ``c`` / ``t`` /
        ``capacity``) and are stacked into a ``(B, n)`` batch for
        :func:`repro_torch.core.build_many`: one ``hierarchy_fused``
        launch on the card for all ``B``.  Each row is then registered
        under its dict key as an :class:`repro_torch.core.RMQ`,
        bit-identical to a solo ``RMQ.build`` of that array.  ``backend``
        picks only the query and update lowering of the indexes (every
        build is bit-identical).  Stacking promotes mixed input dtypes to
        a common one.  ``device=None`` means the card.
        """
        from repro_torch.core import protocol as px
        from repro_torch.core.api import RMQ, resolve_device
        from repro_torch.core.hierarchy import Hierarchy, build_many
        from repro_torch.core.plan import make_plan

        names = list(arrays)
        if not names:
            return {}
        # all-or-nothing: fail before any engine is replaced
        blocked = sorted({r.name for r in self._pending} & set(names))
        if blocked:
            raise ValueError(
                f"index(es) {blocked} have pending requests; flush first")
        dev = resolve_device(device)
        vals = [px.coerce_values(arrays[name], dev) for name in names]
        n = int(vals[0].shape[0])
        for name, v in zip(names, vals):
            if int(v.shape[0]) != n:
                raise ValueError(
                    f"register_many requires equal lengths; {names[0]!r} "
                    f"has {n}, {name!r} has {int(v.shape[0])} — register "
                    "differing geometries individually")
        plan = make_plan(n, c=c, t=t, capacity=capacity)
        backend = px.resolve_backend(backend, dev)
        dtype = functools.reduce(torch.promote_types,
                                 [v.dtype for v in vals])
        batched = build_many(torch.stack([v.to(dtype) for v in vals]), plan,
                             with_positions=with_positions)
        engines: Dict[str, QueryEngine] = {}
        for i, name in enumerate(names):
            h = Hierarchy(
                base=batched.base[i],
                upper=batched.upper[i],
                upper_pos=(batched.upper_pos[i] if with_positions
                           else None),
                plan=plan,
            )
            engines[name] = self.register(
                name, RMQ(hierarchy=h, backend=backend, length=n),
                **engine_kwargs)
        return engines

    def attach(self, name: str, index, **kwargs) -> None:
        """Re-bind ``name`` to a successor index after a mutation."""
        self._engine(name).attach(index, **kwargs)

    def unregister(self, name: str) -> None:
        if any(r.name == name for r in self._pending):
            raise ValueError(
                f"index {name!r} has pending requests; flush first")
        del self._engines[name]

    def engine(self, name: str) -> QueryEngine:
        return self._engine(name)

    def _engine(self, name: str) -> QueryEngine:
        if name not in self._engines:
            raise KeyError(
                f"no index registered as {name!r}; "
                f"have {sorted(self._engines)}")
        return self._engines[name]

    # -- admission queue --------------------------------------------------
    def validate_request(
        self, name: str, ls, rs, op: str = VALUE
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Admission-time checks without enqueueing; returns 1-D numpy
        ``(ls, rs)``.  Shared by :meth:`submit` and the serving tier, so a
        rejected request fails in the caller's hands, not at flush time."""
        engine = self._engine(name)  # fail fast on unknown names
        if op not in (VALUE, INDEX):
            raise ValueError(f"op must be 'value' or 'index', got {op!r}")
        if op == INDEX and not engine.index.with_positions:
            raise ValueError(
                f"index {name!r} was built without positions; "
                "op='index' needs with_positions=True")
        ls, rs = _host(ls), _host(rs)
        if ls.shape != rs.shape or ls.ndim != 1:
            raise ValueError(
                f"bounds must be matching 1-D batches, got "
                f"{ls.shape} vs {rs.shape}")
        return ls, rs

    def submit(self, name: str, ls, rs, op: str = VALUE) -> int:
        """Enqueue a request; returns a ticket for :meth:`flush` results."""
        ls, rs = self.validate_request(name, ls, rs, op)
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append(_Request(ticket, name, op, ls, rs))
        self._pending_queries += ls.shape[0]
        self.requests += 1
        if self.auto_flush and self._pending_queries >= self.max_pending:
            self.flush()
        return ticket

    def submit_bulk(self, name: str, ls, rs, op: str = VALUE) -> int:
        """Execute a bulk-analytics batch now; returns its ticket.

        Admission checks are :meth:`validate_request`'s, but the request
        bypasses the queue: it goes straight through
        :meth:`QueryEngine.query_bulk` (``rmq_bulk`` from the engine's
        crossover up).  The result is stored at once, so :meth:`take`
        claims it without a :meth:`flush`; pending requests are untouched.
        """
        ls, rs = self.validate_request(name, ls, rs, op)
        ticket = self._next_ticket
        self._next_ticket += 1
        self.requests += 1
        res = self._engine(name).query_bulk(ls, rs, op)
        self._store_result(name, ticket, res)
        return ticket

    def snapshot(self, name: str):
        """The immutable index object currently serving ``name``: a stable
        read handle, since every index is pure-functional."""
        return self._engine(name).index

    def flush(
        self, names: Optional[Iterable[str]] = None
    ) -> Dict[int, torch.Tensor]:
        """Execute everything pending, coalesced per (index, op).

        ``names`` restricts the flush to those indexes' requests, leaving
        the rest queued.  Returns ``{ticket: results}``; results also stay
        claimable via :meth:`take` until collected or pushed out by
        ``max_unclaimed`` newer ones (oldest first).

        On a fused engine an index's value and index groups merge into one
        :meth:`QueryEngine.query_mixed`.  Failures stay isolated per
        (index, op) group: when a merged execution fails, the two op
        groups are retried separately (the coalescing counted once), and
        the first error re-raises after the loop with the failed groups'
        tickets in the message; healthy groups' results are stored.
        """
        tr = trace.current()
        sp = tr.begin("service_flush") if tr is not None else None
        if names is None:
            pending, self._pending = self._pending, []
            self._pending_queries = 0
        else:
            picked = set(names)
            pending = [r for r in self._pending if r.name in picked]
            self._pending = [r for r in self._pending
                             if r.name not in picked]
            self._pending_queries = sum(r.ls.shape[0]
                                        for r in self._pending)
        if pending:
            self.flushes += 1
        groups: Dict[Tuple[str, str], List[_Request]] = {}
        for req in pending:
            groups.setdefault((req.name, req.op), []).append(req)
        out: Dict[int, torch.Tensor] = {}
        out_name: Dict[int, str] = {}
        failures: List[Tuple[str, str, List[int], Exception]] = []

        def run_group(name, op, reqs, count_coalesced=True):
            """One per-op engine execution, its own failure unit; True
            when results landed in ``out``.  The merged path's retries
            pass ``count_coalesced=False`` and count the group once."""
            engine = self._engines[name]
            ls = np.concatenate([r.ls for r in reqs])
            rs = np.concatenate([r.rs for r in reqs])
            try:
                res = (engine.query(ls, rs) if op == VALUE
                       else engine.query_index(ls, rs))
            except Exception as e:
                failures.append((name, op, [r.ticket for r in reqs], e))
                return False
            if count_coalesced and len(reqs) > 1:
                self.coalesced_batches += 1
            off = 0
            for r in reqs:
                out[r.ticket] = res[off:off + r.ls.shape[0]]
                out_name[r.ticket] = r.name
                off += r.ls.shape[0]
            return True

        handled = set()
        for (name, op), reqs in groups.items():
            if (name, op) in handled:
                continue
            engine = self._engines[name]
            other = (name, INDEX if op == VALUE else VALUE)
            if other in groups and engine.supports_mixed:
                # both ops in one mixed execution (one launch per bucket)
                reqs = groups[(name, VALUE)] + groups[(name, INDEX)]
                handled.add((name, VALUE))
                handled.add((name, INDEX))
                ls = np.concatenate([r.ls for r in reqs])
                rs = np.concatenate([r.rs for r in reqs])
                flags = np.concatenate([
                    np.full((r.ls.shape[0],), r.op == INDEX, bool)
                    for r in reqs])
                try:
                    vals, poss = engine.query_mixed(ls, rs, flags)
                except Exception:
                    # per-(index, op) isolation: retry each op group on
                    # its own; the admission coalesced these requests
                    # once, so the count does not depend on the path
                    self.mixed_retries += 1
                    ok_v = run_group(name, VALUE, groups[(name, VALUE)],
                                     count_coalesced=False)
                    ok_i = run_group(name, INDEX, groups[(name, INDEX)],
                                     count_coalesced=False)
                    if (ok_v or ok_i) and len(reqs) > 1:
                        self.coalesced_batches += 1
                    continue
                if len(reqs) > 1:
                    self.coalesced_batches += 1
                # per-ticket scatter, each request's own plane (the same
                # offset bookkeeping as run_group)
                off = 0
                for r in reqs:
                    cnt = r.ls.shape[0]
                    plane = poss if r.op == INDEX else vals
                    out[r.ticket] = plane[off:off + cnt]
                    out_name[r.ticket] = r.name
                    off += cnt
                continue
            run_group(name, op, reqs)
        for ticket, res in out.items():
            self._store_result(out_name[ticket], ticket, res)
        if tr is not None:
            tr.end(sp, requests=len(pending), groups=len(groups),
                   failed=len(failures))
        if failures:
            name, op, tickets, err = failures[0]
            raise RuntimeError(
                f"flush failed for {len(failures)} group(s); first: "
                f"index {name!r} op {op!r} tickets {tickets}: {err} "
                "(other groups' results were stored and are claimable)"
            ) from err
        return out

    def _store_result(self, name: str, ticket: int, res) -> None:
        """Stash a flushed result, FIFO-bounding unclaimed per index."""
        bucket = self._results.setdefault(name, OrderedDict())
        bucket[ticket] = res
        self._result_name[ticket] = name
        while len(bucket) > self.max_unclaimed:
            old, _ = bucket.popitem(last=False)
            del self._result_name[old]
            self.dropped_results += 1
            if self.on_dropped_result is not None:
                self.on_dropped_result(name, old)

    def take(self, ticket: int) -> torch.Tensor:
        """Claim (and remove) a flushed result by ticket.

        Raises ``KeyError`` for tickets never flushed and for results
        evicted past ``max_unclaimed``: claim promptly after flushing.
        """
        name = self._result_name.pop(ticket, None)
        if name is None:
            raise KeyError(
                f"ticket {ticket} has no result; flush() it first "
                "(or it aged out of the unclaimed-results buffer)")
        bucket = self._results[name]
        res = bucket.pop(ticket)
        if not bucket:
            del self._results[name]
        return res

    # -- synchronous conveniences -----------------------------------------
    def _query_sync(self, name: str, ls, rs, op: str) -> torch.Tensor:
        ticket = self.submit(name, ls, rs, op)
        try:
            self.flush()
        except RuntimeError:
            # failures are per group: if OUR group executed, its result
            # is stored, and an unrelated group must not lose it
            if ticket not in self._result_name:
                raise
        return self.take(ticket)

    def query(self, name: str, ls, rs) -> torch.Tensor:
        """Submit + flush + take in one call (still coalesces any queue)."""
        return self._query_sync(name, ls, rs, VALUE)

    def query_index(self, name: str, ls, rs) -> torch.Tensor:
        return self._query_sync(name, ls, rs, INDEX)

    # -- introspection ----------------------------------------------------
    def stats(self) -> dict:
        return {
            "requests": self.requests,
            "flushes": self.flushes,
            "coalesced_batches": self.coalesced_batches,
            "mixed_retries": self.mixed_retries,
            "pending_requests": len(self._pending),
            "pending_queries": self._pending_queries,
            "unclaimed_results": len(self._result_name),
            "dropped_results": self.dropped_results,
            "engines": {
                name: eng.stats() for name, eng in self._engines.items()
            },
        }
