"""Deadline-driven serving tier over :class:`repro_torch.qe.QueryService`.

The port of ``repro.serving.tier``.  ``QueryService`` micro-batches, but
its flushes are caller-driven; this module adds the front end that
decides when to flush:

* **deadline scheduler**: each tenant carries a latency SLO; a flush
  fires when the oldest queued request's deadline arrives *or* the queue
  reaches the fused bucket capacity, whichever comes first.  One flusher
  (a background thread via :meth:`ServingTier.start`, an asyncio pump
  via :mod:`repro_torch.serving.aio`, or manual :meth:`ServingTier.step`
  calls with an injected clock for tests) drives all tenants;
* **snapshot-isolated reads**: each tenant's index lives in a
  :class:`repro_torch.serving.snapshot.SnapshotSlot`: mutations stage
  onto the back log in O(1) and swap in *between* flushes, so every
  request in a flush is answered by one pinned generation;
* **admission control**: bounded per-tenant queues and token-bucket
  quotas reject with :class:`Backpressure` (carrying ``retry_after``)
  instead of growing without bound;
* **telemetry**: per-tenant counters and histograms under the
  reference's names (:mod:`repro_torch.serving.metrics`), exported by
  :meth:`ServingTier.stats` and ``tier.metrics.to_prometheus()``.

Requests return :class:`Ticket` objects (``concurrent.futures``-backed).
Each flush funnels the tenant's whole queue through ``QueryService``
coalescing: on a fused engine that is ONE ``rmq_fused`` launch per
drained flush of up to ``max_batch`` = ``max_bucket`` distinct spans.

Streams: a flush runs on the flusher's thread, and PyTorch's current
stream is per thread.  So a flush whose answers live on a card records
one CUDA event on its launching stream after its work, and
:meth:`Ticket.result` makes the caller's current stream wait on it (no
host sync) and records the answer's use on that stream for the caching
allocator.  A caller reading under a side stream
(``with torch.cuda.stream(s)``) sees the finished answer.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import trace
from repro_torch.obs.metrics import LATENCY_BUCKETS, Metrics, SIZE_BUCKETS
from repro_torch.qe.executors import INDEX, VALUE
from repro_torch.qe.service import QueryService
from repro_torch.serving.snapshot import SnapshotSlot

__all__ = [
    "Backpressure",
    "FlushEvent",
    "ServingTier",
    "TenantConfig",
    "Ticket",
]


class Backpressure(RuntimeError):
    """Admission rejected; retry after ``retry_after`` seconds.

    ``reason`` is ``"queue_full"`` (bounded per-tenant queue at
    capacity) or ``"quota"`` (token-bucket QPS quota exhausted).  The
    tier never buffers beyond the configured bounds — callers own the
    retry, which is what keeps overload from turning into unbounded
    memory growth and collapsed tail latency.
    """

    def __init__(self, tenant: str, reason: str, retry_after: float):
        self.tenant = tenant
        self.reason = reason
        self.retry_after = float(retry_after)
        super().__init__(
            f"tenant {tenant!r} rejected ({reason}); "
            f"retry after {self.retry_after:.4f}s"
        )


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """Per-tenant SLO + admission knobs.

    ``slo_ms`` — flush-by deadline for a queued request (the client-side
    latency is roughly ``slo_ms`` + one flush's execution time);
    ``max_queue`` — bound on queued *queries* (not requests) before
    :class:`Backpressure`; ``max_batch`` — queue size that triggers an
    early size-based flush (defaults to the fused bucket capacity so a
    full flush is still one launch); ``quota_qps`` — optional sustained
    queries/second token bucket with burst ``quota_burst``.
    """

    slo_ms: float = 5.0
    max_queue: int = 8192
    max_batch: int = 4096
    quota_qps: Optional[float] = None
    quota_burst: Optional[float] = None

    def __post_init__(self):
        if self.slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {self.slo_ms}")
        if self.max_batch <= 0 or self.max_queue < self.max_batch:
            raise ValueError(
                f"need 0 < max_batch <= max_queue, got "
                f"max_batch={self.max_batch} max_queue={self.max_queue}"
            )
        if self.quota_qps is not None and self.quota_qps <= 0:
            raise ValueError(f"quota_qps must be > 0, got {self.quota_qps}")


class Ticket:
    """Future-style handle for one submitted request.

    ``result(timeout)`` blocks until the deadline/size flush resolves
    it (or re-raises the flush failure).  After resolution,
    ``generation`` records the snapshot the answers came from and
    ``completed_at`` the tier-clock completion time.  An answer on a card
    comes back ordered after its flush's work on the caller's current
    stream (the flush's event).
    """

    __slots__ = ("tenant", "op", "count", "submitted_at", "deadline",
                 "generation", "completed_at", "_future", "_event")

    def __init__(self, tenant, op, count, submitted_at, deadline):
        self.tenant = tenant
        self.op = op
        self.count = count
        self.submitted_at = submitted_at
        self.deadline = deadline
        self.generation: Optional[int] = None
        self.completed_at: Optional[float] = None
        self._future: "concurrent.futures.Future" = (
            concurrent.futures.Future()
        )
        self._event: Optional["torch.cuda.Event"] = None

    def result(self, timeout: Optional[float] = None):
        return self._ready(self._future.result(timeout))

    def _ready(self, res):
        """``res`` made safe to read on the caller's current stream: that
        stream waits for the flush's event, and the caching allocator
        learns that the answer is used there."""
        ev = self._event
        if ev is not None:
            stream = torch.cuda.current_stream(res.device)
            stream.wait_event(ev)
            res.record_stream(stream)
        return res

    def exception(self, timeout: Optional[float] = None):
        return self._future.exception(timeout)

    def done(self) -> bool:
        return self._future.done()

    @property
    def future(self) -> "concurrent.futures.Future":
        """The underlying future (asyncio front ends wrap this)."""
        return self._future


@dataclasses.dataclass(frozen=True)
class FlushEvent:
    """Passed to the ``on_flush`` hook after the snapshot is pinned and
    staged mutations swapped, *before* the read batch executes — the
    seam where 'mutation admitted mid-flush' semantics are observable
    (and tested)."""

    tenant: str
    generation: int
    reason: str
    requests: int
    applied_mutations: int


def _flush_event(results) -> Optional["torch.cuda.Event"]:
    """An event recorded on the current stream after a flush's work, when
    its answers live on a card (else ``None``)."""
    for res in results:
        if isinstance(res, torch.Tensor) and res.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(res.device))
            return ev
    return None


@dataclasses.dataclass
class _Queued:
    ticket: Ticket
    ls: np.ndarray
    rs: np.ndarray


class _Tenant:
    """Queue + slot + quota-bucket + metrics for one registered index."""

    def __init__(self, name: str, cfg: TenantConfig, slot: SnapshotSlot,
                 metrics: Metrics):
        self.name = name
        self.cfg = cfg
        self.slot = slot
        self.lock = threading.Lock()          # queue + quota state
        self.flush_lock = threading.Lock()    # one flush at a time
        self.queue: Deque[_Queued] = deque()
        self.queued_queries = 0
        self.mutation_deadline: Optional[float] = None
        self.tokens = float(cfg.quota_burst or cfg.quota_qps or 0.0)
        self.last_refill: Optional[float] = None
        m = metrics
        self.m_submits = m.counter("submits")
        self.m_submitted_queries = m.counter("submitted_queries")
        self.m_rejected_queue = m.counter("rejected_queue_full")
        self.m_rejected_quota = m.counter("rejected_quota")
        self.m_flushes = m.counter("flushes")
        self.m_flush_deadline = m.counter("flushes_deadline")
        self.m_flush_size = m.counter("flushes_size")
        self.m_flush_mutation = m.counter("flushes_mutation")
        self.m_flush_forced = m.counter("flushes_forced")
        self.m_bulk = m.counter("bulk_routed")
        self.m_failed = m.counter("failed_requests")
        self.m_mut_staged = m.counter("mutations_staged")
        self.m_mut_applied = m.counter("mutations_applied")
        self.m_swaps = m.counter("snapshot_swaps")
        self.m_dropped = m.counter("dropped_results")
        self.m_deadline_miss = m.counter("deadline_misses")
        self.m_latency = m.histogram("latency_s", LATENCY_BUCKETS)
        self.m_batch = m.histogram("flush_queries", SIZE_BUCKETS)
        self.m_depth = m.histogram("queue_depth", SIZE_BUCKETS)


class ServingTier:
    """Multi-tenant deadline batcher over one :class:`QueryService`.

    Drive it one of three ways:

    * ``tier.start()`` — background flusher thread (production shape;
      pair with the default ``time.monotonic`` clock);
    * :class:`repro_torch.serving.aio.AsyncServingTier` — asyncio pump, no
      thread;
    * ``tier.step(now)`` / ``tier.drain(name)`` — manual, with an
      injectable ``clock`` for deterministic tests.
    """

    def __init__(
        self,
        service: Optional[QueryService] = None,
        *,
        clock: Callable[[], float] = time.monotonic,
        metrics: Optional[Metrics] = None,
        idle_tick: float = 0.05,
        on_flush: Optional[Callable[[FlushEvent], None]] = None,
        tuning=None,
    ):
        self.metrics = metrics if metrics is not None else Metrics()
        if service is None:
            # the tier owns flush timing; the service must never flush
            # behind its back on a max_pending crossing.  A tier-owned
            # service also joins the tier's metrics tree (engine scopes
            # included) so one to_prometheus() covers the whole stack.
            # A TuningCache passed here reaches every per-tenant engine
            # the service constructs (self-configured geometry knobs).
            service = QueryService(auto_flush=False,
                                   metrics=self.metrics.scope("service"),
                                   tuning=tuning)
        elif tuning is not None:
            raise ValueError(
                "pass tuning via the QueryService when supplying an "
                "explicit service")
        self._service = service
        self._service_lock = threading.Lock()
        self._clock = clock
        self._idle_tick = float(idle_tick)
        self._on_flush = on_flush
        self._tenant_metrics = self.metrics.scope(
            "tenants", child_label="tenant")
        self._m_steps = self.metrics.counter("steps")
        self._m_errors = self.metrics.counter("flusher_errors")
        self._tenants: Dict[str, _Tenant] = {}
        self._tenants_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._wake = threading.Event()
        service.on_dropped_result = self._count_drop

    # -- registry ---------------------------------------------------------
    def register_tenant(
        self,
        name: str,
        index,
        *,
        slo_ms: float = 5.0,
        max_queue: int = 8192,
        max_batch: int = 4096,
        quota_qps: Optional[float] = None,
        quota_burst: Optional[float] = None,
        **engine_kwargs,
    ):
        """Register ``index`` under ``name`` with its serving SLO.

        Returns the tenant's :class:`~repro_torch.qe.engine.QueryEngine` (the
        same object ``QueryService.register`` creates).
        """
        cfg = TenantConfig(slo_ms=slo_ms, max_queue=max_queue,
                           max_batch=max_batch, quota_qps=quota_qps,
                           quota_burst=quota_burst)
        with self._tenants_lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            with self._service_lock:
                engine = self._service.register(name, index,
                                                **engine_kwargs)
            self._tenants[name] = _Tenant(
                name, cfg, SnapshotSlot(index),
                self._tenant_metrics.scope(name),
            )
        return engine

    def unregister_tenant(self, name: str) -> None:
        tenant = self._tenant(name)
        self.drain(name)
        with self._tenants_lock:
            with self._service_lock:
                self._service.unregister(name)
            del self._tenants[name]
        for q in tenant.queue:     # post-drain submits lose their home
            q.ticket._future.set_exception(
                KeyError(f"tenant {name!r} unregistered")
            )

    def tenant_config(self, name: str) -> TenantConfig:
        return self._tenant(name).cfg

    def _tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            raise KeyError(
                f"no tenant registered as {name!r}; "
                f"have {sorted(self._tenants)}"
            )
        return t

    @property
    def service(self) -> QueryService:
        """The underlying service.  While the tier is running, mutate it
        only through tier methods (the flusher owns its lock)."""
        return self._service

    # -- admission --------------------------------------------------------
    def submit(self, name: str, ls, rs, op: str = VALUE,
               slo_ms: Optional[float] = None) -> Ticket:
        """Enqueue a read; non-blocking.  Raises :class:`Backpressure`
        when the tenant's queue bound or quota rejects it.

        Oversized read-only submissions — more queries than the
        tenant's ``max_batch`` — cannot ride the deadline queue: they
        would either be unadmittable forever (``m > max_queue``) or
        monopolise a flush the SLO sized for interactive traffic.
        They route to the engine's offline bulk path instead
        (:meth:`QueryService.submit_bulk` →
        :meth:`~repro_torch.qe.engine.QueryEngine.query_bulk`): no
        micro-batching, no LRU, one coalesced pass per sorted bucket.
        The returned :class:`Ticket` is already resolved when this
        returns (the bulk sweep runs inline on the caller's thread),
        answered against the tenant's *current* front generation —
        staged mutations keep waiting for the next flush, exactly as a
        queued read admitted before the swap would.  Quota admission
        still applies; only the queue bound is bypassed.
        """
        tenant = self._tenant(name)
        tr = trace.current()
        sp = tr.begin("submit") if tr is not None else None
        admitted = False
        try:
            with self._service_lock:
                ls, rs = self._service.validate_request(name, ls, rs, op)
            m = int(ls.shape[0])
            now = self._clock()
            cfg = tenant.cfg
            bulk = m > cfg.max_batch
            asp = tr.begin("admission") if tr is not None else None
            try:
                with tenant.lock:
                    if cfg.quota_qps is not None:
                        if tenant.last_refill is None:
                            tenant.last_refill = now
                        tenant.tokens = min(
                            float(cfg.quota_burst or cfg.quota_qps),
                            tenant.tokens
                            + (now - tenant.last_refill) * cfg.quota_qps,
                        )
                        tenant.last_refill = now
                        if tenant.tokens < m:
                            tenant.m_rejected_quota.inc()
                            raise Backpressure(
                                name, "quota",
                                (m - tenant.tokens) / cfg.quota_qps,
                            )
                        tenant.tokens -= m
                    if not bulk:
                        if tenant.queued_queries + m > cfg.max_queue:
                            tenant.m_rejected_queue.inc()
                            head = tenant.queue[0].ticket.deadline \
                                if tenant.queue else now + cfg.slo_ms / 1e3
                            raise Backpressure(
                                name, "queue_full",
                                max(head - now, 0.0) + 1e-4,
                            )
                    deadline = now + (slo_ms if slo_ms is not None
                                      else cfg.slo_ms) / 1e3
                    ticket = Ticket(name, op, m, now, deadline)
                    if not bulk:
                        tenant.queue.append(_Queued(ticket, ls, rs))
                        tenant.queued_queries += m
                    depth = tenant.queued_queries
                admitted = True
            finally:
                if tr is not None:
                    tr.end(asp, tenant=name, queries=m,
                           admitted=admitted, bulk=bulk)
            tenant.m_submits.inc()
            tenant.m_submitted_queries.inc(m)
            tenant.m_depth.record(depth)
            if bulk:
                self._execute_bulk(tenant, ticket, ls, rs)
            else:
                self._wake.set()
            return ticket
        finally:
            if tr is not None:
                tr.end(sp, tenant=name, op=op, admitted=admitted)

    def _execute_bulk(self, tenant: _Tenant, ticket: Ticket,
                      ls: np.ndarray, rs: np.ndarray) -> None:
        """Resolve one oversized read inline via the bulk path.

        Bypasses the deadline queue and the flush cycle entirely.  The
        snapshot pin brackets the service call so a concurrent flush's
        generation swap cannot retire the index mid-read; the recorded
        ``generation`` is the front the service is attached to —
        ``flush_lock`` excludes the window inside a flush where the
        slot has swapped but the service has not re-attached yet (same
        lock order as :meth:`_flush_tenant`: flush, then service)."""
        tenant.m_bulk.inc()
        with tenant.flush_lock:
            snap = tenant.slot.pin()
            try:
                with self._service_lock:
                    st = self._service.submit_bulk(
                        tenant.name, ls, rs, ticket.op)
                    res = self._service.take(st)
            except Exception as e:
                ticket._future.set_exception(e)
                tenant.m_failed.inc()
                return
            finally:
                snap.release()
        now = self._clock()
        ticket.generation = snap.generation
        ticket.completed_at = now
        ticket._event = _flush_event((res,))
        tenant.m_latency.record(now - ticket.submitted_at)
        ticket._future.set_result(res)

    # -- mutation staging -------------------------------------------------
    def update(self, name: str, idxs, vals) -> None:
        """Stage a batched point update; O(1), never blocks on reads."""
        self._stage(name, "update", (idxs, vals))

    def append(self, name: str, vals) -> None:
        self._stage(name, "append", (vals,))

    def replace_index(self, name: str, index) -> None:
        """Stage a wholesale successor index (supersedes earlier staged
        ops; see :meth:`SnapshotSlot.stage_replace`)."""
        self._stage(name, "replace", (index,))

    def _stage(self, name, kind, args) -> None:
        tenant = self._tenant(name)
        slot = tenant.slot
        if kind == "update":
            slot.stage_update(*args)
        elif kind == "append":
            slot.stage_append(*args)
        else:
            slot.stage_replace(*args)
        tenant.m_mut_staged.inc()
        now = self._clock()
        with tenant.lock:
            d = now + tenant.cfg.slo_ms / 1e3
            if tenant.mutation_deadline is None \
                    or d < tenant.mutation_deadline:
                tenant.mutation_deadline = d
        self._wake.set()

    # -- the scheduler ----------------------------------------------------
    def step(self, now: Optional[float] = None) -> Optional[float]:
        """Flush every tenant that is due; return the earliest pending
        deadline (None when fully idle).  This is the whole scheduler —
        the thread/asyncio drivers just call it in a loop."""
        now = self._clock() if now is None else now
        self._m_steps.inc()
        nxt: Optional[float] = None
        with self._tenants_lock:
            tenants = list(self._tenants.values())
        for tenant in tenants:
            reason = self._due_reason(tenant, now)
            if reason is not None:
                self._flush_tenant(tenant, reason)
            d = self._next_deadline(tenant)
            if d is not None:
                nxt = d if nxt is None else min(nxt, d)
        return nxt

    @staticmethod
    def _due_reason(tenant: _Tenant, now: float) -> Optional[str]:
        with tenant.lock:
            if tenant.queued_queries >= tenant.cfg.max_batch:
                return "size"
            if tenant.queue and tenant.queue[0].ticket.deadline <= now:
                return "deadline"
            if tenant.mutation_deadline is not None \
                    and tenant.mutation_deadline <= now:
                return "mutation"
        return None

    @staticmethod
    def _next_deadline(tenant: _Tenant) -> Optional[float]:
        with tenant.lock:
            ds = []
            if tenant.queue:
                ds.append(tenant.queue[0].ticket.deadline)
            if tenant.mutation_deadline is not None:
                ds.append(tenant.mutation_deadline)
        return min(ds) if ds else None

    def drain(self, name: str) -> int:
        """Force an immediate flush of one tenant (sync callers, tests).
        Returns the number of requests resolved."""
        tenant = self._tenant(name)
        return self._flush_tenant(tenant, "forced")

    def flush_all(self) -> int:
        with self._tenants_lock:
            tenants = list(self._tenants.values())
        return sum(self._flush_tenant(t, "forced") for t in tenants)

    # -- one flush cycle --------------------------------------------------
    def _flush_tenant(self, tenant: _Tenant, reason: str) -> int:
        tr = trace.current()
        with tenant.flush_lock:
            sp = tr.begin("flush") if tr is not None else None
            batch: List[_Queued] = []
            applied = 0
            generation = -1
            try:
                with tenant.lock:
                    batch = list(tenant.queue)
                    tenant.queue.clear()
                    tenant.queued_queries = 0
                    tenant.mutation_deadline = None
                if tr is not None:
                    # the queue wait is a cross-thread edge (submitted on
                    # a caller thread, drained here) — record it
                    # retroactively from the ticket's own timestamps
                    drained = self._clock()
                    for q in batch:
                        tr.record("queue", q.ticket.submitted_at, drained,
                                  parent=sp, tenant=tenant.name,
                                  queries=q.ticket.count)
                # 1. generation swap: staged mutations fold into the
                #    successor and publish BEFORE any read executes — a
                #    flush never observes a half-applied batch, and
                #    mutations staged from here on wait for the next
                #    cycle.
                ssp = tr.begin("snapshot_swap") if tr is not None else None
                front, applied = tenant.slot.swap()
                if applied:
                    with self._service_lock:
                        self._service.attach(tenant.name, front)
                    tenant.m_swaps.inc()
                    tenant.m_mut_applied.inc(applied)
                if tr is not None:
                    tr.end(ssp, applied=applied)
                if not batch and not applied and reason == "forced":
                    return 0
                # 2. pin the snapshot every request in this flush answers
                #    against (concurrent staging cannot move it).
                snap = tenant.slot.pin()
                generation = snap.generation
                try:
                    if self._on_flush is not None:
                        self._on_flush(FlushEvent(
                            tenant.name, snap.generation, reason,
                            len(batch), applied,
                        ))
                    if batch:
                        self._execute(tenant, batch, snap.generation)
                finally:
                    snap.release()
                tenant.m_flushes.inc()
                {
                    "deadline": tenant.m_flush_deadline,
                    "size": tenant.m_flush_size,
                    "mutation": tenant.m_flush_mutation,
                    "forced": tenant.m_flush_forced,
                }[reason].inc()
                tenant.m_batch.record(sum(q.ticket.count for q in batch))
                return len(batch)
            finally:
                if tr is not None:
                    tr.end(sp, tenant=tenant.name, reason=reason,
                           requests=len(batch), applied=applied,
                           generation=generation)

    def _execute(self, tenant: _Tenant, batch: List[_Queued],
                 generation: int) -> None:
        """Funnel the drained queue through one service flush and
        scatter results/failures back to tickets."""
        svc = self._service
        with self._service_lock:
            stickets: List[Optional[int]] = []
            for q in batch:
                try:
                    stickets.append(
                        svc.submit(tenant.name, q.ls, q.rs, q.ticket.op)
                    )
                except Exception as e:   # late validation (e.g. swap
                    stickets.append(None)             # dropped positions)
                    q.ticket._future.set_exception(e)
                    tenant.m_failed.inc()
            flush_err: Optional[Exception] = None
            try:
                svc.flush(names=(tenant.name,))
            except RuntimeError as e:
                # per-(index, op)-group isolation: healthy groups'
                # results are stored and claimed below
                flush_err = e
            now = self._clock()
            results = {}
            for q, st in zip(batch, stickets):
                if st is None:
                    continue
                try:
                    results[st] = svc.take(st)
                except KeyError:
                    pass
            event = _flush_event(results.values())
            for q, st in zip(batch, stickets):
                if st is None:
                    continue
                res = results.get(st)
                if res is None:
                    q.ticket._future.set_exception(
                        flush_err if flush_err is not None else
                        RuntimeError(
                            f"flush produced no result for ticket {st}"
                        )
                    )
                    tenant.m_failed.inc()
                    continue
                q.ticket.generation = generation
                q.ticket.completed_at = now
                q.ticket._event = event
                lat = now - q.ticket.submitted_at
                tenant.m_latency.record(lat)
                if now > q.ticket.deadline \
                        + tenant.cfg.slo_ms / 1e3:
                    tenant.m_deadline_miss.inc()
                q.ticket._future.set_result(res)

    # -- sync convenience -------------------------------------------------
    def query(self, name: str, ls, rs, op: str = VALUE,
              timeout: Optional[float] = None):
        """submit + wait.  Without a running flusher the tier drains the
        tenant inline (callers in a synchronous loop — e.g. the KV-cache
        eviction tenant — still get one coalesced flush)."""
        ticket = self.submit(name, ls, rs, op)
        if not self.running:
            self.drain(name)
        return ticket.result(timeout)

    # -- drivers ----------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "ServingTier":
        """Run the deadline flusher on a background daemon thread."""
        if self.running:
            raise RuntimeError("serving tier is already running")
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="serving-tier-flusher", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        if self._thread is not None:
            self._stop_evt.set()
            self._wake.set()
            self._thread.join()
            self._thread = None
        if drain:
            self.flush_all()

    def __enter__(self) -> "ServingTier":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                trace.instant("pump_wakeup", driver="thread")
                nxt = self.step()
            except Exception:
                # a tenant's flush failure resolves its tickets with the
                # exception; the scheduler itself must keep breathing
                self._m_errors.inc()
                nxt = None
            now = self._clock()
            timeout = self._idle_tick if nxt is None else \
                min(max(nxt - now, 0.0), self._idle_tick)
            if self._wake.wait(timeout):
                self._wake.clear()

    # -- telemetry --------------------------------------------------------
    def _count_drop(self, name: str, ticket: int) -> None:
        tenant = self._tenants.get(name)
        if tenant is not None:
            tenant.m_dropped.inc()

    def stats(self) -> dict:
        """Plain-dict telemetry: tier metrics + per-tenant snapshot/slot
        state + the underlying service's own counters."""
        out = self.metrics.as_dict()
        for name, tenant in self._tenants.items():
            out["tenants"].setdefault(name, {})["snapshot"] = \
                tenant.slot.stats()
            out["tenants"][name]["queued_queries"] = \
                tenant.queued_queries
        out["service"] = self._service.stats()
        return out
