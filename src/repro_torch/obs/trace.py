"""Request tracing: explicit spans, a thread-safe ring buffer, and
Chrome-trace/Perfetto export.

The serving stack's claims are *per-request* claims — one fused launch
per flush, snapshot-stable reads, SLO-bounded queueing — but until now
only aggregate counters existed to check them.  This module records the
full request lifecycle as spans::

    submit -> admission -> queue -> snapshot_swap -> plan
           -> execute(launch) -> scatter

Design constraints, in order:

* **zero cost when disabled** — instrumentation sites read one module
  global (``current()``); when no tracer is installed they take no
  locks and allocate nothing (the same discipline as
  ``repro.kernels.profiling.record_launch``).  Hot paths use the
  ``tr = current(); if tr is not None`` guard; cold paths may use the
  module-level :func:`span` helper, which returns a shared no-op
  context manager;
* **injectable clock** — defaults to ``time.monotonic`` so span
  timestamps are directly comparable with the serving tier's deadline
  clock; tests inject a fake clock and assert exact orderings;
* **thread-safe bounded buffer** — spans record from caller threads and
  the flusher thread concurrently; the buffer is a ring
  (``maxlen=capacity``) so a long-running service can leave tracing on
  without unbounded growth;
* **nesting by thread** — each thread keeps its own open-span stack
  (thread-local), so a span opened on the flusher thread can never
  adopt a caller thread's span as parent.  Cross-thread edges (the
  ``queue`` wait between a caller's submit and the flusher's drain) are
  recorded retroactively with :meth:`Tracer.record`, using timestamps
  from the shared clock.

Export: :meth:`Tracer.to_chrome_trace` emits the Chrome trace event
format (``chrome://tracing`` / Perfetto / ``ui.perfetto.dev``) — one
complete (``"ph": "X"``) event per span, microsecond timestamps, span
and parent ids in ``args`` so the tree survives tools that re-sort.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "Span",
    "Tracer",
    "current",
    "instant",
    "record",
    "set_tracer",
    "span",
    "use_tracer",
]


@dataclasses.dataclass
class Span:
    """One recorded (or still-open) span.  Times are clock seconds."""

    name: str
    start: float
    span_id: int
    parent_id: Optional[int]
    thread: str
    end: Optional[float] = None
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None else self.start) - self.start


class _SpanCtx:
    """Context-manager shim over ``Tracer.begin``/``Tracer.end``."""

    __slots__ = ("_tracer", "_span", "_args")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self._args = args
        self._span = tracer.begin(name)

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, *exc) -> None:
        self._tracer.end(self._span, **self._args)


class _NullSpan:
    """Shared no-op context manager: the disabled-tracing fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_NULL = _NullSpan()


class Tracer:
    """Explicit-span tracer with a bounded, thread-safe buffer.

    ``clock`` is injectable (fake clocks in tests; must match the clock
    of any timestamps passed to :meth:`record`).  ``capacity`` bounds
    the retained span count — the oldest spans fall off the ring.
    """

    def __init__(
        self,
        clock=time.monotonic,
        capacity: int = 65536,
    ):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self._clock = clock
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self.dropped = 0          # spans pushed off the ring

    # -- span lifecycle ----------------------------------------------------
    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def begin(self, name: str) -> Span:
        """Open a span (child of this thread's innermost open span)."""
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        sp = Span(
            name=name,
            start=self._clock(),
            span_id=next(self._ids),
            parent_id=parent,
            thread=threading.current_thread().name,
        )
        stack.append(sp)
        return sp

    def end(self, sp: Span, **args) -> Span:
        """Close ``sp`` and record it.  Tolerant of unbalanced stacks
        (an exception that skipped inner ``end`` calls): closes any
        still-open descendants silently."""
        sp.end = self._clock()
        if args:
            sp.args.update(args)
        stack = self._stack()
        if sp in stack:
            del stack[stack.index(sp):]
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(sp)
        return sp

    def span(self, name: str, **args) -> _SpanCtx:
        """``with tracer.span("plan", batch=64):`` — begin/end + args."""
        return _SpanCtx(self, name, args)

    def record(
        self,
        name: str,
        start: float,
        end: float,
        parent: Optional[Span] = None,
        **args,
    ) -> Span:
        """Record a span with explicit timestamps (same clock as the
        tracer's).  This is how cross-thread waits — e.g. the ``queue``
        time between a caller's submit and the flusher's drain — enter
        the trace without holding a span open across threads."""
        sp = Span(
            name=name,
            start=start,
            span_id=next(self._ids),
            parent_id=parent.span_id if parent is not None else None,
            thread=threading.current_thread().name,
            end=end,
            args=dict(args),
        )
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(sp)
        return sp

    def instant(self, name: str, **args) -> Span:
        """Zero-duration marker event."""
        now = self._clock()
        return self.record(name, now, now, **args)

    # -- introspection / export --------------------------------------------
    def spans(self) -> List[Span]:
        """Snapshot of recorded spans, in completion order."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def to_chrome_trace(self) -> dict:
        """The Chrome trace event format (Perfetto-loadable) as a dict.

        One ``"ph": "X"`` complete event per span; ``ts``/``dur`` in
        microseconds on the tracer's clock; span/parent ids in ``args``
        so the tree is recoverable independent of nesting heuristics.
        """
        events = []
        for sp in self.spans():
            args = {"span_id": sp.span_id}
            if sp.parent_id is not None:
                args["parent_id"] = sp.parent_id
            args.update(sp.args)
            events.append({
                "name": sp.name,
                "cat": "repro",
                "ph": "X",
                "ts": sp.start * 1e6,
                "dur": max(sp.duration, 0.0) * 1e6,
                "pid": 0,
                "tid": sp.thread,
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
            f.write("\n")


# ---------------------------------------------------------------------------
# the installed tracer (module global, like profiling's launch counter)
# ---------------------------------------------------------------------------
_active: Optional[Tracer] = None


def current() -> Optional[Tracer]:
    """The installed tracer, or None (tracing disabled).

    Hot paths read this once per batch and branch on ``is not None`` —
    the disabled cost is one global load, no locks, no allocations.
    """
    return _active


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or, with None, remove) the process-wide tracer.
    Returns the previously installed tracer."""
    global _active
    prev = _active
    _active = tracer
    return prev


@contextlib.contextmanager
def use_tracer(tracer: Tracer) -> Iterator[Tracer]:
    """Install ``tracer`` for the duration of the block."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


def span(name: str, **args):
    """``with trace.span("flush", tenant=t):`` — no-op when disabled.

    Convenience for cold paths (per-flush, not per-query): when tracing
    is disabled it returns a shared null context (the ``**args`` dict is
    the only allocation).  Hot paths should use the
    ``current()``-and-guard pattern instead.
    """
    t = _active
    if t is None:
        return _NULL
    return t.span(name, **args)


def instant(name: str, **args) -> Optional[Span]:
    """Zero-duration marker; no-op when disabled."""
    t = _active
    if t is None:
        return None
    return t.instant(name, **args)


def record(name: str, start: float, end: float, **args) -> Optional[Span]:
    """Explicit-timestamp span; no-op when disabled."""
    t = _active
    if t is None:
        return None
    return t.record(name, start, end, **args)
