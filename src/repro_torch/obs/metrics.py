"""Unified metrics: counters, gauges, histograms, dict + Prometheus export.

Promoted from ``repro.serving.metrics`` (which remains as a re-export
shim) so the engine, service, and serving tier share one registry tree.
Deliberately dependency-free (no prometheus client in the container):
monotonic :class:`Counter`\\ s, read-through :class:`Gauge`\\ s and
fixed-bucket :class:`Histogram`\\ s collected in a :class:`Metrics`
registry. :meth:`Metrics.as_dict` emits a plain nested dict — the
exchange format tests, benchmarks and examples consume directly — and
:meth:`Metrics.to_prometheus` emits the text exposition format a
production scrape endpoint would serve.

Everything mutable is lock-protected: the tier's flusher thread and
caller threads record concurrently (``x += 1`` on an attribute is NOT
atomic under the GIL).  Gauges may instead wrap a zero-argument callback
(``gauge("hit_rate", fn=...)``) so hot paths keep their plain-int
counters and pay the read cost only at export time.

Registries nest: ``metrics.scope("tenants").scope("search")`` gives each
tenant its own namespace inside one exported tree.  A scope created with
``child_label`` renders its child scopes as Prometheus *label values*
rather than name segments — ``scope("tenants", child_label="tenant")``
exports ``repro_tenants_submits_total{tenant="search"}``.  Metric
objects are created lazily on first touch and are stable thereafter, so
hot paths can hold a reference
(``self._submits = scope.counter("submits")``) instead of re-resolving
names per call.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

__all__ = ["Counter", "Gauge", "Histogram", "Info", "Metrics",
           "LATENCY_BUCKETS", "SIZE_BUCKETS"]

# Log-spaced seconds from 10us to ~10s — spans a sub-millisecond SLO and
# a pathological multi-second stall in the same histogram.
LATENCY_BUCKETS = tuple(1e-5 * (10 ** (i / 3.0)) for i in range(19))

# Pow2 batch/queue-depth buckets up to the fused bucket ceiling.
SIZE_BUCKETS = tuple(float(1 << i) for i in range(15))


class Counter:
    """Monotonic counter (thread-safe)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def as_dict(self) -> int:
        return self._value


class Gauge:
    """Point-in-time value: either set explicitly or read through a
    zero-argument callback.

    The callback form is the cheap way to export state a hot path
    already tracks as plain attributes (cache hit counts, queue depth):
    nothing is double-booked per operation, the source is read once per
    export.  A callback that raises exports 0.0 rather than poisoning
    the whole scrape.
    """

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = fn

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self._fn = None

    def set_fn(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return 0.0
        return self._value

    def as_dict(self) -> float:
        return self.value


class Info:
    """The Prometheus *info* pattern: a constant-``1`` gauge whose
    **labels** carry the payload (build/version/config facts that are
    strings, not numbers) — e.g.
    ``repro_engine_tuned_config{c="128",backend="fused",...} 1``.

    :meth:`set` replaces the whole label set atomically; exporting an
    Info that was never set emits nothing (no labels to report).
    """

    __slots__ = ("_lock", "_labels")

    def __init__(self):
        self._lock = threading.Lock()
        self._labels: Dict[str, str] = {}

    def set(self, labels: Optional[Dict[str, str]]) -> None:
        labels = {str(k): str(v) for k, v in dict(labels or {}).items()}
        with self._lock:
            self._labels = labels

    @property
    def labels(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._labels)

    def as_dict(self) -> Dict[str, str]:
        return self.labels


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max + bucket percentiles.

    ``bounds`` are bucket *upper* edges; an implicit +inf bucket catches
    the overflow.  :meth:`percentile` answers from bucket edges (clamped
    to the observed max), so it is a bounded-error estimate — callers
    needing exact tail latencies keep their own sample list and use this
    for the exported summary.
    """

    __slots__ = ("_lock", "bounds", "counts", "count", "total",
                 "vmin", "vmax")

    def __init__(self, bounds: Sequence[float] = LATENCY_BUCKETS):
        self._lock = threading.Lock()
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def record(self, value: float) -> None:
        value = float(value)
        lo, hi = 0, len(self.bounds)
        while lo < hi:                      # first bucket with bound >= value
            mid = (lo + hi) // 2
            if value <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self.counts[lo] += 1
            self.count += 1
            self.total += value
            self.vmin = min(self.vmin, value)
            self.vmax = max(self.vmax, value)

    def snapshot(self) -> Tuple[List[int], int, float, float, float]:
        """One consistent ``(counts, count, total, vmin, vmax)`` read.

        Everything derived (percentiles, means, exports) starts from a
        snapshot so a concurrent :meth:`record` can never be observed
        half-applied (count bumped but total not yet, etc.).
        """
        with self._lock:
            return (list(self.counts), self.count, self.total,
                    self.vmin, self.vmax)

    def _percentile_from(self, snap, q: float) -> float:
        counts, count, _total, _vmin, vmax = snap
        if count == 0:
            return 0.0
        rank = q * count
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank and c:
                edge = self.bounds[i] if i < len(self.bounds) else vmax
                return min(edge, vmax)
        return vmax

    def percentile(self, q: float) -> float:
        """Upper-edge estimate of the ``q``-quantile (q in [0, 1])."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        return self._percentile_from(self.snapshot(), q)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def as_dict(self) -> dict:
        # One snapshot for every field: the previous implementation
        # released the lock after the count==0 check and re-read live
        # attributes, so a concurrent record() could produce a dict
        # where e.g. count was bumped but sum was not.
        snap = self.snapshot()
        counts, count, total, vmin, vmax = snap
        if count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p99": 0.0}
        return {
            "count": count,
            "sum": total,
            "min": vmin,
            "max": vmax,
            "mean": total / count,
            "p50": self._percentile_from(snap, 0.50),
            "p99": self._percentile_from(snap, 0.99),
        }


_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(*parts: str) -> str:
    name = "_".join(p for p in parts if p)
    name = _NAME_SANITIZE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _prom_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    items = []
    for k, v in labels.items():
        v = str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")
        items.append(f'{_NAME_SANITIZE.sub("_", k)}="{v}"')
    return "{" + ",".join(items) + "}"


def _prom_float(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


class Metrics:
    """Lazy registry of named counters/gauges/histograms + nested scopes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[
            str, Union[Counter, Gauge, Histogram, Info]] = {}
        self._scopes: Dict[str, "Metrics"] = {}
        self._child_label: Optional[str] = None

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, ())

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(name, Gauge, ())
        if fn is not None:
            g.set_fn(fn)
        return g

    def histogram(
        self, name: str, bounds: Optional[Sequence[float]] = None
    ) -> Histogram:
        return self._get(name, Histogram,
                         (bounds if bounds is not None else LATENCY_BUCKETS,))

    def info(self, name: str,
             labels: Optional[Dict[str, str]] = None) -> Info:
        """Constant-1 gauge whose labels carry string facts (see
        :class:`Info`)."""
        m = self._get(name, Info, ())
        if labels is not None:
            m.set(labels)
        return m

    def scope(self, name: str,
              child_label: Optional[str] = None) -> "Metrics":
        """Child registry.  With ``child_label``, this scope's own child
        scopes export as Prometheus label values (``{child_label="..."}``)
        instead of name segments."""
        with self._lock:
            if name in self._metrics:
                raise ValueError(f"{name!r} is already a metric here")
            scope = self._scopes.get(name)
            if scope is None:
                scope = self._scopes[name] = Metrics()
            if child_label is not None:
                scope._child_label = child_label
            return scope

    def _get(self, name, cls, args):
        with self._lock:
            if name in self._scopes:
                raise ValueError(f"{name!r} is already a scope here")
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(*args)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"{name!r} is a {type(m).__name__}, not {cls.__name__}"
                )
            return m

    def as_dict(self) -> dict:
        with self._lock:
            metrics = dict(self._metrics)
            scopes = dict(self._scopes)
        out = {name: m.as_dict() for name, m in metrics.items()}
        for name, scope in scopes.items():
            out[name] = scope.as_dict()
        return out

    # -- Prometheus text exposition -----------------------------------------
    def _samples(self, prefix: str, labels: Dict[str, str], out: list):
        """Collect (prom_name, kind, labels, payload) rows depth-first."""
        with self._lock:
            metrics = list(self._metrics.items())
            scopes = list(self._scopes.items())
            child_label = self._child_label
        for name, m in metrics:
            pname = _prom_name(prefix, name)
            if isinstance(m, Counter):
                out.append((pname + "_total", "counter", labels, m.value))
            elif isinstance(m, Gauge):
                out.append((pname, "gauge", labels, m.value))
            elif isinstance(m, Info):
                info_labels = m.labels
                if info_labels:
                    out.append(
                        (pname, "gauge", {**labels, **info_labels}, 1.0))
            else:
                out.append((pname, "histogram", labels, m))
        for name, scope in scopes:
            if child_label is not None:
                sub = dict(labels)
                sub[child_label] = name
                scope._samples(prefix, sub, out)
            else:
                scope._samples(_prom_name(prefix, name), labels, out)

    def to_prometheus(self, prefix: str = "repro") -> str:
        """Prometheus/OpenMetrics-style text exposition.

        Counters get a ``_total`` suffix; histograms expand to
        cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``;
        scopes either extend the metric name or become labels (see
        :meth:`scope`).  Ends with a trailing newline, as scrapers
        expect.
        """
        samples: list = []
        self._samples(_prom_name(prefix), {}, samples)
        typed: Dict[str, str] = {}
        order: List[str] = []
        by_name: Dict[str, list] = {}
        for pname, kind, labels, payload in samples:
            if pname not in typed:
                typed[pname] = kind
                order.append(pname)
                by_name[pname] = []
            by_name[pname].append((labels, payload))
        lines: List[str] = []
        for pname in order:
            kind = typed[pname]
            lines.append(f"# TYPE {pname} {kind}")
            for labels, payload in by_name[pname]:
                if kind == "histogram":
                    hist: Histogram = payload
                    counts, count, total, _vmin, _vmax = hist.snapshot()
                    cum = 0
                    for bound, c in zip(hist.bounds, counts):
                        cum += c
                        le = dict(labels)
                        le["le"] = _prom_float(bound)
                        lines.append(
                            f"{pname}_bucket{_prom_labels(le)} {cum}")
                    cum += counts[-1]
                    le = dict(labels)
                    le["le"] = "+Inf"
                    lines.append(f"{pname}_bucket{_prom_labels(le)} {cum}")
                    lines.append(
                        f"{pname}_sum{_prom_labels(labels)} "
                        f"{_prom_float(total if count else 0.0)}")
                    lines.append(
                        f"{pname}_count{_prom_labels(labels)} {count}")
                else:
                    lines.append(
                        f"{pname}{_prom_labels(labels)} "
                        f"{_prom_float(payload)}")
        return "\n".join(lines) + "\n"
