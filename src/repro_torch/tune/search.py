"""The geometry / engine autotuner (paper §4, Fig. 12, made operational).

The port of ``repro.tune.search``.  It searches ``(c, t, backend,
planner, long_cutoff)`` per ``(platform, n bucket, span mix)`` by timing
the engines the port serves: every candidate geometry is built once on
the tuner's device, then raced through each backend's
:class:`~repro_torch.qe.QueryEngine` over span-class-pinned workloads
(hierarchies are bit-identical across backends, so one build serves
every engine).  Winners become :class:`~repro_torch.tune.cache.TunedConfig`
entries of a :class:`~repro_torch.tune.cache.TuningCache`.

The default backends are the routed class-split engine and the
single-launch engine of the device: ``("cuda", "fused")`` on a card (B5,
B4 and the hybrid top against B2), ``("eager", "fused")`` on the CPU
(the reference's ``("jax", "fused")``).

:meth:`Autotuner.measure_crossover` finds the measured walk-vs-sparse-top
crossover span (the routed planner's ``long_cutoff``) and
:meth:`Autotuner.measure_bulk_crossover` the batch size from which the
sorted bulk sweep (B7) beats the fused path.  Geometries with
``c * t >= n`` degenerate to one level and are skipped and reported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tune.cache import (
    SPAN_MIXES,
    TunedConfig,
    TuningCache,
    current_platform,
)
from repro_torch.tune.measure import (
    make_input_array,
    make_span_queries,
    time_fn,
)

__all__ = ["Autotuner", "Measurement", "SkippedConfig",
           "DEFAULT_GEOMETRIES", "TINY_GEOMETRIES"]

# The paper's Fig. 12 grid (VL regime c=8 through atom-aligned c=512).
DEFAULT_GEOMETRIES: Tuple[Tuple[int, int], ...] = (
    (8, 8), (8, 64),
    (32, 8), (32, 64),
    (128, 8), (128, 64),
    (256, 8), (256, 64),
    (512, 8),
)

# small chunks, so tiny arrays still get multi-level plans
TINY_GEOMETRIES: Tuple[Tuple[int, int], ...] = ((8, 8), (16, 8), (32, 8))


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One timed candidate: a (geometry, backend) on one workload."""

    n: int
    span_mix: str
    c: int
    t: int
    backend: str
    ns_per_query: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SkippedConfig:
    """A candidate left out of the sweep, with its reason (reported)."""

    n: int
    c: int
    t: int
    reason: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Autotuner:
    """Measure candidate configs on ``device`` and fill a tuning cache.

    ``device=None`` means the card.  ``backends`` are the query lowerings
    to race (default: the device's routed backend and ``"fused"``).
    ``m`` / ``repeats`` trade search time for stability (one warm-up,
    then the median: :func:`repro_torch.tune.measure.time_fn`).
    """

    def __init__(
        self,
        geometries: Sequence[Tuple[int, int]] = DEFAULT_GEOMETRIES,
        backends: Optional[Sequence[str]] = None,
        span_mixes: Sequence[str] = SPAN_MIXES,
        m: int = 4096,
        repeats: int = 3,
        crossover_points: int = 5,
        seed: int = 0,
        log: Optional[Callable[[str], None]] = None,
        device=None,
    ):
        from repro_torch.core.api import resolve_device
        from repro_torch.core.protocol import resolve_backend

        for mix in span_mixes:
            if mix not in SPAN_MIXES:
                raise ValueError(
                    f"span mix {mix!r} not in {SPAN_MIXES}")
        self.device = resolve_device(device)
        # the device's routed backend: builds and the crossovers' engines
        self.routed = resolve_backend("auto", self.device)
        self.geometries = tuple(geometries)
        self.backends = tuple(backends if backends is not None
                              else (self.routed, "fused"))
        self.span_mixes = tuple(span_mixes)
        self.m = int(m)
        self.repeats = int(repeats)
        self.crossover_points = int(crossover_points)
        self.seed = seed
        self._log = log or (lambda msg: None)
        self._x: Optional[Tuple[int, torch.Tensor]] = None

    def reference_c(self, n: int) -> int:
        """The chunk size that defines the span-mix workloads.

        Every candidate races on the same queries, pinned relative to the
        default chunk (c=128), stepped down only while ``n`` is too small
        for a mid-span band (``4c < n``).
        """
        c = 128
        while c > 2 and 4 * c >= n:
            c //= 2
        return c

    def _input(self, n: int) -> torch.Tensor:
        """``make_input_array(n)`` on the device, made once per size."""
        if self._x is None or self._x[0] != n:
            self._x = None  # free the previous size first
            self._x = (n, torch.from_numpy(make_input_array(n)).to(
                self.device))
        return self._x[1]

    def _build(self, n: int, c: int, t: int):
        from repro_torch.core.api import RMQ

        return RMQ.build(self._input(n), c=c, t=t, backend=self.routed,
                         device=self.device)

    # -- one size ----------------------------------------------------------
    def search_size(self, n: int) -> Tuple[
            Dict[str, TunedConfig], List[Measurement], List[SkippedConfig]]:
        """Race every candidate on one array size.

        Returns ``(winners by span mix, all measurements, skipped)``.
        """
        from repro_torch.qe import QueryEngine

        best: Dict[str, Tuple[float, Measurement]] = {}
        measurements: List[Measurement] = []
        skipped: List[SkippedConfig] = []
        ref_c = self.reference_c(n)
        workloads = {
            mix: make_span_queries(n, self.m, ref_c, mix,
                                   seed=self.seed + 1)
            for mix in self.span_mixes
        }

        for c, t in self.geometries:
            if c * t >= n:
                skipped.append(SkippedConfig(
                    n, c, t,
                    f"c*t = {c * t} >= n = {n}: plan degenerates to a "
                    "single level (pure scan)"))
                self._log(f"skip n={n} c={c} t={t}: c*t >= n")
                continue
            # one build per geometry: every engine races over it
            index = self._build(n, c, t)
            engines = {
                b: QueryEngine(index, cache_size=0, backend=b)
                for b in self.backends
            }
            for mix in self.span_mixes:
                ls, rs = workloads[mix]
                for backend, engine in engines.items():
                    secs = time_fn(lambda e=engine: e.query(ls, rs),
                                   repeats=self.repeats)
                    meas = Measurement(
                        n=n, span_mix=mix, c=c, t=t, backend=backend,
                        ns_per_query=secs / self.m * 1e9)
                    measurements.append(meas)
                    self._log(
                        f"n={n} mix={mix} c={c} t={t} {backend}: "
                        f"{meas.ns_per_query:.0f} ns/q")
                    prev = best.get(mix)
                    if prev is None or meas.ns_per_query < prev[0]:
                        best[mix] = (meas.ns_per_query, meas)
            del index, engines

        winners: Dict[str, TunedConfig] = {}
        # both crossovers depend on the geometry, not on the span mix:
        # mixes sharing a winning (c, t) share one measurement
        long_by_geom: Dict[Tuple[int, int], Optional[int]] = {}
        bulk_by_geom: Dict[Tuple[int, int], Optional[int]] = {}
        for mix, (_, meas) in best.items():
            geom = (meas.c, meas.t)
            long_cutoff = None
            if meas.backend != "fused":
                if geom not in long_by_geom:
                    long_by_geom[geom] = self.measure_crossover(
                        n, meas.c, meas.t)
                long_cutoff = long_by_geom[geom]
            if geom not in bulk_by_geom:
                bulk_by_geom[geom] = self.measure_bulk_crossover(
                    n, meas.c, meas.t)
            winners[mix] = TunedConfig(
                c=meas.c, t=meas.t, backend=meas.backend,
                planner="fused" if meas.backend == "fused" else "routed",
                long_cutoff=long_cutoff,
                ns_per_query=meas.ns_per_query,
                bulk_crossover=bulk_by_geom[geom],
            )
        return winners, measurements, skipped

    # -- the routed-vs-sparse-top crossover --------------------------------
    def measure_crossover(self, n: int, c: int, t: int) -> Optional[int]:
        """Smallest span where the O(1) sparse-table top beats the walk.

        Races two engines of the device's routed backend over
        span-pinned batches: one with the long route off (every span
        walks the hierarchy), one whose ``long_cutoff`` admits every
        candidate span to the top.  Returns the first span the top wins,
        or ``None`` when the walk wins everywhere (the planner keeps its
        analytic default).
        """
        from repro_torch.qe import QueryEngine

        if n <= c * t:
            return None
        backend = self.routed
        index = self._build(n, c, t)
        lo = max(4 * c, 2 * c + 2)
        hi = max(n // 2, lo + 1)
        spans = sorted({
            int(s) for s in np.geomspace(lo, hi, self.crossover_points)
        })
        walk = QueryEngine(index, cache_size=0, backend=backend,
                           long_enabled=False)
        top = QueryEngine(index, cache_size=0, backend=backend,
                          long_cutoff=spans[0])
        rng = np.random.default_rng(self.seed + 2)
        for span in spans:
            ls = (rng.random(self.m) * (n - span + 1)).astype(np.int32)
            rs = (ls + span - 1).astype(np.int32)
            t_walk = time_fn(lambda: walk.query(ls, rs),
                             repeats=self.repeats)
            t_top = time_fn(lambda: top.query(ls, rs),
                            repeats=self.repeats)
            self._log(
                f"crossover n={n} c={c} span={span}: walk "
                f"{t_walk / self.m * 1e9:.0f} vs top "
                f"{t_top / self.m * 1e9:.0f} ns/q")
            if t_top < t_walk:
                return span
        return None

    # -- the bulk-vs-fused batch-size crossover ----------------------------
    def measure_bulk_crossover(self, n: int, c: int,
                               t: int) -> Optional[int]:
        """Smallest batch where the sorted bulk sweep beats fused.

        Races the fused engine against a bulk-forced one
        (``bulk_crossover=1``: every batch through ``rmq_bulk``) over
        geometrically spaced batch sizes of the mixed workload.  Returns
        the first size bulk wins, or ``None`` when fused wins at every
        probed size (the engine keeps its analytic model).
        """
        from repro_torch.qe import QueryEngine

        index = self._build(n, c, t)
        fused = QueryEngine(index, cache_size=0, backend="fused")
        bulk = QueryEngine(index, cache_size=0, backend="fused",
                           bulk_crossover=1)
        sizes = sorted({
            int(b) for b in np.geomspace(
                self.m, 64 * self.m, self.crossover_points)
        })
        for m in sizes:
            ls, rs = make_span_queries(n, m, self.reference_c(n),
                                       "mixed", seed=self.seed + 3)
            t_fused = time_fn(lambda: fused.query(ls, rs),
                              repeats=self.repeats)
            t_bulk = time_fn(lambda: bulk.query_bulk(ls, rs),
                             repeats=self.repeats)
            self._log(
                f"bulk crossover n={n} c={c} t={t} m={m}: fused "
                f"{t_fused / m * 1e9:.0f} vs bulk "
                f"{t_bulk / m * 1e9:.0f} ns/q")
            if t_bulk < t_fused:
                return m
        return None

    # -- the full search ---------------------------------------------------
    def search(self, sizes: Sequence[int],
               platform: Optional[str] = None
               ) -> Tuple[TuningCache, dict]:
        """Fill a cache for ``sizes`` under ``platform`` (default: the
        tuner's device's key).  Returns ``(cache, report)``; the report
        carries every measurement and every skipped config."""
        platform = platform or current_platform(self.device)
        cache = TuningCache()
        report = {
            "platform": platform,
            "device": str(self.device),
            "sizes": [int(s) for s in sizes],
            "geometries": [list(g) for g in self.geometries],
            "backends": list(self.backends),
            "m": self.m,
            "repeats": self.repeats,
            "measurements": [],
            "skipped": [],
            "winners": {},
        }
        try:
            for n in sizes:
                winners, measurements, skipped = self.search_size(int(n))
                report["measurements"] += [m.as_dict()
                                           for m in measurements]
                report["skipped"] += [s.as_dict() for s in skipped]
                for mix, cfg in winners.items():
                    cache.put(platform, int(n), mix, cfg)
                    report["winners"][f"n{n}_{mix}"] = cfg.as_dict()
                    self._log(
                        f"winner n={n} mix={mix}: c={cfg.c} t={cfg.t} "
                        f"{cfg.backend}/{cfg.planner} "
                        f"long_cutoff={cfg.long_cutoff} "
                        f"bulk_crossover={cfg.bulk_crossover} "
                        f"({cfg.ns_per_query:.0f} ns/q)")
        finally:
            self._x = None  # the input array is the search's largest hold
        return cache, report
