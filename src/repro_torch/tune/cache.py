"""Persistent tuning cache: measured winners for (platform, n, span mix).

The port of ``repro.tune.cache``.  GPU-RMQ's design is hybrid (paper §4,
Fig. 12): no single ``(c, t)`` geometry or engine wins across array
sizes and span mixes, so the autotuner (:mod:`repro_torch.tune.search`)
measures candidates and files the winners here, and
``make_plan(..., tuned=True)``, ``RMQ.build(c="auto")`` and
``QueryEngine(tuning=...)`` read them.

Keying: ``(platform, n_bucket, span_mix)``.  ``platform`` is
:func:`current_platform` of the index's device: ``"cpu"`` for the host,
``"cuda:" + torch.cuda.get_device_name(dev)`` for a card (one process
may hold CPU and CUDA indexes at once, so the key follows the device,
not the process).  ``n_bucket`` is ``floor(log2(n))``; ``span_mix`` is
one of ``short`` / ``mid`` / ``long`` / ``mixed``.  Lookup falls back
``span_mix -> "mixed" -> nearest n_bucket``; a full miss returns
``None`` and every consumer keeps its defaults (``c=128, t=64``, the
analytic long cutoff), bit for bit.

Backend names are the port's (``eager`` / ``cuda`` / ``fused``); a
document that names the reference's ``jax`` / ``pallas`` is refused, so
a reference cache is never read as the port's.  The file format is
versioned and schema-validated on load: unknown versions and malformed
entries raise :class:`TuningCacheError`.  The committed cache is
``results/tuning_cache_torch.json`` (repo root), measured on the card by
``python -m repro_torch.tune``; ``REPRO_TORCH_TUNING_CACHE`` overrides
its path.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.protocol import BACKENDS

__all__ = [
    "DEFAULT_CACHE_PATH",
    "SCHEMA_VERSION",
    "SPAN_MIXES",
    "TunedConfig",
    "TuningCache",
    "TuningCacheError",
    "current_platform",
    "default_cache",
    "n_bucket",
]

SCHEMA_VERSION = 2

# Version 1 predates the compact-layout fields (``packed_pos``,
# ``summary_dtype``); its entries load with the classic-layout defaults
# and re-save as version 2.  Anything else fails loudly.
_READABLE_VERSIONS = (1, SCHEMA_VERSION)

SPAN_MIXES = ("short", "mid", "long", "mixed")

DEFAULT_CACHE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))),
    "results", "tuning_cache_torch.json",
)

_CACHE_PATH_ENV = "REPRO_TORCH_TUNING_CACHE"


class TuningCacheError(ValueError):
    """A tuning cache file failed schema validation on load."""


def current_platform(device=None) -> str:
    """The cache's platform key for ``device`` (``None`` means the card,
    and raises without one): ``"cpu"``, or ``"cuda:<device name>"``."""
    from repro_torch.core.api import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type == "cuda":
        return "cuda:" + torch.cuda.get_device_name(dev)
    raise ValueError(f"no tuning platform for device {dev}")


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One measured winner: geometry and engine choice for a workload.

    ``c`` / ``t`` are the hierarchy geometry; ``backend`` is the query
    lowering the engine runs (``eager`` / ``cuda`` / ``fused``: the
    hierarchy is bit-identical across backends, so an engine may adopt a
    tuned backend over any build); ``planner`` says whether the winner
    runs through the host-side class split (``"routed"``) or the
    single-launch path (``"fused"``); ``long_cutoff`` is the measured
    walk-vs-sparse-top crossover span (``None`` keeps the analytic
    ``2c·c^(L-2)``); ``scan_chunks`` / ``sparse_top`` parameterize the
    :class:`repro_torch.core.plan.LevelSplit`.  ``ns_per_query`` is the
    winning measurement, informational only.  ``bulk_crossover`` is the
    measured batch size from which ``QueryEngine.query_bulk``'s sorted
    sweep beats the fused path (``None`` keeps the analytic model).
    ``packed_pos`` / ``summary_dtype`` (schema v2) are the compact
    layouts ``make_plan(..., tuned=True)`` adopts unless given.
    """

    c: int
    t: int
    backend: str = "eager"
    planner: str = "routed"
    long_cutoff: Optional[int] = None
    scan_chunks: int = 2
    sparse_top: bool = True
    ns_per_query: Optional[float] = None
    bulk_crossover: Optional[int] = None
    packed_pos: bool = False
    summary_dtype: str = "float32"

    def __post_init__(self):
        if self.c < 2 or (self.c & (self.c - 1)) != 0:
            raise ValueError(f"c must be a power of two >= 2, got {self.c}")
        if self.t < 1:
            raise ValueError(f"t must be >= 1, got {self.t}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; the port's are "
                f"{BACKENDS} (the reference's 'jax' is 'eager', its "
                "'pallas' is 'cuda')")
        if self.planner not in ("routed", "fused"):
            raise ValueError(f"planner must be routed|fused, "
                             f"got {self.planner!r}")
        if self.long_cutoff is not None and self.long_cutoff < 1:
            raise ValueError(
                f"long_cutoff must be positive, got {self.long_cutoff}")
        if self.scan_chunks not in (1, 2):
            raise ValueError(
                f"scan_chunks must be 1 or 2 (the rmq_short kernel scans "
                f"at most two aligned chunks), got {self.scan_chunks}")
        if self.bulk_crossover is not None and self.bulk_crossover < 1:
            raise ValueError(
                f"bulk_crossover must be positive, "
                f"got {self.bulk_crossover}")
        if not isinstance(self.packed_pos, bool):
            raise ValueError(
                f"packed_pos must be a bool, got {self.packed_pos!r}")
        if self.summary_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"summary_dtype must be 'float32' or 'bfloat16', "
                f"got {self.summary_dtype!r}")

    def level_split(self):
        """The :class:`repro_torch.core.plan.LevelSplit` this implies."""
        from repro_torch.core.plan import LevelSplit

        return LevelSplit(
            scan_chunks=self.scan_chunks,
            sparse_top=self.sparse_top,
            long_cutoff=self.long_cutoff,
            fused=self.planner == "fused",
        )

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_REQUIRED_ENTRY_KEYS = {
    "platform": str, "n_bucket": int, "span_mix": str,
    "c": int, "t": int, "backend": str, "planner": str,
    "scan_chunks": int, "sparse_top": bool,
}


def n_bucket(n: int) -> int:
    """The cache's size bucket for an array of length ``n``."""
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")
    return int(n).bit_length() - 1


class TuningCache:
    """In-memory view of the tuning cache, with JSON (de)serialization.

    Thread-safe: engines resolve configs at attach time from whatever
    thread owns them, and the autotuner fills it from the main thread.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, int, str], TunedConfig] = {}
        self.source: Optional[str] = None

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, platform: str, n: int, span_mix: str,
            config: TunedConfig) -> None:
        if span_mix not in SPAN_MIXES:
            raise ValueError(
                f"span_mix must be one of {SPAN_MIXES}, got {span_mix!r}")
        with self._lock:
            self._entries[(platform, n_bucket(n), span_mix)] = config

    def lookup(self, platform: str, n: int,
               span_mix: str = "mixed") -> Optional[TunedConfig]:
        """The tuned config for ``(platform, n, span_mix)``, or ``None``.

        Fallback ladder (most to least specific; a miss at every rung
        returns ``None`` and the caller keeps its defaults):

        1. exact ``(platform, floor(log2 n), span_mix)``;
        2. same bucket, ``span_mix="mixed"``;
        3. the nearest measured bucket of the platform, preferring the
           requested mix at equal distance (winners drift slowly in
           ``log n``).
        """
        b = n_bucket(n)
        with self._lock:
            entries = dict(self._entries)
        for mix in ((span_mix, "mixed") if span_mix != "mixed"
                    else ("mixed",)):
            hit = entries.get((platform, b, mix))
            if hit is not None:
                return hit
        best: Optional[Tuple[int, int, TunedConfig]] = None
        for (p, eb, mix), cfg in entries.items():
            if p != platform:
                continue
            mix_rank = 0 if mix == span_mix else (
                1 if mix == "mixed" else 2)
            if mix_rank == 2:
                continue
            key = (abs(eb - b), mix_rank)
            if best is None or key < (best[0], best[1]):
                best = (abs(eb - b), mix_rank, cfg)
        return best[2] if best is not None else None

    def as_json(self) -> dict:
        with self._lock:
            entries = sorted(self._entries.items())
        return {
            "schema_version": SCHEMA_VERSION,
            "entries": [
                {"platform": p, "n_bucket": b, "span_mix": mix,
                 **cfg.as_dict()}
                for (p, b, mix), cfg in entries
            ],
        }

    def save(self, path: str) -> None:
        """Write atomically (a temporary file, then ``os.replace``), so an
        interrupted save never leaves a truncated cache behind."""
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.as_json(), f, indent=2)
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def from_json(cls, doc: dict, source: Optional[str] = None
                  ) -> "TuningCache":
        """Validate and materialize a cache document; raises
        :class:`TuningCacheError` on a version or shape mismatch."""
        where = source or "<dict>"
        if not isinstance(doc, dict):
            raise TuningCacheError(
                f"{where}: tuning cache must be a JSON object, "
                f"got {type(doc).__name__}")
        version = doc.get("schema_version")
        if version not in _READABLE_VERSIONS:
            raise TuningCacheError(
                f"{where}: unsupported tuning cache schema_version "
                f"{version!r} (this build reads versions "
                f"{_READABLE_VERSIONS}; "
                "regenerate with `python -m repro_torch.tune`)")
        entries = doc.get("entries")
        if not isinstance(entries, list):
            raise TuningCacheError(
                f"{where}: 'entries' must be a list, "
                f"got {type(entries).__name__}")
        cache = cls()
        cache.source = source
        for i, e in enumerate(entries):
            if not isinstance(e, dict):
                raise TuningCacheError(
                    f"{where}: entry {i} must be an object")
            for key, typ in _REQUIRED_ENTRY_KEYS.items():
                if key not in e:
                    raise TuningCacheError(
                        f"{where}: entry {i} missing key {key!r}")
                if not isinstance(e[key], typ) or (
                        typ is int and isinstance(e[key], bool)):
                    raise TuningCacheError(
                        f"{where}: entry {i} key {key!r} must be "
                        f"{typ.__name__}, got {type(e[key]).__name__}")
            if e["span_mix"] not in SPAN_MIXES:
                raise TuningCacheError(
                    f"{where}: entry {i} span_mix {e['span_mix']!r} not "
                    f"in {SPAN_MIXES}")
            try:
                cfg = TunedConfig(
                    c=e["c"], t=e["t"], backend=e["backend"],
                    planner=e["planner"],
                    long_cutoff=e.get("long_cutoff"),
                    scan_chunks=e["scan_chunks"],
                    sparse_top=e["sparse_top"],
                    ns_per_query=e.get("ns_per_query"),
                    bulk_crossover=e.get("bulk_crossover"),
                    # v1 entries predate the compact layouts
                    packed_pos=e.get("packed_pos", False),
                    summary_dtype=e.get("summary_dtype", "float32"),
                )
            except ValueError as err:
                raise TuningCacheError(
                    f"{where}: entry {i} invalid: {err}") from err
            with cache._lock:
                cache._entries[
                    (e["platform"], e["n_bucket"], e["span_mix"])] = cfg
        return cache

    @classmethod
    def load(cls, path: str) -> "TuningCache":
        """Load and schema-validate a cache file (it must exist)."""
        with open(path) as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as err:
                raise TuningCacheError(
                    f"{path}: not valid JSON: {err}") from err
        return cls.from_json(doc, source=path)


_default_cache: Optional[TuningCache] = None
_default_lock = threading.Lock()


def default_cache(refresh: bool = False) -> TuningCache:
    """The committed tuning cache (``results/tuning_cache_torch.json``).

    Loaded once per process; a missing file gives an empty cache (every
    lookup misses, every consumer keeps its defaults), an invalid one
    raises :class:`TuningCacheError`.  ``REPRO_TORCH_TUNING_CACHE``
    overrides the path (empty: load nothing).
    """
    global _default_cache
    with _default_lock:
        if _default_cache is not None and not refresh:
            return _default_cache
        path = os.environ.get(_CACHE_PATH_ENV, DEFAULT_CACHE_PATH)
        if path and os.path.exists(path):
            _default_cache = TuningCache.load(path)
        else:
            _default_cache = TuningCache()
        return _default_cache
