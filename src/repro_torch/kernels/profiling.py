"""Launch accounting: the launch-count contract and the launch registry.

Two counts exist side by side, for two different questions:

* :func:`record_launch` files one *logical* launch under a kernel name,
  on every path, the plain CPU one included (``lowering="eager"``).  It
  makes the reference's launch-count contract assertable on any device:

      with count_launches() as counts:
          build_hierarchy_fused(x, plan)
      assert counts == {"hierarchy_fused": 1}

  Outside a :func:`count_launches` / :func:`launch_registry` scope it is
  one global load and nothing else.
* :class:`KernelCounter` is a plain integer on each kernel wrapper that
  goes up by one exactly where the wrapper launches its CUDA kernel and
  nowhere else, so a run on the card can show that its main path really
  went through the hand-written kernels.

Unlike the reference (which records while tracing, once per jit
specialization), PyTorch runs eagerly: every call records.

Three more tables ride on an active :func:`launch_registry`:
:func:`record_config` files configuration decisions (the engine's
``engine_tuned_config``) without touching any launch count,
``launch_registry(timing=True)`` makes :func:`timed_dispatch` time each
dispatch site to completion (``torch.cuda.synchronize`` on the card), and
:meth:`LaunchRegistry.attach_cost` files a cost estimate (FLOPs, bytes)
per name, from anything with the reference's ``cost_analysis()``, a
mapping of scalars, or a finished ``torch.utils.flop_counter.
FlopCounterMode`` (its total becomes ``flops``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections.abc import Mapping
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "KernelCounter",
    "LaunchRecord",
    "LaunchRegistry",
    "count_launches",
    "current_registry",
    "launch_registry",
    "operand_bytes",
    "record_config",
    "record_launch",
    "timed_dispatch",
]


def operand_bytes(*tensors) -> int:
    """Total byte footprint of the given tensors (``None`` skipped)."""
    return int(sum(t.numel() * t.element_size()
                   for t in tensors if t is not None))


class KernelCounter:
    """Launches of one hand-written kernel, counted where it launches.

    Locked: the serving tier launches from its flusher thread and from
    the threads of oversized submissions at once."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self._lock = threading.Lock()

    def hit(self) -> None:
        with self._lock:
            self.launches += 1

    def reset(self) -> None:
        self.launches = 0


_counts: Optional[Dict[str, int]] = None
_registry: Optional["LaunchRegistry"] = None


@dataclasses.dataclass
class LaunchRecord:
    """One recorded launch with the facts its wrapper knew."""

    name: str
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"name": self.name, **self.meta}


class LaunchRegistry:
    """Thread-safe collection of launch records, keyed by kernel name."""

    def __init__(self, timing: bool = False):
        self._lock = threading.Lock()
        self.timing = bool(timing)
        self.records: List[LaunchRecord] = []
        self.timings: Dict[str, List[float]] = {}
        self.costs: Dict[str, Dict[str, float]] = {}
        self.configs: List[LaunchRecord] = []

    def add(self, name: str, meta: Dict[str, Any]) -> None:
        with self._lock:
            self.records.append(LaunchRecord(name, dict(meta)))

    def add_config(self, name: str, meta: Dict[str, Any]) -> None:
        """File a configuration decision; never a launch."""
        with self._lock:
            self.configs.append(LaunchRecord(name, dict(meta)))

    def add_timing(self, name: str, seconds: float) -> None:
        with self._lock:
            self.timings.setdefault(name, []).append(float(seconds))

    def attach_cost(self, name: str, source: Any) -> Dict[str, float]:
        """File a FLOP / byte estimate for ``name``; returns it.

        ``source`` is anything exposing ``cost_analysis()`` (the
        reference's compiled callables; a one-element list of dicts is
        unwrapped as the reference's ``cost_analysis_dict`` does), a
        finished ``torch.utils.flop_counter.FlopCounterMode`` (its
        ``get_total_flops()`` becomes ``flops``), or a mapping.  Only the
        scalar entries are kept, as floats.
        """
        if hasattr(source, "cost_analysis"):
            raw = source.cost_analysis() or {}
            if isinstance(raw, (list, tuple)):
                raw = raw[0] if raw else {}
        elif hasattr(source, "get_total_flops"):
            raw = {"flops": source.get_total_flops()}
        elif isinstance(source, Mapping):
            raw = source
        else:
            raise TypeError(
                "attach_cost takes an object with cost_analysis(), a "
                "FlopCounterMode or a mapping of scalars, got "
                f"{type(source).__name__}")
        cost = {k: float(v) for k, v in dict(raw).items()
                if isinstance(v, (int, float))}
        with self._lock:
            self.costs[name] = cost
        return cost

    @property
    def counts(self) -> Dict[str, int]:
        """``{kernel name: launch count}`` over the recorded launches."""
        out: Dict[str, int] = {}
        with self._lock:
            for rec in self.records:
                out[rec.name] = out.get(rec.name, 0) + 1
        return out

    def operand_bytes(self) -> Dict[str, int]:
        """Total ``operand_bytes`` attributed per kernel."""
        out: Dict[str, int] = {}
        with self._lock:
            for rec in self.records:
                b = rec.meta.get("operand_bytes")
                if b is not None:
                    out[rec.name] = out.get(rec.name, 0) + int(b)
        return out

    def as_dict(self) -> dict:
        """``counts`` and ``launches``, plus ``configs``, ``timings_s``
        (calls, total, mean, max a site) and ``cost_estimates`` where any
        were recorded: the reference's shape, which a benchmark files
        beside its result."""
        with self._lock:
            records = [r.as_dict() for r in self.records]
            timings = {k: list(v) for k, v in self.timings.items()}
            costs = {k: dict(v) for k, v in self.costs.items()}
            configs = [r.as_dict() for r in self.configs]
        counts: Dict[str, int] = {}
        for r in records:
            counts[r["name"]] = counts.get(r["name"], 0) + 1
        out: dict = {"counts": counts, "launches": records}
        if configs:
            out["configs"] = configs
        if timings:
            out["timings_s"] = {
                k: {"calls": len(v), "total": sum(v),
                    "mean": sum(v) / len(v), "max": max(v)}
                for k, v in timings.items()
            }
        if costs:
            out["cost_estimates"] = costs
        return out


def record_launch(name: str, **meta: Any) -> None:
    """Record one launch under ``name`` (no-op when nothing is counting)."""
    if _counts is not None:
        _counts[name] = _counts.get(name, 0) + 1
    if _registry is not None:
        _registry.add(name, meta)


def record_config(name: str, **meta: Any) -> None:
    """Record a configuration decision (no-op when no registry is active).

    It never touches the launch counts: :func:`count_launches` results
    are the same whether or not an engine records its config.
    """
    if _registry is not None:
        _registry.add_config(name, meta)


@contextlib.contextmanager
def count_launches() -> Iterator[Dict[str, int]]:
    """Collect ``{kernel name: launches}`` recorded inside the block."""
    global _counts
    prev = _counts
    _counts = {}
    try:
        yield _counts
    finally:
        _counts = prev


@contextlib.contextmanager
def launch_registry(timing: bool = False) -> Iterator[LaunchRegistry]:
    """Collect full :class:`LaunchRecord`\\ s for the block (and, with
    ``timing=True``, the wall times of :func:`timed_dispatch` sites)."""
    global _registry
    prev = _registry
    reg = LaunchRegistry(timing=timing)
    _registry = reg
    try:
        yield reg
    finally:
        _registry = prev


def current_registry() -> Optional[LaunchRegistry]:
    """The active :func:`launch_registry`'s registry, else ``None``."""
    return _registry


def timed_dispatch(name: str, fn, *args, **kwargs):
    """Call ``fn(*args, **kwargs)``; under a timing registry, record the
    wall time to completion.

    With no timing registry active this is one global load and a tail
    call.  With one, the call is followed by ``torch.cuda.synchronize()``
    when a card is present, so device work is inside the time; that
    barrier serializes dispatch sites, so timing is an offline mode.
    """
    reg = _registry
    if reg is None or not reg.timing:
        return fn(*args, **kwargs)
    import torch

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    reg.add_timing(name, time.perf_counter() - t0)
    return out
