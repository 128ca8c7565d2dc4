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
``timed_dispatch`` is not ported yet (ROADMAP A7).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "KernelCounter",
    "LaunchRecord",
    "LaunchRegistry",
    "count_launches",
    "launch_registry",
    "operand_bytes",
    "record_launch",
]


def operand_bytes(*tensors) -> int:
    """Total byte footprint of the given tensors (``None`` skipped)."""
    return int(sum(t.numel() * t.element_size()
                   for t in tensors if t is not None))


class KernelCounter:
    """Launches of one hand-written kernel, counted where it launches."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def hit(self) -> None:
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


class LaunchRegistry:
    """Thread-safe collection of launch records, keyed by kernel name."""

    def __init__(self):
        self._lock = threading.Lock()
        self.records: List[LaunchRecord] = []

    def add(self, name: str, meta: Dict[str, Any]) -> None:
        with self._lock:
            self.records.append(LaunchRecord(name, dict(meta)))

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


def record_launch(name: str, **meta: Any) -> None:
    """Record one launch under ``name`` (no-op when nothing is counting)."""
    if _counts is not None:
        _counts[name] = _counts.get(name, 0) + 1
    if _registry is not None:
        _registry.add(name, meta)


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
def launch_registry() -> Iterator[LaunchRegistry]:
    """Collect full :class:`LaunchRecord`\\ s for the block."""
    global _registry
    prev = _registry
    reg = LaunchRegistry()
    _registry = reg
    try:
        yield reg
    finally:
        _registry = prev
