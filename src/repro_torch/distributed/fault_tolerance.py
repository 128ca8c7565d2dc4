"""Fault tolerance: heartbeats, straggler detection, elastic re-mesh.

The port of ``repro.distributed.fault_tolerance``, which is host logic in
pure Python, kept here as a copy so that the port imports nothing of the
reference.  The CPU tests drive it with simulated hosts and injected
failures; ``launch/train.py`` reports each step to a
:class:`HeartbeatMonitor` of one host a rank.

* :class:`HeartbeatMonitor`: hosts report per-step completion times;
  ``stragglers()`` flags hosts slower than ``threshold x`` the fleet
  median over a sliding window; ``dead()`` flags hosts silent for
  ``dead_timeout`` seconds; ``exclude()`` drops a host from both.
* :func:`plan_remesh`: given the surviving chip count, the largest
  production mesh that fits ((2, 16, 16), (1, 16, 16), (16, 16), (8, 16)
  ...), keeping the ``model`` axis whole (tensor-sharded weights keep
  their axis; only the data-parallel width shrinks).
* :func:`global_batch_for`: the elastic batch policy, data-parallel width
  times the per-replica batch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class HeartbeatMonitor:
    num_hosts: int
    straggler_threshold: float = 2.0     # x median step time
    dead_timeout: float = 60.0           # seconds of silence
    window: int = 16

    def __post_init__(self):
        self._beats: Dict[int, List[Tuple[int, float]]] = {
            h: [] for h in range(self.num_hosts)
        }
        self._excluded: set = set()

    def report(self, host: int, step: int, t: Optional[float] = None):
        if host in self._excluded:
            return
        self._beats[host].append((step, t if t is not None else time.time()))
        self._beats[host] = self._beats[host][-self.window :]

    def step_times(self, host: int) -> List[float]:
        beats = self._beats[host]
        return [b[1] - a[1] for a, b in zip(beats, beats[1:])]

    def stragglers(self) -> List[int]:
        per_host = {
            h: (sum(ts) / len(ts))
            for h, ts in ((h, self.step_times(h))
                          for h in self._beats if h not in self._excluded)
            if ts
        }
        if len(per_host) < 2:
            return []
        med = sorted(per_host.values())[len(per_host) // 2]
        return [
            h for h, t in per_host.items()
            if t > self.straggler_threshold * med
        ]

    def dead(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        out = []
        for h, beats in self._beats.items():
            if h in self._excluded:
                continue
            if not beats or now - beats[-1][1] > self.dead_timeout:
                out.append(h)
        return out

    def exclude(self, host: int):
        self._excluded.add(host)

    @property
    def active_hosts(self) -> int:
        return self.num_hosts - len(self._excluded)


# Production mesh ladder: preserve the model axis, shrink data parallelism.
_MESH_LADDER: Sequence[Tuple[Tuple[int, ...], Tuple[str, ...]]] = (
    ((2, 16, 16), ("pod", "data", "model")),
    ((1, 16, 16), ("pod", "data", "model")),
    ((16, 16), ("data", "model")),
    ((8, 16), ("data", "model")),
    ((4, 16), ("data", "model")),
    ((2, 16), ("data", "model")),
    ((1, 16), ("data", "model")),
)


def plan_remesh(available_chips: int,
                require_model: int = 16) -> Tuple[Tuple[int, ...],
                                                  Tuple[str, ...]]:
    """Largest ladder entry that fits the surviving chip count."""
    for shape, axes in _MESH_LADDER:
        chips = 1
        for s in shape:
            chips *= s
        model = shape[axes.index("model")]
        if chips <= available_chips and model == require_model:
            return shape, axes
    raise RuntimeError(
        f"cannot build a mesh with model={require_model} from "
        f"{available_chips} chips"
    )


def global_batch_for(shape: Tuple[int, ...], axes: Tuple[str, ...],
                     per_replica_batch: int) -> int:
    """Data-parallel width x per-replica batch (the elastic batch policy:
    the per-replica batch stays fixed and the global batch scales with
    the survivors)."""
    dp = 1
    for s, a in zip(shape, axes):
        if a in ("pod", "data"):
            dp *= s
    return dp * per_replica_batch
