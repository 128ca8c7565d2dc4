"""RMQ-backed KV-cache eviction: the paper's data structure as a serving
feature.

The port of ``repro.serve.eviction``.  During long-context decode each
sequence accumulates per-token importance scores (attention probability
mass).  When the live token count exceeds the budget, the manager splits
the evictable region ``[0, live - protected_window)`` into
``evict_count`` equal windows and takes ``RMQ_index`` in each: one batch
of range-minimum queries per round, spread over the context.

Two entry points, as in the reference:

* :meth:`RMQEvictionManager.plan_evictions`: one-shot, over a throwaway
  index (offline callers; the oracle of the streaming path);
* :meth:`RMQEvictionManager.make_index` +
  :meth:`RMQEvictionManager.plan_evictions_streaming`: the serving hot
  path, one :class:`~repro_torch.streaming.StreamingRMQ` per generation,
  synced each round with one dense batched update and queried through one
  span-routed engine (``cache_size=0``) re-attached every round.

The reference's default backend is ``"jax"``, its plain path.  The
port's default is ``"auto"``: on the card the index is built by
``hierarchy_build`` (B3), synced by ``hierarchy_update`` (B6) and
queried through ``rmq_short`` (B5) and ``rmq_scan`` (B4) by span class;
``backend="eager"`` is the plain path.  Routing eviction through the
serving tier (``attach_serving``) waits for ROADMAP A8.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.api import RMQ
from repro_torch.streaming import StreamingRMQ

__all__ = ["RMQEvictionManager"]

_TIER_REFUSAL = ("routing eviction through the serving tier needs "
                 "repro_torch.serving, which is not ported yet (ROADMAP A8)")


@dataclasses.dataclass(frozen=True)
class RMQEvictionManager:
    budget: int                 # max live tokens per sequence
    protected_window: int = 256  # never evict the most recent tokens
    c: int = 128
    t: int = 16
    backend: str = "auto"

    def needs_eviction(self, live_tokens: int) -> bool:
        return live_tokens > self.budget

    # -- shared window geometry -------------------------------------------
    def _plan_round(self, live_tokens: int):
        """(evictable, evict_count) for a round, or None if nothing to do."""
        evict_count = live_tokens - self.budget
        if evict_count <= 0:
            return None
        evictable = live_tokens - self.protected_window
        if evictable <= 0:
            return None
        return evictable, min(evict_count, evictable)

    @staticmethod
    def _windows(evictable: int, evict_count: int):
        """One RMQ window per victim, disjoint, covering [0, evictable).

        The bounds are the reference's float32 ``linspace(0, evictable,
        evict_count + 1)`` truncated to int32, with its arithmetic as XLA
        compiles it (``(evictable * (1 / evict_count)) * i`` in float32,
        the end point exact), so both packages query the same windows.
        """
        scale = np.float32(evictable) * (np.float32(1) /
                                         np.float32(evict_count))
        inner = scale * np.arange(evict_count, dtype=np.float32)
        bounds = np.append(inner, np.float32(evictable)).astype(np.int32)
        ls = bounds[:-1]
        rs = np.maximum(bounds[1:] - 1, ls)
        return ls, rs

    @staticmethod
    def _sorted(victims: torch.Tensor) -> torch.Tensor:
        return torch.sort(victims).values.to(torch.int32)

    # -- one-shot path (offline / reference) ------------------------------
    def plan_evictions(self, scores: torch.Tensor,
                       live_tokens: int) -> torch.Tensor:
        """Indices (ascending, unique) of tokens to evict this round, on
        ``scores``' device."""
        round_ = self._plan_round(live_tokens)
        if round_ is None:
            return torch.zeros((0,), dtype=torch.int32, device=scores.device)
        evictable, evict_count = round_
        # The chunk size must stay a power of two even when the evictable
        # region is smaller than self.c.
        c_fit = min(self.c, max(2, evictable))
        c_fit = 1 << (c_fit.bit_length() - 1)   # largest pow2 <= c_fit
        rmq = RMQ.build(scores[:evictable], c=c_fit, t=self.t,
                        with_positions=True, backend=self.backend,
                        device=scores.device)
        ls, rs = self._windows(evictable, evict_count)
        victims = rmq.engine(cache_size=0).query_index(ls, rs)
        # windows are disjoint and each argmin lies in its window => unique
        return self._sorted(victims)

    # -- streaming path (serving hot loop) --------------------------------
    def make_index(self, capacity: int, device=None) -> StreamingRMQ:
        """One-time index over ``capacity`` score slots (all ``+inf``), on
        ``device`` (default: the card)."""
        x = torch.full((capacity,), float("inf"), dtype=torch.float32)
        return StreamingRMQ.from_array(
            x, c=self.c, t=self.t, with_positions=True, backend=self.backend,
            device=device)

    def attach_serving(self, tier, tenant: str = "kv-eviction", *,
                       slo_ms: float = 2.0) -> None:
        raise NotImplementedError(_TIER_REFUSAL)

    def _engine_for(self, index: StreamingRMQ):
        """One persistent query engine per manager, re-attached each round.

        The manager dataclass is frozen (it is config); the engine is
        runtime state, parked on the instance dict.
        """
        eng = self.__dict__.get("_engine")
        if eng is None:
            eng = index.engine(cache_size=0)
            object.__setattr__(self, "_engine", eng)
        else:
            eng.attach(index)
        return eng

    def plan_evictions_streaming(
        self,
        index: StreamingRMQ,
        slot_scores: torch.Tensor,  # (capacity,) live scores, +inf beyond
        live_tokens: int,
    ) -> Tuple[StreamingRMQ, torch.Tensor]:
        """Sync the index with this round's scores and pick victims.

        Decode adds attention mass to every live score each step, so the
        sync is dense: one batched update over every slot, which
        re-reduces every chunk (no rebuild, no re-planning).
        """
        round_ = self._plan_round(live_tokens)
        if round_ is None:
            return index, torch.zeros((0,), dtype=torch.int32,
                                      device=index.device)
        evictable, evict_count = round_
        index = index.update(
            torch.arange(index.capacity, dtype=torch.int32,
                         device=index.device),
            slot_scores.to(index.device))
        ls, rs = self._windows(evictable, evict_count)
        victims = self._engine_for(index).query_index(ls, rs)
        return index, self._sorted(victims)

    def apply_evictions(
        self,
        victims: torch.Tensor,      # (E,) ascending indices
        scores: torch.Tensor,       # (S_live,)
        live_tokens: int,
        *cache_arrays: torch.Tensor,  # arrays with a length-S_live axis
        token_axis: int = 0,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...], int]:
        """Compact scores and cache arrays by deleting ``victims`` rows."""
        e = int(victims.shape[0])
        if e == 0:
            return scores, cache_arrays, live_tokens
        keep = torch.ones((live_tokens,), dtype=torch.bool,
                          device=scores.device)
        keep[victims.long()] = False
        keep_idx = torch.nonzero(keep).reshape(-1)
        new_scores = torch.index_select(scores, 0, keep_idx)
        new_caches = tuple(
            torch.index_select(a, token_axis, keep_idx.to(a.device))
            for a in cache_arrays)
        return new_scores, new_caches, live_tokens - e
