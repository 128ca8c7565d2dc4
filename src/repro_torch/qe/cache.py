"""Result cache for the batched query engine.

Two layers, both host-side (results are scalars — a float or an int —
so the cache never pins device memory):

* **within-batch dedup** lives in the engine (``np.unique`` over the
  ``(l, r)`` pairs); this module only sees deduplicated queries;
* **cross-batch LRU** keyed by ``(op, generation, l, r)``.  The
  generation is the index's monotonic mutation counter —
  ``RMQ.update``/``append`` (and the streaming mutators) return a
  successor with ``generation + 1``, so entries computed against an
  older array version can never be returned for the new one.  Stale
  generations age out of the LRU naturally.

The cache is shared between the serving tier's flusher thread and any
caller thread that queries an engine directly, so every operation —
including the hit/miss bookkeeping, where ``x += 1`` is not atomic under
the GIL — runs under one lock.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Hashable, Optional, Tuple

__all__ = ["ResultCache"]


class ResultCache:
    """Bounded LRU mapping ``(op, generation, l, r) -> scalar result``.

    Thread-safe: one lock covers the OrderedDict and the hit/miss/
    eviction counters, so ``stats()`` is always a consistent snapshot.
    """

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._d: "OrderedDict[Tuple[Hashable, ...], object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, op: str, generation: int, l: int, r: int):
        """The cached result, or None on miss (results are never None)."""
        with self._lock:
            if self.capacity == 0:
                self.misses += 1
                return None
            key = (op, generation, l, r)
            val = self._d.get(key)
            if val is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return val

    def put(self, op: str, generation: int, l: int, r: int, value) -> None:
        if self.capacity == 0:
            return
        key = (op, generation, l, r)
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def hit_rate(self) -> float:
        """Hits / lookups over the cache's lifetime (0.0 when untouched)."""
        with self._lock:
            total = self.hits + self.misses
            return self.hits / total if total else 0.0

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "entries": len(self._d),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }
