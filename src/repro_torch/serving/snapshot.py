"""Double-buffered index snapshots: readers pin a generation, mutations
stage onto a log that swaps in between flushes.

A copy of ``repro.serving.snapshot`` (pure Python: it only calls the
indexes' ``update`` / ``append``, which on the card run
``hierarchy_update``, B6).  The RMQ indexes are pure-functional
(``update``/``append`` return a *successor* with ``generation + 1``),
which makes snapshot isolation cheap — but the query service alone
doesn't provide it: a caller that attaches a successor mid-flush changes
what later groups in the same flush observe.  :class:`SnapshotSlot` closes that hole with the classic
double-buffer discipline:

* the **front** buffer is the currently-served index.  It is immutable;
  a reader that pinned it keeps bit-stable answers no matter what
  happens concurrently;
* the **back** buffer is a staged-mutation log (``update`` / ``append``
  / ``replace`` records).  Staging is O(1) and never blocks on reads —
  mutations admit while a long flush drains;
* :meth:`swap` folds the staged log into a successor chain and publishes
  it as the new front in one atomic reference move.  A half-applied
  batch is unobservable by construction: readers see the old front until
  the *entire* log has been applied.

``swap`` is written for a single swapper (the serving tier's flusher
owns it); concurrent *staging* and *pinning* from any number of threads
is supported.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, Tuple

__all__ = ["Snapshot", "SnapshotSlot"]

_UPDATE, _APPEND, _REPLACE = "update", "append", "replace"


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """A pinned read view: one index object, one generation, forever."""

    index: object
    generation: int
    _slot: "SnapshotSlot" = dataclasses.field(repr=False)

    def release(self) -> None:
        self._slot._release()


class SnapshotSlot:
    """Front/back double buffer over one pure-functional RMQ index."""

    def __init__(self, index):
        self._lock = threading.Lock()
        self._front = index
        self._staged: Deque[Tuple[str, tuple]] = deque()
        self._pins = 0
        self.swaps = 0
        self.staged_total = 0

    # -- read side --------------------------------------------------------
    @property
    def front(self):
        return self._front

    @property
    def generation(self) -> int:
        return getattr(self._front, "generation", 0)

    @property
    def pins(self) -> int:
        """Readers currently draining against a pinned snapshot."""
        return self._pins

    def pin(self) -> Snapshot:
        with self._lock:
            self._pins += 1
            return Snapshot(self._front, self.generation, self)

    def _release(self) -> None:
        with self._lock:
            if self._pins <= 0:
                raise RuntimeError("release() without a matching pin()")
            self._pins -= 1

    # -- write side -------------------------------------------------------
    def stage_update(self, idxs, vals) -> None:
        self._stage(_UPDATE, (idxs, vals))

    def stage_append(self, vals) -> None:
        self._stage(_APPEND, (vals,))

    def stage_replace(self, index) -> None:
        """Stage a wholesale successor (e.g. a caller-built new index).

        Replaces stack with the earlier staged ops: ops staged *before*
        it are superseded (the replacement index is the caller's own
        fold of whatever state it wanted), ops staged after apply on
        top.
        """
        with self._lock:
            self._staged.clear()
            self._staged.append((_REPLACE, (index,)))
            self.staged_total += 1

    def _stage(self, kind, args) -> None:
        with self._lock:
            self._staged.append((kind, args))
            self.staged_total += 1

    @property
    def staged(self) -> int:
        return len(self._staged)

    # -- the swap ---------------------------------------------------------
    def swap(self) -> Tuple[object, int]:
        """Apply the staged log, publish the successor, return it.

        Returns ``(front, n_applied)``; ``n_applied == 0`` means nothing
        was staged and the front is unchanged.  Single-swapper contract:
        only one thread (the tier's flusher) may call this — staging and
        pinning stay safe from any thread throughout.
        """
        with self._lock:
            staged = list(self._staged)
            self._staged.clear()
            front = self._front
        if not staged:
            return front, 0
        # Fold outside the lock: successor construction runs real device
        # work, and staging/pinning must not block behind it.  Readers
        # keep the old front until the publish below.
        for kind, args in staged:
            if kind == _UPDATE:
                front = front.update(*args)
            elif kind == _APPEND:
                front = front.append(*args)
            else:
                front = args[0]
        with self._lock:
            self._front = front
            self.swaps += 1
        return front, len(staged)

    def stats(self) -> dict:
        return {
            "generation": self.generation,
            "pins": self._pins,
            "staged": len(self._staged),
            "staged_total": self.staged_total,
            "swaps": self.swaps,
        }
