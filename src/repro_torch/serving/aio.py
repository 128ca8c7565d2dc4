"""Asyncio front end for :class:`repro_torch.serving.tier.ServingTier`.

The port of ``repro.serving.aio``.  Two pieces, composable:

* :class:`AsyncServingTier` — ``await``-able submit/query wrappers.
  Tickets are ``concurrent.futures``-backed, so ``asyncio.wrap_future``
  bridges them onto the running loop with zero polling;
* :meth:`AsyncServingTier.pump` — the deadline scheduler as a coroutine:
  the same :meth:`ServingTier.step` loop the thread driver runs, but on
  the event loop via ``asyncio.sleep`` — a pure-asyncio application
  needs no background thread at all.

Use either the pump *or* ``tier.start()``'s thread, not both.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from repro_torch.obs import trace
from repro_torch.qe.executors import VALUE
from repro_torch.serving.tier import ServingTier, Ticket

__all__ = ["AsyncServingTier"]


class AsyncServingTier:
    """Awaitable facade over a (shared) :class:`ServingTier`."""

    def __init__(self, tier: ServingTier, min_sleep: float = 1e-4):
        self._tier = tier
        self._min_sleep = float(min_sleep)
        self._pumping = False

    @property
    def tier(self) -> ServingTier:
        return self._tier

    # -- awaitable request surface ----------------------------------------
    def submit(self, name: str, ls, rs, op: str = VALUE,
               slo_ms: Optional[float] = None) -> Ticket:
        """Synchronous enqueue (admission control may raise
        :class:`~repro_torch.serving.tier.Backpressure`); await the result via
        :meth:`wait` or :meth:`query`."""
        return self._tier.submit(name, ls, rs, op, slo_ms=slo_ms)

    async def wait(self, ticket: Ticket):
        """The ticket's answer, ordered on the caller's current stream
        after its flush's work (as :meth:`Ticket.result`)."""
        return ticket._ready(await asyncio.wrap_future(ticket.future))

    async def query(self, name: str, ls, rs, op: str = VALUE,
                    slo_ms: Optional[float] = None):
        """submit + await — resolves when the deadline batcher flushes
        the tenant (run :meth:`pump` or ``tier.start()`` so it does)."""
        return await self.wait(self.submit(name, ls, rs, op,
                                           slo_ms=slo_ms))

    # -- mutation passthrough (already non-blocking) ----------------------
    def update(self, name: str, idxs, vals) -> None:
        self._tier.update(name, idxs, vals)

    def append(self, name: str, vals) -> None:
        self._tier.append(name, vals)

    def replace_index(self, name: str, index) -> None:
        self._tier.replace_index(name, index)

    # -- the event-loop driver --------------------------------------------
    async def pump(self, stop: Optional[asyncio.Event] = None) -> None:
        """Drive the deadline scheduler on the event loop.

        Sleeps until the earliest pending deadline (capped at the tier's
        idle tick so new submits are picked up promptly), flushing due
        tenants each wakeup.  Cancel the task or set ``stop`` to end it;
        queued work is drained on the way out so no ticket is left
        hanging.
        """
        if self._tier.running:
            raise RuntimeError(
                "tier already has a thread driver; use one driver only"
            )
        if self._pumping:
            raise RuntimeError("pump() is already running")
        self._pumping = True
        try:
            while stop is None or not stop.is_set():
                trace.instant("pump_wakeup", driver="asyncio")
                nxt = self._tier.step()
                now = self._tier._clock()
                delay = self._tier._idle_tick if nxt is None else \
                    min(max(nxt - now, self._min_sleep),
                        self._tier._idle_tick)
                await asyncio.sleep(delay)
        finally:
            self._pumping = False
            self._tier.flush_all()
