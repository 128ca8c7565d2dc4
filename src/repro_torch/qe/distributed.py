"""The distributed executor's names; the executor waits for ROADMAP A10.

``repro.qe.distributed`` routes a segment-sharded index's batches by
whether a span stays inside one segment (``SEG_LOCAL``) or crosses one
(``CROSSING``).  The port has no distributed index yet, so
:class:`DistributedExecutor` refuses to be built, as the engine refuses a
distributed index (``qe/engine.py``).
"""

from __future__ import annotations

__all__ = ["SEG_LOCAL", "CROSSING", "DistributedExecutor"]

SEG_LOCAL = "seg_local"
CROSSING = "crossing"


class DistributedExecutor:
    """Refused until the port has a distributed index (ROADMAP A10)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the distributed executor needs a distributed index, which is "
            "not ported yet (ROADMAP A10)")
