"""Back-compat shim: the metrics live in :mod:`repro_torch.obs.metrics`.

As in the reference (``repro.serving.metrics``), the serving tier was the
first metrics consumer; the engine and the query service share the same
registry tree, so the implementation lives in the cross-cutting ``obs``
package and ``from repro_torch.serving.metrics import Metrics`` keeps
working through this re-export.
"""

from repro_torch.obs.metrics import (  # noqa: F401
    LATENCY_BUCKETS,
    SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Metrics,
)

__all__ = ["Counter", "Gauge", "Histogram", "Metrics", "LATENCY_BUCKETS",
           "SIZE_BUCKETS"]
