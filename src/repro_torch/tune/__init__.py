"""``repro_torch.tune``: geometry autotuning for the RMQ hierarchy.

The port of ``repro.tune`` (paper §4, Fig. 12: no single ``(c, t)`` or
engine wins across sizes and span mixes, so the choice is measured):

* :mod:`repro_torch.tune.measure`: the paper's workloads and the timing
  discipline (:func:`time_fn`);
* :mod:`repro_torch.tune.search`: the :class:`Autotuner`, which races
  candidate geometries through the routed and the fused engines on a
  device, per span mix, and measures the ``long_cutoff`` and
  ``bulk_crossover`` crossovers;
* :mod:`repro_torch.tune.cache`: the versioned JSON tuning cache
  (:class:`TuningCache` / :class:`TunedConfig`) that
  ``make_plan(..., tuned=True)``, ``RMQ.build(c="auto")`` and
  ``QueryEngine(tuning=...)`` read, keyed by the index's device.

Regenerate the committed cache on the card with
``python -m repro_torch.tune``.
"""

from repro_torch.tune.cache import (
    DEFAULT_CACHE_PATH,
    SCHEMA_VERSION,
    SPAN_MIXES,
    TunedConfig,
    TuningCache,
    TuningCacheError,
    current_platform,
    default_cache,
    n_bucket,
)
from repro_torch.tune.measure import (
    make_input_array,
    make_queries,
    make_span_queries,
    time_fn,
)
from repro_torch.tune.search import (
    DEFAULT_GEOMETRIES,
    TINY_GEOMETRIES,
    Autotuner,
    Measurement,
    SkippedConfig,
)

__all__ = [
    "Autotuner",
    "DEFAULT_CACHE_PATH",
    "DEFAULT_GEOMETRIES",
    "Measurement",
    "SCHEMA_VERSION",
    "SPAN_MIXES",
    "SkippedConfig",
    "TINY_GEOMETRIES",
    "TunedConfig",
    "TuningCache",
    "TuningCacheError",
    "current_platform",
    "default_cache",
    "make_input_array",
    "make_queries",
    "make_span_queries",
    "n_bucket",
    "time_fn",
]
