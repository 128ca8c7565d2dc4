"""Serving: the batched generation engine and RMQ-backed KV eviction."""

from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.eviction import RMQEvictionManager

__all__ = ["RMQEvictionManager", "ServeEngine"]
