"""Serving: the batched generation engine and RMQ-backed KV eviction.

``ServeEngine`` takes the dense GQA, SSM (mamba2) and hybrid (hymba)
families; eviction compacts the KV cache (an SSM model has none, and a
hybrid model's SSM state stays as it is)."""

from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.eviction import RMQEvictionManager

__all__ = ["RMQEvictionManager", "ServeEngine"]
