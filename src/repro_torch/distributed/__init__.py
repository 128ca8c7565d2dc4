"""The mesh's host logic: sharding rules, sharded trees, gradient
compression and fault tolerance (the port of ``repro.distributed``)."""

from repro_torch.distributed.shardings import (
    batch_shardings,
    cache_shardings,
    make_sharder,
    param_shardings,
    train_state_shardings,
)

__all__ = [
    "batch_shardings",
    "cache_shardings",
    "make_sharder",
    "param_shardings",
    "train_state_shardings",
]
