"""Deterministic, shardable, restart-safe synthetic token pipeline.

The port's copy of ``repro.data.pipeline.SyntheticTokenDataset`` (numpy
only, so it gives the reference's batches bit for bit).  Every batch is a
pure function of ``(seed, step, shard_id)``: no iterator state exists, so

* **restart safety**: resuming at step k reproduces exactly the batches
  k, k+1, ... that the lost run would have seen (a checkpoint records only
  the step);
* **sharding**: each data shard draws its disjoint slice of the global
  batch by folding ``shard_id`` into the counter-based RNG (numpy Philox);
* **elasticity**: re-sharding is re-partitioning the ``global_batch``
  range.

The reference's ``make_batch_specs`` serves only its JAX dry run and has
no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["SyntheticTokenDataset"]


@dataclasses.dataclass(frozen=True)
class SyntheticTokenDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard_id: int = 0
    prefix_tokens: int = 0       # frontend prefix positions (embeddings)
    d_model: int = 0

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of {self.num_shards} shards")
        if not 0 <= self.shard_id < self.num_shards:
            raise ValueError(f"shard_id {self.shard_id} out of range")

    @property
    def shard_batch(self) -> int:
        return self.global_batch // self.num_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for ``step``: a pure function of (seed, step, shard_id)."""
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=[0, 0, step,
                                                     self.shard_id]))
        tokens = rng.integers(0, self.vocab_size,
                              (self.shard_batch, self.seq_len),
                              dtype=np.int32)
        out = {"tokens": tokens}
        if self.prefix_tokens:
            out["prefix"] = rng.standard_normal(
                (self.shard_batch, self.prefix_tokens, self.d_model)
            ).astype(np.float32) * 0.02
        return out

    def reshard(self, num_shards: int, shard_id: int
                ) -> "SyntheticTokenDataset":
        """Elastic re-mesh: same global batches, different shard slices."""
        return dataclasses.replace(self, num_shards=num_shards,
                                   shard_id=shard_id)
