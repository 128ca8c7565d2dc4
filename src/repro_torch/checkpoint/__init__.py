"""Checkpoints of tensor trees: one directory per step, atomic publish."""

from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]
