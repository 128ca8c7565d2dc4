"""The deterministic synthetic token pipeline."""

from repro_torch.data.pipeline import SyntheticTokenDataset

__all__ = ["SyntheticTokenDataset"]
