"""Modality frontend stubs: the shape of the prefix embeddings a ``vlm`` /
``audio`` trunk consumes, and seeded stand-ins for them.

The port of ``repro.models.frontends``.  The assigned architectures give
the transformer trunk only; the frontend (a ViT, an EnCodec conditioner)
is a stub that provides ``(batch, frontend_tokens, d_model)`` precomputed
embeddings, which ``models.lm`` concatenates ahead of the token
embeddings.  The stand-ins are normal values times 0.02 from a seeded
``torch.Generator`` on the given device; they cannot repeat the
reference's ``jax.random`` bits, so tests pass the same numpy array into
both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import resolve_device

__all__ = ["frontend_embedding_shape", "synthetic_frontend_embeddings"]


def frontend_embedding_shape(cfg: ModelConfig, batch: int
                             ) -> Optional[Tuple[int, int, int]]:
    """``(batch, frontend_tokens, d_model)``, or None without a frontend."""
    if not cfg.frontend:
        return None
    return (batch, cfg.frontend_tokens, cfg.d_model)


def synthetic_frontend_embeddings(cfg: ModelConfig, batch: int,
                                  seed: int = 0, device=None
                                  ) -> Optional[torch.Tensor]:
    """float32 stand-in embeddings on ``device`` (default: the card), or
    None without a frontend."""
    shape = frontend_embedding_shape(cfg, batch)
    if shape is None:
        return None
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev,
                       dtype=torch.float32) * 0.02
