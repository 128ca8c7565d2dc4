"""Model, training and serving configs (the port's copy, pure data)."""

from repro_torch.configs.base import (
    ARCH_IDS,
    ModelConfig,
    RMQConfig,
    ServeConfig,
    TrainConfig,
    get_config,
    get_smoke_config,
    registry,
)

__all__ = [
    "ARCH_IDS",
    "ModelConfig",
    "RMQConfig",
    "ServeConfig",
    "TrainConfig",
    "get_config",
    "get_smoke_config",
    "registry",
]
