"""Model configurations (rwkv4, rwkv6 and the dense transformers) for the
port."""
from repro_torch.configs.base import (
    SHAPES, ModelConfig, ShapeConfig, get_config, smoke_config)

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "smoke_config"]
