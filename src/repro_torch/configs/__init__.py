"""Model configurations (the rwkv4 family) for the port."""
from repro_torch.configs.base import ModelConfig, get_config, smoke_config

__all__ = ["ModelConfig", "get_config", "smoke_config"]
