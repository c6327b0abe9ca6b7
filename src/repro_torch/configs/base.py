"""Model configuration: the `ModelConfig` fields the port's models read.

A copy of the fields of `repro/configs/base.py` that `models/rwkv4.py`
and `models/rwkv6.py` consume, with `get_config` / `smoke_config`
resolving the rwkv4 family and rwkv6-7b.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    rwkv_version: int = 0  # 4 or 6
    n_heads: int = 0              # rwkv6 WKV heads (H·N = d_model)
    rwkv_head_dim: int = 64       # rwkv6 head size N
    dtype: str = "bfloat16"


_ARCH_MODULES = {
    "rwkv4-169m": "rwkv4_family",
    "rwkv4-430m": "rwkv4_family",
    "rwkv4-1b5": "rwkv4_family",
    "rwkv4-3b": "rwkv4_family",
    "rwkv4-7b": "rwkv4_family",
    "rwkv6-7b": "rwkv6_7b",
}


def list_configs() -> list[str]:
    return list(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list_configs()}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    """The published configuration of `arch_id`."""
    return _module(arch_id).get(arch_id)


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    return _module(arch_id).smoke(arch_id)
