"""rwkv6-7b — Finch, data-dependent decay, attention-free
(arXiv:2404.05892; the published RWKV-6 World 7B shape).

32L d_model=4096 d_ff=14336 vocab=65536, head size 64 -> 64 WKV heads.
Port of `repro/configs/rwkv6_7b.py`: the fields the port reads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096, d_ff=14336,
    vocab=65536, rwkv_version=6, n_heads=64, rwkv_head_dim=64,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm", n_layers=2, d_model=64, d_ff=128,
    vocab=256, rwkv_version=6, n_heads=4, rwkv_head_dim=16,
)


def get(arch_id: str) -> ModelConfig:
    del arch_id
    return CONFIG


def smoke(arch_id: str) -> ModelConfig:
    del arch_id
    return SMOKE
