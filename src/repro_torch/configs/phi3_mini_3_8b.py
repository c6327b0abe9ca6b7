"""phi3-mini-3.8b [dense] — RoPE SwiGLU, MHA (kv == heads), head dim 96
(arXiv:2404.14219).

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.  Port of
`repro/configs/phi3_mini_3_8b.py`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064, act="swiglu", norm="rmsnorm",
)

SMOKE = ModelConfig(
    name="phi3-mini-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=256, act="swiglu", norm="rmsnorm",
)
