"""minitron-4b [dense] — pruned Nemotron: LayerNorm, squared-ReLU MLP,
head dim 128, large vocab (arXiv:2407.14679).

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.  Port of
`repro/configs/minitron_4b.py`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab=256000, act="relu_sq", norm="layernorm",
)

SMOKE = ModelConfig(
    name="minitron-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=192, vocab=512, act="relu_sq", norm="layernorm",
)
