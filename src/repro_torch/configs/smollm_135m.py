"""smollm-135m [dense] — llama-arch small (hf:HuggingFaceTB/SmolLM-135M).

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, RMSNorm, SwiGLU,
RoPE, tied embeddings.  Port of `repro/configs/smollm_135m.py`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab=49152, act="swiglu", norm="rmsnorm",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-135m-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, act="swiglu", norm="rmsnorm",
    tie_embeddings=True,
)
