"""RWKV-4 — the paper's own model family (BlinkDL/rwkv-4-pile sizes).

  169M: L12 D768     430M: L24 D1024    1.5B: L24 D2048
  3B:   L32 D2560    7B:   L32 D4096
vocab 50277 (pile tokenizer), LayerNorm, channel-mix d_ff = 4·d_model.
"""
from repro_torch.configs.base import ModelConfig

_SIZES = {
    "rwkv4-169m": (12, 768),
    "rwkv4-430m": (24, 1024),
    "rwkv4-1b5": (24, 2048),
    "rwkv4-3b": (32, 2560),
    "rwkv4-7b": (32, 4096),
}


def get(arch_id: str) -> ModelConfig:
    n_layers, d_model = _SIZES[arch_id]
    return ModelConfig(
        name=arch_id, n_layers=n_layers, d_model=d_model,
        d_ff=4 * d_model, vocab=50277, rwkv_version=4,
    )


def smoke(arch_id: str) -> ModelConfig:
    return ModelConfig(
        name=f"{arch_id}-smoke", n_layers=2, d_model=64, d_ff=256,
        vocab=256, rwkv_version=4,
    )
