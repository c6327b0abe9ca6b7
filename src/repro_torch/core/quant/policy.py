"""Which parameters the serving plane quantizes (port of the classifier in
`repro/core/quant/policy.py`).

Weights that multiply activations (≥2-D projections) get Δ-PoT; weights
used additively or element-wise (token-shift μ, decay, bonus, LayerNorm
γ/β, embeddings — matched by path) stay as they are.
"""
from __future__ import annotations

import re
from typing import Any

# path substrings that force the uniform branch even for 2-D tensors
_ADDITIVE_HINTS = re.compile(
    r"(embed|emb_|ln|norm|scale|bias|mu_|time_mix|time_decay|time_first|"
    r"decay|bonus|gamma|beta|_shift|pos_emb|a_log|dt_bias|conv)",
    re.IGNORECASE,
)


def classify_param(path: str, leaf: Any) -> str:
    """'matmul' | 'additive' | 'skip' for a parameter leaf.  `path` is the
    JAX key string form, e.g. "['blocks']['att']['wr']"."""
    if not hasattr(leaf, "ndim"):
        return "skip"
    if leaf.ndim < 2:
        return "additive"
    if _ADDITIVE_HINTS.search(path):
        return "additive"
    return "matmul"
