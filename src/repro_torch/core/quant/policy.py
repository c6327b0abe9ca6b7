"""Which parameters the serving plane quantizes, and into which plane
(port of the classifier and the per-tensor plane selection in
`repro/core/quant/policy.py`).

Weights that multiply activations (≥2-D projections) get a quantized
plane; weights used additively or element-wise (token-shift μ, decay,
bonus, LayerNorm γ/β, embeddings — matched by path) stay as they are.
`PlanePolicy` picks the plane of each matmul tensor: scalar Δ-PoT W8,
nibble-packed W4, or a VQ codebook, by path override, by a fixed
default, or by the excess kurtosis of the weights.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np

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


PLANES = ("w8", "w4", "vq")


def _np_f32(w) -> np.ndarray:
    if hasattr(w, "detach"):           # a torch tensor, on any device
        w = w.detach().float().cpu().numpy()
    return np.asarray(w, np.float32)


def weight_outlier_proxy(w, sample: int = 1 << 16) -> float:
    """Excess kurtosis of the weights (~0 for Gaussian weights, large for
    heavy tails), over a deterministic strided subsample."""
    v = _np_f32(w).reshape(-1)
    if v.size > sample:
        v = v[:: (v.size + sample - 1) // sample]
    v = v - v.mean()
    var = float((v * v).mean())
    if var <= 0:
        return 0.0
    return float((v ** 4).mean() / (var * var) - 3.0)


@dataclasses.dataclass(frozen=True)
class PlanePolicy:
    """Which quantized plane each matmul tensor gets.

    default       — "proxy" (threshold `weight_outlier_proxy`) or a fixed
                    plane name ("w8" | "w4" | "vq")
    w4_max_proxy  — proxy <= this -> W4
    vq_min_proxy  — proxy >= this -> VQ; between the two, W8
    vq_codes      — codebook entries (<= 256, uint8 indices)
    overrides     — ((path regex, plane), ...) checked first, in order
    """

    default: str = "proxy"
    w4_max_proxy: float = 1.5
    vq_min_proxy: float = 8.0
    vq_codes: int = 256
    overrides: tuple = ()

    def __post_init__(self):
        if self.default not in PLANES + ("proxy",):
            raise ValueError(f"default={self.default!r}: expected one of "
                             f"{PLANES + ('proxy',)}")
        for pat, plane in self.overrides:
            if plane not in PLANES:
                raise ValueError(f"override {pat!r} -> {plane!r}: expected "
                                 f"one of {PLANES}")

    def plane_for(self, path: str, leaf) -> str:
        """The plane for one matmul leaf (callers classify first); `path`
        is the JAX key string form."""
        for pat, plane in self.overrides:
            if re.search(pat, path):
                return plane
        if self.default != "proxy":
            return self.default
        p = weight_outlier_proxy(leaf)
        if p >= self.vq_min_proxy:
            return "vq"
        if p <= self.w4_max_proxy:
            return "w4"
        return "w8"

    def to_config(self) -> dict:
        return {"default": self.default,
                "w4_max_proxy": float(self.w4_max_proxy),
                "vq_min_proxy": float(self.vq_min_proxy),
                "vq_codes": int(self.vq_codes),
                "overrides": [list(o) for o in self.overrides]}

    @classmethod
    def from_config(cls, cfg) -> "PlanePolicy | None":
        if cfg is None:
            return None
        return cls(default=cfg["default"],
                   w4_max_proxy=cfg["w4_max_proxy"],
                   vq_min_proxy=cfg["vq_min_proxy"],
                   vq_codes=cfg["vq_codes"],
                   overrides=tuple(tuple(o) for o in cfg["overrides"]))


# Presets: the named operating points of the JAX package's ablation.
PLANE_W8 = PlanePolicy(default="w8")
PLANE_W4 = PlanePolicy(default="w4")
PLANE_VQ = PlanePolicy(default="vq")
PLANE_PROXY = PlanePolicy()
