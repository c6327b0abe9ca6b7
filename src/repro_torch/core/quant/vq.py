"""Per-tensor codebook (vector-quantized) weight plane (port of
`repro/core/quant/vq.py`).

Storage form: uint8 indices shaped like the weight plus a (1, C) bf16
codebook, C <= 256.  The leading 1 marks the codebook as a leaf shared
by every layer of a stacked weight: `fuse_layer_stack` keeps it out of
the slabs, as it does the shared Δ-PoT scales.

Fitting is deterministic 1-D Lloyd k-means in numpy, as in the JAX
package: quantile-spaced init over a strided subsample, nearest-centroid
assignment by `searchsorted` on the midpoints of the sorted centroids,
empty clusters keep their centroid, and every centroid is rounded to bf16
inside the loop, so the stored codebook is the one the assignment
optimised.  Given the same f32 weights the indices and the codebook
equal the JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """Round f32 values to the nearest bf16 (ties to even), as f32."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


# values one searchsorted call takes, bounding its f32 copy (a stacked
# rwkv6-7b leaf holds 1.9e9 weights)
ASSIGN_STEP = 1 << 26


def _assign(flat: torch.Tensor, centroids: np.ndarray,
            dtype: torch.dtype) -> torch.Tensor:
    """Exact nearest-centroid index per value of a flat tensor (centroids
    sorted), on the tensor's device, ASSIGN_STEP values at a time: the
    first of the f32 midpoints that is >= the value."""
    c = torch.from_numpy(centroids).to(flat.device)
    mids = 0.5 * (c[1:] + c[:-1])
    out = torch.empty(flat.shape, dtype=dtype, device=flat.device)
    for i in range(0, flat.numel(), ASSIGN_STEP):
        out[i:i + ASSIGN_STEP] = torch.searchsorted(
            mids, flat[i:i + ASSIGN_STEP].to(torch.float32)).to(dtype)
    return out


def kmeans_1d(values: np.ndarray, n_codes: int, iters: int = 16
              ) -> np.ndarray:
    """Deterministic 1-D Lloyd k-means: `n_codes` sorted centroids (f32,
    already bf16-rounded)."""
    v = np.ascontiguousarray(values, np.float32).reshape(-1)
    qs = (np.arange(n_codes, dtype=np.float64) + 0.5) / n_codes
    cent = np.quantile(v, qs).astype(np.float32)
    cent = np.sort(_bf16_round(cent))
    for _ in range(iters):
        idx = _assign(torch.from_numpy(v), cent, torch.int64).numpy()
        sums = np.bincount(idx, weights=v, minlength=n_codes)
        cnts = np.bincount(idx, minlength=n_codes)
        new = np.where(cnts > 0, sums / np.maximum(cnts, 1), cent)
        new = np.sort(_bf16_round(new.astype(np.float32)))
        if np.array_equal(new, cent):
            break
        cent = new
    return cent


def vq_quantize(w: torch.Tensor, n_codes: int = 256, iters: int = 16,
                sample: int = 1 << 16) -> tuple[torch.Tensor, torch.Tensor]:
    """Fit a per-tensor codebook and assign every weight: (uint8 indices
    shaped like `w`, bf16 codebook (1, n_codes)), both on `w`'s device."""
    if not 2 <= n_codes <= 256:
        raise ValueError(f"n_codes={n_codes}: uint8 indices need 2..256")
    flat = w.detach().reshape(-1)
    fit = flat if flat.numel() <= sample else \
        flat[:: (flat.numel() + sample - 1) // sample]
    cent = kmeans_1d(fit.to(torch.float32).cpu().numpy(), n_codes, iters)
    codebook = torch.from_numpy(cent).to(torch.bfloat16).reshape(1, n_codes)
    return (_assign(flat, cent, torch.uint8).reshape(tuple(w.shape)),
            codebook.to(w.device))


def vq_dequantize(idx: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Gather decode: bf16 weights shaped like `idx`.  The codebook is
    flattened first, so its (1, C), (C,) and (L, C) forms decode alike."""
    return codebook.reshape(-1)[idx.to(torch.int64)]
