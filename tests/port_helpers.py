"""Helpers shared by the port's CPU tests (tests/test_torch_*.py).

JAX trees reach the port through `repro_torch.bridge` as numpy arrays; the
comparisons run in f32 (bf16 converts exactly).

The tolerance rule for the port against the JAX package, per leaf:

    max |got - ref|  <= 2^-5 · max |ref|
    mean |got - ref| <= 2^-8 · mean |ref|

Both sides compute in bf16 with f32 accumulation; summing in another
order can flip a bf16 rounding (one step is at most 2^-7 relative), and
over a 32-step trajectory a flip can travel, so single elements may move by
a few bf16 steps.  A rounding made at the wrong place, or skipped (such
as torch.sigmoid in place of XLA's bf16 expansion), moves most elements
by a step and lifts the mean above 2^-8.
"""
from __future__ import annotations

import jax
import numpy as np
import torch

from repro_torch.bridge import from_jax_tree, to_numpy
from repro_torch.core.quant.policy import PlanePolicy as TPlanePolicy

MAX_REL = 2.0 ** -5
MEAN_REL = 2.0 ** -8

# The mixed plane policy of tests/test_fused_decode.py: W4 for att.wk and
# the head, VQ for ffn.wv, W8 elsewhere, so every decode branch runs.
MIXED_OVERRIDES = ((r"\['att'\]\['wk'\]", "w4"),
                   (r"\['ffn'\]\['wv'\]", "vq"),
                   (r"\['head'\]", "w4"))


def mixed_policies():
    """(the JAX package's PlanePolicy, the port's), both MIXED."""
    from repro.core.quant.policy import PlanePolicy
    return (PlanePolicy(default="w8", overrides=MIXED_OVERRIDES),
            TPlanePolicy(default="w8", overrides=MIXED_OVERRIDES))


def to_port(tree, device="cpu"):
    """A JAX tree -> the port's tree of torch tensors, paths kept."""
    return from_jax_tree(jax.tree_util.tree_map(np.asarray, tree), device)


def f32(a) -> np.ndarray:
    """A JAX array, numpy array or torch tensor as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return to_numpy(a).astype(np.float32)
    return np.asarray(a).astype(np.float32)


def assert_close(ref, got, what: str = ""):
    r, g = f32(ref), f32(got)
    assert r.shape == g.shape, (what, r.shape, g.shape)
    d = np.abs(g - r)
    assert np.isfinite(g).all(), what
    scale_max = float(np.abs(r).max())
    scale_mean = float(np.abs(r).mean())
    assert d.max() <= MAX_REL * scale_max, (what, d.max(), scale_max)
    assert d.mean() <= MEAN_REL * scale_mean, (what, d.mean(), scale_mean)


def assert_bitwise(ref, got, what: str = ""):
    r, g = np.asarray(ref), np.asarray(to_numpy(got) if isinstance(
        got, torch.Tensor) else got)
    if r.dtype.name == "bfloat16":
        r = r.astype(np.float32)
    assert r.shape == g.shape, (what, r.shape, g.shape)
    np.testing.assert_array_equal(r, g, err_msg=what)
