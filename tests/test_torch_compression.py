"""Port vs JAX: int8 gradient compression with error feedback
(`repro_torch/optim/compression.py` against `repro/optim/compression.py`)
on f32 trees from a numpy seed: codes, scales and residuals bit for bit
over several steps of error feedback, as JAX's callers run the functions
(eagerly: tests/test_substrate.py); under jit XLA rewrites amax / 127 as
a multiply by fl(1/127), which the last test records."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.optim.compression import _q_leaf as j_q_leaf
from repro.optim.compression import (
    compress_grads_int8 as j_compress, decompress_grads_int8 as j_decompress,
    init_error_feedback as j_init)
from repro_torch.optim import (
    ErrorFeedback, compress_grads_int8, decompress_grads_int8,
    init_error_feedback)
from repro_torch.tree import leaves_with_path


def _trees(seed):
    """A nested f32 gradient tree over several magnitudes, with an all-zero
    leaf (scale 1) and a one-element leaf, as numpy arrays."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"blocks": {"att": {"wk": n(3, 16, 24) * 1e-3,
                               "u": n(4, 8) * 40.0},
                       "ln": {"scale": np.zeros(24, np.float32)}},
            "embed": n(50, 24),
            "head": n(1) * 1e-30}


def _port(tree):
    return {k: _port(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _flat(tree):
    return {p: v.numpy() for p, v in leaves_with_path(tree)}


def _jflat(tree):
    return {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _same_bits(got, ref):
    assert got.keys() == ref.keys()
    for p in got:
        a, b = got[p], ref[p]
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert np.array_equal(a.reshape(-1).view(np.uint8),
                              b.reshape(-1).view(np.uint8)), p


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_matches_jax_bit_for_bit(seed):
    """Four steps of error feedback on the same gradients and on fresh
    ones: each step's codes, scales and residuals and the decompressed
    gradients equal JAX's eager ones bit for bit."""
    j_ef = j_init(jax.tree_util.tree_map(jnp.asarray, _trees(seed)))
    t_ef = init_error_feedback(_port(_trees(seed)))
    assert isinstance(t_ef, ErrorFeedback)
    for step in range(4):
        g = _trees(seed if step % 2 == 0 else seed + 10 + step)
        j_ef, j_cg = j_compress(jax.tree_util.tree_map(jnp.asarray, g), j_ef)
        t_ef, t_cg = compress_grads_int8(_port(g), t_ef)
        for key in ("q", "scale"):
            _same_bits(_flat(t_cg[key]), _jflat(j_cg[key]))
        _same_bits(_flat(t_ef.residual), _jflat(j_ef.residual))
        _same_bits(_flat(decompress_grads_int8(t_cg)),
                   _jflat(j_decompress(j_cg)))


def test_error_feedback_mean_converges():
    """tests/test_substrate.py's property on the port: the mean of 50
    decompressed steps of one gradient reaches it within 2e-6."""
    g = {"w": torch.from_numpy(np.linspace(-1, 1, 64).astype(np.float32))
         * 1e-3}
    ef = init_error_feedback(g)
    acc = torch.zeros(64)
    for _ in range(50):
        ef, cg = compress_grads_int8(g, ef)
        acc = acc + decompress_grads_int8(cg)["w"]
    assert float((acc / 50 - g["w"]).abs().max()) <= 2e-6


def test_jit_scale_is_a_multiply():
    """Under jit XLA computes the scale as amax · fl(1/127) (the eager
    JAX that the port follows divides): on 200 seeded leaves the jitted
    scales all equal that product and some differ from the division, by
    an ulp; the codes of those leaves agree with the port's."""
    rng = np.random.default_rng(3)
    moved = 0
    for _ in range(200):
        g = (rng.standard_normal(37) * 10.0 ** rng.uniform(-6, 3)).astype(
            np.float32)
        r = np.zeros_like(g)
        jq, js, _ = jax.jit(j_q_leaf)(jnp.asarray(g), jnp.asarray(r))
        amax = np.abs(g).max()
        assert np.float32(js) == amax * np.float32(1.0 / 127.0)
        t_ef, t_cg = compress_grads_int8(
            {"g": torch.from_numpy(g)},
            ErrorFeedback({"g": torch.from_numpy(r)}))
        if np.float32(js) != t_cg["scale"]["g"].numpy():
            moved += 1
            assert abs(int(np.float32(js).view(np.int32))
                       - int(t_cg["scale"]["g"].numpy().view(np.int32))) == 1
            assert np.array_equal(np.asarray(jq), t_cg["q"]["g"].numpy())
    assert moved > 0
