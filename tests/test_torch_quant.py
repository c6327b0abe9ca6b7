"""Port vs JAX: the Δ-PoT W8 codec and the chunk matmul (kernel K5's plain
version), on the CPU at the smoke size.

The codec must match bit for bit: codes, scales, the bf16 leaves, and the
decoded bf16 weights.  The matmul holds to the rule in port_helpers.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import assert_bitwise, assert_close, f32, to_port
from repro.core.quant import delta_pot as jdp
from repro.core.quant.policy import classify_param as j_classify
from repro.core.quant.serving import pack_params as j_pack
from repro.core.quant.serving import unpack_leaf as j_unpack
from repro.kernels.common import exact_jit
from repro.models.registry import get_model as j_get_model
from repro_torch.core.quant import delta_pot as tdp
from repro_torch.core.quant.policy import classify_param as t_classify
from repro_torch.core.quant.serving import (
    is_packed_leaf, pack_params as t_pack, unpack_leaf as t_unpack,
    unpack_params as t_unpack_params)
from repro_torch.kernels.fused_prefill import (
    chunk_matmul, dpot_w8_matmul, dpot_w8_matmul_plain)
from repro_torch.tree import keystr, leaves_with_path

LEAVES = [("blocks", "att", "wr"), ("blocks", "att", "wo"),
          ("blocks", "ffn", "wk"), ("blocks", "ffn", "wv"), ("head",)]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def trees():
    model = j_get_model("rwkv4-169m", smoke=True)
    params = model.init_params(jax.random.PRNGKey(0))
    jp = j_pack(params)
    tp = t_pack(to_port(params))
    return jp, tp


def test_pack_params_bitwise(trees):
    """Every leaf of the packed tree — uint8 codes, f32 scales, the bf16
    non-matmul leaves — equals JAX's pack_params bit for bit."""
    jp, tp = trees
    jflat = {keystr(tuple(k.key for k in path)): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = dict((keystr(p), leaf) for p, leaf in leaves_with_path(tp))
    assert sorted(jflat) == sorted(tflat)
    for key, leaf in jflat.items():
        got = tflat[key]
        assert str(got.dtype).replace("torch.", "") == leaf.dtype.name, key
        assert_bitwise(leaf, got, key)


def test_stacked_scale_is_one_per_channel(trees):
    """A stacked (L, K, N) weight gets ONE (1, 1, N) scale, reduced over
    both L and K (delta_pot.py:183-185)."""
    jp, tp = trees
    for path in LEAVES[:4]:
        leaf = _get(tp, path)
        L, K, N = leaf["packed"].shape
        assert tuple(leaf["scale"].shape) == (1, 1, N)
        assert tuple(_get(jp, path)["scale"].shape) == (1, 1, N)
    assert tuple(tp["head"]["scale"].shape) == (1, tp["head"]["packed"].shape[1])


@pytest.mark.parametrize("path", LEAVES, ids=lambda p: ".".join(p))
def test_unpack_leaf_bitwise(trees, path):
    jp, tp = trees
    assert_bitwise(j_unpack(_get(jp, path)), t_unpack(_get(tp, path)),
                   ".".join(path))


def test_level_table_bitwise():
    codes = np.arange(128, dtype=np.uint8)
    want = jdp.dpot_decode_codes(jnp.asarray(codes), jdp.FORMAT_W8.ks)
    got = tdp.dpot_decode_codes(torch.from_numpy(codes), tdp.FORMAT_W8.ks)
    assert_bitwise(want, got)


def test_quantize_random_bitwise(rng):
    """dpot_quantize on values across many binades, per-channel scales."""
    w = (rng.normal(size=(40, 24)) * np.exp(rng.normal(size=(40, 24)) * 3)
         ).astype(np.float32)
    w[:, 3] = 0.0                                  # an all-zero channel
    jq = jdp.dpot_quantize(jnp.asarray(w), jdp.FORMAT_W8, axis=-1)
    tq = tdp.dpot_quantize(torch.from_numpy(w), tdp.FORMAT_W8, axis=-1)
    assert_bitwise(jdp.dpot_pack_int8(jq), tdp.dpot_pack_int8(tq))
    assert_bitwise(jq.scale, tq.scale)


def test_classify_param_matches_jax(trees):
    model = j_get_model("rwkv4-169m", smoke=True)
    params = model.init_params(jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = jax.tree_util.keystr(path)
        assert t_classify(key, torch.zeros(leaf.shape)) == \
            j_classify(key, leaf), key


@pytest.mark.parametrize("packed", [True, False], ids=["w8", "plain"])
def test_chunk_matmul_matches_jax(rng, packed):
    """Plain chunk_matmul == x @ unpack_leaf(w).astype(bf16) in JAX."""
    w = jnp.asarray(rng.normal(size=(48, 80)) * 0.1, jnp.float32)
    if packed:
        q = jdp.dpot_quantize(w, jdp.FORMAT_W8, axis=-1)
        leaf = {"packed": jdp.dpot_pack_int8(q),
                "scale": q.scale.astype(jnp.float32)}
    else:
        leaf = w.astype(jnp.bfloat16)
    x = jnp.asarray(rng.normal(size=(3, 5, 48)), jnp.bfloat16)
    want = exact_jit(
        lambda x, l: x @ j_unpack(l).astype(jnp.bfloat16))(x, leaf)
    got = chunk_matmul(to_port(x), to_port(leaf), torch.bfloat16)
    assert tuple(got.shape) == want.shape
    assert_close(want, got, "chunk_matmul")


def test_dpot_w8_matmul_cpu_is_plain(rng):
    """On a CPU tensor the K5 wrapper runs its plain version, launches
    nothing, and equals decoding the plane then one matmul."""
    w = torch.from_numpy(rng.normal(size=(32, 20)).astype(np.float32))
    q = tdp.dpot_quantize(w, tdp.FORMAT_W8, axis=-1)
    wq, scale = tdp.dpot_pack_int8(q), q.scale.reshape(-1)
    x = torch.from_numpy(rng.normal(size=(7, 32)).astype(np.float32)).to(
        torch.bfloat16)
    before = dpot_w8_matmul.launches
    got = dpot_w8_matmul(x, wq, scale)
    assert dpot_w8_matmul.launches == before
    want = x @ t_unpack({"packed": wq, "scale": scale[None]})
    assert torch.equal(got, want)
    assert torch.equal(dpot_w8_matmul_plain(x, wq, scale), want)


def test_unpack_params_decodes_only_packed_leaves(trees):
    _, tp = trees
    out = t_unpack_params(tp)
    for path, leaf in leaves_with_path(tp, is_leaf=is_packed_leaf):
        got = _get(out, path)
        if is_packed_leaf(leaf):
            assert got.dtype == torch.bfloat16
            assert tuple(got.shape) == tuple(leaf["packed"].shape)
        else:
            assert got is leaf
    assert f32(out["head"]).shape == tuple(tp["head"]["packed"].shape)
