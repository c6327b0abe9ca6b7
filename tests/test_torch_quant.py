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


# --- W4 and VQ planes, plane selection, the slab form (all bit for bit) ---

from port_helpers import mixed_policies
from repro.core.quant import policy as jpol
from repro.core.quant import vq as jvq
from repro.core.quant.serving import FusedLayerStack as JStack
from repro_torch.bridge import fused_stack_to_numpy
from repro_torch.core.quant import policy as tpol
from repro_torch.core.quant import vq as tvq
from repro_torch.core.quant.serving import (
    broadcast_packed_scales, fuse_layer_stack, leaf_plane, unfuse_layer)
from repro_torch.models import rwkv4 as t_rwkv4
from repro_torch.models.registry import get_model as t_get_model
from repro_torch.models.rwkv4 import _layer


def _flat_leaves(tree):
    """{keystr: leaf} of a JAX tree, descending into plane dicts."""
    return {jax.tree_util.keystr(p): l for p, l in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _heavy(rng, shape, df):
    """Student-t weights: df small -> heavy tails (large kurtosis)."""
    return (rng.standard_t(df, size=shape) * 0.05).astype(np.float32)


def test_w4_nibbles_bitwise(rng):
    """FORMAT_W4 codes, scales and the nibble packing equal JAX's; the
    unpacking re-interleaves the rows (low nibble = even row)."""
    w = (rng.normal(size=(3, 16, 24)) * np.exp(rng.normal(size=(3, 16, 24)))
         ).astype(np.float32)
    jq = jdp.dpot_quantize(jnp.asarray(w), jdp.FORMAT_W4, axis=-1)
    tq = tdp.dpot_quantize(torch.from_numpy(w), tdp.FORMAT_W4, axis=-1)
    jp, tp = jdp.dpot_pack_nibbles(jq), tdp.dpot_pack_nibbles(tq)
    assert tuple(tp.shape) == (3, 8, 24) and tp.dtype == torch.uint8
    assert_bitwise(jp, tp, "packed4")
    assert_bitwise(jq.scale, tq.scale, "scale")
    assert_bitwise(jq.codes, tq.codes, "codes")
    ju = jdp.dpot_unpack_nibbles(jp, jq.scale, jdp.FORMAT_W4.ks)
    tu = tdp.dpot_unpack_nibbles(tp, tq.scale, tdp.FORMAT_W4.ks)
    assert torch.equal(tu.codes, tq.codes) and torch.equal(tu.signs, tq.signs)
    assert_bitwise(ju.codes, tu.codes, "unpacked codes")
    assert_bitwise(ju.signs, tu.signs, "unpacked signs")
    # row 2k is the low nibble of packed row k
    assert torch.equal(tp[:, 0] & 0x7, tq.codes[:, 0])
    assert torch.equal((tp[:, 0] >> 4) & 0x7, tq.codes[:, 1])


@pytest.mark.parametrize("shape,n_codes,df",
                         [((3, 40, 24), 256, 3.0), ((300, 256), 256, 2.5),
                          ((50, 30), 16, 30.0)],
                         ids=["stacked", "subsampled", "16-codes"])
def test_vq_quantize_bitwise(rng, shape, n_codes, df):
    """VQ indices (uint8) and the (1, C) bf16 codebook equal JAX's; the
    (300, 256) case is larger than the 2^16 fitting sample."""
    w = _heavy(rng, shape, df)
    ji, jc = jvq.vq_quantize(jnp.asarray(w), n_codes)
    ti, tc = tvq.vq_quantize(torch.from_numpy(w), n_codes)
    assert ti.dtype == torch.uint8 and tuple(ti.shape) == shape
    assert tc.dtype == torch.bfloat16 and tuple(tc.shape) == (1, n_codes)
    assert_bitwise(ji, ti, "vq_idx")
    assert_bitwise(jc, tc, "codebook")
    assert_bitwise(jvq.vq_dequantize(ji, jc),
                   tvq.vq_dequantize(ti, tc), "decoded")


def test_plane_for_matches_jax(rng):
    """PlanePolicy.plane_for under MIXED and the four presets, over the
    smoke model's matmul leaves and over weights whose tails put the
    kurtosis proxy in each of its three ranges."""
    jmixed, tmixed = mixed_policies()
    pairs = [(jmixed, tmixed), (jpol.PLANE_W8, tpol.PLANE_W8),
             (jpol.PLANE_W4, tpol.PLANE_W4), (jpol.PLANE_VQ, tpol.PLANE_VQ),
             (jpol.PLANE_PROXY, tpol.PLANE_PROXY)]
    model = j_get_model("rwkv4-169m", smoke=True)
    leaves = {k: np.array(l) for k, l in _flat_leaves(
        model.init_params(jax.random.PRNGKey(0))).items()
        if j_classify(k, l) == "matmul"}
    for i, df in enumerate((200.0, 6.0, 2.2)):
        leaves[f"['synthetic{i}']"] = _heavy(rng, (64, 48), df)
    got = set()
    for key, w in leaves.items():
        assert tpol.weight_outlier_proxy(torch.from_numpy(w)) == \
            jpol.weight_outlier_proxy(w), key
        for jp_, tp_ in pairs:
            want = jp_.plane_for(key, w)
            assert tp_.plane_for(key, torch.from_numpy(w)) == want, key
            got.add(want)
    assert got == {"w8", "w4", "vq"}
    assert tmixed.to_config() == jmixed.to_config()
    assert tpol.PlanePolicy.from_config(tmixed.to_config()) == tmixed


@pytest.mark.parametrize("which", ["mixed", "w4", "vq"])
def test_pack_params_planes_bitwise(which, rng):
    """pack_params under a plane policy, leaf by leaf (codes, nibble
    pairs, indices, scales, codebooks, bf16 leaves), against JAX's; an
    odd contraction axis makes W4 fall back to W8 on both sides."""
    jmixed, tmixed = mixed_policies()
    jpolicy, tpolicy = {"mixed": (jmixed, tmixed),
                        "w4": (jpol.PLANE_W4, tpol.PLANE_W4),
                        "vq": (jpol.PLANE_VQ, tpol.PLANE_VQ)}[which]
    model = j_get_model("rwkv4-169m", smoke=True)
    params = model.init_params(jax.random.PRNGKey(0))
    params = {**params, "odd": jnp.asarray(rng.normal(size=(5, 8)),
                                           jnp.float32)}
    jp = _flat_leaves(j_pack(params, jpolicy))
    tp = dict((keystr(p), l) for p, l in leaves_with_path(
        t_pack(to_port(params), tpolicy)))
    assert sorted(jp) == sorted(tp)
    for key, leaf in jp.items():
        got = tp[key]
        assert str(got.dtype).replace("torch.", "") == leaf.dtype.name, key
        assert_bitwise(leaf, got, key)
    # the odd (5, 8) leaf: W8 under MIXED, and under W4 by the fallback
    odd = {"mixed": "packed", "w4": "packed", "vq": "vq_idx"}[which]
    assert f"['odd']['{odd}']" in tp


@pytest.mark.parametrize("which", ["w8", "mixed"])
def test_fuse_layer_stack_bitwise(which):
    """The slab form — per-dtype slabs, aux leaves, manifest offsets —
    equals JAX's prepare_fused_model_params byte for byte."""
    jmixed, tmixed = mixed_policies()
    jpolicy, tpolicy = (None, None) if which == "w8" else (jmixed, tmixed)
    jm = j_get_model("rwkv4-169m", smoke=True)
    tm = t_get_model("rwkv4-169m", smoke=True)
    params = jm.init_params(jax.random.PRNGKey(0))
    jstack = jm.prepare_fused_model_params(j_pack(params, jpolicy))["blocks"]
    tstack = t_rwkv4.prepare_fused_model_params(
        t_pack(to_port(params), tpolicy), tm.cfg)["blocks"]
    assert isinstance(jstack, JStack)
    js, ja, jmf = fused_stack_to_numpy(jstack)
    ts, ta, tmf = fused_stack_to_numpy(tstack)
    assert tmf == jmf
    assert sorted(ts) == sorted(js)
    for k in js:
        assert ts[k].shape == js[k].shape, k
        assert ts[k].tobytes() == js[k].tobytes(), k
    assert len(ta) == len(ja)
    for a, b in zip(ja, ta):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    if which == "mixed":
        assert {k: v.shape for k, v in ts.items()} == {
            "uint8": (2, 51200), "bfloat16": (2, 704)}
        assert len(ta) == 7


def test_unfuse_layer_equals_layer_slice():
    """unfuse_layer(row l) rebuilds layer l of the stacked tree exactly,
    the shared scales and codebook squeezed (the K4 plain version's
    input equals K3's)."""
    _, tmixed = mixed_policies()
    tm = t_get_model("rwkv4-169m", smoke=True)
    tp = tm.cast_params(t_pack(tm.init_params(0, device="cpu"), tmixed))
    stack = fuse_layer_stack(tp["blocks"], tm.cfg.n_layers)
    bcast = broadcast_packed_scales(tp["blocks"], tm.cfg.n_layers)
    aux = [a[0] for a in stack.aux]
    for l in range(tm.cfg.n_layers):
        got = unfuse_layer({k: s[l] for k, s in stack.slabs.items()}, aux,
                           stack.manifest, stack.tdef)
        want = _layer(bcast, l)
        for (pg, g), (pw, w) in zip(leaves_with_path(got),
                                    leaves_with_path(want)):
            assert pg == pw
            assert torch.equal(g.reshape(w.shape), w), pg
        assert leaf_plane(got["ffn"]["wv"]) == "vq"
        assert leaf_plane(got["att"]["wk"]) == "w4"


# --- dpot_quantize as JAX has it: W9 and PoT4, axis 0, axis=None, MSE ---


def test_quantize_defaults_match_jax(rng):
    """With no format or axis: W9 (ks (4, 4)) and one scale per index of
    axis 0, as JAX's defaults; codes, signs and scales bit for bit."""
    w = (rng.normal(size=(24, 40)) * np.exp(rng.normal(size=(24, 40)))
         ).astype(np.float32)
    jq = jdp.dpot_quantize(jnp.asarray(w))
    tq = tdp.dpot_quantize(torch.from_numpy(w))
    assert tq.ks == jq.ks == (4, 4) and tuple(tq.scale.shape) == (24, 1)
    for a, b in ((jq.codes, tq.codes), (jq.signs, tq.signs),
                 (jq.scale, tq.scale)):
        assert_bitwise(a, b)


@pytest.mark.parametrize("fmt", ["FORMAT_W9", "FORMAT_W8", "FORMAT_W4",
                                 "FORMAT_POT4"])
@pytest.mark.parametrize("axis", [0, -1, None, (0, 2)])
@pytest.mark.parametrize("mse", [False, True])
def test_quantize_axes_and_mse_search_bitwise(rng, fmt, axis, mse):
    """Every format, per-channel and tensor-wide scales, with and without
    the MSE grid search of the scale (the 0.6-1.2 candidates): codes and
    scales bit for bit, the scale's shape JAX's."""
    w = (rng.normal(size=(6, 20, 16)) * np.exp(rng.normal(size=(6, 20, 16))
                                               * 2)).astype(np.float32)
    w[1] = 0.0                                     # an all-zero channel
    jq = jdp.dpot_quantize(jnp.asarray(w), getattr(jdp, fmt), axis=axis,
                           mse_search=mse)
    tq = tdp.dpot_quantize(torch.from_numpy(w), getattr(tdp, fmt),
                           axis=axis, mse_search=mse)
    assert tuple(tq.scale.shape) == tuple(np.shape(jq.scale))
    assert_bitwise(jq.codes, tq.codes)
    assert_bitwise(jq.scale, tq.scale)
