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


# --- the rest of the Δ-PoT core, the Table-1 schemes, the tree quantizers,
# --- plane_fingerprint and packed_abstract
#
# Tolerances: codes, signs, scales, W8/W4 decodes, byte counts and the
# fingerprint strings bit for bit.  Where XLA's f32 exp2 on the CPU is
# inexact (W9 and PoT4 levels at 2^-13 and from 2^-15 down, PoT's 2^-e,
# LogQ's 2^(-i/2)), the port is held bit for bit to a numpy model with
# exact powers of two, and to JAX within 2^-20 relative per element
# (XLA's worst is 4.8e-7 < 9.5e-7).  The uniform (additive) leaves: the
# port multiplies by fl(1/255) as jitted XLA does, so it equals jax.jit's
# bit for bit and eager JAX's (which divides) within one f32 ulp.

from repro.core.quant import schemes as jsch
from repro.core.quant.serving import packed_abstract as j_packed_abstract
from repro.core.quant.serving import plane_fingerprint as j_fingerprint
from repro_torch.core.quant import schemes as tsch
from repro_torch.core.quant.serving import (
    packed_abstract as t_packed_abstract, plane_fingerprint as t_fingerprint)

FORMATS = ["FORMAT_W9", "FORMAT_W8", "FORMAT_W4", "FORMAT_POT4"]
REL = 2.0 ** -20


def _exact_dequant(codes, signs, scale, ks):
    """signs · exact level · scale in f32 numpy: the numpy model."""
    lvl = jdp._level_table_np(tuple(ks)).astype(np.float32)[
        np.asarray(codes, np.int64)]
    return (np.asarray(signs).astype(np.float32) * lvl
            * np.asarray(scale, np.float32)).astype(np.float32)


def _within_rel(ref, got, rel=REL, what=""):
    r, g = f32(ref).astype(np.float64), f32(got).astype(np.float64)
    assert r.shape == g.shape, what
    assert bool((np.abs(g - r) <= rel * np.abs(r)).all()), (
        what, float(np.max(np.abs(g - r) / np.maximum(np.abs(r), 1e-38))))


def _weights(rng, shape, spread=2.0):
    return (rng.normal(size=shape) * np.exp(rng.normal(size=shape) * spread)
            ).astype(np.float32)


@pytest.mark.parametrize("fmt", FORMATS)
def test_dpot_levels_and_format_bitwise(fmt):
    jf, tf = getattr(jdp, fmt), getattr(tdp, fmt)
    assert_bitwise(jdp.dpot_levels(jf), tdp.dpot_levels(tf, "cpu"), fmt)
    for prop in ("code_bits", "total_bits"):
        assert getattr(tf, prop) == getattr(jf, prop), prop
    with pytest.raises(ValueError):
        tdp.DPotFormat(ks=(5, 4))
    with pytest.raises(ValueError):
        tdp.DPotFormat(ks=())


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("axis", [0, -1, None])
def test_nbytes_hardware_matches_jax(rng, fmt, axis):
    w = _weights(rng, (3, 20, 16))
    jq = jdp.dpot_quantize(jnp.asarray(w), getattr(jdp, fmt), axis=axis)
    tq = tdp.dpot_quantize(torch.from_numpy(w), getattr(tdp, fmt),
                           axis=axis)
    assert tq.nbytes_hardware() == jq.nbytes_hardware()
    assert tq.fmt == tdp.DPotFormat(jq.ks) and tuple(tq.shape) == jq.shape


def test_unpack_int8_and_dequantize_w8_bitwise(rng):
    """dpot_unpack_int8 of every byte (codes, signs) and dpot_dequantize
    of the W8 plane: bit for bit with JAX (kernels/ref.py's oracle)."""
    packed = rng.integers(0, 256, (256, 48)).astype(np.uint8)
    packed[:, 0] = np.arange(256, dtype=np.uint8)
    scale = _weights(rng, (1, 48)).__abs__()
    jq = jdp.dpot_unpack_int8(jnp.asarray(packed), jnp.asarray(scale),
                              (3, 4))
    tq = tdp.dpot_unpack_int8(torch.from_numpy(packed),
                              torch.from_numpy(scale), (3, 4))
    assert tq.codes.dtype == torch.uint8 and tq.signs.dtype == torch.int8
    assert_bitwise(jq.codes, tq.codes, "codes")
    assert_bitwise(jq.signs, tq.signs, "signs")
    jd, td = np.asarray(jdp.dpot_dequantize(jq)), tdp.dpot_dequantize(tq)
    np.testing.assert_array_equal(td.numpy().view(np.uint32),
                                  jd.view(np.uint32))


@pytest.mark.parametrize("fmt", FORMATS)
def test_dequantize_exact_levels(rng, fmt):
    """dpot_dequantize equals the numpy model with exact levels bit for
    bit, and JAX's within 2^-20: equal bits for W8 and W4, and for W9 and
    PoT4 everywhere but the codes whose level XLA's exp2 misses."""
    w = _weights(rng, (40, 64))
    jq = jdp.dpot_quantize(jnp.asarray(w), getattr(jdp, fmt), axis=-1)
    tq = tdp.dpot_quantize(torch.from_numpy(w), getattr(tdp, fmt), axis=-1)
    got = tdp.dpot_dequantize(tq).numpy()
    model = _exact_dequant(jq.codes, jq.signs, jq.scale, jq.ks)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  model.view(np.uint32))
    ref = np.asarray(jdp.dpot_dequantize(jq))
    _within_rel(ref, got, what=fmt)
    if fmt in ("FORMAT_W8", "FORMAT_W4"):
        np.testing.assert_array_equal(got, ref)


def test_dpot_fake_quant_value_and_identity_gradient(rng):
    """dpot_fake_quant (W9, axis 0 by default; W8 at axis -1 with the MSE
    search): the value as dpot_dequantize(dpot_quantize(w)) in w's dtype,
    bit for bit with the exact-level model and within 2^-20 of JAX; its
    gradient is the cotangent itself, as JAX's custom_vjp."""
    w = _weights(rng, (24, 40))
    for args in ((), ((3, 4), -1, True)):
        jq = jdp.dpot_quantize(jnp.asarray(w), jdp.DPotFormat(
            args[0] if args else (4, 4)), axis=args[1] if args else 0,
            mse_search=bool(args and args[2]))
        got = tdp.dpot_fake_quant(torch.from_numpy(w), *args)
        model = _exact_dequant(jq.codes, jq.signs, jq.scale, jq.ks)
        np.testing.assert_array_equal(got.numpy(), model)
        _within_rel(jdp.dpot_fake_quant(jnp.asarray(w), *args), got)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    assert tdp.dpot_fake_quant(wb).dtype == torch.bfloat16
    g = rng.normal(size=w.shape).astype(np.float32)
    tw = torch.from_numpy(w).requires_grad_()
    (tdp.dpot_fake_quant(tw) * torch.from_numpy(g)).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jdp.dpot_fake_quant(v) * g))(
        jnp.asarray(w))
    assert_bitwise(jg, tw.grad, "gradient")
    np.testing.assert_array_equal(tw.grad.numpy(), g)


def _np_amax(w32, axis):
    if axis is None:
        return np.abs(w32).max()
    keep = {a % w32.ndim for a in ((axis,) if isinstance(axis, int)
                                   else axis)}
    red = tuple(i for i in range(w32.ndim) if i not in keep)
    return np.abs(w32).max(axis=red, keepdims=True)


def _np_log_scheme(w, bits, axis, step, pow2=None):
    """The numpy model of pot_fake_quant (step 1) and logq_fake_quant
    (step 0.5): f32 scale and |w|/s, log2 in float64, levels 2^-e and
    2^-(i//2)·√½ exact in float64, then rounded once to f32.  With `pow2`
    the level is pow2(-i·step) on an f32 exponent instead (XLA's exp2).
    Also returns t = -log2(a)/step, to locate rounding ties, and i·step."""
    w32 = w.astype(np.float32)
    s = _np_amax(w32, axis).astype(np.float32)
    s = np.where(s <= 0, np.float32(1), s).astype(np.float32)
    n = (1 << (bits - 1)) - 1
    a = (np.abs(w32) / s).astype(np.float32)
    t = -np.log2(np.maximum(a.astype(np.float64), 1e-38)) / step
    i = np.clip(np.round(t), 0, n - 1).astype(np.int64)
    if pow2 is not None:
        lvl = pow2((-i * step).astype(np.float32))
    elif step == 1.0:
        lvl = np.ldexp(1.0, -i)
    else:
        lvl = np.ldexp(np.where(i % 2, np.sqrt(0.5), 1.0), -(i // 2))
    lvl = np.asarray(lvl).astype(np.float32)
    thr = np.float32(2.0 ** (-(n - 1) * step) / 2)
    lvl = np.where(a < thr, np.float32(0), lvl).astype(np.float32)
    return (np.sign(w32) * lvl * s).astype(np.float32), t, i * step


@pytest.mark.parametrize("scheme", ["pot", "logq"])
@pytest.mark.parametrize("axis", [None, -1, 0])
def test_log_schemes_exact_and_near_jax(rng, scheme, axis):
    """PoT and LogQ (9 bits): bit for bit against the numpy model with
    exact powers of two.  jax.jit's result equals the same model with
    XLA's own f32 exp2 in place of the exact power, bit for bit, except
    where XLA's f32 log2 rounds a near tie the other way: there
    -log2(|w|/s)/step lies within 2^-16 of a half-integer, and such
    elements are counted, at most 1 in 2^12.  So the port and JAX differ
    by XLA's exp2 error alone: within 2^-20 where the exponent is at most
    24 (the range exp_lut is held to), ~1.01e-6 at 2^-26 and 2^-34."""
    w = _weights(rng, (64, 96), 3.0)
    w[:, 5] = 0.0
    step = 1.0 if scheme == "pot" else 0.5
    got = tsch.SCHEMES[scheme](torch.from_numpy(w), 9, axis).numpy()
    model, t, ex = _np_log_scheme(w, 9, axis, step)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  model.view(np.uint32))
    ref = np.asarray(jax.jit(lambda v: jsch.SCHEMES[scheme](v, 9, axis))(
        jnp.asarray(w)))
    xla, _, _ = _np_log_scheme(w, 9, axis, step,
                               pow2=lambda e: jax.jit(jnp.exp2)(e))
    off = ref.view(np.uint32) != xla.view(np.uint32)
    assert bool((np.abs(t[off] - np.floor(t[off]) - 0.5) < 2.0 ** -16)
                .all()), "a difference away from a rounding tie"
    assert int(off.sum()) <= w.size // 4096, int(off.sum())
    near = ~off & (ex <= 24)
    _within_rel(ref[near], got[near])


@pytest.mark.parametrize("axis", [None, -1])
def test_rtn_and_proposed_schemes(rng, axis):
    """RTN is the uniform fake-quant (bit for bit with jax.jit); proposed
    is W9 Δ-PoT with the MSE search (exact-level model bit for bit, JAX
    within 2^-20); fp is the identity."""
    w = _weights(rng, (32, 48))
    tw = torch.from_numpy(w)
    jr = jax.jit(lambda v: jsch.rtn_fake_quant(v, 9, axis))(jnp.asarray(w))
    assert_bitwise(jr, tsch.rtn_fake_quant(tw, 9, axis), "rtn")
    got = tsch.proposed_fake_quant(tw, 9, axis)
    jq = jdp.dpot_quantize(jnp.asarray(w), jdp.FORMAT_W9, axis=axis,
                           mse_search=True)
    np.testing.assert_array_equal(
        got.numpy(), _exact_dequant(jq.codes, jq.signs, jq.scale, jq.ks))
    _within_rel(jsch.proposed_fake_quant(jnp.asarray(w), 9, axis), got)
    assert tsch.SCHEMES["fp"](tw) is tw
    assert sorted(tsch.SCHEMES) == sorted(jsch.SCHEMES)


def _smoke_params(arch="rwkv4-169m"):
    return j_get_model(arch, smoke=True).init_params(jax.random.PRNGKey(0))


def _check_fake_tree(jtree, ttree, jax_quantized):
    """Matmul leaves: the exact-level model of JAX's own quantization bit
    for bit, JAX within 2^-20; additive leaves: jax.jit's fake-quant bit
    for bit, eager JAX's within 2^-20."""
    jflat = _flat_leaves(jtree)
    tflat = dict((keystr(p), l) for p, l in leaves_with_path(ttree))
    assert sorted(jflat) == sorted(tflat)
    for key, leaf in jflat.items():
        got = tflat[key]
        assert str(got.dtype).replace("torch.", "") == leaf.dtype.name, key
        _within_rel(leaf, got, what=key)
        assert_bitwise(jax_quantized[key], got, key)


@pytest.mark.parametrize("arch", ["rwkv4-169m", "smollm-135m"])
def test_fake_quantize_tree_matches_jax(arch):
    params = _smoke_params(arch)
    jtree = jpol.fake_quantize_tree(params, jpol.QuantPolicy())
    ttree = tpol.fake_quantize_tree(to_port(params), tpol.QuantPolicy())
    exact = {}
    for key, leaf in _flat_leaves(params).items():
        kind = j_classify(key, leaf)
        if kind == "matmul":
            q = jdp.dpot_quantize(leaf, jdp.FORMAT_W9, axis=-1)
            exact[key] = _exact_dequant(q.codes, q.signs, q.scale, q.ks)
        else:
            exact[key] = jax.jit(lambda v: jpol.uniform_fake_quant(
                v, 9, None))(leaf)
    _check_fake_tree(jtree, ttree, exact)


def _mse_near_tie(w, s_port, s_jax):
    """Where the port's MSE search (one tensor-wide W9 scale) picks
    another scale candidate than JAX's: JAX's own f32 squared errors at
    the two scales differ by less than the f32 summation bound n·2^-24 of
    their size, so another summation order may rank them either way."""
    errs = []
    for s in (s_port, s_jax):
        q = jdp._nearest_level(w / s, jdp.FORMAT_W9) * s
        errs.append(float(jnp.sum((q - w) ** 2)))
    bound = w.size * 2.0 ** -24 * max(errs)
    assert abs(errs[0] - errs[1]) <= bound, (errs, bound)


@pytest.mark.parametrize("scheme", ["rtn", "pot", "logq", "proposed"])
def test_fake_quantize_tree_with_matches_jax(scheme):
    """Each Table-1 scheme over the rwkv4 smoke tree (axis None): every
    leaf is the port's scheme (matmul) or 9-bit uniform (additive), and
    within 2^-20 of JAX's, as each scheme's own test holds it.  For
    "proposed" the MSE search over one tensor-wide scale sums 8192 or more
    squared errors, and on this tree two candidates can tie within f32
    rounding: there the port may pick the other one; such leaves must be
    near ties (`_mse_near_tie`) and are counted, at most 2 of 8."""
    params = _smoke_params()
    tparams = to_port(params)
    jtree = jpol.fake_quantize_tree_with(params, jsch.SCHEMES[scheme])
    ttree = tpol.fake_quantize_tree_with(tparams, tsch.SCHEMES[scheme])
    jflat, pflat = _flat_leaves(jtree), _flat_leaves(params)
    ties = 0
    for path, got in leaves_with_path(ttree):
        key = keystr(path)
        leaf = _get(tparams, path)
        matmul = t_classify(key, leaf) == "matmul"
        if matmul:
            assert torch.equal(got, tsch.SCHEMES[scheme](leaf, 9, None))
        else:
            assert torch.equal(got, tpol.uniform_fake_quant(leaf, 9, None))
        if scheme == "proposed" and matmul:
            sp = tdp.dpot_quantize(leaf, tdp.FORMAT_W9, axis=None,
                                   mse_search=True).scale
            sj = jdp.dpot_quantize(pflat[key], jdp.FORMAT_W9, axis=None,
                                   mse_search=True).scale
            if float(sp) != float(sj):
                _mse_near_tie(pflat[key], float(sp), float(sj))
                ties += 1
                continue
        _within_rel(jflat[key], got, what=key)
    assert ties <= 2, ties


def _plane_leaves(tree):
    """{keystr: leaf} of a port tree, DPotQuantized and plane dicts kept
    whole."""
    stop = lambda x: isinstance(x, dict) and set(x) in (
        {"codes", "scale"}, {"vq_idx", "codebook"})
    return dict((keystr(p), l) for p, l in leaves_with_path(
        tree, is_leaf=stop))


@pytest.mark.parametrize("which", ["policy", "w8", "mixed"])
def test_quantize_tree_matches_jax(which):
    """quantize_tree with QuantPolicy() (W9), and with planes= (W8; the
    MIXED W4/VQ selection): the containers, codes, signs, scales and the
    byte accounting equal JAX's; the additive codes equal and their
    scales within an ulp of eager JAX's."""
    jmixed, tmixed = mixed_policies()
    planes = {"policy": (None, None), "w8": (jpol.PLANE_W8, tpol.PLANE_W8),
              "mixed": (jmixed, tmixed)}[which]
    params = _smoke_params()
    jq, jstats = jpol.quantize_tree(params, planes=planes[0])
    tq, tstats = tpol.quantize_tree(to_port(params), planes=planes[1])
    assert tstats == jstats
    bridged = to_port(jq)
    jl, tl = _plane_leaves(bridged), _plane_leaves(tq)
    assert sorted(jl) == sorted(tl)
    for key, want in jl.items():
        got = tl[key]
        assert type(got) is type(want), key
        if isinstance(got, tdp.DPotQuantized):
            assert got.ks == want.ks, key
            for f in ("codes", "signs", "scale"):
                assert torch.equal(getattr(got, f), getattr(want, f)), key
        elif set(got) == {"codes", "scale"}:
            assert got["codes"].dtype == torch.int16
            assert torch.equal(got["codes"], want["codes"]), key
            assert float(abs(got["scale"] - want["scale"])) <= \
                2.0 ** -23 * float(want["scale"]), key
        else:
            for f in ("vq_idx", "codebook"):
                assert torch.equal(got[f], want[f]), key
    # dequantize_tree: the exact levels; W8, W4 and VQ bit for bit
    jd = _flat_leaves(jpol.dequantize_tree(jq))
    for path, got in leaves_with_path(tpol.dequantize_tree(tq)):
        key = keystr(path)
        assert got.dtype == torch.float32, key
        _within_rel(jd[key], got, 2.0 ** -20 if which == "policy"
                    else 2.0 ** -23, key)


def test_quantize_tree_w8_codes_equal_pack_params():
    """dpot_pack_int8 of quantize_tree(planes=PLANE_W8)'s leaves equals
    pack_params' codes, in the port and against JAX's pack_params."""
    params = _smoke_params()
    tq, _ = tpol.quantize_tree(to_port(params), planes=tpol.PLANE_W8)
    packed = t_pack(to_port(params))
    jpacked = j_pack(params)
    n = 0
    for key, leaf in _plane_leaves(tq).items():
        if isinstance(leaf, tdp.DPotQuantized):
            path = tuple(k.strip("'") for k in key[1:-1].split("]["))
            codes = tdp.dpot_pack_int8(leaf)
            assert torch.equal(codes, _get(packed, path)["packed"]), key
            assert_bitwise(_get(jpacked, path)["packed"], codes, key)
            assert torch.equal(leaf.scale, _get(packed, path)["scale"]), key
            n += 1
    assert n == 8


def test_plane_fingerprint_matches_jax(rng):
    """"fp", "dpot_w8" and the "dpot_mix_…" hash of the MIXED selection
    (and of a tree with a list, its indices "[0]") equal JAX's strings."""
    jmixed, tmixed = mixed_policies()
    params = _smoke_params()
    tparams = to_port(params)
    cases = [(params, tparams),
             (j_pack(params), t_pack(tparams)),
             (j_pack(params, jmixed), t_pack(tparams, tmixed)),
             (j_pack(params, jpol.PLANE_PROXY),
              t_pack(tparams, tpol.PLANE_PROXY))]
    got = [t_fingerprint(t) for _, t in cases]
    assert got == [j_fingerprint(j) for j, _ in cases]
    assert got[:2] == ["fp", "dpot_w8"] and got[2].startswith("dpot_mix_")
    w = jnp.asarray(rng.normal(size=(4, 8, 6)), jnp.float32)
    jlist = {"layers": [j_pack({"wk": w}, jpol.PLANE_W4),
                        j_pack({"wk": w})], "head": j_pack({"w": w[0]})}
    tlist = {"layers": [to_port(l) for l in jlist["layers"]],
             "head": to_port(jlist["head"])}
    assert t_fingerprint(tlist) == j_fingerprint(jlist)


@pytest.mark.parametrize("arch", ["rwkv4-169m", "rwkv6-7b", "smollm-135m"])
def test_packed_abstract_matches_pack_params(arch):
    """packed_abstract's meta tree has pack_params' structure, shapes and
    dtypes, and JAX's packed_abstract's."""
    tm = t_get_model(arch, smoke=True)
    jm = j_get_model(arch, smoke=True)
    ab = t_packed_abstract(tm.abstract_params())
    real = t_pack(tm.init_params(0, device="cpu"))
    jab = _flat_leaves(j_packed_abstract(jm.spec(), jm.abstract_params()))
    got = leaves_with_path(ab)
    assert [p for p, _ in got] == [p for p, _ in leaves_with_path(real)]
    for (path, a), (_, r) in zip(got, leaves_with_path(real)):
        assert a.device.type == "meta"
        assert (tuple(a.shape), a.dtype) == (tuple(r.shape), r.dtype), path
        j = jab[keystr(path)]
        assert tuple(a.shape) == j.shape, path
        assert str(a.dtype).replace("torch.", "") == j.dtype.name, path
