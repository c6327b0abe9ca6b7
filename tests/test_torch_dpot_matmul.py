"""Port vs JAX: kernels K1 (`dpot_matmul`, the Δ-PoT W8 matmul) and K8
(`dpot_matmul_w4`, its W4 form), their plain versions on the CPU against
JAX's Pallas kernels in interpret mode, and the port's public kernel entry
point `repro_torch.kernels.ops`.

Tolerances, stated per check:
  - the decoded f32 plane, bit for bit: sign · level is exact and one
    IEEE rounding at the scale follows, on both sides (JAX's exp2 sums
    land on the exact W8 and W4 levels);
  - outputs within K·2^-24·(|x| @ |w|) of JAX's (two f32 sums of the same
    K products in other orders: the Pallas kernel sums K blocks, torch its
    own order), plus one bf16 step at the larger of the two outputs for a
    bf16 x (each side rounds its f32 sum once).

The CUDA kernels' arithmetic (`csrc/chunk_matmul.cu`, the EXACT
instances) is modelled here in plain torch: each level as its bf16 pieces
(`piece_table`: bit for bit the level, zero pieces for a zero level), x as
its bf16 pieces, the exact products summed in f32 a slice of
`chunk_matmul_plan` at a time, the slices in order, the scale after the
sum.  The model is held to JAX's Pallas kernels by the same bound, and its
identity rows to JAX's decoded plane bit for bit.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import f32
from repro.core.quant.delta_pot import (
    FORMAT_W4, FORMAT_W8, dpot_dequantize as j_dequantize, dpot_pack_int8,
    dpot_pack_nibbles, dpot_quantize, dpot_unpack_nibbles as j_unpack4)
from repro.kernels import ref as R
from repro.kernels.dpot_matmul import (
    _decode_w4, _decode_w8, dpot_matmul as j_k1, dpot_matmul_w4 as j_k8)
from repro_torch.bridge import to_torch
from repro_torch.core.quant.delta_pot import (
    dpot_dequantize, dpot_unpack_int8, dpot_unpack_nibbles)
from repro_torch.device import exact_matmuls
from repro_torch.kernels.dpot_matmul import (
    dpot_matmul, dpot_matmul_plain, dpot_matmul_w4, dpot_matmul_w4_plain)
from repro_torch.kernels.fused_prefill import (
    chunk_matmul_plan, piece_table, split_bf16x3)

# tests/test_kernels.py's four (M, K, N) and the TPU tiles it runs them at
SHAPES = [(8, 128, 128, 8, 128, 128), (16, 256, 256, 8, 128, 128),
          (4, 512, 128, 4, 64, 256), (128, 128, 384, 64, 128, 128)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _operands(rng, M, K, N, jdt, w4=False):
    """x (M, K) in jdt, the W8 (or W4) plane of a Gaussian (K, N) weight
    with one scale a column (axis=1, as tests/test_kernels.py quantizes),
    and x @ |w| magnitudes in f64 for the summation bound."""
    x = jnp.asarray(rng.normal(size=(M, K)), jnp.float32).astype(jdt)
    w = jnp.asarray(rng.normal(size=(K, N)), jnp.float32)
    q = dpot_quantize(w, FORMAT_W4 if w4 else FORMAT_W8, axis=1)
    packed = dpot_pack_nibbles(q) if w4 else dpot_pack_int8(q)
    scale = q.scale[0]
    mag = np.abs(f32(x)).astype(np.float64) @ np.abs(
        np.asarray(j_dequantize(q), np.float64))
    return x, packed, scale, mag


def _port(*arrays):
    return [to_torch(np.asarray(a), "cpu") for a in arrays]


def _assert_within(ref, got, mag, K, bf16):
    r, g = f32(ref).astype(np.float64), f32(got).astype(np.float64)
    assert r.shape == g.shape
    bound = K * 2.0 ** -24 * mag
    if bf16:
        bound = bound + 2.0 ** -7 * np.maximum(np.abs(r), np.abs(g))
    d = np.abs(g - r)
    assert bool((d <= bound).all()), float((d - bound).max())


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("M,K,N,bm,bn,bk", SHAPES)
def test_k1_plain_matches_pallas(rng, M, K, N, bm, bn, bk, dt):
    jdt, tdt = DTYPES[dt]
    x, wq, scale, mag = _operands(rng, M, K, N, jdt)
    ref = j_k1(x, wq, scale, bm=bm, bn=bn, bk=bk, interpret=True)
    tx, twq, tsc = _port(x, wq, scale)
    got = dpot_matmul(tx, twq, tsc)
    assert got.dtype == tdt and ref.dtype == jdt
    _assert_within(ref, got, mag, K, dt == "bf16")
    # the plain version is jnp.dot of the oracle, kernels/ref.py
    _assert_within(R.dpot_matmul_ref(x, wq, scale), got, mag, K,
                   dt == "bf16")


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("M,K,N,bm,bn,bk", SHAPES)
def test_k8_plain_matches_pallas(rng, M, K, N, bm, bn, bk, dt):
    """K8 against JAX's Pallas W4 kernel (which no JAX test runs) and
    against the W4 oracle, dpot_unpack_nibbles + dpot_dequantize."""
    jdt, tdt = DTYPES[dt]
    x, wq4, scale, mag = _operands(rng, M, K, N, jdt, w4=True)
    ref = j_k8(x, wq4, scale, bm=bm, bn=bn, bk=bk, interpret=True)
    tx, twq, tsc = _port(x, wq4, scale)
    got = dpot_matmul_w4(tx, twq, tsc)
    assert got.dtype == tdt and ref.dtype == jdt
    _assert_within(ref, got, mag, K, dt == "bf16")
    w = j_dequantize(j_unpack4(wq4, scale[None, :], FORMAT_W4.ks))
    oracle = (x.astype(jnp.float32) @ w).astype(jdt)
    _assert_within(oracle, got, mag, K, dt == "bf16")


def _all_codes(rng, n_codes, N):
    """A plane whose row k holds code k in every column, and random
    positive per-column scales."""
    codes = np.repeat(np.arange(n_codes, dtype=np.uint8)[:, None], N, 1)
    scale = (rng.uniform(0.5, 2.0, N) * 2.0 ** rng.integers(
        -12, 4, N)).astype(np.float32)
    return codes, scale


def test_w8_decode_every_code_bitwise(rng):
    """All 256 W8 codes at 128 column scales: the port's decoded plane
    (dpot_unpack_int8 + dpot_dequantize) equals JAX's _decode_w8 under
    jit bit for bit (sign of zero included); identity rows through the
    plain version and through JAX's Pallas kernel give that plane."""
    codes, scale = _all_codes(rng, 256, 128)
    jplane = np.asarray(jax.jit(_decode_w8)(jnp.asarray(codes),
                                            jnp.asarray(scale)[None, :]))
    tc, ts = _port(codes, scale)
    plane = dpot_dequantize(dpot_unpack_int8(tc, ts[None, :], (3, 4)))
    np.testing.assert_array_equal(plane.numpy().view(np.uint32),
                                  jplane.view(np.uint32))
    eye = np.eye(256, dtype=np.float32)
    got = dpot_matmul(torch.from_numpy(eye), tc, ts)
    ref = j_k1(jnp.asarray(eye), jnp.asarray(codes), jnp.asarray(scale),
               interpret=True)
    np.testing.assert_array_equal(got.numpy(), jplane)
    np.testing.assert_array_equal(np.asarray(ref), jplane)


def test_w4_decode_every_code_bitwise(rng):
    """All 16 nibbles, each in the low and the high half of a byte: the
    port's decoded W4 plane equals JAX's _decode_w4 under jit bit for
    bit, and identity rows through both kernels' bodies give it."""
    codes, scale = _all_codes(rng, 16, 64)
    packed = np.concatenate([codes[0::2] | (codes[1::2] << 4),
                             codes[1::2] | (codes[0::2] << 4)])  # (16, 64)
    jplane = np.asarray(jax.jit(_decode_w4)(jnp.asarray(packed),
                                            jnp.asarray(scale)[None, :]))
    tp, ts = _port(packed, scale)
    plane = dpot_dequantize(dpot_unpack_nibbles(tp, ts[None, :], (3,)))
    np.testing.assert_array_equal(plane.numpy().view(np.uint32),
                                  jplane.view(np.uint32))
    eye = np.eye(32, dtype=np.float32)
    got = dpot_matmul_w4(torch.from_numpy(eye), tp, ts)
    ref = j_k8(jnp.asarray(eye), jnp.asarray(packed), jnp.asarray(scale),
               interpret=True)
    np.testing.assert_array_equal(got.numpy(), jplane)
    np.testing.assert_array_equal(np.asarray(ref), jplane)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("w4", [False, True], ids=["w8", "w4"])
def test_ragged_shapes(rng, dt, w4):
    """Any M and N (the port takes no TPU tiling): M 5, K 96, N 77,
    against the JAX oracles (JAX's Pallas kernels assert N % bn == 0)."""
    jdt, _ = DTYPES[dt]
    M, K, N = 5, 96, 77
    x, wq, scale, mag = _operands(rng, M, K, N, jdt, w4=w4)
    tx, twq, tsc = _port(x, wq, scale)
    if w4:
        got = dpot_matmul_w4(tx, twq, tsc)
        w = j_dequantize(j_unpack4(wq, scale[None, :], FORMAT_W4.ks))
        ref = (x.astype(jnp.float32) @ w).astype(jdt)
    else:
        got = dpot_matmul(tx, twq, tsc)
        ref = R.dpot_matmul_ref(x, wq, scale)
    assert tuple(got.shape) == (M, N)
    _assert_within(ref, got, mag, K, dt == "bf16")


def test_cpu_takes_the_plain_version(rng):
    """A CPU tensor runs the plain version, bit for bit, and launches
    nothing; the plain versions carry x's gradient (the CUDA kernels have
    none, as the TPU kernels have none)."""
    x, wq, scale, _ = _operands(rng, 8, 128, 64, jnp.float32)
    tx, twq, tsc = _port(x, wq, scale)
    n1, n4 = dpot_matmul.launches, dpot_matmul_w4.launches
    assert torch.equal(dpot_matmul(tx, twq, tsc),
                       dpot_matmul_plain(tx, twq, tsc))
    assert torch.equal(dpot_matmul_w4(tx, twq[:64], tsc),
                       dpot_matmul_w4_plain(tx, twq[:64], tsc))
    assert (dpot_matmul.launches, dpot_matmul_w4.launches) == (n1, n4)
    tx.requires_grad_()
    dpot_matmul(tx, twq, tsc).sum().backward()
    assert tx.grad is not None and tuple(tx.grad.shape) == (8, 128)


def test_ops_entry_point():
    """Each public name of JAX's `repro.kernels` (kernels/ops.py) has its
    counterpart in `repro_torch.kernels.ops`; the WKV kernels keep the
    port's names.  The package gives the ops names that are not also its
    submodules' names."""
    import repro.kernels as J
    import repro_torch.kernels as T
    from repro_torch.kernels import ops
    from repro_torch.kernels import dpot_matmul as mod
    renamed = {"wkv4_pallas": "wkv4_seq",
               "wkv6_pallas": "wkv6_chunked_kernel"}
    for name in J.__all__:
        assert callable(getattr(ops, renamed.get(name, name))), name
    assert sorted(ops.__all__) == sorted(
        [renamed.get(n, n) for n in J.__all__] + ["dpot_matmul_w4"])
    assert ops.dpot_matmul is mod.dpot_matmul is dpot_matmul
    assert ops.dpot_matmul_w4 is T.dpot_matmul_w4 is dpot_matmul_w4
    for name in ("exp_kernel", "fused_cross_entropy", "sigmoid_kernel",
                 "wkv4_seq", "wkv6_chunked_kernel"):
        assert getattr(T, name) is getattr(ops, name)


# --- the CUDA kernels' arithmetic: exact bf16 pieces, the scale after the sum

def _pieces(plane):
    """`piece_table(plane)` unpacked: (hi, lo) as f32 numpy arrays, one
    entry a code (W8) or nibble (W4)."""
    w = piece_table(plane, torch.device("cpu")).numpy().view(np.uint32)
    return ((w & 0xFFFF) << 16).view(np.float32), \
        (w & 0xFFFF0000).view(np.float32)


def _kernel_model(x, codes, scale, w4):
    """K1's (or K8's) result as the CUDA kernel forms it, in plain torch:
    the weight's pieces from its code, x's pieces (a bf16 x is one, an f32
    x three by `split_bf16x3`), every piece product summed in f32 a slice
    of `chunk_matmul_plan` at a time, the slices added in order, then the
    column scale, then one rounding to x's dtype."""
    plane = "w4" if w4 else "w8"
    c = codes.numpy().astype(np.int64)
    if w4:
        c = np.stack([c & 15, c >> 4], 1).reshape(2 * c.shape[0], -1)
    ws = [torch.from_numpy(p[c]) for p in _pieces(plane)[:1 if w4 else 2]]
    xs = ([x.float()] if x.dtype == torch.bfloat16
          else list(split_bf16x3(x)))
    M, K = x.shape
    plan = chunk_matmul_plan(M, K, c.shape[1], plane)
    total = None
    with exact_matmuls():
        for s in range(plan.slices):
            k = slice(s * plan.slice_len, (s + 1) * plan.slice_len)
            part = sum(xp[:, k] @ wp[k] for xp in xs for wp in ws)
            total = part if total is None else total + part
    return (total * scale).to(x.dtype)


@pytest.mark.parametrize("w4", [False, True], ids=["w8", "w4"])
def test_piece_table_is_the_level_exactly(w4):
    """Every W8 code's hi and lo (every W4 nibble's level) are bf16 values
    whose f32 sum is the sign·level that dpot_dequantize forms at scale 1
    and that JAX's decode forms, bit for bit; a zero level (Δq0 = 0, or a
    zero Δq) has zero pieces (its sign gives -0 on the plain side)."""
    n = 16 if w4 else 256
    hi, lo = _pieces("w4" if w4 else "w8")
    for p in (hi, lo):
        bf = torch.from_numpy(p).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(bf.view(np.uint32), p.view(np.uint32))
    codes = np.arange(n, dtype=np.uint8)[:, None]
    one = np.ones(1, np.float32)
    if w4:
        assert not lo.any()
        packed = codes[0::2] | (codes[1::2] << 4)
        ref = dpot_dequantize(dpot_unpack_nibbles(
            torch.from_numpy(packed), torch.from_numpy(one)[None], (3,)))
        jref = np.asarray(jax.jit(_decode_w4)(jnp.asarray(packed),
                                              jnp.asarray(one)[None]))
    else:
        ref = dpot_dequantize(dpot_unpack_int8(
            torch.from_numpy(codes), torch.from_numpy(one)[None], (3, 4)))
        jref = np.asarray(jax.jit(_decode_w8)(jnp.asarray(codes),
                                              jnp.asarray(one)[None]))
    ref = ref.numpy()[:, 0]
    np.testing.assert_array_equal(ref.view(np.uint32),
                                  jref[:, 0].view(np.uint32))
    total = hi + lo
    nz = ref != 0
    np.testing.assert_array_equal(total[nz].view(np.uint32),
                                  ref[nz].view(np.uint32))
    assert not hi[~nz].any() and not lo[~nz].any()
    if not w4:
        # lo is nonzero exactly where Δq0 > 0 and Δq1 > 7
        dq0, dq1 = codes[:, 0] & 7, (codes[:, 0] >> 3) & 15
        np.testing.assert_array_equal(lo != 0, (dq0 > 0) & (dq1 > 7))


@pytest.mark.parametrize("w4", [False, True], ids=["k1", "k8"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("M,K,N,bm,bn,bk", SHAPES)
def test_kernel_model_matches_pallas(rng, M, K, N, bm, bn, bk, dt, w4):
    """The model of the CUDA kernels' arithmetic against JAX's Pallas
    dpot_matmul / dpot_matmul_w4 in interpret mode, within K·2^-24·(|x| @
    |w|) (plus one bf16 step for a bf16 x)."""
    jdt, tdt = DTYPES[dt]
    x, wq, scale, mag = _operands(rng, M, K, N, jdt, w4=w4)
    ref = (j_k8 if w4 else j_k1)(x, wq, scale, bm=bm, bn=bn, bk=bk,
                                 interpret=True)
    tx, twq, tsc = _port(x, wq, scale)
    got = _kernel_model(tx, twq, tsc, w4)
    assert got.dtype == tdt
    _assert_within(ref, got, mag, K, dt == "bf16")


@pytest.mark.parametrize("w4", [False, True], ids=["k1", "k8"])
def test_kernel_model_identity_rows_give_the_plane(rng, w4):
    """Identity rows (f32 x) through the model pick out JAX's decoded f32
    plane bit for bit, for every code at random column scales (-0 of a
    signed zero level compares equal to 0)."""
    if w4:
        codes, scale = _all_codes(rng, 16, 64)
        codes = np.concatenate([codes[0::2] | (codes[1::2] << 4),
                                codes[1::2] | (codes[0::2] << 4)])
        jplane = np.asarray(jax.jit(_decode_w4)(jnp.asarray(codes),
                                                jnp.asarray(scale)[None]))
    else:
        codes, scale = _all_codes(rng, 256, 128)
        jplane = np.asarray(jax.jit(_decode_w8)(jnp.asarray(codes),
                                                jnp.asarray(scale)[None]))
    tc, ts = _port(codes, scale)
    eye = torch.eye(jplane.shape[0])
    got = _kernel_model(eye, tc, ts, w4).numpy()
    np.testing.assert_array_equal(got, jplane)
    nz = jplane != 0
    np.testing.assert_array_equal(got[nz].view(np.uint32),
                                  jplane[nz].view(np.uint32))
