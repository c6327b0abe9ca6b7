"""K5, K5-W4 and K5-VQ's launch plan and decode tables, on the CPU.

The kernel (`csrc/chunk_matmul.cu`) decodes a W8 code as
bf16(table[code]·scale[n]) and a W4 nibble as bf16(table4[nibble]·scale[n]),
with the tables `fused_prefill.decode_table` builds; here they are held bit
for bit to `unpack_leaf`, the port's and the JAX package's, for every code
under random f32 scales.  `chunk_matmul_plan` cuts K into slices from K
and N only (a row's bits must not depend on M): the slices tile K exactly,
W4's are even, and at every main-path shape of rwkv4-169m and rwkv6-7b the
grid has two blocks for each of the H100's 132 SMs, or one block per 16 KB
of codes when the plane is smaller.  The f32-x forms split x into three
bf16 pieces on the card; `split_bf16x3`, the split's plain twin, is held
here to its contract over every kind of finite f32 (hypothesis, with
subnormals and ±FLT_MAX): each piece a bf16 value, and x0 + x1 + x2 == x
in f32 wherever x's bits reach no lower than 2^-133, x cut toward zero
below that.  The kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

try:
    from hypothesis import example, given, settings, strategies as st
except ImportError:  # pragma: no cover
    from conftest import hypothesis_stubs
    given, settings, st = hypothesis_stubs()

    def example(*a, **k):
        return lambda fn: fn

from repro.core.quant.serving import unpack_leaf as j_unpack_leaf
from repro_torch.configs.base import get_config
from repro_torch.core.quant.serving import unpack_leaf
from repro_torch.kernels.fused_prefill import (
    BLOCK_CODE_BYTES, CHUNK_BK, TARGET_BLOCKS, chunk_matmul_plan,
    decode_table, split_bf16x3)
from repro_torch.models.rwkv6 import MAA_RANK, TD_RANK

CPU = torch.device("cpu")


def _bits(a) -> np.ndarray:
    """bf16 values as their 16-bit patterns."""
    return np.asarray(torch.as_tensor(np.asarray(a).astype(np.float32))
                      .to(torch.bfloat16).view(torch.int16))


def _scales(n, seed):
    # channel scales over many binades, as dpot_quantize's absmax gives
    rng = np.random.default_rng(seed)
    return (rng.random(n) * 2.0 ** rng.integers(-12, 4, n)).astype(
        np.float32)[None]


def test_w8_table_equals_unpack_leaf():
    """All 256 codes in each of 64 columns, each column its own scale."""
    table = decode_table("w8", CPU)
    assert table.shape == (256,) and table.dtype == torch.float32
    codes = np.tile(np.arange(256, dtype=np.uint8)[:, None], (1, 64))
    scale = _scales(64, 0)
    got = (table[torch.from_numpy(codes).long()]
           * torch.from_numpy(scale)).to(torch.bfloat16)
    port = unpack_leaf({"packed": torch.from_numpy(codes),
                        "scale": torch.from_numpy(scale)})
    jax_w = j_unpack_leaf({"packed": jnp.asarray(codes),
                           "scale": jnp.asarray(scale)})
    assert torch.equal(got.view(torch.int16), port.view(torch.int16))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  _bits(jax_w))


def test_w4_table_equals_unpack_leaf():
    """Packed bytes 0..255 hold every nibble in both rows of a pair (row
    2j the low nibble, 2j + 1 the high one)."""
    table = decode_table("w4", CPU)
    assert table.shape == (16,) and table.dtype == torch.float32
    packed = np.tile(np.arange(256, dtype=np.uint8)[:, None], (1, 64))
    scale = _scales(64, 1)
    nib = np.stack([packed & 15, packed >> 4], axis=1).reshape(512, 64)
    got = (table[torch.from_numpy(nib).long()]
           * torch.from_numpy(scale)).to(torch.bfloat16)
    port = unpack_leaf({"packed4": torch.from_numpy(packed),
                        "scale": torch.from_numpy(scale)})
    jax_w = j_unpack_leaf({"packed4": jnp.asarray(packed),
                           "scale": jnp.asarray(scale)})
    assert torch.equal(got.view(torch.int16), port.view(torch.int16))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  _bits(jax_w))


@pytest.mark.parametrize("K,N,plane", [
    (96, 203, "w8"), (200, 203, "w8"), (4160, 203, "w8"),
    (4160, 4096, "w8"), (768, 768, "w4"), (4160, 1024, "w4"),
    (3072, 768, "vq"), (64, 4096, "w8"), (4096, 64, "w8"), (32, 16, "w8")])
def test_plan_slices_do_not_depend_on_m(K, N, plane):
    plans = [chunk_matmul_plan(M, K, N, plane) for M in range(1, 301)]
    assert len({(p.slices, p.slice_len) for p in plans}) == 1
    p = plans[0]
    assert p.slice_len % CHUNK_BK == 0
    # the slices [s·L, min((s+1)·L, K)) tile K: none empty, none past it
    assert (p.slices - 1) * p.slice_len < K <= p.slices * p.slice_len
    if plane == "w4":
        assert p.slice_len % 2 == 0
    for M, q in zip(range(1, 301), plans):
        assert q.bm == min(128, 16 * -(-M // 16))
        assert q.row_tiles == -(-M // 128)


def _main_path_shapes():
    """(K, N, plane) of every chunk matmul the engines' prefill and heads
    run: rwkv4-169m's W8 tree and MIXED planes, rwkv6-7b's W8 tree with
    its three low-rank products."""
    c4, c6 = get_config("rwkv4-169m"), get_config("rwkv6-7b")
    D, F, V = c4.d_model, c4.d_ff, c4.vocab
    shapes = {"rwkv4 att": (D, D, "w8"), "rwkv4 ffn.wk": (D, F, "w8"),
              "rwkv4 ffn.wv": (F, D, "w8"), "rwkv4 head": (D, V, "w8"),
              "rwkv4 MIXED att.wk": (D, D, "w4"),
              "rwkv4 MIXED head": (D, V, "w4"),
              "rwkv4 MIXED ffn.wv": (F, D, "vq")}
    D, F, V = c6.d_model, c6.d_ff, c6.vocab
    shapes.update({"rwkv6 att": (D, D, "w8"), "rwkv6 ffn.wk": (D, F, "w8"),
                   "rwkv6 ffn.wv": (F, D, "w8"), "rwkv6 head": (D, V, "w8"),
                   "rwkv6 maa_w1": (D, 5 * MAA_RANK, "w8"),
                   "rwkv6 td_w1": (D, TD_RANK, "w8"),
                   "rwkv6 td_w2": (TD_RANK, D, "w8")})
    return shapes


MAIN_PATH = _main_path_shapes()


@pytest.mark.parametrize("name", list(MAIN_PATH))
def test_plan_fills_the_card(name):
    K, N, plane = MAIN_PATH[name]
    code_bytes = K * N // 2 if plane == "w4" else K * N
    want = min(TARGET_BLOCKS, -(-code_bytes // BLOCK_CODE_BYTES))
    for M in (8, 128):
        p = chunk_matmul_plan(M, K, N, plane)
        assert p.row_tiles == 1       # the plane is read once
        assert p.blocks >= want, (p, want)


FLT_MAX = float(np.finfo(np.float32).max)
GRID = 2.0 ** -133          # bf16's least subnormal


def _split_ok(x: np.ndarray):
    """split_bf16x3's contract on an f32 array of finite values."""
    t = torch.from_numpy(x.astype(np.float32))
    pieces = split_bf16x3(t)
    for p in pieces:
        bits = p.view(torch.int32)
        assert bool(((bits & 0xFFFF) == 0).all())   # a bf16 value
        assert bool(torch.isfinite(p).all())
    total = (pieces[0] + pieces[1]) + pieces[2]       # in f32
    x64 = t.double()
    exact = torch.remainder(x64, GRID) == 0           # bits >= 2^-133
    assert torch.equal(total[exact], t[exact])        # as values: -0 == 0
    # below the grid: x cut toward zero to a multiple of 2^-133
    cut = x64 - total.double()
    assert bool((cut.abs() < GRID).all())
    assert bool((cut * x64 >= 0).all())
    assert bool((torch.remainder(total.double(), GRID) == 0).all())
    # every normal |x| >= 2^-110 is exact
    assert bool(exact[x64.abs() >= 2.0 ** -110].all())


@settings(max_examples=500, deadline=None)
@given(st.floats(width=32, allow_nan=False, allow_infinity=False,
                 allow_subnormal=True))
@example(FLT_MAX)
@example(-FLT_MAX)
@example(2.0 ** -149)
@example(-(2.0 ** -126) * (1 + 2.0 ** -23))
@example(2.0 ** -110 * (1 + 2.0 ** -23))
@example(-0.0)
def test_bf16x3_split_is_exact(x):
    _split_ok(np.array([x], dtype=np.float32))


def test_bf16x3_split_over_random_bits():
    """2^20 random bit patterns (every exponent, both signs, subnormals)."""
    bits = np.random.default_rng(0).integers(0, 2 ** 32, 2 ** 20,
                                             dtype=np.uint64)
    x = bits.astype(np.uint32).view(np.float32)
    _split_ok(x[np.isfinite(x)])
