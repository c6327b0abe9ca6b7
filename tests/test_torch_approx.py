"""Port vs JAX: the paper's hardware units (`core/approx/units.py`), the A9
fake quant (`core/quant/uniform.py`) and the EXP-σ kernel K9's plain
versions (`kernels/expsig.py`).

Rules, each stated where it is checked:
  - sigmoid_pwl, lod and uniform_fake_quant: bit for bit against JAX under
    `jax.jit` (σ's slopes are powers of two, so its products are exact;
    A9's scale is amax·fl(1/255), as XLA compiles `amax / 255` under jit).
  - exp_lut and div_lut: bit for bit against a numpy model of the same
    formula with exact powers of two (`np.ldexp` in f64, rounded once to
    f32), and within 2^-20 relative of `jax.jit` of the JAX functions:
    XLA's `exp2` on the CPU is not exact at integers (up to 2^-20.7
    relative at the exponents these units reach), the hardware's shift is.
  - K9's plain versions against the JAX kernels in interpret mode: σ bit
    for bit, e^x by the rule above in f32; in bf16 an e^x output either
    equals JAX's or the exact value lies on a bf16 midpoint (the LUT's 9
    significant bits make ties common), the port rounds it to even, and
    JAX's inexact power moved it off the midpoint to the other neighbour.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core.approx import units as J
from repro.core.quant.uniform import uniform_fake_quant as j_fq
from repro.kernels.expsig import exp_kernel as j_exp_kernel
from repro.kernels.expsig import sigmoid_kernel as j_sigmoid_kernel
from repro_torch.core.approx import units as T
from repro_torch.core.quant.uniform import uniform_fake_quant as t_fq
from repro_torch.kernels.expsig import (
    exp_kernel, exp_kernel_plain, sigmoid_kernel, sigmoid_kernel_plain)

REL_JAX = 2.0 ** -20
EXP_TAB = np.reshape(T.EXP_LUT_TABLE, -1).astype(np.float32)
DIV_TAB = np.reshape(T.DIV_LUT_TABLE, -1).astype(np.float32)


def _pow2(e):
    """Exact 2^e, rounded once to f32."""
    return np.ldexp(1.0, np.asarray(e, np.int64)).astype(np.float32)


@np.errstate(over="ignore")
def np_exp_lut(x):
    x = np.asarray(x, np.float32)
    y = np.clip(x * np.float32(1.4375), np.float32(-24), np.float32(24))
    u = np.floor(y)
    v = y - u
    idx = np.clip((v * np.float32(256)).astype(np.int32), 0, 255)
    return _pow2(u) * EXP_TAB[idx]


@np.errstate(over="ignore")
def np_div_lut(x, y):
    x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
    sign = np.sign(x) * np.where(y < 0, np.float32(-1), np.float32(1))
    ax, ay = np.abs(x), np.abs(y)
    tiny = np.float32(1e-38)
    mx, ex = np.frexp(np.maximum(ax, tiny))
    my, ey = np.frexp(np.maximum(ay, tiny))
    mx, my = mx * np.float32(2), my * np.float32(2)
    ex, ey = ex - 1, ey - 1
    ix = np.clip(((mx - np.float32(1)) * np.float32(16)).astype(np.int32),
                 0, 15)
    iy = np.clip(((my - np.float32(1)) * np.float32(16)).astype(np.int32),
                 0, 15)
    q = DIV_TAB[ix * 16 + iy] * _pow2(ex - ey)
    q = np.where(ay <= 0, np.float32(2 ** 15), q)
    q = np.where(ax <= 0, np.float32(0), q)
    return (sign * q).astype(np.float32)


def _finite_patterns(rng, n, inf=True):
    """n random finite f32 values spread over every exponent (bit
    patterns), with zeros, subnormals and (given `inf`) ±inf among them."""
    bits = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32).copy()
    x[~np.isfinite(x)] = 0.0
    big = np.inf if inf else 3.4e38
    x[:8] = [0.0, -0.0, big, -big, 1e-40, -1e-45, 3.4e38, -1.2e-38]
    return x


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_tables_match_jax():
    np.testing.assert_array_equal(T.EXP_LUT_TABLE, J.EXP_LUT_TABLE)
    np.testing.assert_array_equal(T.DIV_LUT_TABLE, J.DIV_LUT_TABLE)
    assert T._LOG2E_HW == J._LOG2E_HW == 1.4375


def test_sigmoid_pwl_bitwise_vs_jax(rng):
    x = np.concatenate([
        (4 * rng.normal(size=1 << 16)).astype(np.float32),
        np.array([0, -0.0, 1, -1, 2.375, -2.375, 5, -5, 4.999, np.inf,
                  -np.inf], np.float32)])
    ref = np.asarray(jax.jit(J.sigmoid_pwl)(x))
    np.testing.assert_array_equal(T.sigmoid_pwl(_t(x)).numpy(), ref)


@pytest.mark.parametrize("width", [8, 16, 32])
def test_lod_bitwise_vs_jax(rng, width):
    x = rng.integers(-2 ** 31, 2 ** 31 - 1, 1 << 14).astype(np.int32)
    x[:3] = [0, 1, -1]
    ref = np.asarray(jax.jit(lambda a: J.lod(a, width))(x))
    np.testing.assert_array_equal(T.lod(_t(x), width).numpy(), ref)


@pytest.mark.parametrize("axis", [None, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_uniform_fake_quant_bitwise_vs_jax(rng, dtype, axis):
    a = (3 * rng.normal(size=(4, 16, 96))).astype(np.float32)
    a[1, 3] = 0.0                     # an all-zero row for axis=1's scale
    ja = jnp.asarray(a).astype(dtype)
    ref = np.asarray(jax.jit(lambda v: j_fq(v, 9, axis))(ja)).astype(
        np.float32)
    ta = _t(np.asarray(ja.astype(jnp.float32))).to(getattr(torch, dtype))
    got = t_fq(ta, 9, axis)
    assert got.dtype == ta.dtype
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_uniform_fake_quant_gradient_is_identity(rng, dtype):
    x = _t((3 * rng.normal(size=(8, 64))).astype(np.float32)).to(dtype)
    x.requires_grad_(True)
    g = _t(rng.normal(size=(8, 64)).astype(np.float32)).to(dtype)
    t_fq(x, 9, None).backward(g)
    assert torch.equal(x.grad, g)


def test_exp_lut_bitwise_vs_numpy_model(rng):
    x = np.concatenate([(8 * rng.normal(size=1 << 20)).astype(np.float32),
                        _finite_patterns(rng, 1 << 16)])
    np.testing.assert_array_equal(T.exp_lut(_t(x)).numpy(), np_exp_lut(x))


def test_div_lut_bitwise_vs_numpy_model(rng):
    """Over random bit patterns of every exponent, zeros and subnormals
    (the unit is not defined on ±inf): ratios that overflow give inf,
    that underflow 0 or a subnormal, as the exact formula rounds them."""
    n = 1 << 18
    x = np.concatenate([(8 * rng.normal(size=n)).astype(np.float32),
                        _finite_patterns(rng, n, inf=False)])
    y = np.concatenate([(8 * rng.normal(size=n)).astype(np.float32),
                        _finite_patterns(rng, n, inf=False)])
    got = T.div_lut(_t(x), _t(y)).numpy()
    np.testing.assert_array_equal(got, np_div_lut(x, y))


def test_exp_lut_within_2e20_of_jax(rng):
    x = (8 * rng.normal(size=1 << 20)).astype(np.float32)
    ref = np.asarray(jax.jit(J.exp_lut)(x))
    got = T.exp_lut(_t(x)).numpy()
    assert np.all(np.abs(got - ref) <= REL_JAX * np.abs(got))
    assert np.mean(got == ref) > 0.5


def test_div_lut_within_2e20_of_jax(rng):
    """x, y = 8·N(0, 1): where |ex - ey| <= 24 (the range the WKV
    recurrence's ratios take) XLA's exp2 is within 2^-20.7; farther out
    its error grows (2^-19.9 at 2^34), so those entries are held to the
    numpy model only (the test above)."""
    n = 1 << 20
    x = (8 * rng.normal(size=n)).astype(np.float32)
    y = (8 * rng.normal(size=n)).astype(np.float32)
    ref = np.asarray(jax.jit(J.div_lut)(x, y))
    got = T.div_lut(_t(x), _t(y)).numpy()
    near = np.abs(np.frexp(x)[1] - np.frexp(y)[1]) <= 24
    assert near.mean() > 0.999
    assert np.all(np.abs(got - ref)[near] <= REL_JAX * np.abs(got)[near])


def test_table_operand_forms_equal_defaults(rng):
    x = _t((8 * rng.normal(size=1 << 14)).astype(np.float32))
    y = _t((8 * rng.normal(size=1 << 14)).astype(np.float32))
    et = _t(EXP_TAB.copy())
    dt = _t(DIV_TAB.copy())
    assert torch.equal(T.exp_lut(x, table=et), T.exp_lut(x))
    assert torch.equal(T.div_lut(x, y, table=dt), T.div_lut(x, y))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k9_plain_vs_jax_interpret(rng, dtype):
    x = (8 * rng.normal(size=(64, 256))).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    j_sig = np.asarray(j_sigmoid_kernel(jx, interpret=True)).astype(
        np.float32)
    t_sig = sigmoid_kernel_plain(tx)
    assert t_sig.dtype == tx.dtype
    np.testing.assert_array_equal(t_sig.float().numpy(), j_sig)
    j_exp = np.asarray(j_exp_kernel(jx, interpret=True)).astype(np.float32)
    t_exp = exp_kernel_plain(tx)
    assert t_exp.dtype == tx.dtype
    got = t_exp.float().numpy()
    if dtype == "float32":
        assert np.all(np.abs(got - j_exp) <= REL_JAX * np.abs(got))
        return
    exact = T.exp_lut(tx.float()).numpy()
    np.testing.assert_array_equal(
        got, tx.new_tensor(exact).to(torch.bfloat16).float().numpy())
    off = got != j_exp
    assert off.mean() < 0.1
    np.testing.assert_array_equal(exact[off], (got[off] + j_exp[off]) / 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_cpu_is_plain(rng, dtype):
    """On CPU tensors the K9 wrappers run their plain versions and launch
    nothing; any shape comes back in the input's shape and dtype."""
    x = _t((8 * rng.normal(size=(3, 5, 7))).astype(np.float32)).to(dtype)
    before = (exp_kernel.launches, sigmoid_kernel.launches)
    e, s = exp_kernel(x), sigmoid_kernel(x)
    assert (exp_kernel.launches, sigmoid_kernel.launches) == before
    assert e.shape == s.shape == x.shape and e.dtype == s.dtype == dtype
    assert torch.equal(e, T.exp_lut(x).to(dtype))
    assert torch.equal(s, T.sigmoid_pwl(x).to(dtype))
