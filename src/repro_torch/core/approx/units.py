"""The paper's complex-operation hardware units as bit-accurate models
(port of `repro/core/approx/units.py`).

  exp_lut      e^x = 2^(x·1.4375): 2^⌊y⌋ by shift, 2^frac from a 256-entry
               LUT on the top 8 fraction bits (the EXP unit, mode 0 of
               the EXP-σ unit)
  sigmoid_pwl  σ as a 4-segment piecewise-linear curve with dyadic slopes
               (mode 1)
  lod          the leading-one detector's successive-halving search
  div_lut      x / y from a 16×16 LUT of mantissa ratios after leading-one
               normalization, the exponent difference as a shift

All take and return f32 tensors (lod int32).  The powers of two are built
exactly, as the paper's unit shifts: the JAX reference computes them with
`jnp.exp2`, which XLA on the CPU returns inexactly at some integers (off
by up to 2^-20.8 relative), so the two agree within 2^-20 relative and the
port agrees with the formula computed exactly bit for bit.

Subnormal inputs: the port computes IEEE f32 with subnormals, on the CPU
and on the card alike (`div_lut` clamps |x| and |y| to f32(1e-38), itself
subnormal, before normalizing).  XLA on the CPU flushes subnormals to
zero, so for a subnormal divisor or dividend the JAX reference may
saturate or return 0 where the port divides.  NaN inputs, and ±inf in
`div_lut`, give unspecified values (an infinite mantissa's conversion to
a LUT index is platform-defined).

`table=` passes a LUT as an operand (256 f32 values: the EXP fractions,
or the DIV ratios row-major by (x mantissa bin, y mantissa bin)); the
default is the module's constant, on the input's device.
"""
from __future__ import annotations

import numpy as np
import torch

# log2(e) as the paper's unit computes it: 1.0111 in binary, one add, one
# subtract and two shifts
_LOG2E_HW = 1.0 + 0.25 + 0.125 + 0.0625

# 2^(i/256) rounded to 8 fraction bits
EXP_LUT_TABLE = np.round(np.exp2(np.arange(256) / 256.0) * 256.0) / 256.0


def _build_div_lut() -> np.ndarray:
    """table[i, j] = (1 + (i + 0.5)/16) / (1 + (j + 0.5)/16), 8-bit
    rounded: the ratio of the two mantissa bins' midpoints."""
    i = 1.0 + (np.arange(16)[:, None] + 0.5) / 16.0
    j = 1.0 + (np.arange(16)[None, :] + 0.5) / 16.0
    return np.round(i / j * 256.0) / 256.0


DIV_LUT_TABLE = _build_div_lut()
# the smallest magnitude div_lut normalizes, as the JAX unit clamps it
_TINY = float(np.float32(1e-38))

_TABLES: dict = {}


def lut_tensor(which: str, device) -> torch.Tensor:
    """The module's EXP ("exp") or DIV ("div") table as a flat (256,) f32
    tensor on `device`, made once per device."""
    key = (which, str(torch.device(device)))
    if key not in _TABLES:
        t = EXP_LUT_TABLE if which == "exp" else DIV_LUT_TABLE
        _TABLES[key] = torch.tensor(np.reshape(t, -1), dtype=torch.float32,
                                    device=device)
    return _TABLES[key]


def _pow2_small(e: torch.Tensor) -> torch.Tensor:
    """Exact f32 2^e for integer-valued e in [-126, 127]: the exponent
    bits."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e rounded once to f32 for any integer e: exact in f64, then one
    rounding (0 below the subnormals, inf above 2^127)."""
    e = e.to(torch.int64).clamp(-1022, 1023)
    return ((e + 1023) << 52).view(torch.float64).to(torch.float32)


def exp_lut(x: torch.Tensor, *, table: torch.Tensor | None = None
            ) -> torch.Tensor:
    """e^x per the paper's EXP unit: y = clip(x·1.4375, ±24), then
    2^⌊y⌋ · LUT[⌊256·(y − ⌊y⌋)⌋]."""
    x = x.to(torch.float32)
    tab = lut_tensor("exp", x.device) if table is None else table
    y = torch.clamp(x * _LOG2E_HW, -24.0, 24.0)
    u = torch.floor(y)
    v = y - u
    idx = torch.clamp((v * 256.0).to(torch.int32), 0, 255)
    return _pow2_small(u) * tab[idx.long()]


def sigmoid_pwl(x: torch.Tensor) -> torch.Tensor:
    """σ(x) as the paper's Eq. 9: a 4-segment PWL with dyadic slopes on
    |x|, mirrored for x < 0."""
    x = x.to(torch.float32)
    ax = x.abs()
    f = torch.where(
        ax >= 5.0, 1.0,
        torch.where(ax >= 2.375, 0.03125 * ax + 0.84375,
                    torch.where(ax >= 1.0, 0.125 * ax + 0.625,
                                0.25 * ax + 0.5)))
    return torch.where(x >= 0, f, 1.0 - f)


def lod(x: torch.Tensor, width: int = 16) -> torch.Tensor:
    """Leading-one position of each int32 (its low `width` bits), -1 for
    0, by the successive-halving search (Algorithm 1)."""
    x = x.to(torch.int32)
    d = x & ((1 << width) - 1) if width < 32 else x
    p = torch.zeros_like(d)
    w = width
    while w > 1:
        h = w // 2
        upper = d >> h
        has_upper = upper != 0
        p = torch.where(has_upper, p + h, p)
        d = torch.where(has_upper, upper, d & ((1 << h) - 1))
        w = h
    return torch.where(x == 0, -1, p)


def div_lut(x: torch.Tensor, y: torch.Tensor, *,
            table: torch.Tensor | None = None) -> torch.Tensor:
    """x / y per the paper's unsigned division unit on f32 carriers: signs
    apart, magnitudes normalized to [1, 2) (frexp), the mantissa ratio
    from the LUT by the top 4 bits after the leading one of each, the
    exponent difference applied as 2^(ex − ey).  y = 0 saturates at
    2^15; x = 0 gives 0."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    tab = lut_tensor("div", x.device) if table is None else table
    sign = torch.sign(x) * torch.where(y < 0, -1.0, 1.0)
    ax, ay = x.abs(), y.abs()
    mx, ex = torch.frexp(torch.clamp_min(ax, _TINY))   # m in [0.5, 1)
    my, ey = torch.frexp(torch.clamp_min(ay, _TINY))
    mx, ex = mx * 2.0, ex - 1
    my, ey = my * 2.0, ey - 1
    ix = torch.clamp(((mx - 1.0) * 16.0).to(torch.int32), 0, 15)
    iy = torch.clamp(((my - 1.0) * 16.0).to(torch.int32), 0, 15)
    q = tab[(ix * 16 + iy).long()] * _pow2(ex - ey)
    q = torch.where(ay <= 0, 2.0 ** 15, q)       # saturate on y = 0
    q = torch.where(ax <= 0, 0.0, q)
    return sign * q
