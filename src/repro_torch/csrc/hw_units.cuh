// The paper's hardware units as device functions, bit for bit the port's
// core/approx/units.py (and core/quant/uniform.py for the A9 step):
//   exp_lut      e^x = 2^(x·1.4375): 2^⌊y⌋ from the exponent bits, 2^frac
//                from the 256-entry EXP LUT
//   sigmoid_pwl  the 4-segment PWL σ with dyadic slopes
//   div_lut      x / y from the 16×16 DIV LUT after frexp normalization,
//                2^(ex − ey) by pow2_rn (ldexpf(1, n) without its
//                branches), saturating at y = 0
//   a9_scale/a9  the 9-bit fake quant of one value, given its tensor's
//                max |x|: scale = amax · fl(1/255), code = rint(x / scale)
//                clipped to ±255, value = code · scale
// K9 (expsig.cu) runs exp_lut and sigmoid_pwl over whole tensors; K2, K3
// and K4 run all of them inside their bodies under the hardware numerics.
// One source keeps the standalone unit and the fused ones from drifting.
//
// Every operation is one IEEE f32 operation rounded to nearest (the
// sources build with -fmad=false and without fast math): the products by
// 1.4375 and by the dyadic slopes are exact or rounded once, as in
// PyTorch.  Powers of two are never taken from exp2f.  Float-to-int index
// conversions truncate toward zero, then clamp, as astype(int32) then clip
// do.  NaN inputs give unspecified values.
#pragma once

#include "common.cuh"

namespace repro {

constexpr float kLog2eHw = 1.4375f;        // 1.0111 in binary
constexpr float kDivTiny = 0x1.b38fb8p-127f;  // f32(1e-38), subnormal
constexpr float kA9Recip = 0x1.010102p-8f;    // fl(1/255)

// exact 2^e for integer e in [-126, 127]
__device__ __forceinline__ float pow2_bits(int e) {
  return __int_as_float((e + 127) << 23);
}

// 2^n rounded once to f32, as ldexpf(1.f, n) returns it: a normal for n in
// [-126, 127], a subnormal for n in [-149, -127], 0 below (2^-150 is a tie
// that rounds to the even 0), inf above; from the bits, with no branch
// (ldexpf branches on |n|, which would keep a caller's steps apart)
__device__ __forceinline__ float pow2_rn(int n) {
  const int m = min(max(n, -150), 128);
  const unsigned sub = m >= -149 ? 1u << max(m + 149, 0) : 0u;
  return __uint_as_float(m >= -126 ? static_cast<unsigned>(m + 127) << 23
                                   : sub);
}

__device__ __forceinline__ float exp_lut(float x, const float* tab) {
  const float y = fminf(fmaxf(x * kLog2eHw, -24.f), 24.f);
  const float u = floorf(y);
  const float v = y - u;
  const int idx = min(max(static_cast<int>(v * 256.f), 0), 255);
  return pow2_bits(static_cast<int>(u)) * tab[idx];
}

__device__ __forceinline__ float sigmoid_pwl(float x) {
  const float ax = fabsf(x);
  float f;
  if (ax >= 5.f)
    f = 1.f;
  else if (ax >= 2.375f)
    f = 0.03125f * ax + 0.84375f;
  else if (ax >= 1.f)
    f = 0.125f * ax + 0.625f;
  else
    f = 0.25f * ax + 0.5f;
  return x >= 0.f ? f : 1.f - f;
}

__device__ __forceinline__ float div_lut(float x, float y, const float* tab) {
  const float sx = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float sign = sx * (y < 0.f ? -1.f : 1.f);
  const float ax = fabsf(x), ay = fabsf(y);
  int ex, ey;
  float mx = frexpf(fmaxf(ax, kDivTiny), &ex);  // m in [0.5, 1)
  float my = frexpf(fmaxf(ay, kDivTiny), &ey);
  mx *= 2.f;
  my *= 2.f;
  ex -= 1;
  ey -= 1;
  const int ix = min(max(static_cast<int>((mx - 1.f) * 16.f), 0), 15);
  const int iy = min(max(static_cast<int>((my - 1.f) * 16.f), 0), 15);
  // 2^(ex - ey) rounded once (0, subnormal or inf outside the normals),
  // then the product rounded once, as frac · exp2(ex - ey) in f32
  float q = tab[ix * 16 + iy] * pow2_rn(ex - ey);
  if (ay <= 0.f) q = 32768.f;  // saturate on y = 0
  if (ax <= 0.f) q = 0.f;
  return sign * q;
}

// The hardware numerics' exp and division for wkv4_step, the two tables
// (256 f32 each) in shared memory.
struct LutUnits {
  const float* exp_tab;
  const float* div_tab;
  __device__ __forceinline__ float exp(float x) const {
    return exp_lut(x, exp_tab);
  }
  __device__ __forceinline__ float div(float a, float b) const {
    return div_lut(a, b, div_tab);
  }
};

__device__ __forceinline__ float a9_scale(float amax) {
  return amax <= 0.f ? 1.f : amax * kA9Recip;
}

__device__ __forceinline__ float a9(float x, float scale) {
  return fminf(fmaxf(rintf(x / scale), -255.f), 255.f) * scale;
}

// a9's value with one multiply by rcp = 1 / scale in place of most
// divisions: for |x·rcp| < 2^12, x·rcp lies within 2^-10 of RN(x / scale)
// (two roundings of 2^-24 each), so both round to the same integer unless
// x·rcp is within 2^-10 of a rounding boundary; there, and for large, NaN
// or infinite quotients, the division is taken.  The same bits as a9.
__device__ __forceinline__ float a9_rcp(float x, float scale, float rcp) {
  const float q = x * rcp;
  float n = rintf(q);
  if (!(fabsf(q) < 4096.f && fabsf(q - n) < 0.5f - 0x1p-10f))
    n = rintf(x / scale);
  return fminf(fmaxf(n, -255.f), 255.f) * scale;
}

}  // namespace repro
