// Shared device helpers for the port's Hopper kernels.
//
// Rounding rule: every place where the JAX trace produces a bf16 value,
// the kernels round with bf16r() (round to nearest even), so intermediate
// values are the same bf16 grid points the plain PyTorch version holds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }

// exact 2^-q for 0 <= q < 127
__device__ __forceinline__ float exp2_neg(int q) {
  return __int_as_float((127 - q) << 23);
}

// One Δ-PoT W8 byte -> its bf16 weight, exactly as
// core/quant/serving.py:unpack_leaf computes it: bit 7 is the sign,
// bits 2:0 are Δq0 and bits 6:3 are Δq1; level = 2^-q0 + 2^-(q0+q1), a
// zero Δ killing the later terms (exact in f32); then sign·level times
// the channel's f32 scale, one f32 multiply, rounded once to bf16.
__device__ __forceinline__ float dpot_w8_decode(uint32_t byte, float scale) {
  const int dq0 = byte & 7;
  const int dq1 = (byte >> 3) & 15;
  float lvl = 0.f;
  if (dq0) {
    lvl = exp2_neg(dq0);
    if (dq1) lvl += exp2_neg(dq0 + dq1);
  }
  const float s = (byte & 0x80u) ? -lvl : lvl;
  return bf16r(s * scale);
}

// One Δ-PoT W4 weight -> its bf16 value, as the W4 branch of unpack_leaf
// computes it: the byte holds contraction rows 2j (low nibble) and 2j+1
// (high nibble); `hi` picks the nibble (k & 1).  Nibble bit 3 is the sign,
// bits 2:0 the code q; level = 2^-q, and 0 for q = 0.  Then sign·level
// times the channel's f32 scale, one f32 multiply, rounded once to bf16.
__device__ __forceinline__ float dpot_w4_decode(uint32_t byte, int hi,
                                                float scale) {
  const uint32_t nib = hi ? (byte >> 4) & 15u : byte & 15u;
  const int q = nib & 7;
  const float lvl = q ? exp2_neg(q) : 0.f;
  const float s = (nib & 8u) ? -lvl : lvl;
  return bf16r(s * scale);
}

// One VQ weight: the bf16 codebook entry its uint8 index names (the
// codebook in shared or global memory).
__device__ __forceinline__ float vq_decode(uint32_t idx, const bf16* cb) {
  return __bfloat162float(cb[idx]);
}

// A bf16 value held in the high or low 16 bits of a word, as a float.
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

// ---- Tensor-core building blocks (K5 and K13) ----------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
// 4 bytes global -> shared, asynchronously; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) · b (16x8 bf16, col), f32 accumulators.  The
// m16n8k16 layouts, g = lane / 4 and c = lane % 4: a[0] holds A (g, 2c and
// 2c+1), a[1] (g+8, 2c..), a[2] (g, 2c+8..), a[3] (g+8, 2c+8..), the
// lower column in the low 16 bits; b[0] B (2c and 2c+1, g), b[1] (2c+8..,
// g); d[0..1] D (g, 2c and 2c+1), d[2..3] (g+8, the same)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 values in one word, the first in the low 16 bits (an MMA
// fragment register): their bit patterns, and the two floats rounded.
__device__ __forceinline__ uint32_t pack_bf16_bits(uint32_t lo,
                                                   uint32_t hi) {
  return (lo & 0xffffu) | (hi << 16);
}
__device__ __forceinline__ uint32_t pack_bf16_rn(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16x16 tile whose f32 values sit in the C fragments
// of two m16n8 products (c0: columns 0-7, c1: columns 8-15; the m16n8 C
// layout is the A layout, FlashAttention-2's register reuse), in P bf16
// pieces: piece 0 = bf16_rn(x), piece i = bf16_rn(x - the pieces before).
// With P = 2, |x - hi - lo| <= 2^-17·|x| while x - hi is a normal f32,
// and <= 2^-134 (half bf16's least subnormal) below that; hi is finite
// for |x| < (2 - 2^-8)·2^127.
// kernels/flash_attention.py:split_bf16x2 is the two-piece plain twin.
template <int P>
__device__ __forceinline__ void c_to_a_pieces(const float* c0,
                                              const float* c1,
                                              uint32_t (&a)[P][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // A register r: columns 8·(r / 2) + 2c and +1, row g (r even) or g + 8
    const float* c = (r >> 1) ? c1 : c0;
    float x0 = c[2 * (r & 1)], x1 = c[2 * (r & 1) + 1];
#pragma unroll
    for (int pc = 0; pc < P; ++pc) {
      a[pc][r] = pack_bf16_rn(x0, x1);
      x0 -= bf16_lo(a[pc][r]);
      x1 -= bf16_hi(a[pc][r]);
    }
  }
}

// Rows [r0, r0 + nrows) of one head of a (B, S, heads, d) bf16 tensor
// (src at the head's first element, `row` elements a position), columns
// [0, dpad), into a shared tile of row stride LD; rows past S and columns
// past d as 0.  vec: 16-byte cp.async (d % 8 == 0, 16-byte aligned rows);
// else element loads.  K13 and its backward stage every tile so.
template <int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int r0, int nrows, int S,
                                          long long row, int d, int dpad,
                                          bool vec, int tid, int nthreads) {
  if (vec) {
    const int chunks = dpad / 8;
    for (int i = tid; i < nrows * chunks; i += nthreads) {
      const int r = i / chunks, c = (i % chunks) * 8;
      const bool ok = r0 + r < S && c < d;
      cp_async16(dst + r * LD + c, ok ? src + (r0 + r) * row + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < nrows * dpad; i += nthreads) {
      const int r = i / dpad, c = i % dpad;
      dst[r * LD + c] = r0 + r < S && c < d ? src[(r0 + r) * row + c]
                                            : __float2bfloat16_rn(0.f);
    }
  }
}

// The truncating three-way split of an f32 into bf16 pieces, as bit
// patterns: x0 is x with its low 16 bits cleared, x1 the same of x - x0,
// x2 the high 16 bits of x - x0 - x1.  Each difference is exact, so
// x0 + x1 + x2 == x for every finite x whose lowest set bit is at least
// 2^-133 (bf16's least subnormal; every |x| >= 2^-110 qualifies); below
// that, the pieces hold x cut toward zero to a multiple of 2^-133.  No
// piece overflows.  kernels/fused_prefill.py:split_bf16x3 is its plain
// twin.
__device__ __forceinline__ void split_bf16x3(float x, uint32_t* p) {
  const uint32_t u0 = __float_as_uint(x) & 0xffff0000u;
  const float r1 = x - __uint_as_float(u0);
  const uint32_t u1 = __float_as_uint(r1) & 0xffff0000u;
  const float r2 = r1 - __uint_as_float(u1);
  p[0] = u0 >> 16;
  p[1] = u1 >> 16;
  p[2] = __float_as_uint(r2) >> 16;
}

// σ(x) = 1 / (1 + exp(-x)) with each op rounded to bf16: how XLA expands
// jax.nn.sigmoid on bf16, and what models/rwkv4.py:sigmoid computes.
__device__ __forceinline__ float sigmoid_bf16(float x) {
  return bf16r(1.f / bf16r(1.f + bf16r(expf(-x))));
}

// Token-shift mix h·p + prev·(1-p), each op rounded to bf16 as in JAX.
__device__ __forceinline__ bf16 mix(float h, float prev, float p) {
  const float hp = bf16r(h * p);
  const float q = bf16r(1.f - p);
  const float xq = bf16r(prev * q);
  return __float2bfloat16_rn(hp + xq);
}

// One element (n, m) of the RWKV-6 WKV step (core/wkv/wkv6.py:wkv6_step)
// in f32, JAX's operation order, no contraction: kv = k[n]·v[m]; the
// output term r[n]·(S + u[n]·kv), which the caller adds to y[m] in order
// of n; and the stepped state w[n]·S + kv.
__device__ __forceinline__ float wkv6_term(float s, float r, float k,
                                           float v, float u, float w,
                                           float* s_new) {
  const float kv = k * v;
  *s_new = w * s + kv;
  return r * (s + u * kv);
}

// The weight forms a matrix may arrive in: the three quantized planes of
// core/quant/serving.py, or plain bf16 weights (a tree that was never
// packed).
enum Plane { kPlaneW8 = 0, kPlaneW4 = 1, kPlaneVQ = 2, kPlaneBF16 = 3 };

// A weight matrix as the decode kernels take it.
struct Matrix {
  const uint8_t* codes;  // W8, VQ: (K, N) bytes; W4: (K/2, N); BF16: (K, N)
                         // bf16 weights
  const void* aux;       // W8, W4: f32 scale (N,); VQ: bf16 codebook (C,);
                         // BF16: null
  int plane;             // enum Plane
  int aux_len;           // VQ: C, the codebook's entries (<= 256)
};

// The per-plane decode policies, one for each enum Plane, used by K7
// (rwkv6_body.cuh).  col(m, n) is what
// column n's weights share (the f32 scale of W8 and W4), read once a
// column; at(m, r, n, N, c) is weight (r, n) of an (R, N) matrix m, with
// c = col(m, n), as unpack_leaf decodes it (a W4 byte holds rows r & ~1
// and r | 1; a BF16 matrix's codes are its bf16 weights, as they are).
template <int PLANE>
struct Decode;

template <>
struct Decode<kPlaneW8> {
  static __device__ __forceinline__ float col(const Matrix& m, int n) {
    return static_cast<const float*>(m.aux)[n];
  }
  static __device__ __forceinline__ float at(const Matrix& m, int r, int n,
                                             int N, float c) {
    return dpot_w8_decode(__ldg(m.codes + (size_t)r * N + n), c);
  }
};

template <>
struct Decode<kPlaneW4> {
  static __device__ __forceinline__ float col(const Matrix& m, int n) {
    return static_cast<const float*>(m.aux)[n];
  }
  static __device__ __forceinline__ float at(const Matrix& m, int r, int n,
                                             int N, float c) {
    return dpot_w4_decode(__ldg(m.codes + (size_t)(r >> 1) * N + n), r & 1,
                          c);
  }
};

template <>
struct Decode<kPlaneVQ> {
  static __device__ __forceinline__ float col(const Matrix&, int) {
    return 0.f;
  }
  static __device__ __forceinline__ float at(const Matrix& m, int r, int n,
                                             int N, float) {
    return vq_decode(__ldg(m.codes + (size_t)r * N + n),
                     static_cast<const bf16*>(m.aux));
  }
};

template <>
struct Decode<kPlaneBF16> {
  static __device__ __forceinline__ float col(const Matrix&, int) {
    return 0.f;
  }
  static __device__ __forceinline__ float at(const Matrix& m, int r, int n,
                                             int N, float) {
    return bf16_lo(__ldg(reinterpret_cast<const unsigned short*>(m.codes) +
                         (size_t)r * N + n));
  }
};

// The exact e^x and x / y of the WKV step (the standard numerics);
// hw_units.cuh:LutUnits is the hardware numerics' counterpart.
struct ExactUnits {
  __device__ __forceinline__ float exp(float x) const { return expf(x); }
  __device__ __forceinline__ float div(float a, float b) const {
    return a / b;
  }
};

// The RWKV-4 WKV step (core/wkv/wkv4.py:wkv4_step), f32 throughout, in
// the same operation order, its exp and division from `un`.  Returns the
// output; writes the stepped state.
template <class Units = ExactUnits>
__device__ __forceinline__ float wkv4_step(float a, float b, float o, float k,
                                           float v, float w, float u,
                                           float* na, float* nb, float* no,
                                           const Units& un = Units()) {
  const float no1 = fmaxf(o, u + k);
  const float A = un.exp(o - no1);
  const float B = un.exp(u + k - no1);
  const float y = un.div(A * a + B * v, A * b + B);
  const float no2 = fmaxf(o - w, k);
  const float A2 = un.exp(o - w - no2);
  const float B2 = un.exp(k - no2);
  *na = A2 * a + B2 * v;
  *nb = A2 * b + B2;
  *no = no2;
  return y;
}

}  // namespace repro
