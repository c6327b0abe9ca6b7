// K1 and K8: out (M,N) = x (M,K) @ decode(codes) · scale (N,), the codes'
// weights decoded in-kernel to f32, the products summed in f32:
//   dpot_matmul      W8 codes (K,N) u8: bit 7 the sign, bits 2:0 Δq0,
//                    bits 6:3 Δq1; weight sign·(2^-q0 + 2^-(q0+q1))·scale
//   dpot_matmul_w4   W4 nibble pairs (K/2,N) u8: row 2j the low nibble of
//                    packed row j, row 2j+1 the high one; nibble bit 3 the
//                    sign, bits 2:0 Δq; weight sign·2^-Δq·scale
// x is f32 or bf16 and the output has x's type, rounded once from the f32
// sum.  A zero Δq0 kills both W8 terms, a zero Δq1 the second; a zero Δq
// gives a zero W4 weight.
//
// Replaces the TPU kernels kernels/dpot_matmul.py:dpot_matmul (_kernel,
// _decode_w8) and dpot_matmul_w4 (_kernel_w4, _decode_w4).  Unlike K5
// (chunk_matmul.cu), which rounds each decoded weight to bf16 as
// unpack_leaf does, these keep the f32 weight, as the TPU kernels do: the
// TPU's (bm, bn, bk) tiles and their divisibility asserts are not carried
// over; any M and N run, and any even K for W4.
//
// Decode: each level is built from exponent bits (exp2_neg, exact), so
// sign·level is exact and the weight is one IEEE rounding of it times the
// scale: the same f32 bits as the plain version's dpot_dequantize
// (-fmad=false keeps that multiply alone).
//
// What bounds it on an H100: at M = 8 (a serving matvec) the code plane's
// bytes (one byte a weight for W8, half for W4) over 3.35 TB/s; at M = 128
// on rwkv6-7b's matrices the 2·M·K·N f32 operations over the 67 TFLOP/s
// of the CUDA cores (no tensor cores: the reference is a true f32 dot,
// and TF32 would move outputs by ~2^-11 relative).  The design: a block
// owns 32 output columns (one a lane, so a warp's code loads are 32
// consecutive bytes) and TM rows of x, staged in shared memory tile by
// tile (transposed, so one 16-byte load feeds four rows); its 8 warps split
// each 256-row tile of K, and each thread issues U independent code loads
// before it decodes and uses them, so several loads are in flight (K5's
// one dependent load a step is the fault this avoids).  The warps' partial
// sums meet in shared memory and are added in warp order.  Tensor cores,
// TMA and a pipelined producer stage are later work.
//
// Order and batch invariance: out[m][n] = Σ_w (Σ over warp w's rows of
// every tile, in increasing k, one fmaf at a time), the 8 partial sums
// added in warp order.  The order depends on K alone, never on M or on
// the tile a row falls in, so a row's result does not depend on the other
// rows of the call.
#include "common.cuh"

namespace {

using repro::bf16;
using repro::exp2_neg;

constexpr int WARPS = 8;          // K slices of a block
constexpr int KW = 32;            // rows of a tile a warp takes
constexpr int BK = WARPS * KW;    // rows of K a tile stages
constexpr int U = 16;             // code rows a thread loads before use

// the f32 W8 weight: sign·(t0 + t1)·scale, the TPU body's order
__device__ __forceinline__ float w8_weight(uint32_t byte, float scale) {
  const int dq0 = byte & 7;
  const int dq1 = (byte >> 3) & 15;
  float lvl = 0.f;
  if (dq0) {
    const float t0 = exp2_neg(dq0);
    lvl = dq1 ? t0 + exp2_neg(dq0 + dq1) : t0;
  }
  const float s = (byte & 0x80u) ? -lvl : lvl;
  return s * scale;
}

// the f32 W4 weight of one nibble: sign·2^-Δq·scale
__device__ __forceinline__ float w4_weight(uint32_t nib, float scale) {
  const int q = nib & 7;
  const float lvl = q ? exp2_neg(q) : 0.f;
  const float s = (nib & 8u) ? -lvl : lvl;
  return s * scale;
}

__device__ __forceinline__ float load_x(bf16 v) { return repro::bf2f(v); }
__device__ __forceinline__ float load_x(float v) { return v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

template <int TM, typename TX, bool W4>
__global__ void __launch_bounds__(32 * WARPS)
dpot_matmul_kernel(const TX* __restrict__ x,
                   const uint8_t* __restrict__ codes,
                   const float* __restrict__ scale, TX* __restrict__ out,
                   int M, int K, int N) {
  __shared__ __align__(16) float xs[BK][TM];   // x tile, xs[k][m]
  __shared__ float part[WARPS][TM][32];        // the warps' partial sums
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * TM;
  const bool col_ok = n < N;                   // ragged N (V = 50277)
  const float sc = col_ok ? scale[n] : 0.f;
  float acc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < TM * BK; i += blockDim.x) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K) ? load_x(x[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();
    const int kb = k0 + warp * KW;             // this warp's first row
    const int kn = min(KW, K - kb);            // its rows in this tile
    if (col_ok) {
      for (int kk = 0; kk < kn; kk += U) {
        // U rows' codes, every load issued before the first is used
        uint32_t c[W4 ? U / 2 : U];
        if constexpr (W4) {  // kb and kk are even, and so is kn (K even)
#pragma unroll
          for (int j = 0; j < U / 2; ++j)
            c[j] = (kk + 2 * j < kn)
                       ? __ldg(codes + (size_t)((kb + kk) / 2 + j) * N + n)
                       : 0u;
        } else {
#pragma unroll
          for (int j = 0; j < U; ++j)
            c[j] = (kk + j < kn)
                       ? __ldg(codes + (size_t)(kb + kk + j) * N + n)
                       : 0u;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (kk + u < kn) {
            float w;
            if constexpr (W4)
              w = w4_weight((c[u >> 1] >> (4 * (u & 1))) & 15u, sc);
            else
              w = w8_weight(c[u], sc);
            const float4* xr =
                reinterpret_cast<const float4*>(&xs[warp * KW + kk + u][0]);
#pragma unroll
            for (int i = 0; i < TM / 4; ++i) {
              const float4 xv = xr[i];
              acc[4 * i] = fmaf(xv.x, w, acc[4 * i]);
              acc[4 * i + 1] = fmaf(xv.y, w, acc[4 * i + 1]);
              acc[4 * i + 2] = fmaf(xv.z, w, acc[4 * i + 2]);
              acc[4 * i + 3] = fmaf(xv.w, w, acc[4 * i + 3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) part[warp][i][lane] = acc[i];
  __syncthreads();
  for (int t = threadIdx.x; t < TM * 32; t += blockDim.x) {
    const int i = t / 32, l = t % 32;
    const int m = m0 + i, nn = blockIdx.x * 32 + l;
    if (m < M && nn < N) {
      float s = part[0][i][l];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += part[w][i][l];
      store_out(out + (size_t)m * N + nn, s);
    }
  }
}

template <typename TX, bool W4>
int launch_typed(const void* x, const void* codes, const void* scale,
                 void* out, int M, int K, int N, cudaStream_t s) {
  const dim3 block(32 * WARPS);
  const auto* xp = static_cast<const TX*>(x);
  const auto* cp = static_cast<const uint8_t*>(codes);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<TX*>(out);
  if (M <= 8) {
    const dim3 grid((N + 31) / 32, 1);
    dpot_matmul_kernel<8, TX, W4><<<grid, block, 0, s>>>(xp, cp, sp, op, M,
                                                         K, N);
  } else {
    const dim3 grid((N + 31) / 32, (M + 15) / 16);
    dpot_matmul_kernel<16, TX, W4><<<grid, block, 0, s>>>(xp, cp, sp, op, M,
                                                          K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool W4>
int launch(const void* x, const void* codes, const void* scale, void* out,
           int M, int K, int N, int x_bf16, void* stream) {
  if (M < 1 || K < 1 || N < 1 || (W4 && K % 2) || M > 65535 * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_typed<bf16, W4>(x, codes, scale, out, M, K, N, s)
                : launch_typed<float, W4>(x, codes, scale, out, M, K, N, s);
}

}  // namespace

// x (M, K) bf16 (x_bf16 = 1) or f32 (0); wq (K, N); scale (N,) f32;
// out (M, N) in x's type
extern "C" int dpot_matmul(const void* x, const void* wq, const void* scale,
                           void* out, int M, int K, int N, int x_bf16,
                           void* stream) {
  return launch<false>(x, wq, scale, out, M, K, N, x_bf16, stream);
}

// wq4 (K/2, N): contraction row k is nibble k & 1 of packed row k / 2
extern "C" int dpot_matmul_w4(const void* x, const void* wq4,
                              const void* scale, void* out, int M, int K,
                              int N, int x_bf16, void* stream) {
  return launch<true>(x, wq4, scale, out, M, K, N, x_bf16, stream);
}
