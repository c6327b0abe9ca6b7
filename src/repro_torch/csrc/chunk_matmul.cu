// K5, K5-W4, K5-VQ: out (M,N) bf16 = x (M,K) bf16 @ W, with W decoded
// in-kernel from one quantized plane exactly as unpack_leaf decodes it:
//   dpot_w8_matmul       W8 codes (K,N) u8 + scale (N,) f32
//   dpot_w4_matmul       W4 nibble pairs (K/2,N) u8 + scale (N,) f32
//   vq_matmul            VQ indices (K,N) u8 + codebook (C,) bf16, C <= 256
//   dpot_w8_matmul_f32x  K5 with an f32 x and an f32 out (M,N): the bf16
//                        weights promoted, the sum not rounded, as
//                        fused_prefill.py:102 gives result_type(x, dt); the
//                        hardware numerics feed att.wo an f32 activation
//
// Replaces the TPU kernels kernels/fused_prefill.py:dpot_chunk_matmul
// (_mm_kernel), w4_chunk_matmul (_mm_kernel_w4) and vq_chunk_matmul
// (_mm_kernel_vq).  Used for every prefill chunk matmul (M = B·C) and for
// the prefill and decode heads (M = B).  One kernel template over a
// weight-decode policy; the Pallas tiles are not carried over.
//
// What bounds it on an H100: the uint8 codes.  At M = 8 (the heads) the
// product is a GEMV over the code plane (38.6 MB for the W8 head, 19.3 MB
// for the W4 head), far below the card's ~295 flop/byte ridge, so device
// memory bandwidth is the limit; at M = 128 it is still below the ridge.
// The design reads each code byte from device memory once per block of
// TM rows, decodes it in registers (never writing bf16 weights back),
// stages the VQ codebook (at most 512 B) in shared memory, and keeps the
// TM partial sums in registers.  A CUDA-core FMA loop: simple and right
// first; the wgmma version with a dequantizing producer stage is later
// work.
//
// Batch invariance: out[m][n] accumulates x[m][k]·w[k][n] in f32 for
// k = 0..K-1 in order, one fmaf at a time, whatever M or the tile the row
// falls in, and rounds once to bf16.  So a row's result never depends on
// which other rows share the call.
#include "common.cuh"

namespace {

using repro::bf16;

constexpr int BN = 128;  // threads per block = output columns per block
constexpr int BK = 64;   // K tile of x staged in shared memory

// Weight-decode policies.  col(n) is read once per output column;
// at(k, n, ...) is the bf16-exact weight w[k][n] as a float.
struct DecodeW8 {
  const uint8_t* __restrict__ codes;
  const float* __restrict__ scale;
  __device__ void stage(bf16*) const {}
  __device__ float col(int n) const { return scale[n]; }
  __device__ float at(int k, int n, int N, float sc, const bf16*) const {
    return repro::dpot_w8_decode(__ldg(codes + (size_t)k * N + n), sc);
  }
};

struct DecodeW4 {
  const uint8_t* __restrict__ codes;  // row k lives in packed row k / 2
  const float* __restrict__ scale;
  __device__ void stage(bf16*) const {}
  __device__ float col(int n) const { return scale[n]; }
  __device__ float at(int k, int n, int N, float sc, const bf16*) const {
    return repro::dpot_w4_decode(__ldg(codes + (size_t)(k >> 1) * N + n),
                                 k & 1, sc);
  }
};

struct DecodeVQ {
  const uint8_t* __restrict__ codes;
  const bf16* __restrict__ codebook;
  int C;
  __device__ void stage(bf16* cb) const {
    for (int i = threadIdx.x; i < C; i += blockDim.x) cb[i] = codebook[i];
  }
  __device__ float col(int) const { return 0.f; }
  __device__ float at(int k, int n, int N, float, const bf16* cb) const {
    return repro::vq_decode(__ldg(codes + (size_t)k * N + n), cb);
  }
};

__device__ __forceinline__ float load_x(bf16 v) { return repro::bf2f(v); }
__device__ __forceinline__ float load_x(float v) { return v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

// TX: the activation type (bf16, or f32 for the f32-x form); the output
// has the same type, rounded once from the f32 sum
template <int TM, class Dec, typename TX>
__global__ void __launch_bounds__(BN)
chunk_matmul_kernel(const TX* __restrict__ x, const Dec dec,
                    TX* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[TM][BK];
  __shared__ __align__(4) unsigned char cb_raw[256 * sizeof(bf16)];
  bf16* cb = reinterpret_cast<bf16*>(cb_raw);
  dec.stage(cb);  // visible after the first barrier below
  const int n = blockIdx.x * BN + threadIdx.x;
  const int m0 = blockIdx.y * TM;
  const bool col_ok = n < N;  // ragged N edge (V = 50277 is odd)
  const float cp = col_ok ? dec.col(n) : 0.f;
  float acc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < TM * BK; i += BN) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      xs[r][c] = (m < M && k < K) ? load_x(x[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();
    const int kn = min(BK, K - k0);
    if (col_ok) {
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float w = dec.at(k0 + kk, n, N, cp, cb);
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i] = fmaf(xs[i][kk], w, acc[i]);
      }
    }
    __syncthreads();
  }
  if (col_ok) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + i;
      if (m < M) store_out(out + (size_t)m * N + n, acc[i]);
    }
  }
}

template <class Dec, typename TX = bf16>
int launch(const void* x, const Dec& dec, void* out, int M, int K, int N,
           void* stream) {
  if (M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(BN);
  const auto* xp = static_cast<const TX*>(x);
  auto* op = static_cast<TX*>(out);
  if (M <= 8) {
    const dim3 grid((N + BN - 1) / BN, (M + 7) / 8);
    chunk_matmul_kernel<8, Dec, TX><<<grid, block, 0, s>>>(xp, dec, op, M, K,
                                                           N);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
    chunk_matmul_kernel<16, Dec, TX><<<grid, block, 0, s>>>(xp, dec, op, M, K,
                                                            N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dpot_w8_matmul(const void* x, const void* wq, const void* scale,
                              void* out, int M, int K, int N, void* stream) {
  const DecodeW8 dec{static_cast<const uint8_t*>(wq),
                     static_cast<const float*>(scale)};
  return launch(x, dec, out, M, K, N, stream);
}

// x (M, K) f32 -> out (M, N) f32
extern "C" int dpot_w8_matmul_f32x(const void* x, const void* wq,
                                   const void* scale, void* out, int M, int K,
                                   int N, void* stream) {
  const DecodeW8 dec{static_cast<const uint8_t*>(wq),
                     static_cast<const float*>(scale)};
  return launch<DecodeW8, float>(x, dec, out, M, K, N, stream);
}

// wq4 (K/2, N): contraction row k is nibble k & 1 of packed row k / 2
extern "C" int dpot_w4_matmul(const void* x, const void* wq4,
                              const void* scale, void* out, int M, int K,
                              int N, void* stream) {
  if (K % 2) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeW4 dec{static_cast<const uint8_t*>(wq4),
                     static_cast<const float*>(scale)};
  return launch(x, dec, out, M, K, N, stream);
}

extern "C" int vq_matmul(const void* x, const void* idx, const void* codebook,
                         int C, void* out, int M, int K, int N, void* stream) {
  if (C < 1 || C > 256) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeVQ dec{static_cast<const uint8_t*>(idx),
                     static_cast<const bf16*>(codebook), C};
  return launch(x, dec, out, M, K, N, stream);
}
