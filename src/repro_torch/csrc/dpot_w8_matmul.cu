// K5 (W8): out (M,N) bf16 = x (M,K) bf16 @ unpack_leaf(wq (K,N) u8, scale (N,) f32)
//
// Replaces the TPU kernel kernels/fused_prefill.py:dpot_chunk_matmul
// (_mm_kernel).  Used for every prefill chunk matmul (M = B·C) and for the
// prefill and decode heads (M = B).
//
// What bounds it on an H100: the uint8 codes.  At M = 8 (the heads) the
// product is a GEMV over a 38.6 MB code plane, far below the card's
// ~295 flop/byte ridge, so device-memory bandwidth is the limit; at
// M = 128 it is still below the ridge.  The design reads each code byte
// from device memory once per block of TM rows, decodes it in registers
// (never writing bf16 weights back), and keeps the TM partial sums in
// registers.  A CUDA-core FMA loop: simple and right first; the wgmma
// version with a dequantizing producer stage is later work.
//
// Batch invariance: out[m][n] accumulates x[m][k]·w[k][n] in f32 for
// k = 0..K-1 in order, one fmaf at a time, whatever M or the tile the row
// falls in, and rounds once to bf16.  So a row's result never depends on
// which other rows share the call.
#include "common.cuh"

namespace {

constexpr int BN = 128;  // threads per block = output columns per block
constexpr int BK = 64;   // K tile of x staged in shared memory

template <int TM>
__global__ void __launch_bounds__(BN)
dpot_w8_matmul_kernel(const repro::bf16* __restrict__ x,
                      const uint8_t* __restrict__ wq,
                      const float* __restrict__ scale,
                      repro::bf16* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[TM][BK];
  const int n = blockIdx.x * BN + threadIdx.x;
  const int m0 = blockIdx.y * TM;
  const bool col_ok = n < N;  // ragged N edge (V = 50277 is odd)
  const float sc = col_ok ? scale[n] : 0.f;
  float acc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < TM * BK; i += BN) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      xs[r][c] = (m < M && k < K) ? repro::bf2f(x[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();
    const int kn = min(BK, K - k0);
    if (col_ok) {
      const uint8_t* wp = wq + (size_t)k0 * N + n;
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float w = repro::dpot_w8_decode(__ldg(wp + (size_t)kk * N), sc);
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
      if (m < M) out[(size_t)m * N + n] = __float2bfloat16_rn(acc[i]);
    }
  }
}

}  // namespace

extern "C" int dpot_w8_matmul(const void* x, const void* wq, const void* scale,
                              void* out, int M, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(BN);
  const auto* xp = static_cast<const repro::bf16*>(x);
  const auto* wp = static_cast<const uint8_t*>(wq);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<repro::bf16*>(out);
  if (M <= 8) {
    const dim3 grid((N + BN - 1) / BN, (M + 7) / 8);
    dpot_w8_matmul_kernel<8><<<grid, block, 0, s>>>(xp, wp, sp, op, M, K, N);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
    dpot_w8_matmul_kernel<16><<<grid, block, 0, s>>>(xp, wp, sp, op, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}
