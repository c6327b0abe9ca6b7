// K6: the masked sequential RWKV-6 WKV recurrence over a prompt chunk.
//
// Replaces the TPU kernel kernels/wkv6.py:wkv6_seq_pallas (_seq_kernel):
// the exact per-step wkv6_step math, with the `valid` commit mask and the
// bf16 carry snap of the chunked prefill.
//
// r, k, v, w (B,T,H,N) f32; u (H,N) f32; s0 (B,H,N,N) f32 or bf16 (the
// pool state itself: bf16 -> f32 is exact); valid (B,T) i32 or null
// -> y (B,T,H,N) f32 and the final state (B,H,N,N) f32.
//
// Each step, per head, with the state S (N x N):
//   y[m] = Σ_n r[n]·(S[n,m] + u[n]·(k[n]·v[m]))   (n in order)
//   S[n,m] <- w[n]·S[n,m] + k[n]·v[m]              (kept where valid == 0)
//   S <- bf16(S)                                    (bf16 carry)
// in JAX's operation order with no contraction (the build has -fmad=false,
// common.cuh:wkv6_term).  The state update has no reduction, so it
// matches the plain version bit for bit; y sums n in another order than
// the plain version's einsum.
//
// What bounds it on an H100: bytes.  A step does ~5·N² flops per head on
// 4·N inputs, so the work is small against reading r, k, v, w and the
// state once and writing y and the state once (~23 MB at B8 T16 H64 N64,
// ~7 µs at 3.35 TB/s).  One block owns one (batch, head) pair, 512 blocks
// at that shape, and keeps the head's N x N f32 state in shared memory
// (16 KB at N = 64) for the whole window, as the TPU kernel kept it in
// VMEM: the state never round-trips device memory between steps.  Thread m
// owns column m, so its state accesses are conflict-free and its step
// needs no barrier; r, k, w of each step are staged in shared memory for
// every column to read.
#include "common.cuh"

namespace {

using repro::bf16;

__global__ void wkv6_seq_kernel(const float* __restrict__ r,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ w,
                                const float* __restrict__ u,
                                const void* __restrict__ s0, int s0_bf16,
                                const int32_t* __restrict__ valid,
                                float* __restrict__ y, float* __restrict__ sf,
                                int T, int H, int N, int snap_bf16) {
  extern __shared__ float sm[];
  float* S = sm;            // (N, N), column m owned by thread m
  float* rs = S + N * N;    // this step's r, k, w; the head's u
  float* ks = rs + N;
  float* ws = ks + N;
  float* us = ws + N;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, m = threadIdx.x;
  const size_t soff = (size_t)bh * N * N;
  for (int n = 0; n < N; ++n) {
    const size_t i = soff + (size_t)n * N + m;
    S[n * N + m] = s0_bf16 ? repro::bf2f(static_cast<const bf16*>(s0)[i])
                           : static_cast<const float*>(s0)[i];
  }
  us[m] = u[h * N + m];
  for (int t = 0; t < T; ++t) {
    const size_t off = (((size_t)b * T + t) * H + h) * N;
    __syncthreads();  // every column is done with the last step's r, k, w
    rs[m] = r[off + m];
    ks[m] = k[off + m];
    ws[m] = w[off + m];
    const float vm = v[off + m];
    __syncthreads();
    const bool commit = valid == nullptr || valid[b * T + t] != 0;
    float yv = 0.f;
    for (int n = 0; n < N; ++n) {
      const float s = S[n * N + m];
      float ns;
      yv = yv + repro::wkv6_term(s, rs[n], ks[n], vm, us[n], ws[n], &ns);
      if (!commit) ns = s;
      S[n * N + m] = snap_bf16 ? repro::bf16r(ns) : ns;
    }
    y[off + m] = yv;
  }
  for (int n = 0; n < N; ++n) sf[soff + (size_t)n * N + m] = S[n * N + m];
}

}  // namespace

extern "C" int wkv6_seq(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        const void* valid, void* y, void* sf, int B, int T,
                        int H, int N, int s0_bf16, int snap_bf16,
                        void* stream) {
  if (B < 1 || T < 1 || H < 1 || N < 1 || N > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ((size_t)N * N + 4 * N) * sizeof(float);
  wkv6_seq_kernel<<<B * H, N, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), s0, s0_bf16,
      static_cast<const int32_t*>(valid), static_cast<float*>(y),
      static_cast<float*>(sf), T, H, N, snap_bf16);
  return static_cast<int>(cudaGetLastError());
}
