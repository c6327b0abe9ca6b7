// K10: the chunked RWKV-6 WKV over a whole sequence (long prefill).
//
// Replaces the TPU kernel kernels/wkv6.py:wkv6_pallas (_kernel): per head,
// the (N x N) f32 state stays on chip across all chunks, and each chunk of
// C tokens is done in one step:
//   L     = cumsum_c log max(w, 1e-38)        (in order of c; inclusive)
//   Lprev = L - log w                          (exclusive)
//   y     = (r e^Lprev) @ S                    (inter-chunk, exponents <= 0)
//         + att @ v,  att[s,i] = Σ_n r[s,n] k[i,n] e^(Lprev[s,n] - L[i,n])
//                     for i < s only (the TPU kernel masks the exponent to
//                     -1e30 before the exp; here the pairs are skipped)
//         + (Σ_n r[s,n] u[n] k[s,n]) v[s]      (the u-bonus)
//   S    <- e^Ltot S + (k e^(Ltot - L))ᵀ v     (Ltot = L[C-1]; exponents <= 0)
// in the TPU kernel's order of operations, with expf / logf (the build has
// no fast math and -fmad=false).
//
// r, k, v (B,T,H,N) f32 or bf16 (one type); w (B,T,H,N) f32 or bf16;
// u (H,N) f32; s0 (B,H,N,N) f32 or null (zeros) -> y (B,T,H,N) f32 and the
// final state (B,H,N,N) f32.  N in {16, 32, 64}; C <= 64 divides T.
//
// What bounds it on an H100: operations.  A chunk needs C(C-1)/2·N
// exponentials and ~4·C·N² multiply-adds a head (~2.0 M operations at
// C = N = 64), against ~14·C·N bytes of inputs and output: at B1 T32768
// H64 N64 that is ~66 G operations (~1 ms at 67 TFLOP/s f32) against
// 1.9 GB (~0.56 ms at 3.35 TB/s).  One block owns one (batch, head) pair
// and keeps its state in shared memory for the whole sequence, as the TPU
// kernel kept it in VMEM; one chunk's tiles (r, k, v, L, Lprev, r e^Lprev,
// k e^(Ltot-L)), the pair matrix and the state take ~150 KB of shared
// memory at C = N = 64 (opted in above 48 KB).  The pairwise decay tensor
// (C, C, N) is never stored: each thread owns a pair (s, i) and sums its
// N terms, the rows padded to N + 1 floats so a warp's pairs, which share
// s and run over i, read distinct banks.  At B = 1 the grid is H = 64
// blocks for 132 SMs; the blocks do not split a head.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxC = 64;

__device__ __forceinline__ float ld(const void* p, size_t i, int is_bf16) {
  return is_bf16 ? repro::bf2f(static_cast<const repro::bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

size_t smem_floats(int C, int N) {
  const int NP = N + 1;
  return (size_t)N * N + 7 * (size_t)C * NP + (size_t)C * C + C + 2 * N;
}

__global__ void __launch_bounds__(kThreads)
wkv6_chunked_kernel(const void* __restrict__ r, const void* __restrict__ k,
                    const void* __restrict__ v, const void* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    float* __restrict__ y, float* __restrict__ sf, int T,
                    int H, int N, int C, int rkv_bf16, int w_bf16) {
  extern __shared__ float sm[];
  const int NP = N + 1;
  float* S = sm;              // (N, N) the carried state
  float* rs = S + N * N;      // (C, NP) this chunk's r
  float* ks = rs + C * NP;    // k
  float* vs = ks + C * NP;    // v
  float* Ls = vs + C * NP;    // log w, then its inclusive cumsum L
  float* Lp = Ls + C * NP;    // Lprev = L - log w
  float* rd = Lp + C * NP;    // r e^Lprev
  float* kf = rd + C * NP;    // k e^(Ltot - L)
  float* att = kf + C * NP;   // (C, C), strictly lower part used
  float* bonus = att + C * C; // (C) Σ_n r u k
  float* eL = bonus + C;      // (N) e^Ltot
  float* us = eL + N;         // (N) u of this head
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t soff = (size_t)bh * N * N;
  for (int e = tid; e < N * N; e += kThreads)
    S[e] = s0 != nullptr ? s0[soff + e] : 0.f;
  for (int n = tid; n < N; n += kThreads) us[n] = u[h * N + n];
  const int n_pairs = C * (C - 1) / 2;
  for (int t0 = 0; t0 < T; t0 += C) {
    __syncthreads();  // the last chunk is done with every buffer
    for (int e = tid; e < C * N; e += kThreads) {
      const int c = e / N, n = e % N;
      const size_t g = (((size_t)b * T + t0 + c) * H + h) * N + n;
      rs[c * NP + n] = ld(r, g, rkv_bf16);
      ks[c * NP + n] = ld(k, g, rkv_bf16);
      vs[c * NP + n] = ld(v, g, rkv_bf16);
      Ls[c * NP + n] = logf(fmaxf(ld(w, g, w_bf16), 1e-38f));
    }
    __syncthreads();
    if (tid < N) {  // column tid: the cumsum in order of c
      float acc = 0.f;
      for (int c = 0; c < C; ++c) {
        const float lw = Ls[c * NP + tid];
        acc = acc + lw;
        Ls[c * NP + tid] = acc;
        Lp[c * NP + tid] = acc - lw;
      }
    } else if (tid >= kMaxC && tid < kMaxC + C) {  // row c's bonus
      const int c = tid - kMaxC;
      float acc = 0.f;
      for (int n = 0; n < N; ++n)
        acc = acc + rs[c * NP + n] * us[n] * ks[c * NP + n];
      bonus[c] = acc;
    }
    __syncthreads();
    const float* Ltot = Ls + (C - 1) * NP;
    for (int e = tid; e < C * N; e += kThreads) {
      const int c = e / N, n = e % N;
      rd[c * NP + n] = rs[c * NP + n] * expf(Lp[c * NP + n]);
      kf[c * NP + n] = ks[c * NP + n] * expf(Ltot[n] - Ls[c * NP + n]);
    }
    for (int n = tid; n < N; n += kThreads) eL[n] = expf(Ltot[n]);
    for (int p = tid; p < n_pairs; p += kThreads) {
      // pair p -> (s, i), i < s: row s holds pairs s(s-1)/2 ... s(s+1)/2-1
      int s = static_cast<int>(0.5f * (1.f + sqrtf(1.f + 8.f * p)));
      while (s * (s - 1) / 2 > p) --s;
      while (s * (s + 1) / 2 <= p) ++s;
      const int i = p - s * (s - 1) / 2;
      const float* rr = rs + s * NP;
      const float* lp = Lp + s * NP;
      const float* kk = ks + i * NP;
      const float* li = Ls + i * NP;
      float acc = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n)
        acc = acc + rr[n] * kk[n] * expf(lp[n] - li[n]);
      att[s * C + i] = acc;
    }
    __syncthreads();
    for (int e = tid; e < C * N; e += kThreads) {
      const int c = e / N, m = e % N;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = inter + rd[c * NP + n] * S[n * N + m];
      float intra = 0.f;
      for (int i = 0; i < c; ++i)
        intra = intra + att[c * C + i] * vs[i * NP + m];
      const float yv = (inter + intra) + bonus[c] * vs[c * NP + m];
      y[(((size_t)b * T + t0 + c) * H + h) * N + m] = yv;
    }
    __syncthreads();  // every y has read the old state
    for (int e = tid; e < N * N; e += kThreads) {
      const int n = e / N, m = e % N;
      float acc = 0.f;
      for (int i = 0; i < C; ++i) acc = acc + kf[i * NP + n] * vs[i * NP + m];
      S[e] = eL[n] * S[e] + acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < N * N; e += kThreads) sf[soff + e] = S[e];
}

}  // namespace

extern "C" int wkv6_chunked(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* y, void* sf, int B, int T, int H, int N,
                            int C, int rkv_bf16, int w_bf16, void* stream) {
  if (B < 1 || T < 1 || H < 1 || (N != 16 && N != 32 && N != 64) ||
      C < 1 || C > kMaxC || T % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(C, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_chunked_kernel<<<B * H, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      r, k, v, w, static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(y),
      static_cast<float*>(sf), T, H, N, C, rkv_bf16, w_bf16);
  return static_cast<int>(cudaGetLastError());
}
