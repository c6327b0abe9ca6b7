// K12 and K12-bwd: cross-entropy over a large vocabulary, one read of the
// logits each way.
//
// Replaces the TPU kernels kernels/fused_ce.py:_fwd_kernel (launched by
// _fwd_call) and _bwd_kernel (launched by _ce_bwd):
//   forward   x (N, V) f32 or bf16, labels (N,) i32 ->
//             lse = max + log(max(Σ exp(x − max), 1e-30)),
//             nll = lse − x[label]                     both (N,) f32;
//   backward  dx = (exp(x − lse) − onehot(label)) · g   (N, V) in x's type,
//             computed in f32 and rounded once (JAX's astype(f32) cotangent).
// A label outside [0, V) picks no logit (nll = lse, no onehot), as the TPU
// kernel's block test gives.
//
// What bounds it on an H100: bytes.  A row is one pass over V logits with
// ~4 operations an element (an exp, a max, two adds), far below the card's
// ~295 operations a byte: (8192, 50277) bf16 moves 0.82 GB forward (≥ 0.246
// ms at 3.35 TB/s) and 1.65 GB backward (≥ 0.49 ms).  The design: one block
// a row, each thread carrying its own online (max, sum-exp) over 16-byte
// loads, merged in a warp-shuffle tree and across warps in shared memory;
// the TPU kernel walked vocabulary blocks in order with the pair in VMEM
// scratch, and shrank its block until it divided V (V = 50277 = 3·16759
// has no power-of-two divisor).  Here the row is split at its first 16-byte
// boundary: a ragged head and tail take scalar loads, the middle 16-byte
// vectors, so any V and any row alignment compute the same function.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(repro::bf16 x) { return repro::bf2f(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(repro::bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Walk row p[0, V) in this block: f(j, vals, n) gets n consecutive values
// from column j, n = VEC from a 16-byte load or n = 1 at the ragged edges.
// With VECTOR false every element takes a scalar load.
template <typename T, bool VECTOR, typename F>
__device__ __forceinline__ void for_row(const T* p, int V, F&& f) {
  constexpr int VEC = 16 / sizeof(T);
  int head = V;
  if (VECTOR) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    head = static_cast<int>(((16 - (a & 15)) & 15) / sizeof(T));
    if (head > V) head = V;
  }
  for (int j = threadIdx.x; j < head; j += blockDim.x) {
    const float v = to_f(p[j]);
    f(j, &v, 1);
  }
  if (!VECTOR) return;
  const int nvec = (V - head) / VEC;
  const uint4* pv = reinterpret_cast<const uint4*>(p + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 raw = pv[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    float vals[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) vals[q] = to_f(e[q]);
    f(head + i * VEC, vals, VEC);
  }
  for (int j = head + nvec * VEC + threadIdx.x; j < V; j += blockDim.x) {
    const float v = to_f(p[j]);
    f(j, &v, 1);
  }
}

// (m, s) <- the pair for the union of two sets of logits
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ x, const int32_t* __restrict__ labels,
              float* __restrict__ nll, float* __restrict__ lse, int V) {
  __shared__ float part[2][kThreads / 32];
  const size_t row = blockIdx.x;
  const T* p = x + row * V;
  float m = kNegInf, s = 0.f;
  for_row<T, VECTOR>(p, V, [&](int, const float* v, int n) {
    float mv = v[0];
    for (int q = 1; q < n; ++q) mv = fmaxf(mv, v[q]);
    const float mn = fmaxf(m, mv);
    float add = 0.f;
    for (int q = 0; q < n; ++q) add = add + expf(v[q] - mn);
    s = s * expf(m - mn) + add;
    m = mn;
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    merge(m, s, __shfl_xor_sync(0xffffffffu, m, o),
          __shfl_xor_sync(0xffffffffu, s, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = m;
    part[1][warp] = s;
  }
  __syncthreads();
  if (warp != 0) return;
  m = lane < kThreads / 32 ? part[0][lane] : kNegInf;
  s = lane < kThreads / 32 ? part[1][lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    merge(m, s, __shfl_xor_sync(0xffffffffu, m, o),
          __shfl_xor_sync(0xffffffffu, s, o));
  if (lane == 0) {
    const int lbl = labels[row];
    const float t = (lbl >= 0 && lbl < V) ? to_f(p[lbl]) : 0.f;
    const float l = m + logf(fmaxf(s, 1e-30f));
    lse[row] = l;
    nll[row] = l - t;
  }
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ x, const int32_t* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ g,
              T* __restrict__ dx, int V) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t row = blockIdx.x;
  const T* p = x + row * V;
  T* d = dx + row * V;
  const float l = lse[row], gr = g[row];
  const int lbl = labels[row];
  for_row<T, VECTOR>(p, V, [&](int j, const float* v, int n) {
    float o[VEC];
    for (int q = 0; q < n; ++q) {
      const float hit = (j + q == lbl) ? 1.f : 0.f;
      o[q] = (expf(v[q] - l) - hit) * gr;
    }
    if (n == VEC) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int q = 0; q < VEC; ++q) from_f(e + q, o[q]);
      *reinterpret_cast<uint4*>(d + j) = raw;
    } else {
      for (int q = 0; q < n; ++q) from_f(d + j + q, o[q]);
    }
  });
}

template <typename T>
int fwd(const void* x, const void* labels, void* nll, void* lse, int N,
        int V, cudaStream_t st) {
  ce_fwd_kernel<T, true><<<N, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(labels),
      static_cast<float*>(nll), static_cast<float*>(lse), V);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* x, const void* labels, const void* lse, const void* g,
        void* dx, int N, int V, int vec, cudaStream_t st) {
  auto k = vec ? ce_bwd_kernel<T, true> : ce_bwd_kernel<T, false>;
  k<<<N, kThreads, 0, st>>>(static_cast<const T*>(x),
                            static_cast<const int32_t*>(labels),
                            static_cast<const float*>(lse),
                            static_cast<const float*>(g), static_cast<T*>(dx),
                            V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, V) row-major, any alignment: each row peels its own head
extern "C" int fused_ce_fwd(const void* x, const void* labels, void* nll,
                            void* lse, int N, int V, int x_bf16,
                            void* stream) {
  if (N < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? fwd<repro::bf16>(x, labels, nll, lse, N, V, st)
                : fwd<float>(x, labels, nll, lse, N, V, st);
}

// vec: 16-byte loads and stores in the middle of each row, which needs dx
// at x's offset modulo 16 bytes (the caller checks); else scalar accesses
extern "C" int fused_ce_bwd(const void* x, const void* labels,
                            const void* lse, const void* g, void* dx, int N,
                            int V, int x_bf16, int vec, void* stream) {
  if (N < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? bwd<repro::bf16>(x, labels, lse, g, dx, N, V, vec, st)
                : bwd<float>(x, labels, lse, g, dx, N, V, vec, st);
}
