// K11: row LayerNorm in one pass (var = E[x²] − μ²), over the last axis,
// and its backward (K11-bwd).
//
// Replaces the TPU kernel kernels/fused_layernorm.py:fused_layernorm
// (_kernel): per row of D elements, Σx and Σx² in f32 in the same pass
// (the paper's two ATAC trees, Eq. 12), then
//   μ = Σx / D,  E[x²] = Σx² / D,  var = E[x²] − μ²,
//   y = ((x − μ) · rsqrt(var + eps)) · γ + β     in f32,
// stored in x's dtype.  x f32 or bf16, γ and β f32 or bf16 (widened to
// f32), any number of rows, any D >= 1.
//
// What bounds it on an H100: bytes.  A row is read once from device memory
// and written once (the normalising pass reads it again from L1, where the
// row still lies), ~7 operations an element against 4 bytes in bf16:
// (32768, 4096) bf16 moves 0.54 GB, ≥ 0.16 ms at 3.35 TB/s.  One block
// owns one row; each thread loads 16 bytes at a time where the row allows
// it (D a multiple of 8 bf16 or 4 f32 values, the base aligned), so a warp
// reads 512 contiguous bytes per load; the two sums meet in a warp-shuffle
// tree and then across the block's warps in shared memory.
//
// The backward has no TPU kernel (XLA differentiated the norm).  With
// x̂ = (x − μ)·rs and dx̂ = dy·γ, both in f32:
//   dx = rs · ((dx̂ − mean(dx̂)) − x̂ · mean(dx̂ · x̂))   in x's dtype,
//   dγ = Σ_rows dy · x̂,  dβ = Σ_rows dy               in γ's and β's.
// The single-pass variance has the same derivative as the two-pass one
// (∂var/∂x = 2(x − μ)/D either way).  μ and rs are recomputed from x by the
// forward's own traversal and tree, so they are the forward's bits when
// both take the same load width.  Bytes bound it too: x and dy read, dx
// written, (8192, 768) bf16 38 MB, ≥ 0.0113 ms.  A block walks a fixed
// set of rows (row = block, block + G, ...), keeping its dγ, dβ column
// partials in shared memory (each thread owns its columns, so no atomics);
// a second kernel sums the G partials of each column in block order.  The
// sums are deterministic: the same inputs give the same bits every run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(repro::bf16 x) { return repro::bf2f(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(repro::bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float ldp(const void* p, int j, int is_bf16) {
  return is_bf16 ? repro::bf2f(static_cast<const repro::bf16*>(p)[j])
                 : static_cast<const float*>(p)[j];
}

// VEC elements of x from one 16-byte load (VEC > 1) or one element
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float* f) {
  if constexpr (VEC == 1) {
    f[0] = to_f(p[0]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int q = 0; q < VEC; ++q) f[q] = to_f(e[q]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float* f) {
  if constexpr (VEC == 1) {
    from_f(p, f[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int q = 0; q < VEC; ++q) from_f(e + q, f[q]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// The block's Σ of (s1, s2), through a warp-shuffle tree and then across
// the warps in shared memory; every thread returns the two totals.  Safe to
// call again at once: the last barrier keeps the next call's writes behind
// every thread's read.
__device__ __forceinline__ void block_sum2(float& s1, float& s2,
                                           float (*part)[kThreads / 32],
                                           float* stats) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 = s1 + __shfl_xor_sync(0xffffffffu, s1, o);
    s2 = s2 + __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = s1;
    part[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < kThreads / 32 ? part[0][lane] : 0.f;
    s2 = lane < kThreads / 32 ? part[1][lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 = s1 + __shfl_xor_sync(0xffffffffu, s1, o);
      s2 = s2 + __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) {
      stats[0] = s1;
      stats[1] = s2;
    }
  }
  __syncthreads();
  s1 = stats[0];
  s2 = stats[1];
  __syncthreads();
}

// μ and rs = rsqrt(var + eps) of row xr, var = E[x²] − μ²
template <typename T, int VEC>
__device__ __forceinline__ void row_stats(const T* xr, int D, float eps,
                                          float (*part)[kThreads / 32],
                                          float* stats, float* mu,
                                          float* rs) {
  float s1 = 0.f, s2 = 0.f;
  for (int j = threadIdx.x * VEC; j < D; j += kThreads * VEC) {
    float f[VEC];
    load<T, VEC>(xr + j, f);
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      s1 = s1 + f[q];
      s2 = s2 + f[q] * f[q];
    }
  }
  block_sum2(s1, s2, part, stats);
  const float m = s1 / static_cast<float>(D);
  const float ex2 = s2 / static_cast<float>(D);
  const float var = ex2 - m * m;
  *mu = m;
  *rs = rsqrtf(var + eps);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                 const void* __restrict__ beta, T* __restrict__ out, int D,
                 float eps, int g_bf16, int b_bf16) {
  __shared__ float part[2][kThreads / 32];
  __shared__ float stats[2];
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* orow = out + row * D;
  float mu, rs;
  row_stats<T, VEC>(xr, D, eps, part, stats, &mu, &rs);
  for (int j = threadIdx.x * VEC; j < D; j += kThreads * VEC) {
    float f[VEC];
    load<T, VEC>(xr + j, f);
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const float yn = (f[q] - mu) * rs;
      f[q] = yn * ldp(gamma, j + q, g_bf16) + ldp(beta, j + q, b_bf16);
    }
    store<T, VEC>(orow + j, f);
  }
}

template <typename T>
int launch(const void* x, const void* g, const void* b, void* out, int R,
           int D, float eps, int g_bf16, int b_bf16, int vec,
           cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec)
    layernorm_kernel<T, V><<<R, kThreads, 0, st>>>(
        static_cast<const T*>(x), g, b, static_cast<T*>(out), D, eps,
        g_bf16, b_bf16);
  else
    layernorm_kernel<T, 1><<<R, kThreads, 0, st>>>(
        static_cast<const T*>(x), g, b, static_cast<T*>(out), D, eps,
        g_bf16, b_bf16);
  return static_cast<int>(cudaGetLastError());
}


// K11-bwd, pass 1: dx of rows blockIdx.x, blockIdx.x + G, ..., and this
// block's column partials of dγ (Σ dy·x̂) and dβ (Σ dy) into
// partial[blockIdx.x] = (dγ part (D), dβ part (D)).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ partial, int R, int D, float eps,
                     int g_bf16) {
  extern __shared__ float acc[];   // [0, D) dγ, [D, 2D) dβ; own columns
  __shared__ float part[2][kThreads / 32];
  __shared__ float stats[2];
  for (int j = threadIdx.x * VEC; j < D; j += kThreads * VEC) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      acc[j + q] = 0.f;
      acc[D + j + q] = 0.f;
    }
  }
  for (int row = blockIdx.x; row < R; row += gridDim.x) {
    const size_t off = static_cast<size_t>(row) * D;
    float mu, rs;
    row_stats<T, VEC>(x + off, D, eps, part, stats, &mu, &rs);
    float a1 = 0.f, a2 = 0.f;
    for (int j = threadIdx.x * VEC; j < D; j += kThreads * VEC) {
      float f[VEC], g[VEC];
      load<T, VEC>(x + off + j, f);
      load<T, VEC>(dy + off + j, g);
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float xh = (f[q] - mu) * rs;
        const float dxh = g[q] * ldp(gamma, j + q, g_bf16);
        a1 = a1 + dxh;
        a2 = a2 + dxh * xh;
        acc[j + q] = acc[j + q] + g[q] * xh;
        acc[D + j + q] = acc[D + j + q] + g[q];
      }
    }
    block_sum2(a1, a2, part, stats);
    const float m1 = a1 / static_cast<float>(D);
    const float m2 = a2 / static_cast<float>(D);
    for (int j = threadIdx.x * VEC; j < D; j += kThreads * VEC) {
      float f[VEC], g[VEC];
      load<T, VEC>(x + off + j, f);
      load<T, VEC>(dy + off + j, g);
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float xh = (f[q] - mu) * rs;
        const float dxh = g[q] * ldp(gamma, j + q, g_bf16);
        f[q] = rs * ((dxh - m1) - xh * m2);
      }
      store<T, VEC>(dx + off + j, f);
    }
  }
  float* mine = partial + static_cast<size_t>(blockIdx.x) * 2 * D;
  for (int j = threadIdx.x * VEC; j < D; j += kThreads * VEC) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      mine[j + q] = acc[j + q];
      mine[D + j + q] = acc[D + j + q];
    }
  }
}

// K11-bwd, pass 2: dγ[j], dβ[j] = the G partials of column j summed in
// block order, stored in γ's and β's dtypes
__global__ void layernorm_bwd_reduce(const float* __restrict__ partial,
                                     int G, int D, void* dgamma, void* dbeta,
                                     int g_bf16, int b_bf16) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= D) return;
  float sg = 0.f, sb = 0.f;
  for (int b = 0; b < G; ++b) {
    const float* p = partial + static_cast<size_t>(b) * 2 * D;
    sg = sg + p[j];
    sb = sb + p[D + j];
  }
  if (g_bf16)
    from_f(static_cast<repro::bf16*>(dgamma) + j, sg);
  else
    from_f(static_cast<float*>(dgamma) + j, sg);
  if (b_bf16)
    from_f(static_cast<repro::bf16*>(dbeta) + j, sb);
  else
    from_f(static_cast<float*>(dbeta) + j, sb);
}

template <typename T>
int launch_bwd(const void* x, const void* g, const void* dy, void* dx,
               void* dgamma, void* dbeta, void* partial, int R, int D, int G,
               float eps, int g_bf16, int b_bf16, int vec, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  auto k = vec ? layernorm_bwd_kernel<T, V> : layernorm_bwd_kernel<T, 1>;
  const size_t smem = 2 * static_cast<size_t>(D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  k<<<G, kThreads, smem, st>>>(
      static_cast<const T*>(x), g, static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(partial), R, D, eps, g_bf16);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  layernorm_bwd_reduce<<<(D + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), G, D, dgamma, dbeta, g_bf16,
      b_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: the caller has checked that D is a multiple of 16 bytes' worth of
// elements and that x and out are 16-byte aligned
extern "C" int fused_layernorm(const void* x, const void* gamma,
                               const void* beta, void* out, int R, int D,
                               float eps, int x_bf16, int g_bf16, int b_bf16,
                               int vec, void* stream) {
  if (R < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<repro::bf16>(x, gamma, beta, out, R, D, eps, g_bf16,
                                      b_bf16, vec, st)
                : launch<float>(x, gamma, beta, out, R, D, eps, g_bf16,
                                b_bf16, vec, st);
}

// The backward of fused_layernorm for the output gradient dy (x's dtype):
// dx (x's dtype), dgamma, dbeta (γ's and β's dtypes); partial is (G, 2, D)
// f32 scratch, G <= R blocks each owning rows b, b + G, ...; vec as above
// for x, dy and dx
extern "C" int fused_layernorm_bwd(const void* x, const void* gamma,
                                   const void* dy, void* dx, void* dgamma,
                                   void* dbeta, void* partial, int R, int D,
                                   int G, float eps, int x_bf16, int g_bf16,
                                   int b_bf16, int vec, void* stream) {
  if (R < 1 || D < 1 || G < 1 || G > R)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_bwd<repro::bf16>(x, gamma, dy, dx, dgamma, dbeta,
                                          partial, R, D, G, eps, g_bf16,
                                          b_bf16, vec, st)
                : launch_bwd<float>(x, gamma, dy, dx, dgamma, dbeta, partial,
                                    R, D, G, eps, g_bf16, b_bf16, vec, st);
}
