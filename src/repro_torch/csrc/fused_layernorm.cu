// K11: row LayerNorm in one pass (var = E[x²] − μ²), over the last axis.
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
  const float mu = stats[0] / static_cast<float>(D);
  const float ex2 = stats[1] / static_cast<float>(D);
  const float var = ex2 - mu * mu;
  const float rs = rsqrtf(var + eps);
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
