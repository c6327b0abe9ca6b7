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
// (∂var/∂x = 2(x − μ)/D either way).  μ and rs are recomputed from x by
// the backward's own tree (each lane's values in column order, then a
// warp-shuffle tree), not the forward's block-wide one, so they may
// differ from the forward's in the last bits; the checks' bounds allow a
// sum in another order.  Bytes bound it too: x and dy read, dx written,
// (8192, 768) bf16 38 MB, ≥ 0.0113 ms.  One warp owns a row and holds its
// x and dy in registers (24 values a lane at D 768 bf16, read once with
// 16-byte loads where the rows allow it); μ, rs, mean(dx̂) and
// mean(dx̂·x̂) come from warp shuffles, with no block barrier per row, and
// dx is written from the registers.  A row too wide for one warp's
// registers takes a few warps of the same kernel (D 4096 f32: 8), whose
// sums meet once more through shared memory in a fixed order.  Each lane
// keeps its columns' dγ, dβ partials in registers over its warp's fixed
// set of rows; the block adds its warps' in warp order, and a second
// kernel sums the G blocks' partials of each column in block order.  The
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


// K11-bwd, pass 1: one warp group of WPR warps a row (a warp when the
// row fits its registers), the block's 32·max(8, WPR) threads taking
// RPB = max(8, WPR) / WPR rows at a time: rows r, r + G·RPB, ... for the
// group's r = blockIdx.x·RPB + group.  Lane l of warp part p holds chunk
// c (VEC values: 16 bytes, or one element) at columns ((c·WPR + p)·32 +
// l)·VEC, for c < nch; x and dy are read once into registers, the row's
// sums meet in a warp-shuffle tree (and, for WPR > 1, through shared
// memory in part order behind a named barrier per group), dx is written
// from the registers, and each lane's dγ, dβ column partials stay in
// registers until the block adds its groups' in group order into
// partial[blockIdx.x] = (dγ part (D), dβ part (D)).
template <typename T, int VEC>
__device__ __forceinline__ uint4 load_raw(const T* p) {
  if constexpr (VEC == 1) {
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (sizeof(T) == 2)
      r.x = *reinterpret_cast<const unsigned short*>(p);
    else
      r.x = __float_as_uint(*reinterpret_cast<const float*>(p));
    return r;
  } else {
    return *reinterpret_cast<const uint4*>(p);
  }
}

// value q of a chunk as loaded
template <typename T>
__device__ __forceinline__ float raw_val(const uint4& r, int q) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  if constexpr (sizeof(T) == 2)
    return (q & 1) ? repro::bf16_hi(w[q >> 1]) : repro::bf16_lo(w[q >> 1]);
  else
    return __uint_as_float(w[q]);
}

__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The row's Σ of (s1, s2) over the warp (xor tree: every lane gets the
// same bits), then over the group's WPR warps in part order through xch.
template <int WPR>
__device__ __forceinline__ void row_sum2(float& s1, float& s2,
                                         float (*xch)[WPR], int part,
                                         int group) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 = s1 + __shfl_xor_sync(0xffffffffu, s1, o);
    s2 = s2 + __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if constexpr (WPR > 1) {
    if ((threadIdx.x & 31) == 0) {
      xch[0][part] = s1;
      xch[1][part] = s2;
    }
    group_sync(1 + group, 32 * WPR);
    s1 = xch[0][0];
    s2 = xch[1][0];
#pragma unroll
    for (int q = 1; q < WPR; ++q) {
      s1 = s1 + xch[0][q];
      s2 = s2 + xch[1][q];
    }
  }
}

template <int WPR>
__host__ __device__ constexpr int bwd_threads() {
  return 32 * (WPR > 8 ? WPR : 8);
}

// chunks a lane holds at most: 24 bf16 or 16 f32 values (16-byte loads),
// 8 elements (element loads), so that x, dy and the partials stay in
// registers at two 256-thread blocks an SM
template <typename T, int VEC>
__host__ __device__ constexpr int bwd_max_chunks() {
  return VEC == 1 ? 8 : sizeof(T) == 2 ? 3 : 4;
}

template <typename T, int VEC, int WPR>
__global__ void __launch_bounds__(bwd_threads<WPR>(),
                                  512 / bwd_threads<WPR>())
layernorm_bwd_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ partial, int R, int D, int nch,
                     float eps, int g_bf16) {
  constexpr int NT = bwd_threads<WPR>();
  constexpr int RPB = NT / 32 / WPR;
  constexpr int NMAX = bwd_max_chunks<T, VEC>();
  extern __shared__ float sm[];   // γ in f32 (D), then dγ, dβ sums (2D)
  __shared__ float xch[RPB][2][2][WPR];
  float* gam = sm;
  float* acc = sm + D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / WPR, part = warp % WPR;
  for (int j = threadIdx.x; j < D; j += NT) {
    gam[j] = ldp(gamma, j, g_bf16);
    acc[j] = 0.f;
    acc[D + j] = 0.f;
  }
  __syncthreads();
  float pg[NMAX][VEC], pb[NMAX][VEC];
#pragma unroll
  for (int c = 0; c < NMAX; ++c)
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      pg[c][q] = 0.f;
      pb[c][q] = 0.f;
    }
  for (int row = blockIdx.x * RPB + group; row < R;
       row += gridDim.x * RPB) {
    const size_t off = static_cast<size_t>(row) * D;
    uint4 xr[NMAX], gr[NMAX];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < NMAX; ++c) {
      const int j = ((c * WPR + part) * 32 + lane) * VEC;
      xr[c] = gr[c] = make_uint4(0u, 0u, 0u, 0u);
      if (c < nch && j < D) {
        xr[c] = load_raw<T, VEC>(x + off + j);
        gr[c] = load_raw<T, VEC>(dy + off + j);
      }
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float f = raw_val<T>(xr[c], q);
        s1 = s1 + f;
        s2 = s2 + f * f;
      }
    }
    row_sum2<WPR>(s1, s2, xch[group][0], part, group);
    const float mu = s1 / static_cast<float>(D);
    const float var = s2 / static_cast<float>(D) - mu * mu;
    const float rs = rsqrtf(var + eps);
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int c = 0; c < NMAX; ++c) {
      const int j = ((c * WPR + part) * 32 + lane) * VEC;
      if (c < nch && j < D) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const float xh = (raw_val<T>(xr[c], q) - mu) * rs;
          const float dxh = raw_val<T>(gr[c], q) * gam[j + q];
          a1 = a1 + dxh;
          a2 = a2 + dxh * xh;
        }
      }
    }
    row_sum2<WPR>(a1, a2, xch[group][1], part, group);
    const float m1 = a1 / static_cast<float>(D);
    const float m2 = a2 / static_cast<float>(D);
#pragma unroll
    for (int c = 0; c < NMAX; ++c) {
      const int j = ((c * WPR + part) * 32 + lane) * VEC;
      if (c < nch && j < D) {
        float f[VEC];
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const float g = raw_val<T>(gr[c], q);
          const float xh = (raw_val<T>(xr[c], q) - mu) * rs;
          const float dxh = g * gam[j + q];
          f[q] = rs * ((dxh - m1) - xh * m2);
          pg[c][q] = pg[c][q] + g * xh;
          pb[c][q] = pb[c][q] + g;
        }
        store<T, VEC>(dx + off + j, f);
      }
    }
  }
  // the block's partials: its groups' in group order (the WPR warps of a
  // group own disjoint columns)
  for (int r = 0; r < RPB; ++r) {
    if (group == r) {
#pragma unroll
      for (int c = 0; c < NMAX; ++c) {
        const int j = ((c * WPR + part) * 32 + lane) * VEC;
        if (c < nch && j < D) {
#pragma unroll
          for (int q = 0; q < VEC; ++q) {
            acc[j + q] = acc[j + q] + pg[c][q];
            acc[D + j + q] = acc[D + j + q] + pb[c][q];
          }
        }
      }
    }
    __syncthreads();
  }
  float* mine = partial + static_cast<size_t>(blockIdx.x) * 2 * D;
  for (int j = threadIdx.x; j < 2 * D; j += NT) mine[j] = acc[j];
}

// K11-bwd, pass 2: element t of the (dγ, dβ) row summed over the G
// blocks' partials in block order (32 loads in flight, then their adds in
// order), stored in γ's or β's dtype
constexpr int kReduceThreads = 64;
constexpr int kReduceBatch = 32;

__global__ void __launch_bounds__(kReduceThreads)
layernorm_bwd_reduce(const float* __restrict__ partial, int G, int D,
                     void* dgamma, void* dbeta, int g_bf16, int b_bf16) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * D) return;
  const size_t stride = static_cast<size_t>(2) * D;
  const float* p = partial + t;
  float s = 0.f;
  for (int b = 0; b < G; b += kReduceBatch) {
    float v[kReduceBatch];
#pragma unroll
    for (int i = 0; i < kReduceBatch; ++i)
      v[i] = b + i < G ? p[(b + i) * stride] : 0.f;
#pragma unroll
    for (int i = 0; i < kReduceBatch; ++i)
      if (b + i < G) s = s + v[i];
  }
  const bool beta = t >= D;
  const int j = beta ? t - D : t;
  void* out = beta ? dbeta : dgamma;
  if (beta ? b_bf16 : g_bf16)
    from_f(static_cast<repro::bf16*>(out) + j, s);
  else
    from_f(static_cast<float*>(out) + j, s);
}

template <typename T, int VEC, int WPR>
int launch_bwd_rows(const void* x, const void* g, const void* dy, void* dx,
                    void* partial, int R, int D, int G, int nch, float eps,
                    int g_bf16, cudaStream_t st) {
  auto k = layernorm_bwd_kernel<T, VEC, WPR>;
  const size_t smem = 3 * static_cast<size_t>(D) * sizeof(float);
  if (smem > 32 * 1024) {  // with the static exchange, past the default
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  k<<<G, bwd_threads<WPR>(), smem, st>>>(
      static_cast<const T*>(x), g, static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(partial), R, D, nch, eps,
      g_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_bwd_wpr(int wpr, const void* x, const void* g, const void* dy,
                   void* dx, void* partial, int R, int D, int G, int nch,
                   float eps, int g_bf16, cudaStream_t st) {
  switch (wpr) {
    case 1: return launch_bwd_rows<T, VEC, 1>(x, g, dy, dx, partial, R, D, G,
                                              nch, eps, g_bf16, st);
    case 2: return launch_bwd_rows<T, VEC, 2>(x, g, dy, dx, partial, R, D, G,
                                              nch, eps, g_bf16, st);
    case 4: return launch_bwd_rows<T, VEC, 4>(x, g, dy, dx, partial, R, D, G,
                                              nch, eps, g_bf16, st);
    case 8: return launch_bwd_rows<T, VEC, 8>(x, g, dy, dx, partial, R, D, G,
                                              nch, eps, g_bf16, st);
    case 16: return launch_bwd_rows<T, VEC, 16>(x, g, dy, dx, partial, R, D,
                                                G, nch, eps, g_bf16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_bwd(const void* x, const void* g, const void* dy, void* dx,
               void* dgamma, void* dbeta, void* partial, int R, int D, int G,
               int wpr, int nch, float eps, int g_bf16, int b_bf16, int vec,
               cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int most = vec ? bwd_max_chunks<T, V>() : bwd_max_chunks<T, 1>();
  const int per = vec ? V : 1;
  if (nch < 1 || nch > most ||
      static_cast<long long>(nch) * wpr * 32 * per < D)
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = vec ? launch_bwd_wpr<T, V>(wpr, x, g, dy, dx, partial, R, D,
                                           G, nch, eps, g_bf16, st)
                    : launch_bwd_wpr<T, 1>(wpr, x, g, dy, dx, partial, R, D,
                                           G, nch, eps, g_bf16, st);
  if (e != 0) return e;
  layernorm_bwd_reduce<<<(2 * D + kReduceThreads - 1) / kReduceThreads,
                         kReduceThreads, 0, st>>>(
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
// f32 scratch, G blocks; wpr warps a row (1, 2, 4, 8 or 16) and nch
// chunks a lane (kernels/fused_layernorm.py:bwd_plan); vec as above for
// x, dy and dx
extern "C" int fused_layernorm_bwd(const void* x, const void* gamma,
                                   const void* dy, void* dx, void* dgamma,
                                   void* dbeta, void* partial, int R, int D,
                                   int G, int wpr, int nch, float eps,
                                   int x_bf16, int g_bf16, int b_bf16,
                                   int vec, void* stream) {
  if (R < 1 || D < 1 || G < 1 || G > R)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_bwd<repro::bf16>(x, gamma, dy, dx, dgamma, dbeta,
                                          partial, R, D, G, wpr, nch, eps,
                                          g_bf16, b_bf16, vec, st)
                : launch_bwd<float>(x, gamma, dy, dx, dgamma, dbeta, partial,
                                    R, D, G, wpr, nch, eps, g_bf16, b_bf16,
                                    vec, st);
}
