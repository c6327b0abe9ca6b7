// K9: the paper's reusable EXP-σ unit over a whole tensor, f32 or bf16 in
// and the same type out: mode 0 the LUT e^x, mode 1 the PWL σ.
//
// Replaces the TPU kernel kernels/expsig.py:_kernel (exp_kernel mode 0,
// sigmoid_kernel mode 1).  The unit's math is hw_units.cuh, which the
// hardware-numerics bodies of K2, K3 and K4 compile too.
//
// What bounds it on an H100: bytes.  A few f32 operations an element
// against reading and writing it (8 bytes an f32 element), far below the
// card's ridge.  The design is a grid-stride loop, neighbouring threads on
// neighbouring elements, with the 1 KB EXP LUT staged in shared memory
// once per block (the TPU kernel kept it resident in VMEM).
#include "hw_units.cuh"

namespace {

using repro::bf16;

__device__ __forceinline__ float load_f32(float v) { return v; }
__device__ __forceinline__ float load_f32(bf16 v) { return repro::bf2f(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(256)
expsig_kernel(const T* __restrict__ x, const float* __restrict__ lut,
              T* __restrict__ out, long long n) {
  __shared__ float tab[256];
  if (MODE == 0) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) tab[i] = lut[i];
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = load_f32(x[i]);
    store(out + i, MODE == 0 ? repro::exp_lut(v, tab) : repro::sigmoid_pwl(v));
  }
}

template <typename T, int MODE>
int launch(const void* x, const void* lut, void* out, long long n,
           cudaStream_t s) {
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  expsig_kernel<T, MODE><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(lut),
      static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: n elements of f32 (bf16 = 0) or bf16 (bf16 = 1); lut: the 256
// f32 EXP fractions (read in mode 0 only); mode 0 e^x, mode 1 σ.
extern "C" int expsig(const void* x, const void* lut, void* out, long long n,
                      int mode, int is_bf16, void* stream) {
  if (n < 1 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return mode == 0 ? launch<bf16, 0>(x, lut, out, n, s)
                     : launch<bf16, 1>(x, lut, out, n, s);
  return mode == 0 ? launch<float, 0>(x, lut, out, n, s)
                   : launch<float, 1>(x, lut, out, n, s);
}
