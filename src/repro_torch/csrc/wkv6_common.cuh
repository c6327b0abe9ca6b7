// What K10-bwd (wkv6_chunked_bwd.cu) and K6-bwd (wkv6_seq_bwd.cu) share:
// the last launch of each, which sums du's partials in a fixed order.
#pragma once

#include <stddef.h>

#include "common.cuh"

namespace wkv6 {
// internal linkage: each source that includes this header has its own copy
// of the kernel, so the library links no symbol twice
namespace {

constexpr int kSumThreads = 128;

// du[j] = Σ_i part[i][j] over i in order, a thread a column j: no atomics,
// the same bits every run
__global__ void __launch_bounds__(kSumThreads)
du_sum_kernel(const float* __restrict__ part, float* __restrict__ du,
              int rows, int cols) {
  const int j = blockIdx.x * kSumThreads + threadIdx.x;
  if (j >= cols) return;
  float acc = 0.f;
  for (int i = 0; i < rows; ++i)
    acc = __fadd_rn(acc, part[(size_t)i * cols + j]);
  du[j] = acc;
}

// du_sum_kernel's launch on `st`; returns the launch's error
int du_sum(const float* part, float* du, int rows, int cols,
           cudaStream_t st) {
  du_sum_kernel<<<(cols + kSumThreads - 1) / kSumThreads, kSumThreads, 0,
                  st>>>(part, du, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace wkv6
