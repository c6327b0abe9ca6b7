// K2: the masked RWKV-4 WKV recurrence over a prompt chunk.
//
// Replaces the TPU kernel kernels/wkv4.py:wkv4_pallas (_kernel), with the
// `valid` commit mask, the bf16 carry snap and both numerics: exact (expf
// and division) or, given the exp_table/div_table operands, the paper's
// hardware units (hw_units.cuh: LUT exp, LUT division), both tables staged
// in shared memory as the TPU kernel kept them in VMEM.
//
// k, v (B,T,C) f32; w, u (C,) f32; a0, b0, o0 (B,C) f32; valid (B,T) i32;
// exp_tab, div_tab (256,) f32 or both null -> y (B,T,C) f32 and the final
// (a, b, o) (B,C) f32.
//
// What bounds it on an H100: bytes.  Each (b, c) channel is an independent
// sequential recurrence of ~20 f32 operations a step, so the work is tiny
// against reading k, v and writing y once.  One thread owns one (b, c)
// channel and keeps (a, b, o) in registers for all T steps (the TPU kernel
// kept them in VMEM): the state never round-trips device memory between
// steps, and neighbouring threads touch neighbouring channels, so every
// k/v/y access is coalesced.
//
// Each step follows kernels/wkv4.py:61-85: output from the carried state,
// state update, commit only where valid, then snap the carry through bf16
// (__float2bfloat16_rn) and back, as the per-op oracle stores its state
// in the bf16 pool between steps.
#include "hw_units.cuh"

namespace {

template <class Units>
__device__ __forceinline__ void wkv4_seq_body(
    const float* __restrict__ k, const float* __restrict__ v, float wc,
    float uc, const int32_t* __restrict__ valid, float* __restrict__ y,
    float* sa, float* sb, float* so, int b, int c, int T, int C,
    int snap_bf16, const Units& un) {
  for (int t = 0; t < T; ++t) {
    const size_t off = ((size_t)b * T + t) * C + c;
    float na, nb, no;
    y[off] = repro::wkv4_step(*sa, *sb, *so, k[off], v[off], wc, uc, &na, &nb,
                              &no, un);
    if (valid != nullptr && valid[b * T + t] == 0) {
      na = *sa;
      nb = *sb;
      no = *so;
    }
    if (snap_bf16) {
      na = repro::bf16r(na);
      nb = repro::bf16r(nb);
      no = repro::bf16r(no);
    }
    *sa = na;
    *sb = nb;
    *so = no;
  }
}

template <bool HW>
__global__ void wkv4_seq_kernel(const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ w,
                                const float* __restrict__ u,
                                const float* __restrict__ a0,
                                const float* __restrict__ b0,
                                const float* __restrict__ o0,
                                const int32_t* __restrict__ valid,
                                const float* __restrict__ exp_tab,
                                const float* __restrict__ div_tab,
                                float* __restrict__ y, float* __restrict__ af,
                                float* __restrict__ bf, float* __restrict__ of,
                                int B, int T, int C, int snap_bf16) {
  __shared__ float tabs[HW ? 512 : 1];
  if constexpr (HW) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
      tabs[i] = exp_tab[i];
      tabs[256 + i] = div_tab[i];
    }
    __syncthreads();
  }
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * C) return;
  const int b = idx / C, c = idx % C;
  float sa = a0[idx], sb = b0[idx], so = o0[idx];
  if constexpr (HW)
    wkv4_seq_body(k, v, w[c], u[c], valid, y, &sa, &sb, &so, b, c, T, C,
                  snap_bf16, repro::LutUnits{tabs, tabs + 256});
  else
    wkv4_seq_body(k, v, w[c], u[c], valid, y, &sa, &sb, &so, b, c, T, C,
                  snap_bf16, repro::ExactUnits());
  af[idx] = sa;
  bf[idx] = sb;
  of[idx] = so;
}

}  // namespace

extern "C" int wkv4_seq(const void* k, const void* v, const void* w,
                        const void* u, const void* a0, const void* b0,
                        const void* o0, const void* valid, const void* exp_tab,
                        const void* div_tab, void* y, void* af, void* bf,
                        void* of, int B, int T, int C, int snap_bf16,
                        void* stream) {
  if ((exp_tab == nullptr) != (div_tab == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const int blocks = (B * C + threads - 1) / threads;
  auto run = exp_tab ? wkv4_seq_kernel<true> : wkv4_seq_kernel<false>;
  run<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(a0), static_cast<const float*>(b0),
      static_cast<const float*>(o0), static_cast<const int32_t*>(valid),
      static_cast<const float*>(exp_tab), static_cast<const float*>(div_tab),
      static_cast<float*>(y), static_cast<float*>(af), static_cast<float*>(bf),
      static_cast<float*>(of), B, T, C, snap_bf16);
  return static_cast<int>(cudaGetLastError());
}
