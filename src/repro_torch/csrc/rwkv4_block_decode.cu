// K3: one whole RWKV-4 block decode step per launch, over W8, W4 or VQ
// planes or plain bf16 weights.
//
// Replaces the TPU kernel kernels/fused_decode.py:fused_block_decode with
// the RWKV-4 body (models/rwkv4.py:block_decode, exact or hardware
// numerics) written into the kernel: Pallas traced the block function,
// CUDA cannot.  The body is rwkv4_body.cuh, shared with K4
// (rwkv4_model_decode.cu), so one launch per layer and one launch for all
// layers give the same bits.  Given the EXP and DIV tables (the `_luts`
// operands) it runs the hardware numerics, the tables staged in shared
// memory.
//
// Grid: one block per tile of bb batch lanes (bb = B by default, as in
// fused_decode.py:91).  Shared memory holds each lane's intermediates as
// bf16, (6·D + F)·2 bytes a lane (15,360 B at 169M; bb = 8 takes 123 KB,
// dynamic shared memory set with cudaFuncSetAttribute); the hardware
// numerics take (7·D + F)·2 bytes a lane and 2.4 KB more (135 KB at bb = 8).
//
// What bounds it on an H100: the uint8 weight codes, 5·D² + 2·D·F bytes a
// layer at W8 (7.67 MB at 169M), against ~122 MFLOP at B = 8: bytes.  This
// first design reads each code byte once per block and decodes it in
// registers, but runs a layer on as many SMs as there are batch tiles
// (one at bb = B), so it is far from the bandwidth bound.  Splitting a
// layer's columns over many blocks needs a grid-wide barrier between the
// phases; that is the later work that makes it fast.
#include <algorithm>

#include "rwkv4_body.cuh"

namespace {

using repro::bf16;
namespace R4 = repro::rwkv4;

template <int BB, int PLANES, bool HW>
__global__ void __launch_bounds__(1024)
rwkv4_block_decode_kernel(const R4::LayerWeights w, const R4::LayerState st,
                          const bf16* __restrict__ x, bf16* __restrict__ x_out,
                          const float* __restrict__ exp_tab,
                          const float* __restrict__ div_tab, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  float* scratch = nullptr;
  if constexpr (HW) {
    scratch = R4::hw_scratch(smem, BB, D, F);
    R4::stage_luts(scratch, exp_tab, div_tab);
  }
  const int b0 = blockIdx.x * BB;
  R4::load_residual<BB, HW>(x, smem, D, F, b0);
  __syncthreads();
  R4::layer<BB, PLANES, HW>(w, st, smem, D, F, b0, scratch);
  __syncthreads();
  R4::store_residual<BB, HW>(smem, x_out, D, F, b0);
}

struct Args {
  R4::LayerWeights w;
  R4::LayerState st;
  const bf16* x;
  bf16* x_out;
  const float* exp_tab;  // null: exact numerics
  const float* div_tab;
  int B, D, F;
};

template <int BB, int PLANES, bool HW>
int launch(const Args& a, cudaStream_t s) {
  const int threads = std::min(1024, ((a.D + 31) / 32) * 32);
  const size_t smem = R4::smem_bytes(BB, a.D, a.F, HW);
  cudaError_t e = cudaFuncSetAttribute(
      rwkv4_block_decode_kernel<BB, PLANES, HW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rwkv4_block_decode_kernel<BB, PLANES, HW><<<a.B / BB, threads, smem, s>>>(
      a.w, a.st, a.x, a.x_out, a.exp_tab, a.div_tab, a.D, a.F);
  return static_cast<int>(cudaGetLastError());
}

template <int PLANES, bool HW>
int launch_bb(int bb, const Args& a, cudaStream_t s) {
  switch (bb) {
    case 1: return launch<1, PLANES, HW>(a, s);
    case 2: return launch<2, PLANES, HW>(a, s);
    case 3: return launch<3, PLANES, HW>(a, s);
    case 4: return launch<4, PLANES, HW>(a, s);
    case 5: return launch<5, PLANES, HW>(a, s);
    case 6: return launch<6, PLANES, HW>(a, s);
    case 7: return launch<7, PLANES, HW>(a, s);
    default: return launch<8, PLANES, HW>(a, s);
  }
}

template <bool HW>
int launch_planes(int bb, const int* planes, const Args& a, cudaStream_t s) {
  switch (R4::planes_of(planes)) {
    case repro::kPlaneW8: return launch_bb<repro::kPlaneW8, HW>(bb, a, s);
    case repro::kPlaneBF16: return launch_bb<repro::kPlaneBF16, HW>(bb, a, s);
    case R4::kPlaneAny: return launch_bb<R4::kPlaneAny, HW>(bb, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

constexpr int kNumPtrs =
    4 + R4::kNumVecs + 2 * R4::kNumMats + 2 * R4::kNumState;

}  // namespace

// ptrs (kNumPtrs device pointers): x (B,D), x_out (B,D), the 11 vectors
// in R4::Vec order, the 7 matrices' codes (a BF16 matrix: its weights)
// then their scale / codebook (BF16: null) in R4::Mat order, the 5 state leaves in and the 5 out in R4::State order,
// each (B,D), then the EXP and DIV tables (256 f32 each; both null for the
// exact numerics).  planes: the 7 matrices' planes.
extern "C" int rwkv4_block_decode(const void* const* ptrs, int n_ptrs,
                                  const int* planes, int B, int D, int F,
                                  int bb, void* stream) {
  if (n_ptrs != kNumPtrs || bb < 1 || bb > 8 || B % bb != 0 || D % 2 ||
      F % 2 || (ptrs[kNumPtrs - 2] == nullptr) !=
                   (ptrs[kNumPtrs - 1] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  int i = 0;
  a.x = static_cast<const bf16*>(ptrs[i++]);
  a.x_out = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  for (int v = 0; v < R4::kNumVecs; ++v)
    a.w.vec[v] = static_cast<const bf16*>(ptrs[i++]);
  for (int m = 0; m < R4::kNumMats; ++m)
    a.w.mat[m].codes = static_cast<const uint8_t*>(ptrs[i++]);
  for (int m = 0; m < R4::kNumMats; ++m) {
    if (planes[m] < repro::kPlaneW8 || planes[m] > repro::kPlaneBF16)
      return static_cast<int>(cudaErrorInvalidValue);
    a.w.mat[m].aux = ptrs[i++];
    a.w.mat[m].plane = planes[m];
    a.w.mat[m].aux_len = 0;
  }
  for (int k = 0; k < R4::kNumState; ++k)
    a.st.in[k] = static_cast<const bf16*>(ptrs[i++]);
  for (int k = 0; k < R4::kNumState; ++k)
    a.st.out[k] = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  a.exp_tab = static_cast<const float*>(ptrs[i++]);
  a.div_tab = static_cast<const float*>(ptrs[i++]);
  a.B = B;
  a.D = D;
  a.F = F;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.exp_tab ? launch_planes<true>(bb, planes, a, s)
                   : launch_planes<false>(bb, planes, a, s);
}
