// K3: one whole RWKV-4 block decode step per launch, W8, W4 or VQ weights.
//
// Replaces the TPU kernel kernels/fused_decode.py:fused_block_decode with
// the RWKV-4 body (models/rwkv4.py:block_decode, exact numerics) written
// into the kernel: Pallas traced the block function, CUDA cannot.  The
// body is rwkv4_body.cuh, shared with K4 (rwkv4_model_decode.cu), so one
// launch per layer and one launch for all layers give the same bits.
//
// Grid: one block per tile of bb batch lanes (bb = B by default, as in
// fused_decode.py:91).  Shared memory holds each lane's intermediates as
// bf16, (6·D + F)·2 bytes a lane (15,360 B at 169M; bb = 8 takes 123 KB,
// dynamic shared memory set with cudaFuncSetAttribute).
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

template <int BB, int PLANES>
__global__ void __launch_bounds__(1024)
rwkv4_block_decode_kernel(const R4::LayerWeights w, const R4::LayerState st,
                          const bf16* __restrict__ x, bf16* __restrict__ x_out,
                          int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int b0 = blockIdx.x * BB;
  R4::load_residual<BB>(x, smem, D, F, b0);
  __syncthreads();
  R4::layer<BB, PLANES>(w, st, smem, D, F, b0);
  __syncthreads();
  R4::store_residual<BB>(smem, x_out, D, F, b0);
}

template <int BB, int PLANES>
int launch(const R4::LayerWeights& w, const R4::LayerState& st, const bf16* x,
           bf16* x_out, int B, int D, int F, cudaStream_t s) {
  const int threads = std::min(1024, ((D + 31) / 32) * 32);
  const size_t smem = R4::smem_bytes(BB, D, F);
  cudaError_t e = cudaFuncSetAttribute(
      rwkv4_block_decode_kernel<BB, PLANES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rwkv4_block_decode_kernel<BB, PLANES><<<B / BB, threads, smem, s>>>(
      w, st, x, x_out, D, F);
  return static_cast<int>(cudaGetLastError());
}

template <int PLANES>
int launch_bb(int bb, const R4::LayerWeights& w, const R4::LayerState& st,
              const bf16* x, bf16* x_out, int B, int D, int F,
              cudaStream_t s) {
  switch (bb) {
    case 1: return launch<1, PLANES>(w, st, x, x_out, B, D, F, s);
    case 2: return launch<2, PLANES>(w, st, x, x_out, B, D, F, s);
    case 3: return launch<3, PLANES>(w, st, x, x_out, B, D, F, s);
    case 4: return launch<4, PLANES>(w, st, x, x_out, B, D, F, s);
    case 5: return launch<5, PLANES>(w, st, x, x_out, B, D, F, s);
    case 6: return launch<6, PLANES>(w, st, x, x_out, B, D, F, s);
    case 7: return launch<7, PLANES>(w, st, x, x_out, B, D, F, s);
    default: return launch<8, PLANES>(w, st, x, x_out, B, D, F, s);
  }
}

constexpr int kNumPtrs =
    2 + R4::kNumVecs + 2 * R4::kNumMats + 2 * R4::kNumState;

}  // namespace

// ptrs (kNumPtrs device pointers): x (B,D), x_out (B,D), the 11 vectors
// in R4::Vec order, the 7 matrices' codes then their scale / codebook in
// R4::Mat order, the 5 state leaves in and the 5 out in R4::State order,
// each (B,D).  planes: the 7 matrices' planes.
extern "C" int rwkv4_block_decode(const void* const* ptrs, int n_ptrs,
                                  const int* planes, int B, int D, int F,
                                  int bb, void* stream) {
  if (n_ptrs != kNumPtrs || bb < 1 || bb > 8 || B % bb != 0 || D % 2 ||
      F % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int i = 0;
  const bf16* x = static_cast<const bf16*>(ptrs[i++]);
  bf16* x_out = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  R4::LayerWeights w;
  for (int v = 0; v < R4::kNumVecs; ++v)
    w.vec[v] = static_cast<const bf16*>(ptrs[i++]);
  for (int m = 0; m < R4::kNumMats; ++m)
    w.mat[m].codes = static_cast<const uint8_t*>(ptrs[i++]);
  for (int m = 0; m < R4::kNumMats; ++m) {
    w.mat[m].aux = ptrs[i++];
    w.mat[m].plane = planes[m];
  }
  R4::LayerState st;
  for (int k = 0; k < R4::kNumState; ++k)
    st.in[k] = static_cast<const bf16*>(ptrs[i++]);
  for (int k = 0; k < R4::kNumState; ++k)
    st.out[k] = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return R4::planes_of(planes) == repro::kPlaneW8
             ? launch_bb<repro::kPlaneW8>(bb, w, st, x, x_out, B, D, F, s)
             : launch_bb<R4::kPlaneAny>(bb, w, st, x, x_out, B, D, F, s);
}
