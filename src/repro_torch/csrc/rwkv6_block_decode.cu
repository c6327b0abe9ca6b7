// K7-block: one whole RWKV-6 block decode step per launch, over W8, W4 or
// VQ planes (a mixed policy's layer holds several) or plain bf16 weights.
//
// Replaces the TPU kernel kernels/fused_decode.py:fused_block_decode with
// the RWKV-6 body (models/rwkv6.py:block_decode, exact numerics) written
// into the kernel: Pallas traced the block function, CUDA cannot.  The
// body is rwkv6_body.cuh, shared with K7-model (rwkv6_model_decode.cu),
// so one launch per layer and one launch for all layers give the same
// bits.
//
// Grid: a cooperative launch of as many 512-thread blocks as fit on the
// card at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor × SMs, or
// fewer when the caller asks), the layer's ten phases separated by
// grid-wide barriers; the body's header says how each phase is split.
//
// What bounds it on an H100: bytes.  One rwkv6-7b layer at batch 8 reads
// 219,967,488 B of W8 codes and 4,325,376 B of bf16 state (read once,
// written once), ≈ 228.6 MB, ≥ 68 µs at 3.35 TB/s, against ~3.5 GFLOP
// (W4 halves its matrices' bytes; plain bf16 weights double them).  Each
// code byte is read once per step for all 8 lanes and decoded in
// registers.  This first design runs CUDA-core FMA loops and pays ten
// grid barriers a layer; wgmma, TMA and the barrier count are later work.
#include "rwkv6_body.cuh"

namespace {

using repro::bf16;
namespace R6 = repro::rwkv6;

struct BlockArgs {
  R6::LayerWeights w;
  R6::LayerState st;
  R6::Dims dims;
  R6::Scratch s;
  const bf16* x;
  bf16* x_out;
};

// The layer's table (its 15 matrix descriptors and state pointers) is read
// from shared memory, as K7-model reads it: read through a reference to
// the kernel parameters it cost 4% at W8 and 50% on mixed planes, per
// launch (PERF.md §6, K7).
template <int PLANES>
__global__ void __launch_bounds__(R6::kThreads)
rwkv6_block_decode_kernel(const BlockArgs a) {
  extern __shared__ float smem[];
  __shared__ R6::LayerWeights w;
  __shared__ R6::LayerState st;
  if (threadIdx.x == 0) {
    w = a.w;
    st = a.st;
  }
  __syncthreads();
  R6::layer<PLANES>(w, st, a.dims, a.s, a.x, a.x_out, smem);
}

// The instance for a layer of these planes (R6::planes_of).
auto kernel_for(const int* planes) {
  return R6::planes_of(planes) == repro::kPlaneW8
             ? rwkv6_block_decode_kernel<repro::kPlaneW8>
             : rwkv6_block_decode_kernel<R6::kPlaneAny>;
}

constexpr int kNumPtrs =
    2 + R6::kNumVecs + 2 * R6::kNumMats + 2 * R6::kNumState + 1;

}  // namespace

// Scratch bytes one K7 launch (block or model form) needs at (D, F).
extern "C" long long rwkv6_decode_scratch_bytes(int D, int F) {
  return static_cast<long long>(R6::carve(nullptr, D, F, nullptr));
}

// Whether the device has cooperative launch, and the largest grid of
// K7-block's instance for these matrix planes (mats, the first 15 ints of
// the launch's) that fits on it at once.
extern "C" int rwkv6_block_decode_grid(const int* mats, int* coop,
                                       int* max_blocks) {
  return R6::max_grid(kernel_for(mats), coop, max_blocks);
}

// ptrs (kNumPtrs device pointers): x (B,D), x_out (B,D), the 9 vectors in
// R6::Vec order, the 15 matrices' codes (a BF16 matrix: its weights) then
// their f32 scale or bf16 codebook (BF16: null) in R6::Mat order, the 3
// state leaves in and the 3 out in R6::State order, the scratch
// (rwkv6_decode_scratch_bytes, zeroed).  mats (2·15 ints): the matrices'
// planes (enum Plane), then their codebooks' entries (0 unless VQ).
extern "C" int rwkv6_block_decode(const void* const* ptrs, int n_ptrs,
                                  const int* mats, int B, int D, int F, int H,
                                  int N, int grid, void* stream) {
  if (n_ptrs != kNumPtrs || B < 1 || B > R6::kLanes || H * N != D ||
      R6::kThreads % N != 0 || D % 4 || F % 4 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BlockArgs a;
  int i = 0;
  a.x = static_cast<const bf16*>(ptrs[i++]);
  a.x_out = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  for (int v = 0; v < R6::kNumVecs; ++v)
    a.w.vec[v] = static_cast<const bf16*>(ptrs[i++]);
  for (int m = 0; m < R6::kNumMats; ++m) {
    if (!R6::valid_matrix(mats[m], mats[R6::kNumMats + m]))
      return static_cast<int>(cudaErrorInvalidValue);
    a.w.mat[m].codes = static_cast<const uint8_t*>(ptrs[i++]);
    a.w.mat[m].plane = mats[m];
    a.w.mat[m].aux_len = mats[R6::kNumMats + m];
  }
  for (int m = 0; m < R6::kNumMats; ++m) a.w.mat[m].aux = ptrs[i++];
  for (int k = 0; k < R6::kNumState; ++k)
    a.st.in[k] = static_cast<const bf16*>(ptrs[i++]);
  for (int k = 0; k < R6::kNumState; ++k)
    a.st.out[k] = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  R6::carve(static_cast<unsigned char*>(const_cast<void*>(ptrs[i++])), D, F,
            &a.s);
  a.dims = {B, D, F, H, N};
  return R6::launch(kernel_for(mats), a, grid,
                    static_cast<cudaStream_t>(stream));
}
