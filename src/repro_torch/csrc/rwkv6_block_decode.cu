// K7-block: one whole RWKV-6 block decode step per launch, W8 weights.
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
// written once), ≈ 228.6 MB, ≥ 68 µs at 3.35 TB/s, against ~3.5 GFLOP.
// Each code byte is read once per step for all 8 lanes and decoded in
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

__global__ void __launch_bounds__(R6::kThreads)
rwkv6_block_decode_kernel(const BlockArgs a) {
  extern __shared__ float smem[];
  R6::layer(a.w, a.st, a.dims, a.s, a.x, a.x_out, smem);
}

constexpr int kNumPtrs =
    2 + R6::kNumVecs + 2 * R6::kNumMats + 2 * R6::kNumState + 1;

}  // namespace

// Scratch bytes one K7 launch (block or model form) needs at (D, F).
extern "C" long long rwkv6_decode_scratch_bytes(int D, int F) {
  return static_cast<long long>(R6::carve(nullptr, D, F, nullptr));
}

// Whether the device has cooperative launch, and the largest grid of
// K7-block that fits on it at once.
extern "C" int rwkv6_block_decode_grid(int* coop, int* max_blocks) {
  return R6::max_grid(rwkv6_block_decode_kernel, coop, max_blocks);
}

// ptrs (kNumPtrs device pointers): x (B,D), x_out (B,D), the 9 vectors in
// R6::Vec order, the 15 planes' codes then their f32 scales in R6::Mat
// order, the 3 state leaves in and the 3 out in R6::State order, the
// scratch (rwkv6_decode_scratch_bytes, zeroed).
extern "C" int rwkv6_block_decode(const void* const* ptrs, int n_ptrs, int B,
                                  int D, int F, int H, int N, int grid,
                                  void* stream) {
  if (n_ptrs != kNumPtrs || B < 1 || B > R6::kLanes || H * N != D ||
      R6::kThreads % N != 0 || D % 4 || F % 4 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BlockArgs a;
  int i = 0;
  a.x = static_cast<const bf16*>(ptrs[i++]);
  a.x_out = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  for (int v = 0; v < R6::kNumVecs; ++v)
    a.w.vec[v] = static_cast<const bf16*>(ptrs[i++]);
  for (int m = 0; m < R6::kNumMats; ++m)
    a.w.codes[m] = static_cast<const uint8_t*>(ptrs[i++]);
  for (int m = 0; m < R6::kNumMats; ++m)
    a.w.scale[m] = static_cast<const float*>(ptrs[i++]);
  for (int k = 0; k < R6::kNumState; ++k)
    a.st.in[k] = static_cast<const bf16*>(ptrs[i++]);
  for (int k = 0; k < R6::kNumState; ++k)
    a.st.out[k] = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  R6::carve(static_cast<unsigned char*>(const_cast<void*>(ptrs[i++])), D, F,
            &a.s);
  a.dims = {B, D, F, H, N};
  return R6::launch(rwkv6_block_decode_kernel, a, grid,
                    static_cast<cudaStream_t>(stream));
}
