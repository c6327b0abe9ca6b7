// K7-block: one whole RWKV-6 block decode step per launch, over W8, W4 or
// VQ planes (a mixed policy's layer holds several) or plain bf16 weights.
//
// Replaces the TPU kernel kernels/fused_decode.py:fused_block_decode with
// the RWKV-6 body (models/rwkv6.py:block_decode, exact numerics) written
// into the kernel: Pallas traced the block function, CUDA cannot.  The
// kernel is rwkv6_body.cuh's, launched on one layer by the launch that
// K7-model shares (rwkv6_model_decode.cu), so one launch per layer and one
// launch for all layers give the same bits.
//
// Grid: a cooperative launch of one 384-thread block an SM (8 consumer
// warps and 4 producer warps; the ring, the x buffer and the decode table
// fill most of the SM's shared memory), or fewer blocks when the caller
// asks; the layer's seven phases are separated by the consumers' own
// grid barriers.  The body's header says how each phase is dealt.
//
// What bounds it on an H100: bytes.  One rwkv6-7b layer at batch 8 reads
// 219,967,488 B of W8 codes and 4,325,376 B of bf16 state (read once,
// written once), ≈ 228.6 MB, ≥ 68 µs at 3.35 TB/s, against ~3.5 GFLOP
// (W4 halves its matrices' bytes; plain bf16 weights double them).  The
// design before this one (CUDA-core FMA loops over weights read one L2
// round trip a row, ten grid barriers) took 0.648 ms W8, 0.627 MIXED,
// 0.456 bf16 on "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md §6, PR 21 run
// 8); this one streams every block's weights through a ring of
// asynchronous copies into tensor-core MMAs, with seven barriers a layer,
// and takes 0.294 ms W8, 0.331 MIXED, 0.331 bf16 on the same card (PR 28
// run 27; rwkv6_body.cuh's header says what binds it).
#include "rwkv6_body.cuh"

namespace {

using repro::bf16;
namespace R6 = repro::rwkv6;

constexpr int kNumPtrs =
    2 + R6::kNumVecs + 2 * R6::kNumMats + 2 * R6::kNumState + 1;

}  // namespace

// Scratch bytes one K7 launch (block or model form) needs at (D, F).
extern "C" long long rwkv6_decode_scratch_bytes(int D, int F) {
  return static_cast<long long>(R6::carve(nullptr, D, F, nullptr));
}

// Whether the device has cooperative launch, and the largest grid of
// K7's instance for these matrix planes (mats, the first 15 ints of the
// launch's) that fits on it at once.
extern "C" int rwkv6_block_decode_grid(const int* mats, int* coop,
                                       int* max_blocks) {
  return R6::max_grid(mats, coop, max_blocks);
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
      R6::kConsumers % N != 0 || D % 4 || F % 4 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  R6::Net a;
  int i = 0;
  a.x = static_cast<const bf16*>(ptrs[i++]);
  a.x_out = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  for (int v = 0; v < R6::kNumVecs; ++v)
    a.vec[v] = static_cast<const bf16*>(ptrs[i++]);
  a.vec_layer = 0;
  for (int m = 0; m < R6::kNumMats; ++m) {
    if (!R6::valid_matrix(mats[m], mats[R6::kNumMats + m]))
      return static_cast<int>(cudaErrorInvalidValue);
    a.mat[m] = static_cast<const uint8_t*>(ptrs[i++]);
    a.mat_layer[m] = 0;
    a.plane[m] = mats[m];
    a.aux_len[m] = mats[R6::kNumMats + m];
  }
  for (int m = 0; m < R6::kNumMats; ++m) a.aux[m] = ptrs[i++];
  for (int k = 0; k < R6::kNumState; ++k) {
    a.st_in[k] = static_cast<const bf16*>(ptrs[i++]);
    a.st_layer[k] = 0;
  }
  for (int k = 0; k < R6::kNumState; ++k)
    a.st_out[k] = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  R6::carve(static_cast<unsigned char*>(const_cast<void*>(ptrs[i++])), D, F,
            &a.s);
  a.L = 1;
  a.B = B;
  a.D = D;
  a.F = F;
  a.H = H;
  a.N = N;
  return R6::launch(mats, a, grid, static_cast<cudaStream_t>(stream));
}
