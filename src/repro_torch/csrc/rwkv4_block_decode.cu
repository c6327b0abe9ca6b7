// K3: one whole RWKV-4 block decode step per launch, over W8, W4 or VQ
// planes or plain bf16 weights, spread over the whole card.
//
// Replaces the TPU kernel kernels/fused_decode.py:fused_block_decode with
// the RWKV-4 body (models/rwkv4.py:block_decode, exact or hardware
// numerics) written into the kernel: Pallas traced the block function,
// CUDA cannot.  The layer runs as rwkv4_grid.cuh's grid-wide body: this
// file launches K4's kernel (rwkv4_model_decode.cu) on one layer, so one
// K4 launch and L K3 launches give the same bits.  Given the EXP and DIV
// tables (the `_luts` operands) it runs the hardware numerics, the tables
// staged in each block's shared memory.
//
// Grid: a cooperative launch of as many 512-thread blocks as fit on the
// card at once (one an SM: a block's ring of weight stages fills most of
// its shared memory), or fewer when the caller asks; the batch tiles of
// bb lanes all run in the one launch.  kernels/fused_decode.py:k3_plan
// sizes the ring and the tile and gives the shared memory a block needs.
// The host describes each matrix to the tensor-copy unit (a CUtensorMap a
// matrix, passed in the kernel's parameters).
//
// What bounds it on an H100: the weight codes, 5·D² + 2·D·F bytes a layer
// at W8 (7.67 MB at rwkv4-169m, ≥ 2.3 µs at 3.35 TB/s; plain bf16 weights
// twice that), against ~122 MFLOP at B = 8.  Every block puts its slices'
// codes in flight at launch, so the whole layer streams at once; then the
// longest dependent chain bounds it: ffn.wv's F FMAs in order (3072 at
// rwkv4-169m, ~7 µs), plus three grid barriers (four under the hardware
// numerics).
#include "rwkv4_grid.cuh"

namespace {

using repro::bf16;
namespace R4 = repro::rwkv4;
namespace RG = repro::rwkv4::grid;

constexpr int kNumScratch = 6;
constexpr int kExpTab = 2 + R4::kNumVecs + 2 * R4::kNumMats +
                        2 * R4::kNumState;   // then the DIV table
constexpr int kNumPtrs = kExpTab + 2 + kNumScratch;

}  // namespace

// Whether the device has cooperative launch, and the largest grid of K3's
// kernel (K4's too: the same kernel) for these 7 matrix planes and
// numerics (hw) at `smem` bytes of shared memory a block that fits on it
// at once.
extern "C" int rwkv4_block_decode_grid(const int* planes, int hw, int smem,
                                       int* coop, int* max_blocks) {
  return RG::max_grid(R4::planes_of(planes), hw != 0, smem, coop,
                      max_blocks);
}

// ptrs (kNumPtrs device pointers): x (B,D), x_out (B,D), the 11 vectors
// in R4::Vec order, the 7 matrices' codes (a BF16 matrix: its weights)
// then their scale / codebook (BF16: null) in R4::Mat order, the 5 state
// leaves in and the 5 out in R4::State order, each (B,D), the EXP and
// DIV tables (256 f32 each; both null for the exact numerics), then the
// scratch: y (B,D) f32, x2 (B,D) bf16, kk (B,F) bf16, rr (B,D) f32, g
// (B,D) f32 and B/bb uint32.  planes: the 7 matrices' planes.  width, kc,
// ns and smem: k3_plan's slice width, stage rows, ring slots and bytes of
// shared memory; vec: csrc/rwkv4_grid.cuh's Args::vec (which copies and
// loads may take 16 bytes).
extern "C" int rwkv4_block_decode(const void* const* ptrs, int n_ptrs,
                                  const int* planes, int B, int D, int F,
                                  int bb, int width, int kc, int ns, int smem,
                                  int grid, int vec, void* stream) {
  if (n_ptrs != kNumPtrs) return static_cast<int>(cudaErrorInvalidValue);
  RG::Args a;
  int i = 0;
  a.x = static_cast<const bf16*>(ptrs[i++]);
  a.x_out = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  for (int v = 0; v < R4::kNumVecs; ++v)
    a.w.vec[v] = static_cast<const bf16*>(ptrs[i++]);
  a.w.vec_stride = 0;
  for (int m = 0; m < R4::kNumMats; ++m)
    a.w.mat[m].codes = static_cast<const uint8_t*>(ptrs[i++]);
  for (int m = 0; m < R4::kNumMats; ++m) {
    a.w.mat[m].aux = ptrs[i++];
    a.w.mat[m].plane = planes[m];
    a.w.mat[m].aux_len = 0;
    a.w.mat_stride[m] = 0;
  }
  for (int k = 0; k < R4::kNumState; ++k)
    a.st.in[k] = static_cast<const bf16*>(ptrs[i++]);
  for (int k = 0; k < R4::kNumState; ++k)
    a.st.out[k] = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  a.exp_tab = static_cast<const float*>(ptrs[i++]);
  a.div_tab = static_cast<const float*>(ptrs[i++]);
  a.s.y = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.s.x2 = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  a.s.kk = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  a.s.rr = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.s.g = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.s.gmax = static_cast<unsigned*>(const_cast<void*>(ptrs[i++]));
  a.s.res[0] = a.s.res[1] = nullptr;
  a.L = 1;
  a.B = B;
  a.D = D;
  a.F = F;
  a.bb = bb;
  a.kc = kc;
  a.ns = ns;
  a.vec = vec;
  return RG::launch(a, R4::planes_of(planes), width, smem, grid,
                    static_cast<cudaStream_t>(stream));
}
