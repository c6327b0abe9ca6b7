// K7-model: the whole L-layer RWKV-6 decode step in one launch, over the
// FusedLayerStack slab form of the weights (core/quant/serving.py): W8, W4
// or VQ planes, or plain bf16 weights.  This file also holds the kernel's
// instances and the launch that K7-block (rwkv6_block_decode.cu) shares.
//
// Replaces the TPU kernel kernels/fused_decode.py:fused_model_decode with
// the RWKV-6 body.  Its TPU forms, "stream" and "resident", compute the
// same bits; here both are one loop over layers inside one cooperative
// launch of rwkv6_body.cuh's kernel, the "stream" form's prefetch of layer
// l + 1's weights behind layer l being each block's ring of weight stages,
// which runs across layers.  The residual stays in bf16 in the scratch
// between layers, where K7-block writes it to device memory in bf16, so
// one K7-model launch and L K7-block launches give the same bits.
//
// Weights: layer l's codes are row l of the uint8 slab (each plane at a
// fixed offset), its vectors row l of the bf16 slab, and so are the
// weights of a plain bf16 matrix (a tree that was never packed has no
// uint8 slab); the table's plane of a matrix picks the slab its offset
// indexes.  The shared scales and VQ codebooks (leading-1 leaves) are aux
// pointers, the same for every layer.  The host turns the slab manifest
// into a table of offsets and checks it against the expected shapes; the
// kernel parses no tree.  Offsets are 64-bit: rwkv6-7b's uint8 slab holds
// 7.0e9 bytes.
//
// What bounds it on an H100: bytes.  At rwkv6-7b and batch 8 the step
// reads 32 × 219,967,488 B of codes, the vectors and scales, and reads and
// writes the state (32 × 2 × 4,325,376 B), ≈ 7.32 GB, ≥ 2.18 ms at
// 3.35 TB/s; under the MIXED policy (W4 att.wk, VQ ffn.wv) ≈ 7.05 GB, on
// plain bf16 weights ≈ 14.4 GB.  The design before this one ran each
// layer's phases with empty pipes after ten grid barriers a layer: 20.53
// ms W8, 19.92 MIXED, 14.97 bf16 on "NVIDIA H100 80GB HBM3, 700.00 W"
// (PERF.md §6, PR 21 run 8).  Here seven barriers a layer remain, the
// weights of the next phase and of the next layer are in flight when each
// opens, and the step takes 9.13 ms W8, 10.26 MIXED, 10.17 bf16 on the
// same card (PR 28 run 27); rwkv6_body.cuh's header says what binds it.
#include "rwkv6_body.cuh"

namespace repro {
namespace rwkv6 {

namespace {

const void* kernel_for(const int* planes) {
  return planes_of(planes) == kPlaneW8
             ? reinterpret_cast<const void*>(rwkv6_decode_kernel<kPlaneW8>)
             : reinterpret_cast<const void*>(rwkv6_decode_kernel<kPlaneAny>);
}

// The kernel's shared memory, and a carve-out of 71% of the SM's 228 KB:
// the driver rounds it up to the 164 KB configuration, which holds the
// block (~160 KB) and leaves the L1 ~92 KB, where the loop state the
// registers spill stays (PERF.md §6, PR 28 runs 26-27).
cudaError_t configure(const void* kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 71);
  return e;
}

}  // namespace

int max_grid(const int* planes, int* coop, int* blocks) {
  const void* kernel = kernel_for(planes);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = configure(kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, kSmemBytes);
  *blocks = *coop ? per_sm * sms : 0;
  return static_cast<int>(e);
}

int launch(const int* planes, const Net& net, int grid, cudaStream_t s) {
  const void* kernel = kernel_for(planes);
  cudaError_t e = configure(kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* params[] = {const_cast<Net*>(&net)};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), params,
                                  kSmemBytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rwkv6
}  // namespace repro

namespace {

using repro::bf16;
namespace R6 = repro::rwkv6;

constexpr int kNumPtrs = 4 + R6::kNumMats + 2 * R6::kNumState + 1;
constexpr int kNumOffs = 2 + R6::kNumVecs + R6::kNumMats;

}  // namespace

// Whether the device has cooperative launch, and the largest grid of
// K7's instance for these matrix planes (mats, the first 15 ints of the
// launch's) that fits on it at once.
extern "C" int rwkv6_model_decode_grid(const int* mats, int* coop,
                                       int* max_blocks) {
  return R6::max_grid(mats, coop, max_blocks);
}

// The launch plan the kernel runs for these matrix planes (mats, 15 ints)
// at (D, F, H, N), B lanes and `grid` blocks: R6::kPlanInts ints into out
// (rwkv6_body.cuh: plan_of); kernels/fused_decode.py:k7_plan is its twin.
extern "C" int rwkv6_decode_plan(const int* mats, int D, int F, int H, int N,
                                 int B, int grid, int* out) {
  if (D < 1 || F < 1 || H * N != D || grid < 1 || grid > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  R6::plan_of(mats, D, F, H, B, grid, out);
  return 0;
}

// ptrs (kNumPtrs): x, x_out, the uint8 slab (null where there is none),
// the bf16 slab, the 15 matrices' shared f32 scale or bf16 codebook (BF16:
// null) in R6::Mat order, the 3 state leaves in and the 3 out in
// R6::State order, each pointing at lane 0 of this launch's tile of B
// lanes in an (L, B_state, ...) leaf, the scratch
// (rwkv6_decode_scratch_bytes, zeroed).  offs (kNumOffs, int64): the uint8
// and bf16 slab row lengths, the 9 vectors' offsets in a bf16 row
// (R6::Vec order), the 15 matrices' offsets in a uint8 row, a BF16
// matrix's in a bf16 row (R6::Mat order).  mats (2·15 ints): the
// matrices' planes, then their codebooks' entries (0 unless VQ).
// B is the tile (at most R6::kLanes); B_state, the state's whole batch,
// sets the layer stride, so a tile runs in place in the whole state.
extern "C" int rwkv6_model_decode(const void* const* ptrs, int n_ptrs,
                                  const long long* offs, int n_offs,
                                  const int* mats, int L,
                                  int B, int B_state, int D, int F, int H,
                                  int N, int grid, void* stream) {
  if (n_ptrs != kNumPtrs || n_offs != kNumOffs || L < 1 || B < 1 ||
      B > R6::kLanes || B_state < B || H * N != D ||
      R6::kConsumers % N != 0 || D % 4 || F % 4 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  R6::Net a;
  int i = 0;
  a.x = static_cast<const bf16*>(ptrs[i++]);
  a.x_out = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  const uint8_t* u8 = static_cast<const uint8_t*>(ptrs[i++]);
  const bf16* b16 = static_cast<const bf16*>(ptrs[i++]);
  const long long u8_row = offs[0], b16_row = offs[1];
  for (int v = 0; v < R6::kNumVecs; ++v) a.vec[v] = b16 + offs[2 + v];
  a.vec_layer = b16_row;
  for (int m = 0; m < R6::kNumMats; ++m) {
    if (!R6::valid_matrix(mats[m], mats[R6::kNumMats + m]))
      return static_cast<int>(cudaErrorInvalidValue);
    const long long off = offs[2 + R6::kNumVecs + m];
    const bool bf = mats[m] == repro::kPlaneBF16;
    a.mat[m] = bf ? reinterpret_cast<const uint8_t*>(b16 + off) : u8 + off;
    a.mat_layer[m] = bf ? 2 * b16_row : u8_row;
    a.aux[m] = ptrs[i++];
    a.plane[m] = mats[m];
    a.aux_len[m] = mats[R6::kNumMats + m];
  }
  for (int k = 0; k < R6::kNumState; ++k)
    a.st_in[k] = static_cast<const bf16*>(ptrs[i++]);
  for (int k = 0; k < R6::kNumState; ++k)
    a.st_out[k] = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  R6::carve(static_cast<unsigned char*>(const_cast<void*>(ptrs[i++])), D, F,
            &a.s);
  a.st_layer[R6::ATT_X] = a.st_layer[R6::FFN_X] = (long long)B_state * D;
  a.st_layer[R6::WKV_S] = (long long)B_state * H * N * N;
  a.L = L;
  a.B = B;
  a.D = D;
  a.F = F;
  a.H = H;
  a.N = N;
  return R6::launch(mats, a, grid, static_cast<cudaStream_t>(stream));
}
