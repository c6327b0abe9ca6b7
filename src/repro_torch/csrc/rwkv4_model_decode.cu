// K4: the whole L-layer RWKV-4 decode step in one launch, over the
// FusedLayerStack slab form of the weights (core/quant/serving.py).
//
// Replaces the TPU kernel kernels/fused_decode.py:fused_model_decode with
// the RWKV-4 body.  Its TPU forms, "stream" (a grid over layers, the
// next layer's slab row prefetched behind this one's compute) and
// "resident" (all layers bound at once), compute the same bits; here the
// stream form is the one: a cooperative launch of one 512-thread block an
// SM that loops rwkv4_grid.cuh's grid-wide layer body over the layers,
// with a grid barrier between layers, and whose ring of weight stages
// runs over the launch, so that layer l + 1's slices stream into each
// block's shared memory behind layer l's compute.  K3
// (rwkv4_block_decode.cu) is the same kernel launched on one layer, so one
// K4 launch and L K3 launches give the same bits: the residual passes
// between layers as a bf16 row in device memory, rounded where K3 writes
// its x_out.
//
// Weights: layer l's codes are row l of the uint8 slab (every matrix's
// W8 bytes, W4 nibble pairs or VQ indices at a fixed offset), its vectors
// row l of the bf16 slab, and so are the weights of a plain bf16 matrix
// (a tree that was never packed has no uint8 slab); the table's plane of
// a matrix picks the slab its offset indexes.  Each matrix is a 3-D
// tensor map (row bytes × rows × layers, the slab row the layer stride),
// so a stage is one box at (column byte, row, layer).  The shared scales
// and codebooks (leading-1 leaves) are aux pointers, the same for every
// layer.  The host turns the slab manifest into a table of offsets and
// planes and checks it against the expected shapes; the kernel parses no
// tree.  Offsets are 64-bit: rwkv4-7b's uint8 slab passes 2^31 bytes.
//
// Given the EXP and DIV tables (the stack's `_luts` aux leaves) it runs the
// hardware numerics, the tables staged in each block's shared memory once
// per launch.
//
// What bounds it on an H100: the weight codes, 12 × 7,372,800 B at
// rwkv4-169m with the mixed W8/W4/VQ planes (~90 MB with the vectors, the
// aux leaves and the state in and out, ~27 µs at 3.35 TB/s).  What binds
// is K3's per-layer cost, paid L times less one launch: each phase's
// prologue run by every block (LayerNorm and mixes, A9 under the hardware
// numerics), the stages' decode and chains, and the grid barriers (PERF.md
// §6).
//
// This file also holds the host side that K3 and K4 share (rwkv4_grid.cuh's
// max_grid and launch), where the kernel's instances are compiled.
#include "rwkv4_grid.cuh"

namespace repro {
namespace rwkv4 {
namespace grid {
namespace {

void* kernel_for(int planes, bool hw) {
  if (hw)
    return planes == kPlaneW8 ? reinterpret_cast<void*>(
                                    decode_kernel<kPlaneW8, true>)
           : planes == kPlaneBF16
               ? reinterpret_cast<void*>(decode_kernel<kPlaneBF16, true>)
               : reinterpret_cast<void*>(decode_kernel<kPlaneAny, true>);
  return planes == kPlaneW8
             ? reinterpret_cast<void*>(decode_kernel<kPlaneW8, false>)
         : planes == kPlaneBF16
             ? reinterpret_cast<void*>(decode_kernel<kPlaneBF16, false>)
             : reinterpret_cast<void*>(decode_kernel<kPlaneAny, false>);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the
// library links no driver API)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Matrix m's codes (K × N of a plane, or bf16 weights) over L layers as a
// 3-D tensor of bytes: rows of N·esize bytes (K / 2 rows of a W4 plane's
// nibble pairs), layer l at `stride` bytes from layer l - 1 (one layer:
// the matrix's bytes), boxes of one slice's row bytes × kc rows (kc / 2
// for W4) × one layer, rows past the matrix read as zeros, lines promoted
// to L2 256 bytes at a time so that neighbouring slices (other blocks)
// find them there.  kernels/fused_decode.py:k4_tensor_maps mirrors it.
bool encode_matrix(CUtensorMap* map, const Matrix& mat, int m, int D, int F,
                   int kc, int L, long long stride) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const int esz = mat.plane == kPlaneBF16 ? 2 : 1;
  const int half = mat.plane == kPlaneW4 ? 2 : 1;
  const cuuint64_t K = m == FFN_WV ? F : D, N = m == FFN_WK ? F : D;
  const cuuint64_t dims[3] = {N * esz, K / half, (cuuint64_t)L};
  const cuuint64_t strides[2] = {
      N * esz, stride ? (cuuint64_t)stride : N * esz * (K / half)};
  const cuuint32_t box[3] = {(cuuint32_t)(kWidth * esz),
                             (cuuint32_t)(kc / half), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
             const_cast<uint8_t*>(mat.codes), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

int max_grid(int planes, bool hw, int smem, int* coop, int* blocks) {
  if (planes == kPlanesInvalid)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = kernel_for(planes, hw);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  *blocks = *coop ? per_sm * sms : 0;
  return static_cast<int>(e);
}

int launch(Args& a, int planes, int width, int smem, int grid,
           cudaStream_t stream) {
  const bool hw = a.exp_tab != nullptr;
  if (planes == kPlanesInvalid || a.L < 1 || a.bb < 1 || a.bb > 8 ||
      a.B % a.bb != 0 || a.D % 2 || a.F % 2 || grid < 1 || a.kc < 8 ||
      a.kc % 8 || a.ns < 1 || a.ns > kMaxStages || width != kWidth ||
      (size_t)smem != layout(a.bb, a.D, a.F, hw, a.kc, a.ns,
                             planes == kPlaneBF16 ? 2 * kWidth : kWidth)
                          .total ||
      hw != (a.div_tab != nullptr) ||
      (a.L > 1 && (a.s.res[0] == nullptr || a.s.res[1] == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int m = 0; m < kNumMats; ++m)
    if ((a.vec & 1) && !encode_matrix(&a.tmap[m], a.w.mat[m], m, a.D, a.F,
                                      a.kc, a.L, a.w.mat_stride[m]))
      return static_cast<int>(cudaErrorInvalidValue);
  void* kernel = kernel_for(planes, hw);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), params,
                                  smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace grid
}  // namespace rwkv4
}  // namespace repro

namespace {

using repro::bf16;
namespace R4 = repro::rwkv4;
namespace RG = repro::rwkv4::grid;

constexpr int kNumScratch = 8;
constexpr int kExpTab = 4 + R4::kNumMats + 2 * R4::kNumState;
constexpr int kNumPtrs = kExpTab + 2 + kNumScratch;
constexpr int kNumOffs = 2 + R4::kNumVecs + R4::kNumMats;

}  // namespace

// ptrs (kNumPtrs): x, x_out, the uint8 slab, the bf16 slab, the 7
// matrices' shared scale / codebook in R4::Mat order, the 5 state leaves
// in and the 5 out in R4::State order, each (L, B, D), the EXP and DIV
// tables (256 f32 each; both null for the exact numerics), then the
// scratch: y (B,D) f32, x2 (B,D) bf16, kk (B,F) bf16, rr (B,D) f32, g
// (B,D) f32, L·B/bb uint32 and the two residual rows (B,D) bf16.  The
// uint8 slab and a BF16 matrix's aux are null where there are none.
// offs (kNumOffs, int64): the uint8 and bf16 slab row lengths, the 11
// vectors' offsets in a bf16 row (R4::Vec order), the 7 matrices' offsets
// in a uint8 row (a BF16 matrix's in a bf16 row).  planes: the 7
// matrices' planes.  width, kc, ns and smem: k3_plan's slice width, stage
// rows, ring slots and bytes of shared memory; vec: rwkv4_grid.cuh's
// Args::vec (which copies and loads may take 16 bytes).
extern "C" int rwkv4_model_decode(const void* const* ptrs, int n_ptrs,
                                  const long long* offs, int n_offs,
                                  const int* planes, int L, int B, int D,
                                  int F, int bb, int width, int kc, int ns,
                                  int smem, int grid, int vec, void* stream) {
  if (n_ptrs != kNumPtrs || n_offs != kNumOffs)
    return static_cast<int>(cudaErrorInvalidValue);
  RG::Args a;
  int i = 0;
  a.x = static_cast<const bf16*>(ptrs[i++]);
  a.x_out = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  const uint8_t* u8 = static_cast<const uint8_t*>(ptrs[i++]);
  const bf16* b16 = static_cast<const bf16*>(ptrs[i++]);
  const long long u8_row = offs[0], b16_row = offs[1];
  const long long* vec_off = offs + 2;
  const long long* mat_off = vec_off + R4::kNumVecs;
  for (int v = 0; v < R4::kNumVecs; ++v) a.w.vec[v] = b16 + vec_off[v];
  a.w.vec_stride = b16_row;
  for (int m = 0; m < R4::kNumMats; ++m) {
    const bool plain = planes[m] == repro::kPlaneBF16;
    a.w.mat[m] = {plain ? reinterpret_cast<const uint8_t*>(b16 + mat_off[m])
                        : u8 + mat_off[m],
                  ptrs[i++], planes[m], 0};
    a.w.mat_stride[m] = plain ? 2 * b16_row : u8_row;
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
  a.s.res[0] = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  a.s.res[1] = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  a.L = L;
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
