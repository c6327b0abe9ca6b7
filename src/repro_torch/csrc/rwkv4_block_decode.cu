// K3: one whole RWKV-4 block decode step per launch, over W8, W4 or VQ
// planes or plain bf16 weights, spread over the whole card.
//
// Replaces the TPU kernel kernels/fused_decode.py:fused_block_decode with
// the RWKV-4 body (models/rwkv4.py:block_decode, exact or hardware
// numerics) written into the kernel: Pallas traced the block function,
// CUDA cannot.  The layer runs as rwkv4_grid.cuh's grid-wide body, whose
// every output keeps the arithmetic of rwkv4_body.cuh's one-block layer,
// which K4 (rwkv4_model_decode.cu) runs per layer: one K4 launch and L K3
// launches give the same bits.  Given the EXP and DIV tables (the `_luts`
// operands) it runs the hardware numerics, the tables staged in each
// block's shared memory.
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
// numerics).  The one-block design this replaces ran a layer on one SM
// (2.26 ms at rwkv4-169m W8).
#include "rwkv4_grid.cuh"

namespace {

using repro::bf16;
namespace R4 = repro::rwkv4;
namespace RG = repro::rwkv4::grid;

// The layer's table is read from shared memory, as K7 reads its own:
// indexed at run time, a parameter-space table lands on each thread's
// stack.  So is the launch's geometry.
template <int PLANES, bool HW>
__global__ void __launch_bounds__(RG::kThreads, 1)
rwkv4_block_decode_kernel(const __grid_constant__ RG::Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ R4::LayerWeights w;
  __shared__ R4::LayerState st;
  __shared__ RG::Geo g;
  if (threadIdx.x == 0) {
    w = a.w;
    st = a.st;
    g = RG::make_geo(a);
  }
  __syncthreads();
  RG::layer<PLANES, HW>(w, st, g, a, smem);
}

template <bool HW>
auto kernel_for(int planes) {
  return planes == repro::kPlaneW8
             ? rwkv4_block_decode_kernel<repro::kPlaneW8, HW>
             : planes == repro::kPlaneBF16
                   ? rwkv4_block_decode_kernel<repro::kPlaneBF16, HW>
                   : rwkv4_block_decode_kernel<R4::kPlaneAny, HW>;
}

// The largest cooperative grid of `kernel` with `smem` bytes on the
// current device (0 when the device has no cooperative launch).
template <class Kernel>
int max_grid(Kernel kernel, int smem, int* coop, int* blocks) {
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
                                                      RG::kThreads, smem);
  *blocks = *coop ? per_sm * sms : 0;
  return static_cast<int>(e);
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

// Matrix m's codes (K × N of a plane, or bf16 weights) as a 2-D tensor of
// bytes: rows of N·esize bytes (K / 2 rows of a W4 plane's nibble pairs),
// boxes of one slice's row bytes × kc rows (kc / 2 for W4), rows past the
// matrix read as zeros, lines promoted to L2 256 bytes at a time so that
// neighbouring slices (other blocks) find them there.
bool encode_matrix(CUtensorMap* map, const repro::Matrix& mat, int m, int D,
                   int F, int kc) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const int esz = mat.plane == repro::kPlaneBF16 ? 2 : 1;
  const int half = mat.plane == repro::kPlaneW4 ? 2 : 1;
  const cuuint64_t K = m == R4::FFN_WV ? F : D, N = m == R4::FFN_WK ? F : D;
  const cuuint64_t dims[2] = {N * esz, K / half};
  const cuuint64_t strides[1] = {N * esz};
  const cuuint32_t box[2] = {(cuuint32_t)(RG::kWidth * esz),
                             (cuuint32_t)(kc / half)};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<uint8_t*>(mat.codes), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kNumScratch = 6;
constexpr int kExpTab = 2 + R4::kNumVecs + 2 * R4::kNumMats +
                        2 * R4::kNumState;   // then the DIV table
constexpr int kNumPtrs = kExpTab + 2 + kNumScratch;

}  // namespace

// Whether the device has cooperative launch, and the largest grid of K3's
// instance for these 7 matrix planes and numerics (hw) at `smem` bytes of
// shared memory a block that fits on it at once.
extern "C" int rwkv4_block_decode_grid(const int* planes, int hw, int smem,
                                       int* coop, int* max_blocks) {
  const int p = R4::planes_of(planes);
  if (p == R4::kPlanesInvalid) return static_cast<int>(cudaErrorInvalidValue);
  return hw ? max_grid(kernel_for<true>(p), smem, coop, max_blocks)
            : max_grid(kernel_for<false>(p), smem, coop, max_blocks);
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
  const int p = R4::planes_of(planes);
  const bool hw = ptrs[kExpTab] != nullptr;
  if (p == R4::kPlanesInvalid || bb < 1 || bb > 8 || B % bb != 0 || D % 2 ||
      F % 2 || grid < 1 || kc < 8 || kc % 8 || ns < 1 ||
      ns > RG::kMaxStages || width != RG::kWidth ||
      (size_t)smem != RG::layout(bb, D, F, hw, kc, ns,
                                 p == repro::kPlaneBF16 ? 2 * RG::kWidth
                                                        : RG::kWidth)
                          .total ||
      hw != (ptrs[kExpTab + 1] != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  RG::Args a;
  int i = 0;
  a.x = static_cast<const bf16*>(ptrs[i++]);
  a.x_out = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  for (int v = 0; v < R4::kNumVecs; ++v)
    a.w.vec[v] = static_cast<const bf16*>(ptrs[i++]);
  for (int m = 0; m < R4::kNumMats; ++m)
    a.w.mat[m].codes = static_cast<const uint8_t*>(ptrs[i++]);
  for (int m = 0; m < R4::kNumMats; ++m) {
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
  a.s.y = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.s.x2 = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  a.s.kk = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  a.s.rr = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.s.g = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.s.gmax = static_cast<unsigned*>(const_cast<void*>(ptrs[i++]));
  a.B = B;
  a.D = D;
  a.F = F;
  a.bb = bb;
  a.kc = kc;
  a.ns = ns;
  a.vec = vec;
  for (int m = 0; m < R4::kNumMats; ++m)
    if ((vec & 1) && !encode_matrix(&a.tmap[m], a.w.mat[m], m, D, F, kc))
      return static_cast<int>(cudaErrorInvalidValue);
  void* kernel = hw ? reinterpret_cast<void*>(kernel_for<true>(p))
                    : reinterpret_cast<void*>(kernel_for<false>(p));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(RG::kThreads),
                                  params, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
