// K4: the whole L-layer RWKV-4 decode step in one launch, over the
// FusedLayerStack slab form of the weights (core/quant/serving.py).
//
// Replaces the TPU kernel kernels/fused_decode.py:fused_model_decode with
// the RWKV-4 body.  Its TPU forms, "stream" (a grid over layers, the
// next layer's slab row prefetched behind this one's compute) and
// "resident" (all layers bound at once), compute the same bits; here both
// become one loop over layers inside one block, so there is one form.
//
// Grid: one block per tile of bb batch lanes (bb = B by default, at most
// 8).  The block loops l = 0..L-1 over the layer body of rwkv4_body.cuh,
// whose every output K3's grid-wide body (rwkv4_grid.cuh) computes with
// the same arithmetic.  The residual stays in shared memory in bf16
// between layers, where K3 writes it to device memory in bf16, so one K4
// launch and L K3 launches give the same bits.
//
// Weights: layer l's codes are row l of the uint8 slab (every matrix's
// W8 bytes, W4 nibble pairs or VQ indices at a fixed offset), its vectors
// row l of the bf16 slab, and so are the weights of a plain bf16 matrix
// (a tree that was never packed has no uint8 slab); the table's plane of
// a matrix picks the slab its offset indexes.  The shared scales and
// codebooks (leading-1 leaves) are aux pointers, the same for every
// layer.  The host turns the
// slab manifest into a table of offsets and planes and checks it against
// the expected shapes; the kernel parses no tree.  Offsets are 64-bit:
// rwkv4-7b's uint8 slab passes 2^31 bytes.
//
// Given the EXP and DIV tables (the stack's `_luts` aux leaves) it runs the
// hardware numerics, the tables staged in shared memory once per launch.
//
// What bounds it on an H100: the weight codes, 12 × 7,372,800 B at
// rwkv4-169m with the mixed W8/W4/VQ planes (~90 MB with the vectors, the
// aux leaves and the state in and out, ~27 µs at 3.35 TB/s).  At bb = B the
// whole step runs on one SM (27 ms at rwkv4-169m): far from that bound.
// K3 now spreads a layer over every SM with the same arithmetic
// (rwkv4_grid.cuh); looping that grid-wide body over the layers in one
// launch, layer l+1's slices prefetched behind layer l, is the later work
// that makes K4 fast.
#include <algorithm>

#include "rwkv4_body.cuh"

namespace {

using repro::bf16;
namespace R4 = repro::rwkv4;

struct ModelArgs {
  const bf16* x;                           // (B, D)
  bf16* x_out;                             // (B, D)
  const uint8_t* u8;                       // (L, u8_row) code slab
  const bf16* b16;                         // (L, b16_row) vector slab
  long long u8_row, b16_row;               // slab row lengths (elements)
  long long vec_off[R4::kNumVecs];         // into a bf16 slab row
  long long mat_off[R4::kNumMats];         // into a uint8 slab row (a
                                           // BF16 matrix: a bf16 row)
  const void* mat_aux[R4::kNumMats];       // shared scale or codebook
  int mat_plane[R4::kNumMats];
  const bf16* st_in[R4::kNumState];        // (L, B, D) each
  bf16* st_out[R4::kNumState];             // (L, B, D) each
  const float* exp_tab;                    // null: exact numerics
  const float* div_tab;
  int L, B, D, F;
};

template <int BB, int PLANES, bool HW>
__global__ void __launch_bounds__(1024)
rwkv4_model_decode_kernel(const ModelArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ R4::LayerWeights w;
  __shared__ R4::LayerState st;
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int D = a.D, F = a.F;
  const int b0 = blockIdx.x * BB;
  const size_t layer_state = (size_t)a.B * D;
  float* scratch = nullptr;
  if constexpr (HW) {
    scratch = R4::hw_scratch(smem, BB, D, F);
    R4::stage_luts(scratch, a.exp_tab, a.div_tab);
  }
  R4::load_residual<BB, HW>(a.x, smem, D, F, b0);
  for (int l = 0; l < a.L; ++l) {
    if (threadIdx.x == 0) {
      const uint8_t* u8 = a.u8 + (size_t)l * a.u8_row;
      const bf16* b16 = a.b16 + (size_t)l * a.b16_row;
      for (int v = 0; v < R4::kNumVecs; ++v) w.vec[v] = b16 + a.vec_off[v];
      for (int m = 0; m < R4::kNumMats; ++m)
        w.mat[m] = {a.mat_plane[m] == repro::kPlaneBF16
                        ? reinterpret_cast<const uint8_t*>(b16 + a.mat_off[m])
                        : u8 + a.mat_off[m],
                    a.mat_aux[m], a.mat_plane[m], 0};
      for (int k = 0; k < R4::kNumState; ++k) {
        st.in[k] = a.st_in[k] + l * layer_state;
        st.out[k] = a.st_out[k] + l * layer_state;
      }
    }
    __syncthreads();  // the layer's table, and the residual, are in place
    R4::layer<BB, PLANES, HW>(w, st, smem, D, F, b0, scratch);
    __syncthreads();  // the layer's output is in X before anyone reads it
  }
  R4::store_residual<BB, HW>(smem, a.x_out, D, F, b0);
}

template <int BB, int PLANES, bool HW>
int launch(const ModelArgs& a, cudaStream_t s) {
  const int threads = std::min(1024, ((a.D + 31) / 32) * 32);
  const size_t smem = R4::smem_bytes(BB, a.D, a.F, HW);
  cudaError_t e = cudaFuncSetAttribute(
      rwkv4_model_decode_kernel<BB, PLANES, HW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rwkv4_model_decode_kernel<BB, PLANES, HW><<<a.B / BB, threads, smem, s>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

template <int PLANES, bool HW>
int launch_bb(int bb, const ModelArgs& a, cudaStream_t s) {
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
int launch_planes(int bb, const int* planes, const ModelArgs& a,
                  cudaStream_t s) {
  switch (R4::planes_of(planes)) {
    case repro::kPlaneW8: return launch_bb<repro::kPlaneW8, HW>(bb, a, s);
    case repro::kPlaneBF16: return launch_bb<repro::kPlaneBF16, HW>(bb, a, s);
    case R4::kPlaneAny: return launch_bb<R4::kPlaneAny, HW>(bb, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

constexpr int kNumPtrs = 6 + R4::kNumMats + 2 * R4::kNumState;
constexpr int kNumOffs = 2 + R4::kNumVecs + R4::kNumMats;

}  // namespace

// ptrs (kNumPtrs): x, x_out, the uint8 slab, the bf16 slab, the 7
// matrices' shared scale / codebook in R4::Mat order, the 5 state leaves
// in and the 5 out in R4::State order, each (L, B, D), then the EXP and
// DIV tables (256 f32 each; both null for the exact numerics).  The
// uint8 slab and a BF16 matrix's aux are null where there are none.
// offs (kNumOffs, int64): the uint8 and bf16 slab row lengths, the 11
// vectors' offsets in a bf16 row (R4::Vec order), the 7 matrices' offsets
// in a uint8 row (a BF16 matrix's in a bf16 row).  planes: the 7
// matrices' planes.
extern "C" int rwkv4_model_decode(const void* const* ptrs, int n_ptrs,
                                  const long long* offs, int n_offs,
                                  const int* planes, int L, int B, int D,
                                  int F, int bb, void* stream) {
  if (n_ptrs != kNumPtrs || n_offs != kNumOffs || L < 1 || bb < 1 ||
      bb > 8 || B % bb != 0 || D % 2 || F % 2 ||
      (ptrs[kNumPtrs - 2] == nullptr) != (ptrs[kNumPtrs - 1] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ModelArgs a;
  int i = 0;
  a.x = static_cast<const bf16*>(ptrs[i++]);
  a.x_out = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  a.u8 = static_cast<const uint8_t*>(ptrs[i++]);
  a.b16 = static_cast<const bf16*>(ptrs[i++]);
  for (int m = 0; m < R4::kNumMats; ++m) {
    if (planes[m] < repro::kPlaneW8 || planes[m] > repro::kPlaneBF16)
      return static_cast<int>(cudaErrorInvalidValue);
    a.mat_aux[m] = ptrs[i++];
    a.mat_plane[m] = planes[m];
  }
  for (int k = 0; k < R4::kNumState; ++k)
    a.st_in[k] = static_cast<const bf16*>(ptrs[i++]);
  for (int k = 0; k < R4::kNumState; ++k)
    a.st_out[k] = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  a.exp_tab = static_cast<const float*>(ptrs[i++]);
  a.div_tab = static_cast<const float*>(ptrs[i++]);
  int j = 0;
  a.u8_row = offs[j++];
  a.b16_row = offs[j++];
  for (int v = 0; v < R4::kNumVecs; ++v) a.vec_off[v] = offs[j++];
  for (int m = 0; m < R4::kNumMats; ++m) a.mat_off[m] = offs[j++];
  a.L = L;
  a.B = B;
  a.D = D;
  a.F = F;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.exp_tab ? launch_planes<true>(bb, planes, a, s)
                   : launch_planes<false>(bb, planes, a, s);
}
