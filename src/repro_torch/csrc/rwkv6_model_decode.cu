// K7-model: the whole L-layer RWKV-6 decode step in one launch, over the
// FusedLayerStack slab form of the weights (core/quant/serving.py): W8, W4
// or VQ planes, or plain bf16 weights.
//
// Replaces the TPU kernel kernels/fused_decode.py:fused_model_decode with
// the RWKV-6 body.  Its TPU forms, "stream" and "resident", compute the
// same bits; here both are one loop over layers inside one cooperative
// launch, each layer the body of rwkv6_body.cuh that K7-block runs, with
// a grid-wide barrier between layers.  The residual stays in bf16 in the
// scratch between layers, where K7-block writes it to device memory in
// bf16, so one K7-model launch and L K7-block launches give the same bits.
//
// Weights: layer l's codes are row l of the uint8 slab (each plane at a
// fixed offset), its vectors row l of the bf16 slab, and so are the
// weights of a plain bf16 matrix (a tree that was never packed has no
// uint8 slab); the table's plane of a matrix picks the slab its offset
// indexes.  The shared scales and VQ codebooks (leading-1 leaves) are aux
// pointers, the same for every layer.  The
// host turns the slab manifest into a table of offsets and checks it
// against the expected shapes; the kernel parses no tree.  Offsets are
// 64-bit: rwkv6-7b's uint8 slab holds 7.0e9 bytes.
//
// What bounds it on an H100: bytes.  At rwkv6-7b and batch 8 the step
// reads 32 × 219,967,488 B of codes, the vectors and scales, and reads and
// writes the state (32 × 2 × 4,325,376 B), ≈ 7.32 GB, ≥ 2.18 ms at
// 3.35 TB/s; under the MIXED policy (W4 att.wk, VQ ffn.wv) ≈ 7.05 GB, on
// plain bf16 weights ≈ 14.4 GB.  The design spreads every layer over the whole card
// (K7-block's header); its speed is later work.
#include "rwkv6_body.cuh"

namespace {

using repro::bf16;
namespace R6 = repro::rwkv6;

struct ModelArgs {
  const uint8_t* u8;                       // (L, u8_row) code slab
  const bf16* b16;                         // (L, b16_row) vector slab
  long long u8_row, b16_row;               // slab row lengths (elements)
  long long vec_off[R6::kNumVecs];         // into a bf16 slab row
  long long mat_off[R6::kNumMats];         // into a uint8 slab row (a
                                           // BF16 matrix: a bf16 row)
  const void* mat_aux[R6::kNumMats];       // shared scale or codebook
  int mat_plane[R6::kNumMats], mat_len[R6::kNumMats];
  const bf16* st_in[R6::kNumState];        // (L, B, ...) each
  bf16* st_out[R6::kNumState];
  long long st_layer[R6::kNumState];       // elements a layer
  R6::Dims dims;
  R6::Scratch s;
  const bf16* x;                           // (B, D)
  bf16* x_out;                             // (B, D)
  int L;
};

template <int PLANES>
__global__ void __launch_bounds__(R6::kThreads)
rwkv6_model_decode_kernel(const ModelArgs a) {
  extern __shared__ float smem[];
  __shared__ R6::LayerWeights w;
  __shared__ R6::LayerState st;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int l = 0; l < a.L; ++l) {
    if (threadIdx.x == 0) {
      const uint8_t* u8 = a.u8 + (size_t)l * a.u8_row;
      const bf16* b16 = a.b16 + (size_t)l * a.b16_row;
      for (int v = 0; v < R6::kNumVecs; ++v) w.vec[v] = b16 + a.vec_off[v];
      for (int m = 0; m < R6::kNumMats; ++m)
        w.mat[m] = {a.mat_plane[m] == repro::kPlaneBF16
                        ? reinterpret_cast<const uint8_t*>(b16 + a.mat_off[m])
                        : u8 + a.mat_off[m],
                    a.mat_aux[m], a.mat_plane[m], a.mat_len[m]};
      for (int k = 0; k < R6::kNumState; ++k) {
        st.in[k] = a.st_in[k] + l * a.st_layer[k];
        st.out[k] = a.st_out[k] + l * a.st_layer[k];
      }
    }
    __syncthreads();  // the layer's table is in place
    R6::layer<PLANES>(w, st, a.dims, a.s, l == 0 ? a.x : a.s.xres,
              l == a.L - 1 ? a.x_out : a.s.xres, smem);
    grid.sync();      // the layer's output is whole before the next reads it
  }
}

// The instance for layers of these planes (R6::planes_of).
auto kernel_for(const int* planes) {
  return R6::planes_of(planes) == repro::kPlaneW8
             ? rwkv6_model_decode_kernel<repro::kPlaneW8>
             : rwkv6_model_decode_kernel<R6::kPlaneAny>;
}

constexpr int kNumPtrs = 4 + R6::kNumMats + 2 * R6::kNumState + 1;
constexpr int kNumOffs = 2 + R6::kNumVecs + R6::kNumMats;

}  // namespace

// Whether the device has cooperative launch, and the largest grid of
// K7-model's instance for these matrix planes (mats, the first 15 ints of
// the launch's) that fits on it at once.
extern "C" int rwkv6_model_decode_grid(const int* mats, int* coop,
                                       int* max_blocks) {
  return R6::max_grid(kernel_for(mats), coop, max_blocks);
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
      B > R6::kLanes || B_state < B || H * N != D || R6::kThreads % N != 0 ||
      D % 4 || F % 4 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ModelArgs a;
  int i = 0;
  a.x = static_cast<const bf16*>(ptrs[i++]);
  a.x_out = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  a.u8 = static_cast<const uint8_t*>(ptrs[i++]);
  a.b16 = static_cast<const bf16*>(ptrs[i++]);
  for (int m = 0; m < R6::kNumMats; ++m) {
    if (!R6::valid_matrix(mats[m], mats[R6::kNumMats + m]))
      return static_cast<int>(cudaErrorInvalidValue);
    a.mat_aux[m] = ptrs[i++];
    a.mat_plane[m] = mats[m];
    a.mat_len[m] = mats[R6::kNumMats + m];
  }
  for (int k = 0; k < R6::kNumState; ++k)
    a.st_in[k] = static_cast<const bf16*>(ptrs[i++]);
  for (int k = 0; k < R6::kNumState; ++k)
    a.st_out[k] = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  R6::carve(static_cast<unsigned char*>(const_cast<void*>(ptrs[i++])), D, F,
            &a.s);
  int j = 0;
  a.u8_row = offs[j++];
  a.b16_row = offs[j++];
  for (int v = 0; v < R6::kNumVecs; ++v) a.vec_off[v] = offs[j++];
  for (int m = 0; m < R6::kNumMats; ++m) a.mat_off[m] = offs[j++];
  a.st_layer[R6::ATT_X] = a.st_layer[R6::FFN_X] = (long long)B_state * D;
  a.st_layer[R6::WKV_S] = (long long)B_state * H * N * N;
  a.dims = {B, D, F, H, N};
  a.L = L;
  return R6::launch(kernel_for(mats), a, grid,
                    static_cast<cudaStream_t>(stream));
}
