// The pieces of the RWKV-4 layer decode that K3 and K4 run
// (rwkv4_grid.cuh's grid-wide body, rwkv4_block_decode.cu and
// rwkv4_model_decode.cu): the layer's operand tables, the LayerNorm of a
// tile's lanes, the hardware numerics' tables and block maximum.
//
// One layer is models/rwkv4.py:block_decode:
//   1. LN1 (single pass, f32)        -> h, the new att_x state
//   2. the three token-shift mixes   -> mr, mk, mv
//   3. r/k/v matvecs, weights decoded in-kernel, and per channel the
//      WKV-4 step in f32 (new wkv_a/b/o state) and y = σ(r)·wkv
//   4. the wo matvec and the residual x2 = x + att
//   5. LN2                           -> h2, the new ffn_x state
//   6. the two channel-mix mixes
//   7. the wk matvec (K=D, N=F) with relu², and the wr matvec with σ
//   8. the wv matvec (K=F) and the gate, then x = x2 + rr·(kk @ wv)
// Every value the JAX trace holds in bf16 is rounded to bf16 at the same
// place (bf16r): the LN outputs, each of h·p, (1-p), x·(1-p) and their
// sum, each matvec output, σ(r)·out, relu² and the gated products, and
// both residual adds.
//
// The numerics are a template parameter, HW:
//   false  exact (the `_Std` numerics): XLA's bf16 σ expansion, expf and
//          division in the WKV step.
//   true   the paper's hardware numerics (`_Hw`, hw_units.cuh): LUT exp
//          and LUT division in the WKV step, the PWL σ, and the A9 fake
//          quant of the five mixes, kk, y = σ(r)·wkv and the gated FFN
//          output.  σ_pwl returns f32, so y, att, rr and ffn stay f32
//          where the exact numerics round to bf16, and the wo matvec takes
//          the f32 y.  A9's scale is max|v| over the whole (bb, n) tensor
//          of a tile: a tile of bb < B lanes takes its own max, as the TPU
//          kernel body sees one tile.  The two LUTs sit in shared memory.
//
// Each matrix arrives as a descriptor {codes, scale or codebook, plane}
// (common.cuh: Matrix): a W8, W4 or VQ plane (core/quant/serving.py), or
// plain bf16 weights read as they are (a tree that was never packed; the
// descriptor's `codes` then point at the bf16 weights and `aux` is null).
// The body is a template on PLANES: kPlaneW8 or kPlaneBF16 when every
// matrix of the layer has that form (that loop alone is compiled),
// kPlaneAny for a layer of mixed quantized planes (each matrix's plane is
// read at run time; a plain tree's layer is all BF16).  Both compute the
// same bits.
//
// Batch invariance (exact numerics): each LayerNorm reduction belongs to
// one warp in a fixed order, and each matvec output accumulates over
// k = 0..K-1 in order, whatever bb or the tile a lane falls in.
#pragma once

#include "hw_units.cuh"

namespace repro {
namespace rwkv4 {

// the layer's vector leaves, each (D,) bf16
enum Vec {
  LN1_W, LN1_B, LN2_W, LN2_B, ATT_MIX_R, ATT_MIX_K, ATT_MIX_V, TIME_DECAY,
  TIME_FIRST, FFN_MIX_R, FFN_MIX_K, kNumVecs
};
// the layer's matrices: att.wr/wk/wv/wo and ffn.wr (D,D), ffn.wk (D,F),
// ffn.wv (F,D)
enum Mat { ATT_WR, ATT_WK, ATT_WV, ATT_WO, FFN_WR, FFN_WK, FFN_WV, kNumMats };
// the recurrent state leaves, each (B, D) bf16 for one layer
enum State { ATT_X, FFN_X, WKV_A, WKV_B, WKV_O, kNumState };

// A stack of layers' weights: layer 0's vectors and matrices, and how far
// layer l + 1's lie from layer l's (zero for a single layer; in K4 the
// slab row: every layer's leaves sit at the same offsets of its row).
struct LayerWeights {
  const bf16* vec[kNumVecs];
  Matrix mat[kNumMats];
  long long vec_stride;            // elements from layer l's vectors to l+1's
  long long mat_stride[kNumMats];  // bytes from layer l's codes to l+1's
};

// One layer's state rows: (B, D) each, in and out.
struct LayerState {
  const bf16* in[kNumState];
  bf16* out[kNumState];
};

// PLANES of a layer whose matrices' planes are read at run time
constexpr int kPlaneAny = -1;

// LayerNorm of each of bb lanes' rows src (bf16, D) into dst and, unless
// gout is null, into the global state output row; one warp per lane,
// fixed reduction order, so every block that runs it gets the same bits.
__device__ inline void layernorm_lanes_n(int bb, const bf16* src, bf16* dst,
                                         int lane_stride, const bf16* g,
                                         const bf16* beta, int D, bf16* gout,
                                         int b0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int b = warp; b < bb; b += nwarps) {
    const bf16* row = src + b * lane_stride;
    float s = 0.f, s2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = bf2f(row[d]);
      s += v;
      s2 += v * v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mu = s / (float)D;
    const float var = s2 / (float)D - mu * mu;
    const float rs = rsqrtf(var + 1e-5f);
    bf16* out = dst + b * lane_stride;
    bf16* gr = gout ? gout + (size_t)(b0 + b) * D : nullptr;
    for (int d = lane; d < D; d += 32) {
      const float v = (bf2f(row[d]) - mu) * rs * bf2f(g[d]) + bf2f(beta[d]);
      const bf16 h = __float2bfloat16_rn(v);
      out[d] = h;
      if (gr) gr[d] = h;
    }
  }
}

// The PLANES a layer with these 7 matrix planes is compiled for: W8 or
// BF16 when every matrix is, else kPlaneAny (quantized planes only); -2
// for a layer that mixes plain bf16 and quantized matrices, which no
// packed or plain tree holds and the kernels refuse.
constexpr int kPlanesInvalid = -2;
inline int planes_of(const int* planes) {
  bool bf16 = false, any = false, w8 = true;
  for (int m = 0; m < kNumMats; ++m) {
    if (planes[m] < kPlaneW8 || planes[m] > kPlaneBF16) return kPlanesInvalid;
    (planes[m] == kPlaneBF16 ? bf16 : any) = true;
    w8 = w8 && planes[m] == kPlaneW8;
  }
  if (bf16) return any ? kPlanesInvalid : kPlaneBF16;
  return w8 ? kPlaneW8 : kPlaneAny;
}

// The hardware numerics' scratch, in floats: the EXP and
// DIV tables, then the block reductions' 33 slots for up to three values.
constexpr int kHwTabs = 512;
constexpr int kHwScratch = kHwTabs + 3 * 33;

// Stage the EXP and DIV tables (256 f32 each) into the scratch; visible
// after the caller's next barrier.
__device__ inline void stage_luts(float* scratch, const float* exp_tab,
                                  const float* div_tab) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    scratch[i] = exp_tab[i];
    scratch[256 + i] = div_tab[i];
  }
}

__device__ __forceinline__ float as_f32(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float as_f32(float v) { return v; }

// m[j] <- the max of m[j] over the block, for each j < N (values >= 0);
// red holds 33·N floats.  Every thread returns the same maxima.
template <int N>
__device__ void block_max(float (&m)[N], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], off));
    if (lane == 0) red[j * 33 + warp] = m[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float v = lane < nwarps ? red[j * 33 + lane] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) red[j * 33 + 32] = v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) m[j] = red[j * 33 + 32];
}

}  // namespace rwkv4
}  // namespace repro
