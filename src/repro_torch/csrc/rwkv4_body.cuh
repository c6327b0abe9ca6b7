// The RWKV-4 layer decode body: K4 (rwkv4_model_decode.cu, every layer in
// one launch) runs `layer` below on one block a tile; K3
// (rwkv4_block_decode.cu, one layer a launch) runs rwkv4_grid.cuh's
// grid-wide body, built from the same pieces here (the LayerNorm, the
// mixes, the A9 steps, the decodes, dot_col's order of FMAs), so both
// give the same bits.
//
// One call runs models/rwkv4.py:block_decode for one layer and one tile of
// BB batch lanes:
//   1. LN1 (single pass, f32)        -> h, the new att_x state
//   2. the three token-shift mixes   -> mr, mk, mv
//   3. r/k/v matvecs, weights decoded in-kernel, and per channel the
//      WKV-4 step in f32 (new wkv_a/b/o state) and y = σ(r)·wkv
//   4. the wo matvec and the residual x2 = x + att
//   5. LN2                           -> h2, the new ffn_x state
//   6. the two channel-mix mixes
//   7. the wk matvec (K=D, N=F) with relu², and the wr matvec with σ
//   8. the wv matvec (K=F) and the gate, then x = x2 + rr·(kk @ wv)
// Every value the JAX trace holds in bf16 is rounded to bf16 here at the
// same place (bf16r): the LN outputs, each of h·p, (1-p), x·(1-p) and
// their sum, each matvec output, σ(r)·out, relu² and the gated products,
// and both residual adds.
//
// The numerics are a template parameter, HW:
//   false  exact (the `_Std` numerics): XLA's bf16 σ expansion, expf and
//          division in the WKV step.
//   true   the paper's hardware numerics (`_Hw`, hw_units.cuh): LUT exp
//          and LUT division in the WKV step, the PWL σ, and the A9 fake
//          quant of the five mixes, kk, y = σ(r)·wkv and the gated FFN
//          output.  σ_pwl returns f32, so y, att, rr and ffn stay f32
//          where the exact numerics round to bf16, and the wo matvec takes
//          the f32 y.  A9's scale is max|v| over the whole (BB, n) tensor:
//          a block-wide reduction (exact, so its order does not matter)
//          before any element is quantized.  A tile of BB < B lanes takes
//          its own max, as the TPU kernel body sees one tile.  The two
//          LUTs sit in shared memory beside the lanes.
//
// The residual x lives in shared memory in bf16 (X below): it enters
// there and the body leaves the layer's output there, in place; K4 keeps
// it for the next layer.
//
// Each matrix arrives as a descriptor {codes, scale or codebook, plane}
// (common.cuh: Matrix): a W8, W4 or VQ plane (core/quant/serving.py), or
// plain bf16 weights read as they are (a tree that was never packed; the
// descriptor's `codes` then point at the bf16 weights and `aux` is null).
// The plane is uniform across a matrix, so its branch costs no
// divergence.  The body is a template on PLANES: kPlaneW8 or kPlaneBF16
// when every matrix of the layer has that form (that loop alone is
// compiled), kPlaneAny for a layer of mixed quantized planes (each
// matrix's plane is read at run time; a plain tree's layer is all BF16).
// Both compute the same bits.
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

struct LayerWeights {
  const bf16* vec[kNumVecs];
  Matrix mat[kNumMats];
};

struct LayerState {
  const bf16* in[kNumState];
  bf16* out[kNumState];
};

// acc[b] += in[b][k]·w0 then in[b][k+1]·w1, lane b's bf16 row at
// in + b·lane_stride (k even, 4-byte aligned).
template <int BB>
__device__ __forceinline__ void fma_pair(const bf16* in, int lane_stride,
                                         int k, float w0, float w1,
                                         float (&acc)[BB]) {
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    const float2 xv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(in + b * lane_stride + k));
    acc[b] = fmaf(xv.x, w0, acc[b]);
    acc[b] = fmaf(xv.y, w1, acc[b]);
  }
}

// The same for f32 rows (the hardware numerics' y).
template <int BB>
__device__ __forceinline__ void fma_pair(const float* in, int lane_stride,
                                         int k, float w0, float w1,
                                         float (&acc)[BB]) {
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    const float* p = in + b * lane_stride + k;
    acc[b] = fmaf(p[0], w0, acc[b]);
    acc[b] = fmaf(p[1], w1, acc[b]);
  }
}

// PLANES of a layer whose matrices' planes are read at run time
constexpr int kPlaneAny = -1;

// acc[b] = Σ_k in[b][k] · decode(w[k][col]) over k = 0..K-1 in order (K
// even); PLANES is m's plane, or kPlaneAny to read it from m; the rows are
// bf16 or f32 (TIn).
template <int BB, int PLANES, typename TIn>
__device__ __forceinline__ void dot_col(const TIn* in, int lane_stride, int K,
                                        const Matrix& m, int N, int col,
                                        float (&acc)[BB]) {
#pragma unroll
  for (int b = 0; b < BB; ++b) acc[b] = 0.f;
  const uint8_t* __restrict__ wp = m.codes + col;
  const int plane = PLANES == kPlaneAny ? m.plane : PLANES;
  if constexpr (PLANES == kPlaneBF16) {
    const unsigned short* __restrict__ wb =
        reinterpret_cast<const unsigned short*>(m.codes) + col;
#pragma unroll 2
    for (int k = 0; k < K; k += 2) {
      fma_pair<BB>(in, lane_stride, k, bf16_lo(__ldg(wb + (size_t)k * N)),
                   bf16_lo(__ldg(wb + (size_t)(k + 1) * N)), acc);
    }
  } else if (plane == kPlaneVQ) {
    const bf16* cb = static_cast<const bf16*>(m.aux);
#pragma unroll 2
    for (int k = 0; k < K; k += 2) {
      const float w0 = vq_decode(__ldg(wp + (size_t)k * N), cb);
      const float w1 = vq_decode(__ldg(wp + (size_t)(k + 1) * N), cb);
      fma_pair<BB>(in, lane_stride, k, w0, w1, acc);
    }
  } else if (plane == kPlaneW4) {
    const float sc = static_cast<const float*>(m.aux)[col];
#pragma unroll 2
    for (int k = 0; k < K; k += 2) {
      const uint32_t byte = __ldg(wp + (size_t)(k >> 1) * N);
      fma_pair<BB>(in, lane_stride, k, dpot_w4_decode(byte, 0, sc),
                   dpot_w4_decode(byte, 1, sc), acc);
    }
  } else {
    const float sc = static_cast<const float*>(m.aux)[col];
#pragma unroll 2
    for (int k = 0; k < K; k += 2) {
      const float w0 = dpot_w8_decode(__ldg(wp + (size_t)k * N), sc);
      const float w1 = dpot_w8_decode(__ldg(wp + (size_t)(k + 1) * N), sc);
      fma_pair<BB>(in, lane_stride, k, w0, w1, acc);
    }
  }
}

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

template <int BB>
__device__ void layernorm_lanes(const bf16* src, bf16* dst, int lane_stride,
                                const bf16* g, const bf16* beta, int D,
                                bf16* gout, int b0) {
  layernorm_lanes_n(BB, src, dst, lane_stride, g, beta, D, gout, b0);
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

// A lane's stride in shared memory, in bf16 elements: X, H, M0, M1, M2,
// R and KK (F wide) as bf16; under the hardware numerics R holds f32 (y,
// then rr, then the gated FFN output) and takes two bf16 slots a value.
__host__ __device__ inline int lane_stride(int D, int F, bool hw) {
  return (hw ? 7 * D : 6 * D) + F;
}

// The hardware numerics' scratch after the lanes, in floats: the EXP and
// DIV tables, then the block reductions' 33 slots for up to three values.
constexpr int kHwTabs = 512;
constexpr int kHwScratch = kHwTabs + 3 * 33;

// Shared memory a block needs for BB lanes: each lane's intermediates,
// (6·D + F)·2 bytes a lane, or (7·D + F)·2 under the hardware numerics
// plus its scratch.
__host__ __device__ inline size_t smem_bytes(int bb, int D, int F,
                                             bool hw = false) {
  return (size_t)bb * lane_stride(D, F, hw) * sizeof(bf16) +
         (hw ? kHwScratch * sizeof(float) : 0);
}

// The hardware numerics' scratch of a block's shared memory.
__device__ inline float* hw_scratch(bf16* smem, int bb, int D, int F) {
  return reinterpret_cast<float*>(smem + (size_t)bb * lane_stride(D, F, true));
}

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

// A9 of N tensors of BB lanes × n values each, in place: bufs[j] (lane
// stride LS elements of T), each with its own max|v| over the block; a
// bf16 tensor's dequantized value is rounded to bf16 (`.astype(x.dtype)`),
// an f32 one's is kept.  Ends with a barrier.
template <int BB, int N, typename T>
__device__ void a9_tensors(T* const (&bufs)[N], int LS, int n, float* red) {
  float m[N];
#pragma unroll
  for (int j = 0; j < N; ++j) m[j] = 0.f;
  for (int i = threadIdx.x; i < BB * n; i += blockDim.x) {
    const int b = i / n, d = i % n;
#pragma unroll
    for (int j = 0; j < N; ++j)
      m[j] = fmaxf(m[j], fabsf(as_f32(bufs[j][b * LS + d])));
  }
  block_max<N>(m, red);
#pragma unroll
  for (int j = 0; j < N; ++j) m[j] = a9_scale(m[j]);
  for (int i = threadIdx.x; i < BB * n; i += blockDim.x) {
    const int b = i / n, d = i % n;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T& v = bufs[j][b * LS + d];
      if constexpr (sizeof(T) == sizeof(bf16))
        v = __float2bfloat16_rn(a9(as_f32(v), m[j]));
      else
        v = a9(as_f32(v), m[j]);
    }
  }
  __syncthreads();
}

// One layer for the BB lanes b0..b0+BB-1.  smem holds BB lanes of
// lane_stride(D, F, HW) bf16 each; X (the first D of each lane) carries
// the residual in and the layer's output out.  Under HW, `scratch` is
// hw_scratch(): the staged LUTs, then the reductions' room.  Ends without
// a barrier: the caller synchronises before reading X.
template <int BB, int PLANES, bool HW = false>
__device__ void layer(const LayerWeights& w, const LayerState& st,
                      bf16* smem, int D, int F, int b0,
                      float* scratch = nullptr) {
  const int LS = lane_stride(D, F, HW);  // lane stride in shared memory
  bf16* X = smem;            // residual x, then x2, then the output
  bf16* H = smem + D;        // h, then y = σ(r)·wkv (exact numerics), h2
  bf16* M0 = smem + 2 * D;   // mixes: r / k / v, then ffn r / k
  bf16* M1 = smem + 3 * D;
  bf16* M2 = smem + 4 * D;
  bf16* R = smem + 5 * D;    // σ(ffn r)
  // hardware numerics: R as f32 (lane stride LS / 2 floats): y, then
  // σ(ffn r), then the gated FFN output
  float* RF = reinterpret_cast<float*>(R);
  bf16* KK = smem + (HW ? 7 : 6) * D;  // relu²(ffn k), F wide
  float* red = HW ? scratch + kHwTabs : nullptr;
  const LutUnits units{scratch, HW ? scratch + 256 : nullptr};
  const int tid = threadIdx.x, nt = blockDim.x;
  const Matrix* mat = w.mat;

  // 1. LN1 -> h (also the new att_x state)
  layernorm_lanes<BB>(X, H, LS, w.vec[LN1_W], w.vec[LN1_B], D,
                      st.out[ATT_X], b0);
  __syncthreads();

  // 2. time-mix token shifts (A9 under HW)
  for (int i = tid; i < BB * D; i += nt) {
    const int b = i / D, d = i % D;
    const float h = bf2f(H[b * LS + d]);
    const float prev = bf2f(st.in[ATT_X][(size_t)(b0 + b) * D + d]);
    M0[b * LS + d] = mix(h, prev, bf2f(w.vec[ATT_MIX_R][d]));
    M1[b * LS + d] = mix(h, prev, bf2f(w.vec[ATT_MIX_K][d]));
    M2[b * LS + d] = mix(h, prev, bf2f(w.vec[ATT_MIX_V][d]));
  }
  __syncthreads();
  if constexpr (HW) {
    bf16* const mixes[3] = {M0, M1, M2};
    a9_tensors<BB, 3>(mixes, LS, D, red);
  }

  // 3. r/k/v matvecs, the WKV step and y = σ(r)·wkv, one channel a thread
  for (int c = tid; c < D; c += nt) {
    float ar[BB], ak[BB], av[BB];
    dot_col<BB, PLANES>(M0, LS, D, mat[ATT_WR], D, c, ar);
    dot_col<BB, PLANES>(M1, LS, D, mat[ATT_WK], D, c, ak);
    dot_col<BB, PLANES>(M2, LS, D, mat[ATT_WV], D, c, av);
    const float wd = expf(bf2f(w.vec[TIME_DECAY][c]));
    const float u = bf2f(w.vec[TIME_FIRST][c]);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const size_t g = (size_t)(b0 + b) * D + c;
      float na, nb, no;
      if constexpr (HW) {
        const float out = wkv4_step(
            bf2f(st.in[WKV_A][g]), bf2f(st.in[WKV_B][g]),
            bf2f(st.in[WKV_O][g]), bf16r(ak[b]), bf16r(av[b]), wd, u, &na,
            &nb, &no, units);
        RF[b * (LS / 2) + c] = sigmoid_pwl(bf16r(ar[b])) * bf16r(out);
      } else {
        const float out = wkv4_step(
            bf2f(st.in[WKV_A][g]), bf2f(st.in[WKV_B][g]),
            bf2f(st.in[WKV_O][g]), bf16r(ak[b]), bf16r(av[b]), wd, u, &na,
            &nb, &no);
        const float sr = sigmoid_bf16(bf16r(ar[b]));
        H[b * LS + c] = __float2bfloat16_rn(sr * bf16r(out));
      }
      st.out[WKV_A][g] = __float2bfloat16_rn(na);
      st.out[WKV_B][g] = __float2bfloat16_rn(nb);
      st.out[WKV_O][g] = __float2bfloat16_rn(no);
    }
  }
  __syncthreads();

  // 4. att = y @ wo; x2 = x + att (y f32 and A9'd under HW; att is f32
  //    there and rounded once on the add's input, as `att.astype(bf16)`)
  if constexpr (HW) {
    float* const ys[1] = {RF};
    a9_tensors<BB, 1>(ys, LS / 2, D, red);
  }
  for (int c = tid; c < D; c += nt) {
    float acc[BB];
    if constexpr (HW)
      dot_col<BB, PLANES>(RF, LS / 2, D, mat[ATT_WO], D, c, acc);
    else
      dot_col<BB, PLANES>(H, LS, D, mat[ATT_WO], D, c, acc);
#pragma unroll
    for (int b = 0; b < BB; ++b)
      X[b * LS + c] = __float2bfloat16_rn(bf2f(X[b * LS + c]) + bf16r(acc[b]));
  }
  __syncthreads();

  // 5. LN2 -> h2 (also the new ffn_x state)
  layernorm_lanes<BB>(X, H, LS, w.vec[LN2_W], w.vec[LN2_B], D,
                      st.out[FFN_X], b0);
  __syncthreads();

  // 6. channel-mix token shifts (A9 under HW)
  for (int i = tid; i < BB * D; i += nt) {
    const int b = i / D, d = i % D;
    const float h = bf2f(H[b * LS + d]);
    const float prev = bf2f(st.in[FFN_X][(size_t)(b0 + b) * D + d]);
    M0[b * LS + d] = mix(h, prev, bf2f(w.vec[FFN_MIX_R][d]));
    M1[b * LS + d] = mix(h, prev, bf2f(w.vec[FFN_MIX_K][d]));
  }
  __syncthreads();
  if constexpr (HW) {
    bf16* const mixes[2] = {M0, M1};
    a9_tensors<BB, 2>(mixes, LS, D, red);
  }

  // 7. kk = relu(mk @ wk)², rr = σ(mr @ wr) (σ_pwl in f32 under HW)
  for (int f = tid; f < F; f += nt) {
    float acc[BB];
    dot_col<BB, PLANES>(M1, LS, D, mat[FFN_WK], F, f, acc);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const float t = fmaxf(bf16r(acc[b]), 0.f);
      KK[b * LS + f] = __float2bfloat16_rn(t * t);
    }
  }
  for (int c = tid; c < D; c += nt) {
    float acc[BB];
    dot_col<BB, PLANES>(M0, LS, D, mat[FFN_WR], D, c, acc);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      if constexpr (HW)
        RF[b * (LS / 2) + c] = sigmoid_pwl(bf16r(acc[b]));
      else
        R[b * LS + c] = __float2bfloat16_rn(sigmoid_bf16(bf16r(acc[b])));
    }
  }
  __syncthreads();

  // 8. x = x2 + rr·(kk @ wv), in place: thread c alone reads and writes
  //    column c of X (and of R) in this phase.  Under HW kk is A9'd first,
  //    and the gated product is A9'd over the tile before the add.
  if constexpr (HW) {
    bf16* const kks[1] = {KK};
    a9_tensors<BB, 1>(kks, LS, F, red);
    for (int c = tid; c < D; c += nt) {
      float acc[BB];
      dot_col<BB, PLANES>(KK, LS, F, mat[FFN_WV], D, c, acc);
#pragma unroll
      for (int b = 0; b < BB; ++b)
        RF[b * (LS / 2) + c] *= bf16r(acc[b]);
    }
    __syncthreads();
    float m[1] = {0.f};
    for (int i = tid; i < BB * D; i += nt)
      m[0] = fmaxf(m[0], fabsf(RF[(i / D) * (LS / 2) + i % D]));
    block_max<1>(m, red);
    const float scale = a9_scale(m[0]);
    for (int i = tid; i < BB * D; i += nt) {
      const int b = i / D, c = i % D;
      const float ffn = bf16r(a9(RF[b * (LS / 2) + c], scale));
      X[b * LS + c] = __float2bfloat16_rn(bf2f(X[b * LS + c]) + ffn);
    }
  } else {
    for (int c = tid; c < D; c += nt) {
      float acc[BB];
      dot_col<BB, PLANES>(KK, LS, F, mat[FFN_WV], D, c, acc);
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        const float ffn = bf16r(bf2f(R[b * LS + c]) * bf16r(acc[b]));
        X[b * LS + c] = __float2bfloat16_rn(bf2f(X[b * LS + c]) + ffn);
      }
    }
  }
}

// Residual rows in: x (B, D) rows b0.. -> X of each lane.
template <int BB, bool HW = false>
__device__ void load_residual(const bf16* x, bf16* smem, int D, int F,
                              int b0) {
  const int LS = lane_stride(D, F, HW);
  for (int i = threadIdx.x; i < BB * D; i += blockDim.x) {
    const int b = i / D, d = i % D;
    smem[b * LS + d] = x[(size_t)(b0 + b) * D + d];
  }
}

// Residual rows out: X of each lane -> x_out (B, D) rows b0..
template <int BB, bool HW = false>
__device__ void store_residual(const bf16* smem, bf16* x_out, int D, int F,
                               int b0) {
  const int LS = lane_stride(D, F, HW);
  for (int i = threadIdx.x; i < BB * D; i += blockDim.x) {
    const int b = i / D, d = i % D;
    x_out[(size_t)(b0 + b) * D + d] = smem[b * LS + d];
  }
}

}  // namespace rwkv4
}  // namespace repro
