// The RWKV-4 layer decode body, shared by K3 (rwkv4_block_decode.cu, one
// layer per launch) and K4 (rwkv4_model_decode.cu, every layer in one
// launch), so that both run the same code and give the same bits.
//
// One call runs models/rwkv4.py:block_decode (exact numerics) for one
// layer and one tile of BB batch lanes:
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
// The residual x lives in shared memory in bf16 (X below): it enters
// there and the body leaves the layer's output there, in place.  K3
// copies it to device memory after one layer; K4 keeps it for the next.
//
// Each matrix arrives as a descriptor {codes, scale or codebook, plane}
// (W8, W4 or VQ, core/quant/serving.py).  The plane is uniform across a
// matrix, so its branch costs no divergence.  The body is a template on
// PLANES: kPlaneW8 when every matrix of the layer is W8 (the W8 loop
// alone is compiled, as before the planes came), kPlaneAny otherwise
// (each matrix's plane is read at run time).  Both compute the same bits.
//
// Batch invariance: each LayerNorm reduction belongs to one warp in a
// fixed order, and each matvec output accumulates over k = 0..K-1 in
// order, whatever bb or the tile a lane falls in.
#pragma once

#include "common.cuh"

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

struct Matrix {
  const uint8_t* codes;  // W8, VQ: (K, N); W4: (K/2, N)
  const void* aux;       // W8, W4: f32 scale (N,); VQ: bf16 codebook (C,)
  int plane;             // kPlaneW8 | kPlaneW4 | kPlaneVQ
};

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

// PLANES of a layer whose matrices' planes are read at run time
constexpr int kPlaneAny = -1;

// acc[b] = Σ_k in[b][k] · decode(w[k][col]) over k = 0..K-1 in order (K
// even); PLANES is m's plane, or kPlaneAny to read it from m.
template <int BB, int PLANES>
__device__ __forceinline__ void dot_col(const bf16* in, int lane_stride, int K,
                                        const Matrix& m, int N, int col,
                                        float (&acc)[BB]) {
#pragma unroll
  for (int b = 0; b < BB; ++b) acc[b] = 0.f;
  const uint8_t* __restrict__ wp = m.codes + col;
  const int plane = PLANES == kPlaneAny ? m.plane : PLANES;
  if (plane == kPlaneVQ) {
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

// LayerNorm of each lane's row src (bf16, D) into dst and into the global
// state output row; one warp per lane, fixed reduction order.
template <int BB>
__device__ void layernorm_lanes(const bf16* src, bf16* dst, int lane_stride,
                                const bf16* g, const bf16* beta, int D,
                                bf16* gout, int b0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int b = warp; b < BB; b += nwarps) {
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
    bf16* gr = gout + (size_t)(b0 + b) * D;
    for (int d = lane; d < D; d += 32) {
      const float v = (bf2f(row[d]) - mu) * rs * bf2f(g[d]) + bf2f(beta[d]);
      const bf16 h = __float2bfloat16_rn(v);
      out[d] = h;
      gr[d] = h;
    }
  }
}

// The PLANES a layer with these 7 matrix planes is compiled for.
inline int planes_of(const int* planes) {
  for (int m = 0; m < kNumMats; ++m)
    if (planes[m] != kPlaneW8) return kPlaneAny;
  return kPlaneW8;
}

// Shared memory a block needs for BB lanes: each lane's intermediates as
// bf16, (6·D + F)·2 bytes a lane.
__host__ __device__ inline size_t smem_bytes(int bb, int D, int F) {
  return (size_t)bb * (6 * D + F) * sizeof(bf16);
}

// One layer for the BB lanes b0..b0+BB-1.  smem holds BB lanes of
// (6·D + F) bf16 each; X (the first D of each lane) carries the residual
// in and the layer's output out.  Ends without a barrier: the caller
// synchronises before reading X.
template <int BB, int PLANES>
__device__ void layer(const LayerWeights& w, const LayerState& st,
                      bf16* smem, int D, int F, int b0) {
  const int LS = 6 * D + F;  // lane stride in shared memory
  bf16* X = smem;            // residual x, then x2, then the output
  bf16* H = smem + D;        // h, then y = σ(r)·wkv, then h2
  bf16* M0 = smem + 2 * D;   // mixes: r / k / v, then ffn r / k
  bf16* M1 = smem + 3 * D;
  bf16* M2 = smem + 4 * D;
  bf16* R = smem + 5 * D;    // σ(ffn r)
  bf16* KK = smem + 6 * D;   // relu²(ffn k), F wide
  const int tid = threadIdx.x, nt = blockDim.x;
  const Matrix* mat = w.mat;

  // 1. LN1 -> h (also the new att_x state)
  layernorm_lanes<BB>(X, H, LS, w.vec[LN1_W], w.vec[LN1_B], D,
                      st.out[ATT_X], b0);
  __syncthreads();

  // 2. time-mix token shifts
  for (int i = tid; i < BB * D; i += nt) {
    const int b = i / D, d = i % D;
    const float h = bf2f(H[b * LS + d]);
    const float prev = bf2f(st.in[ATT_X][(size_t)(b0 + b) * D + d]);
    M0[b * LS + d] = mix(h, prev, bf2f(w.vec[ATT_MIX_R][d]));
    M1[b * LS + d] = mix(h, prev, bf2f(w.vec[ATT_MIX_K][d]));
    M2[b * LS + d] = mix(h, prev, bf2f(w.vec[ATT_MIX_V][d]));
  }
  __syncthreads();

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
      const float out = wkv4_step(
          bf2f(st.in[WKV_A][g]), bf2f(st.in[WKV_B][g]), bf2f(st.in[WKV_O][g]),
          bf16r(ak[b]), bf16r(av[b]), wd, u, &na, &nb, &no);
      st.out[WKV_A][g] = __float2bfloat16_rn(na);
      st.out[WKV_B][g] = __float2bfloat16_rn(nb);
      st.out[WKV_O][g] = __float2bfloat16_rn(no);
      const float sr = sigmoid_bf16(bf16r(ar[b]));
      H[b * LS + c] = __float2bfloat16_rn(sr * bf16r(out));
    }
  }
  __syncthreads();

  // 4. att = y @ wo; x2 = x + att
  for (int c = tid; c < D; c += nt) {
    float acc[BB];
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

  // 6. channel-mix token shifts
  for (int i = tid; i < BB * D; i += nt) {
    const int b = i / D, d = i % D;
    const float h = bf2f(H[b * LS + d]);
    const float prev = bf2f(st.in[FFN_X][(size_t)(b0 + b) * D + d]);
    M0[b * LS + d] = mix(h, prev, bf2f(w.vec[FFN_MIX_R][d]));
    M1[b * LS + d] = mix(h, prev, bf2f(w.vec[FFN_MIX_K][d]));
  }
  __syncthreads();

  // 7. kk = relu(mk @ wk)², rr = σ(mr @ wr)
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
    for (int b = 0; b < BB; ++b)
      R[b * LS + c] = __float2bfloat16_rn(sigmoid_bf16(bf16r(acc[b])));
  }
  __syncthreads();

  // 8. x = x2 + rr·(kk @ wv), in place: thread c alone reads and writes
  //    column c of X in this phase
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

// Residual rows in: x (B, D) rows b0.. -> X of each lane.
template <int BB>
__device__ void load_residual(const bf16* x, bf16* smem, int D, int F,
                              int b0) {
  const int LS = 6 * D + F;
  for (int i = threadIdx.x; i < BB * D; i += blockDim.x) {
    const int b = i / D, d = i % D;
    smem[b * LS + d] = x[(size_t)(b0 + b) * D + d];
  }
}

// Residual rows out: X of each lane -> x_out (B, D) rows b0..
template <int BB>
__device__ void store_residual(const bf16* smem, bf16* x_out, int D, int F,
                               int b0) {
  const int LS = 6 * D + F;
  for (int i = threadIdx.x; i < BB * D; i += blockDim.x) {
    const int b = i / D, d = i % D;
    x_out[(size_t)(b0 + b) * D + d] = smem[b * LS + d];
  }
}

}  // namespace rwkv4
}  // namespace repro
