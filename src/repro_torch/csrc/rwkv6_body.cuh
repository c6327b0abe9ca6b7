// The RWKV-6 layer decode body, shared by K7-block (rwkv6_block_decode.cu,
// one layer per launch) and K7-model (rwkv6_model_decode.cu, every layer
// in one launch), so that both run the same code and give the same bits.
//
// One call runs models/rwkv6.py:block_decode (exact numerics) for one
// layer and all B <= 8 lanes, spread over the whole card: the kernels are
// cooperative launches of as many blocks as fit at once, and the phases
// below are separated by grid-wide barriers (cooperative_groups).  A
// layer of rwkv6-7b reads 220 MB of W8 codes (440 MB of plain bf16
// weights) and a lane's WKV state is
// 64 x 64 x 64 values, so neither one block (K4's design) nor one SM's
// shared memory can carry it (K3, rwkv4_grid.cuh, spreads its smaller
// layer over the card the same way).
//   1. LN1 -> h (the new att_x), dx = att_x - h, xxx = h + dx·μ_x
//   2. dmix = tanh(xxx @ maa_w1)                      (5·32 columns)
//   3. the five deltas dmix_s @ maa_w2[s] and mixes
//      x_s = h + dx·(μ_s + delta_s), s in (w, k, v, r, g)
//   4. r, k, v = x_s @ W; g = silu(xg @ wg); a = tanh(xw @ td_w1)
//   5. w = exp(-exp(time_decay + a @ td_w2))
//   6. per (lane, head): the WKV-6 step (new wkv_s), GroupNorm, y·g
//   7. x2 = x + (y·g) @ wo
//   8. LN2 -> h2 (the new ffn_x) and the two channel-mix mixes
//   9. rr = σ(mr @ ffn.wr), kk = relu(mk @ ffn.wk)²
//  10. x = x2 + rr·(kk @ ffn.wv)
// Every value the JAX trace holds in bf16 is rounded to bf16 at the same
// place (bf16r): the LN outputs, each op of the mixes, each matvec
// output, tanh, the five delta rows, time_decay + lora, y after the WKV
// step, the GroupNorm output, the silu expansion and y·g, relu², the
// gated products and both residual adds.
//
// Weights: each of the 15 matrices (time_maa_x, time_maa, time_faaaa and
// maa_w2 among them) arrives in its own form (common.cuh: Matrix): a W8,
// W4 or VQ plane (core/quant/serving.py; a mixed policy gives a layer
// several) or plain bf16 weights (a tree that was never packed).  Each is
// decoded in registers with the bits of unpack_leaf: sign·level times the
// column's f32 scale rounded once (W8, W4), the codebook gather (VQ, the
// codebook staged in shared memory per tile), the weight as it is (BF16).
// The element-wise reads of time_maa_x, time_maa and time_faaaa go
// through decode_elem, the plane's policy (common.cuh: Decode).  A W4 leaf must pair rows within a layer: a
// (L, D) leaf that pack_leaf paired across layers is refused by the
// wrappers, as the JAX fused paths cannot take it either.
//
// Matvecs (phases 2-5, 7, 9, 10): out[b][n] = Σ_k in[b][k]·W[k][n] over
// weights decoded in registers.  A work item is a tile of 32·CPT output
// columns of one matrix; its block's 16 warps split K into 16 fixed
// contiguous slices (a W4 matrix's on even rows), each warp's lane
// covering CPT adjacent columns for all 8 lanes, so each code byte is read
// once per step for the whole batch.  The job's plane is read once a
// tile, which then runs that plane's loop.  The 16 partial sums are added
// in warp order.  The inputs live in
// a small scratch the wrapper allocates (about 1.5 MB at rwkv6-7b, so it
// stays in L2), lane-minor ((K, 8) bf16: one 16-byte load gives a row's
// 8 lanes); scratch is read with __ldcg, past the L1, because other
// blocks write it between barriers.
//
// Batch invariance and determinism: every output's K order (slice by
// slice, warp order) depends only on K, every LayerNorm is one warp's per
// lane in a fixed order (recomputed by each block, so no barrier), and
// every GroupNorm is summed in order by each thread of its head: a lane's
// bits do not depend on B, on the grid size or on the other lanes.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace repro {
namespace rwkv6 {

namespace cg = cooperative_groups;

constexpr int kLanes = 8;        // batch lanes one launch carries (B <= 8)
constexpr int kThreads = 512;    // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 128;    // widest matvec tile (CPT = 4)
constexpr int kMaaRank = 32;     // models/rwkv6.py:MAA_RANK
constexpr int kTdRank = 64;      // models/rwkv6.py:TD_RANK
constexpr int kMaxCodebook = 256;  // VQ codebook entries (uint8 indices)
// PLANES of a layer whose matrices' planes are read at run time
constexpr int kPlaneAny = -1;
// dynamic shared memory: two LN stats a lane, then the matvec partials
// (kWarps x kLanes x kMaxTile f32, 64 KB), reused by phase 6, then a VQ
// job's codebook (bf16)
constexpr size_t kPartFloats = (size_t)kWarps * kLanes * kMaxTile;
constexpr size_t kSmemBytes = (2 * kLanes + kPartFloats) * sizeof(float) +
                              kMaxCodebook * sizeof(bf16);

// the layer's bf16 vectors, each (D,)
enum Vec {
  LN1_W, LN1_B, LN2_W, LN2_B, TIME_DECAY, LNX_W, LNX_B, FFN_MIX_R,
  FFN_MIX_K, kNumVecs
};
// the layer's matrices (each a W8, W4 or VQ plane or bf16 weights):
// time_maa_x (D), time_maa (5, D), time_faaaa (H, N), maa_w1 (D, 160),
// maa_w2 (5, 32, D), td_w1 (D, 64), td_w2 (64, D), att.wr/wk/wv/wg/wo and
// ffn.wr (D, D), ffn.wk (D, F), ffn.wv (F, D)
enum Mat {
  TIME_MAA_X, TIME_MAA, TIME_FAAAA, MAA_W1, MAA_W2, TD_W1, TD_W2, ATT_WR,
  ATT_WK, ATT_WV, ATT_WG, ATT_WO, FFN_WR, FFN_WK, FFN_WV, kNumMats
};
// the recurrent state leaves of one layer: att_x, ffn_x (B, D), wkv_s
// (B, H, N, N), all bf16
enum State { ATT_X, FFN_X, WKV_S, kNumState };

struct LayerWeights {
  const bf16* vec[kNumVecs];
  Matrix mat[kNumMats];  // common.cuh: codes, scale or codebook, plane
};

struct LayerState {
  const bf16* in[kNumState];
  bf16* out[kNumState];
};

struct Dims {
  int B, D, F, H, N;
};

// The intermediates of one layer, carved from the wrapper's scratch.
// "8" buffers are lane-minor matvec inputs (K, 8); the others are
// lane-major (8, D).  Lanes >= B are never written (the wrapper zeroes
// the scratch), and their sums are discarded.
struct Scratch {
  bf16 *h8, *dx8, *xxx8, *dmix8, *xs8, *tda8, *y8, *mr8, *mk8, *kk8;
  bf16 *r, *k, *v, *g, *x2, *rr, *xres;
  float* w;
};

// Lays out the scratch from `base` (if s is not null) and returns its size
// in bytes; every buffer is 256-byte aligned.  Host side: the entry points
// pass the carved pointers to the kernel.
inline size_t carve(unsigned char* base, int D, int F, Scratch* s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  const size_t lane_d = (size_t)kLanes * D * sizeof(bf16);
  Scratch t;
  t.h8 = reinterpret_cast<bf16*>(take(lane_d));
  t.dx8 = reinterpret_cast<bf16*>(take(lane_d));
  t.xxx8 = reinterpret_cast<bf16*>(take(lane_d));
  t.dmix8 = reinterpret_cast<bf16*>(
      take((size_t)kLanes * 5 * kMaaRank * sizeof(bf16)));
  t.xs8 = reinterpret_cast<bf16*>(take(5 * lane_d));
  t.tda8 = reinterpret_cast<bf16*>(
      take((size_t)kLanes * kTdRank * sizeof(bf16)));
  t.y8 = reinterpret_cast<bf16*>(take(lane_d));
  t.mr8 = reinterpret_cast<bf16*>(take(lane_d));
  t.mk8 = reinterpret_cast<bf16*>(take(lane_d));
  t.kk8 = reinterpret_cast<bf16*>(take((size_t)kLanes * F * sizeof(bf16)));
  t.r = reinterpret_cast<bf16*>(take(lane_d));
  t.k = reinterpret_cast<bf16*>(take(lane_d));
  t.v = reinterpret_cast<bf16*>(take(lane_d));
  t.g = reinterpret_cast<bf16*>(take(lane_d));
  t.x2 = reinterpret_cast<bf16*>(take(lane_d));
  t.rr = reinterpret_cast<bf16*>(take(lane_d));
  t.xres = reinterpret_cast<bf16*>(take(lane_d));
  t.w = reinterpret_cast<float*>(take((size_t)kLanes * D * sizeof(float)));
  if (s) *s = t;
  return off;
}

__device__ __forceinline__ float ldf(const bf16* p) {
  return bf2f(__ldcg(p));
}

// One matvec of a phase: matrix m (K, N), lane-minor input (K, 8) in
// scratch.
struct Job {
  Matrix m;
  const bf16* in8;
  int K, N;
};

template <int CPT>
__device__ __forceinline__ uint32_t load_codes(const uint8_t* p) {
  if (CPT == 4) return __ldg(reinterpret_cast<const unsigned int*>(p));
  if (CPT == 2) return __ldg(reinterpret_cast<const unsigned short*>(p));
  return __ldg(p);
}

// The 8 lanes of one lane-minor input row.
__device__ __forceinline__ void lanes_of(const uint4* row, float (&x)[kLanes]) {
  const uint4 xv = __ldcg(row);
  const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = bf16_lo(xw[i]);
    x[2 * i + 1] = bf16_hi(xw[i]);
  }
}

// A lane's sums over its warp's K slice for the CPT columns n0.. of j
// (n0 < N), for all 8 lanes, k ascending.  The 16 slices are cut from K
// alone; a W4 matrix's on even rows, its bytes pairing rows 2i and 2i+1
// (low, high nibble), so one load of CPT bytes gives CPT columns of two
// rows, summed row 2i first.  A W8 or VQ row is one load of CPT code
// bytes, a BF16 row of 2·CPT bytes of weights.  bf16 x times a bf16-exact
// weight is exact in f32, so each fma rounds once, as a separate multiply
// and add would.
template <int CPT, int PLANE>
__device__ __forceinline__ void slice_sums(const Job& j, int n0, int warp,
                                           const bf16* cb,
                                           float (&acc)[kLanes][CPT]) {
  const int K = j.K, N = j.N;
  constexpr int P = PLANE == kPlaneW4 ? 2 : 1;  // rows a slice unit holds
  const int k0 = P * (int)((long long)(K / P) * warp / kWarps);
  const int k1 = P * (int)((long long)(K / P) * (warp + 1) / kWarps);
  float sc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) sc[c] = Decode<PLANE>::col(j.m, n0 + c);
  const uint4* xp = reinterpret_cast<const uint4*>(j.in8);
  if constexpr (PLANE == kPlaneW4) {
    const uint8_t* wp = j.m.codes + n0;
#pragma unroll 2
    for (int k = k0; k < k1; k += 2) {
      const uint32_t word = load_codes<CPT>(wp + (size_t)(k >> 1) * N);
      float x0[kLanes], x1[kLanes];
      lanes_of(xp + k, x0);
      lanes_of(xp + k + 1, x1);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const uint32_t byte = (word >> (8 * c)) & 0xffu;
        const float w0 = dpot_w4_decode(byte, 0, sc[c]);
        const float w1 = dpot_w4_decode(byte, 1, sc[c]);
#pragma unroll
        for (int b = 0; b < kLanes; ++b) {
          acc[b][c] = fmaf(x0[b], w0, acc[b][c]);
          acc[b][c] = fmaf(x1[b], w1, acc[b][c]);
        }
      }
    }
  } else {
    // BF16: 2·CPT bytes a row, read as CPT (<= 4) bf16 halves of h
    const uint8_t* wp =
        j.m.codes + (PLANE == kPlaneBF16 ? 2 * n0 : n0);
    const size_t row = PLANE == kPlaneBF16 ? 2 * (size_t)N : (size_t)N;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      uint32_t h[2] = {0u, 0u};
      if constexpr (PLANE == kPlaneBF16 && CPT == 4) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(wp + k * row));
        h[0] = v.x;
        h[1] = v.y;
      } else if constexpr (PLANE == kPlaneBF16 && CPT == 2) {
        h[0] = __ldg(reinterpret_cast<const unsigned int*>(wp + k * row));
      } else if constexpr (PLANE == kPlaneBF16) {
        h[0] = __ldg(reinterpret_cast<const unsigned short*>(wp + k * row));
      } else {
        h[0] = load_codes<CPT>(wp + k * row);
      }
      float x[kLanes];
      lanes_of(xp + k, x);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float wv;
        if constexpr (PLANE == kPlaneBF16) {
          wv = c & 1 ? bf16_hi(h[c >> 1]) : bf16_lo(h[c >> 1]);
        } else {
          const uint32_t byte = (h[0] >> (8 * c)) & 0xffu;
          wv = PLANE == kPlaneVQ ? vq_decode(byte, cb)
                                 : dpot_w8_decode(byte, sc[c]);
        }
#pragma unroll
        for (int b = 0; b < kLanes; ++b) acc[b][c] = fmaf(x[b], wv, acc[b][c]);
      }
    }
  }
}

// One tile of 32·CPT columns of job j: epi(b, n, sum) for every lane
// b < B and column n < N of the tile, the 16 slices' sums added in warp
// order.  PLANES is the layer's form: kPlaneW8 (every matrix W8: that
// loop alone is compiled), or kPlaneAny: the job's plane is read once a
// tile, which then runs that plane's loop, a VQ job's codebook staged in
// shared memory (cb) first.  part: kWarps·kLanes·32·CPT
// f32; cb: kMaxCodebook bf16.
template <int CPT, int PLANES, class Epi>
__device__ void matvec_tile(const Job& j, int tile, float* part, bf16* cb,
                            int B, Epi epi) {
  constexpr int TN = 32 * CPT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = tile * TN + lane * CPT;
  const int N = j.N;
  if constexpr (PLANES == kPlaneAny) {
    if (j.m.plane == kPlaneVQ) {
      const bf16* src = static_cast<const bf16*>(j.m.aux);
      for (int i = threadIdx.x; i < j.m.aux_len; i += kThreads) cb[i] = src[i];
      __syncthreads();
    }
  }
  float acc[kLanes][CPT];
#pragma unroll
  for (int b = 0; b < kLanes; ++b)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[b][c] = 0.f;
  if (n0 < N) {  // N % CPT == 0: a lane's columns are all in or all out
    if constexpr (PLANES == kPlaneAny) {
      switch (j.m.plane) {
        case kPlaneW4: slice_sums<CPT, kPlaneW4>(j, n0, warp, cb, acc); break;
        case kPlaneVQ: slice_sums<CPT, kPlaneVQ>(j, n0, warp, cb, acc); break;
        case kPlaneBF16:
          slice_sums<CPT, kPlaneBF16>(j, n0, warp, cb, acc);
          break;
        default: slice_sums<CPT, kPlaneW8>(j, n0, warp, cb, acc);
      }
    } else {
      slice_sums<CPT, PLANES>(j, n0, warp, cb, acc);
    }
  }
#pragma unroll
  for (int b = 0; b < kLanes; ++b)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      part[(warp * kLanes + b) * TN + lane * CPT + c] = acc[b][c];
  __syncthreads();
  for (int o = threadIdx.x; o < kLanes * TN; o += kThreads) {
    const int b = o / TN, col = o % TN, n = tile * TN + col;
    if (b < B && n < N) {
      float s = part[b * TN + col];
      for (int w = 1; w < kWarps; ++w) s += part[(w * kLanes + b) * TN + col];
      epi(b, n, s);
    }
  }
  __syncthreads();  // part and cb are free for the next tile
}

// Element (r, n) of an (R, N) matrix of a layer of form PLANES, by the
// plane's policy; under kPlaneAny the plane is read from m (uniform across
// m, so the branch does not diverge).
template <int PLANES>
__device__ __forceinline__ float decode_elem(const Matrix& m, int r, int n,
                                             int N) {
  if constexpr (PLANES != kPlaneAny) {
    return Decode<PLANES>::at(m, r, n, N, Decode<PLANES>::col(m, n));
  } else {
    switch (m.plane) {
      case kPlaneW4: return decode_elem<kPlaneW4>(m, r, n, N);
      case kPlaneVQ: return decode_elem<kPlaneVQ>(m, r, n, N);
      case kPlaneBF16: return decode_elem<kPlaneBF16>(m, r, n, N);
      default: return decode_elem<kPlaneW8>(m, r, n, N);
    }
  }
}

// m from contraction row r on (r even for W4, whose bytes pair rows).
__device__ __forceinline__ Matrix rows_from(const Matrix& m, int r, int N) {
  const size_t n = (size_t)r * N;
  Matrix o = m;
  o.codes += m.plane == kPlaneW4 ? n / 2 : m.plane == kPlaneBF16 ? 2 * n : n;
  return o;
}

// Every tile of `jobs` over the grid: epi(job index, b, n, sum).
template <int CPT, int PLANES, int NJ, class Epi>
__device__ void matvec_phase(const Job (&jobs)[NJ], float* part, bf16* cb,
                             int B, Epi epi) {
  constexpr int TN = 32 * CPT;
  int total = 0;
#pragma unroll
  for (int i = 0; i < NJ; ++i) total += (jobs[i].N + TN - 1) / TN;
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    int i = 0, t = item;
    while (t >= (jobs[i].N + TN - 1) / TN) {
      t -= (jobs[i].N + TN - 1) / TN;
      ++i;
    }
    matvec_tile<CPT, PLANES>(jobs[i], t, part, cb, B,
                     [&](int b, int n, float s) { epi(i, b, n, s); });
  }
}

// LayerNorm statistics of each lane's row of x (B rows of D, lane-major):
// mu[b] and rs[b] = rsqrt(E[x²] - mu² + 1e-5), the single-pass form of
// models/layers.py:apply_norm.  One warp per lane, a fixed order, so every
// block computes the same bits.
__device__ inline void ln_stats(const bf16* x, int B, int D, float* mu, float* rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < B) {
    const bf16* row = x + (size_t)warp * D;
    float s = 0.f, s2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = ldf(row + d);
      s += v;
      s2 += v * v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      const float m = s / (float)D;
      mu[warp] = m;
      rs[warp] = rsqrtf(s2 / (float)D - m * m + 1e-5f);
    }
  }
  __syncthreads();
}

// One layer for all B lanes, every block of the cooperative grid taking
// part; xin (B, D) residual in, xout (B, D) out (xout may be xin).  PLANES
// is the layer's form (planes_of).  Ends without a grid barrier: the
// caller syncs before reading xout.
template <int PLANES>
__device__ void layer(const LayerWeights& w, const LayerState& st,
                      const Dims& dm, const Scratch& s, const bf16* xin,
                      bf16* xout, float* smem) {
  cg::grid_group grid = cg::this_grid();
  const int B = dm.B, D = dm.D, F = dm.F, H = dm.H, N = dm.N;
  float* mu = smem;
  float* rs = smem + kLanes;
  float* part = smem + 2 * kLanes;
  bf16* cb = reinterpret_cast<bf16*>(part + kPartFloats);
  const Matrix* mat = w.mat;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gsz = gridDim.x * blockDim.x;
  const bf16* const* vec = w.vec;

  // 1. LN1 -> h (the new att_x); dx = att_x - h; xxx = h + dx·μ_x
  ln_stats(xin, B, D, mu, rs);
  for (int i = gtid; i < D * kLanes; i += gsz) {
    const int d = i / kLanes, b = i % kLanes;
    if (b >= B) continue;
    const size_t bd = (size_t)b * D + d;
    const float h = bf16r((ldf(xin + bd) - mu[b]) * rs[b] *
                              bf2f(vec[LN1_W][d]) + bf2f(vec[LN1_B][d]));
    st.out[ATT_X][bd] = __float2bfloat16_rn(h);
    const float dx = bf16r(bf2f(st.in[ATT_X][bd]) - h);
    const float mx = decode_elem<PLANES>(mat[TIME_MAA_X], 0, d, D);
    s.h8[i] = __float2bfloat16_rn(h);
    s.dx8[i] = __float2bfloat16_rn(dx);
    s.xxx8[i] = __float2bfloat16_rn(h + bf16r(dx * mx));
  }
  grid.sync();

  // 2. dmix = tanh(xxx @ maa_w1), (5·32) columns
  {
    const Job jobs[1] = {{mat[MAA_W1], s.xxx8, D, 5 * kMaaRank}};
    matvec_phase<1, PLANES>(jobs, part, cb, B,
                            [&](int, int b, int n, float a) {
      s.dmix8[n * kLanes + b] = __float2bfloat16_rn(tanhf(bf16r(a)));
    });
  }
  grid.sync();

  // 3. delta_s = dmix_s @ maa_w2[s]; μ_s = time_maa[s] + delta_s;
  //    x_s = h + dx·μ_s, for s in (w, k, v, r, g)
  {
    Job jobs[5];
#pragma unroll
    for (int i = 0; i < 5; ++i)
      jobs[i] = {rows_from(mat[MAA_W2], i * kMaaRank, D),
                 s.dmix8 + i * kMaaRank * kLanes, kMaaRank, D};
    matvec_phase<4, PLANES>(jobs, part, cb, B,
                            [&](int i, int b, int d, float a) {
      const float tm = decode_elem<PLANES>(mat[TIME_MAA], i, d, D);
      const float m = bf16r(tm + bf16r(a));
      const int e = d * kLanes + b;
      s.xs8[(size_t)i * D * kLanes + e] =
          __float2bfloat16_rn(ldf(s.h8 + e) + bf16r(ldf(s.dx8 + e) * m));
    });
  }
  grid.sync();

  // 4. r, k, v; g = silu(xg @ wg); a = tanh(xw @ td_w1)
  {
    const size_t xs = (size_t)D * kLanes;
    const Job jobs[5] = {
        {mat[ATT_WR], s.xs8 + 3 * xs, D, D},
        {mat[ATT_WK], s.xs8 + 1 * xs, D, D},
        {mat[ATT_WV], s.xs8 + 2 * xs, D, D},
        {mat[ATT_WG], s.xs8 + 4 * xs, D, D},
        {mat[TD_W1], s.xs8, D, kTdRank}};
    matvec_phase<4, PLANES>(jobs, part, cb, B,
                            [&](int i, int b, int n, float a) {
      const float t = bf16r(a);
      const size_t bn = (size_t)b * D + n;
      if (i == 0) s.r[bn] = __float2bfloat16_rn(t);
      else if (i == 1) s.k[bn] = __float2bfloat16_rn(t);
      else if (i == 2) s.v[bn] = __float2bfloat16_rn(t);
      else if (i == 3) s.g[bn] = __float2bfloat16_rn(t * sigmoid_bf16(t));
      else s.tda8[n * kLanes + b] = __float2bfloat16_rn(tanhf(t));
    });
  }
  grid.sync();

  // 5. w = exp(-exp(time_decay + a @ td_w2)), f32
  {
    const Job jobs[1] = {{mat[TD_W2], s.tda8, kTdRank, D}};
    matvec_phase<1, PLANES>(jobs, part, cb, B,
                            [&](int, int b, int d, float a) {
      const float dd = bf16r(bf2f(vec[TIME_DECAY][d]) + bf16r(a));
      s.w[(size_t)b * D + d] = expf(-expf(dd));
    });
  }
  grid.sync();

  // 6. per (lane, head): the WKV-6 step, GroupNorm over the head, y·g.
  //    A group of N threads per head, thread m owning column m.
  {
    const int G = kThreads / N;
    const int gi = threadIdx.x / N, m = threadIdx.x % N;
    float* R = part;
    float* Kh = R + kThreads;
    float* W = Kh + kThreads;
    float* U = W + kThreads;
    float* Y = U + kThreads;
    const int o = gi * N;
    for (int base = blockIdx.x * G; base < B * H; base += gridDim.x * G) {
      const int item = base + gi;
      const bool live = gi < G && item < B * H;
      const int b = live ? item / H : 0, h = live ? item % H : 0;
      const int d = h * N + m;
      const size_t bd = (size_t)b * D + d;
      if (live) {
        R[o + m] = ldf(s.r + bd);
        Kh[o + m] = ldf(s.k + bd);
        W[o + m] = __ldcg(s.w + bd);
        U[o + m] = decode_elem<PLANES>(mat[TIME_FAAAA], h, m, N);
      }
      __syncthreads();
      if (live) {
        const float vm = ldf(s.v + bd);
        const size_t so = (size_t)(b * H + h) * N * N + m;
        const bf16* Sin = st.in[WKV_S] + so;
        bf16* Sout = st.out[WKV_S] + so;
        float y = 0.f;
        for (int n = 0; n < N; ++n) {
          float ns;
          y = y + wkv6_term(bf2f(Sin[(size_t)n * N]), R[o + n], Kh[o + n], vm,
                            U[o + n], W[o + n], &ns);
          Sout[(size_t)n * N] = __float2bfloat16_rn(ns);
        }
        Y[o + m] = bf16r(y);
      }
      __syncthreads();
      if (live) {
        float sum = 0.f;
        for (int n = 0; n < N; ++n) sum += Y[o + n];
        const float mean = sum / (float)N;
        float sq = 0.f;
        for (int n = 0; n < N; ++n) {
          const float c = Y[o + n] - mean;
          sq += c * c;
        }
        const float r = rsqrtf(sq / (float)N + 64e-5f);
        const float gn = bf16r((Y[o + m] - mean) * r * bf2f(vec[LNX_W][d]) +
                               bf2f(vec[LNX_B][d]));
        s.y8[d * kLanes + b] = __float2bfloat16_rn(gn * ldf(s.g + bd));
      }
      __syncthreads();
    }
  }
  grid.sync();

  // 7. x2 = x + (y·g) @ wo
  {
    const Job jobs[1] = {{mat[ATT_WO], s.y8, D, D}};
    matvec_phase<1, PLANES>(jobs, part, cb, B,
                            [&](int, int b, int d, float a) {
      const size_t bd = (size_t)b * D + d;
      s.x2[bd] = __float2bfloat16_rn(ldf(xin + bd) + bf16r(a));
    });
  }
  grid.sync();

  // 8. LN2 -> h2 (the new ffn_x); the channel-mix token shifts
  ln_stats(s.x2, B, D, mu, rs);
  for (int i = gtid; i < D * kLanes; i += gsz) {
    const int d = i / kLanes, b = i % kLanes;
    if (b >= B) continue;
    const size_t bd = (size_t)b * D + d;
    const float h2 = bf16r((ldf(s.x2 + bd) - mu[b]) * rs[b] *
                               bf2f(vec[LN2_W][d]) + bf2f(vec[LN2_B][d]));
    st.out[FFN_X][bd] = __float2bfloat16_rn(h2);
    const float prev = bf2f(st.in[FFN_X][bd]);
    s.mr8[i] = mix(h2, prev, bf2f(vec[FFN_MIX_R][d]));
    s.mk8[i] = mix(h2, prev, bf2f(vec[FFN_MIX_K][d]));
  }
  grid.sync();

  // 9. rr = σ(mr @ ffn.wr); kk = relu(mk @ ffn.wk)²
  {
    const Job jobs[2] = {{mat[FFN_WR], s.mr8, D, D},
                         {mat[FFN_WK], s.mk8, D, F}};
    matvec_phase<4, PLANES>(jobs, part, cb, B,
                            [&](int i, int b, int n, float a) {
      const float t = bf16r(a);
      if (i == 0) {
        s.rr[(size_t)b * D + n] = __float2bfloat16_rn(sigmoid_bf16(t));
      } else {
        const float q = fmaxf(t, 0.f);
        s.kk8[(size_t)n * kLanes + b] = __float2bfloat16_rn(q * q);
      }
    });
  }
  grid.sync();

  // 10. x = x2 + rr·(kk @ ffn.wv)
  {
    const Job jobs[1] = {{mat[FFN_WV], s.kk8, F, D}};
    matvec_phase<1, PLANES>(jobs, part, cb, B,
                            [&](int, int b, int d, float a) {
      const size_t bd = (size_t)b * D + d;
      const float ffn = bf16r(ldf(s.rr + bd) * bf16r(a));
      xout[bd] = __float2bfloat16_rn(ldf(s.x2 + bd) + ffn);
    });
  }
}

// Host side: whether a matrix's plane and codebook length are ones the
// body takes.
inline bool valid_matrix(int plane, int aux_len) {
  if (plane == kPlaneVQ) return 1 <= aux_len && aux_len <= kMaxCodebook;
  return plane == kPlaneW8 || plane == kPlaneW4 || plane == kPlaneBF16;
}

// Host side: the PLANES a layer with these 15 matrix planes is compiled
// for: kPlaneW8 when every matrix is W8 (that loop alone, the code a W8
// layer ran before the other forms came), else kPlaneAny.
inline int planes_of(const int* planes) {
  for (int m = 0; m < kNumMats; ++m)
    if (planes[m] != kPlaneW8) return kPlaneAny;
  return kPlaneW8;
}

// Host side: the largest cooperative grid of `kernel` on the current
// device (0 when the device has no cooperative launch), and the launch.
template <class Kernel>
inline int max_grid(Kernel kernel, int* coop, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, kSmemBytes);
  *blocks = *coop ? per_sm * sms : 0;
  return static_cast<int>(e);
}

template <class Kernel, class Args>
inline int launch(Kernel kernel, const Args& a, int grid, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* params[] = {const_cast<Args*>(&a)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                  dim3(kThreads), params, kSmemBytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rwkv6
}  // namespace repro
