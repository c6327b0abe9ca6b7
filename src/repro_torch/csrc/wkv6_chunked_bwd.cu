// K10-bwd: the gradients of the chunked RWKV-6 WKV (K10) with respect to r,
// k, v, w and u.
//
// No TPU kernel: the JAX package lets XLA differentiate wkv6_chunked
// (core/wkv/wkv6.py:58).  This is the backward of K10 as the whole-sequence
// forward calls it (models/rwkv6.py:_time_mix_seq): an initial state that
// takes no gradient (the forward's is zero), the final state carrying none.
// kernels/wkv6.py:wkv6_chunked_bwd_plain runs the same function in torch
// ops, one level of chunks; tests/test_torch_k10_bwd_plan.py:
// wkv6_chunked_bwd_twin transcribes this source's passes.
//
// The forward, per chunk g of C tokens from the state S = S_(g-1) (N x N,
// rows n the key channels, columns m the value channels), per column n with
// l = log max(w, 1e-38), L its inclusive cumsum over the chunk, Lp = L - l
// and Ltot = L[C-1]:
//   y_t = (r_t e^Lp_t) S + Σ_(i<t) A[t,i] v_i + (Σ_n r_t u k_t) v_t,
//         A[t,i] = Σ_n r_tn k_in E[t,i,n],  E[t,i,n] = e^(Lp_tn - L_in)
//   S_g = e^Ltot ⊙rows S + Σ_i (k_i e^(Ltot - L_i)) ⊗ v_i.
// For dy and G = dS_g (zero after the last chunk), with VD[t,i] = v_i·dy_t:
//   dS_(g-1) = e^Ltot ⊙rows G + (r e^Lp)ᵀ dy            (a reverse chain)
//   dr_t = e^Lp_t (S dy_t) + Σ_(i<t) k_i E[t,i] VD[t,i] + u k_t VD[t,t]
//   dk_i = Σ_(t>i) r_t E[t,i] VD[t,i] + e^(Ltot - L_i) (G v_i)
//          + u r_i VD[i,i]
//   dv_i = Σ_(t>i) A[t,i] dy_t + Gᵀ (k_i e^(Ltot - L_i)) + (Σ r_i u k_i) dy_i
//   du   = Σ over the chunks and the batch of Σ_t r_t k_t VD[t,t]
//   dw_s = dl_s / w_s where w_s >= 1e-38 (torch's clamp gradient), else 0.
// dl_s has a reverse-cumsum form, Σ_(t>s) P_t - Σ_(i>=s) K_i + Z, but its
// two sums cancel: where w_s is small every term that survives carries the
// factor w_s, and the O(1) sums that cancel leave f32 noise, which / w_s
// turns into garbage (XLA's autodiff of wkv6_chunked reads 1e8 off
// wkv6_scan's dw at w ~ 1e-27: tests/test_torch_wkv6_bwd.py).  The kernel
// takes dw directly, with the factor w_s divided out of each term: with
// S_(s-1) the chunk's running state before position s (S_(-1) = S),
//   dw_s = Σ_(t>s) r_t e^(Lp_t - L_s) X_s[t] + e^(Ltot - L_s) Y_s,
//   X_s[t] = (S_(s-1) dy_t)_n,  Y_s = rowsum(S_(s-1) ⊙ G)_n,
// walked forward in s: X_(s+1)[t] = w_s X_s[t] + k_s VD[t,s], Y_(s+1) =
// w_s Y_s + k_s (G v_s) (w_s = e^(l_s)), no term cancelling another and no
// exponent above 0.
//
// r, k, v (B,T,H,N) bf16 or f32 (one type), w f32 or bf16, u (H,N) f32, dy
// (B,T,H,N) f32 and K10's workspace (S_(g-1) and e^Ltot_g of every chunk,
// which the forward's launch B left there) -> dr, dk, dv in r's type, dw
// in w's (each rounded once from f32), du (H,N) f32.  N in {16, 32, 64};
// C <= 64 divides T.
//
// Design, four launches on the caller's stream (chunks g-major, as K10's;
// the plan's owner is plan_of below, kernels/wkv6.py:k10_bwd_plan its twin):
//   1  state_grad_kernel  a block a chunk: (r e^Lp)ᵀ dy on the tensor cores.
//   2  grad_scan_kernel   a thread a (b, h, n, m) chain over g from the
//                         last, eight chunks' loads ahead: writes G_g over
//                         chunk g's product in place, then G <- e^Ltot_g G
//                         + product.
//   3  chunk_grad_kernel  a block of 256 a chunk: every product on the
//                         tensor cores, the diagonal pairs and the dw walk
//                         on the CUDA cores (below).
//   4  du_sum_kernel      a thread a (h, n): the partials over (g, b) in
//                         order (wkv6_common.cuh).
// No atomics: the same bits every run.
//
// Decays.  e^l = max(w, 1e-38) exactly (l = log max(w, 1e-38)), so every
// decay e^(L_t - L_s), t >= s, is the product of the e^l between: <= 1,
// no exponent at all.  Launches 1 and 3 take them as running products.
//
// Launch 3: sub-chunks (JAX's two-level form, K10's launch C).  The chunk
// is padded to Cp = 16·nsub rows (rows >= C: r = k = v = dy = 0, w = 1,
// which moves no kept output) and cut into sub-chunks b of 16.  Per
// sub-chunk and column, D'_t = e^(Lp_t - Lst_b), the product of the
// sub-chunk's e^l before t, decays row t from its sub-chunk's start;
// D''_s = e^(Lend_b - L_s), of those after s, key s to its sub-chunk's
// end; e^(T_b) is all 16, and the running products e^Lb_b and c(a, b) =
// e^(Lb_a - Lb_(b+1)) span the sub-chunks between.  With R' = r D' and
// K'' = k D'' (shared tiles), K'_a = K'' c(a, sub j) (keys j < 16a: k_j
// e^(Lb_a - L_j)), R''_b = R' c(sub t, b) (rows past b: r_t e^(Lp_t -
// Lb_(b+1))) and E_b = c(nsub, b), a pair across sub-chunks factors
// through a boundary between them, and the function becomes:
//   VD = dy vᵀ (the blocks at and below the diagonal), SD = dy Sᵀ,
//   σ_a = Σ_(t in a) R' SD;
//   XI_a = e^(Lb_a) SD_a + VD[a, <a] K'_a, the walk's X at the sub-chunk's
//     start; dr_t = D'_t XI_t + (diagonal pairs) + u k_t VD[t,t];
//   P̃_b = E_b ⊙ (v Gᵀ) + VD[>b, <=b]ᵀ R''_b over the keys up to b's end
//     (v Gᵀ taken once a row block, shared by every b);
//     dk_s = D''_s P̃_b[s] + (diagonal pairs) + u r_s VD[s,s] for s in b;
//   Q̃_b = e^(Lb_b) (Σ_(a>b) c(a, b) σ_a + E_b rowsum(S ⊙ G))
//         + Σ_(s<16b) K'_b[s] P̃_b[s]:
//     Σ_(t past b) r_t e^(Lp_t - L_s) X_s[t] + e^(Ltot - L_s) Y_s =
//     D''_s Q̃_b(s) for s in b, Q̃_b(s+1) = w_s Q̃_b(s) + k_s P̃_b[s]: the
//     walk's rows past the sub-chunk, gathered into one chain a column;
//   A[a, bb < a] = R'_a K'_aᵀ; dv = (K'' E_b) G + Aᵀ dy + bonus dy.
// The diagonal pairs (t > s, one sub-chunk) keep their exact decay E[t,s]
// = e^(Lp_t - L_s), the product of the pair's own e^l, one multiply a
// pair, on the CUDA cores, in the walk of each (n, sub-chunk) thread; step
// s takes column s (rows t > s, E walked up from 1: r_t E X[t] to dw_s,
// r_t E VD[t,s] to dk_s, r_t k_s E to A[t,s], X's step; E ends at D''_s)
// and row s (keys i < s, E walked down from 1: k_i E VD[s,i] to dr_s).
// Each pair's decay serves dr, dk, A and the walk; A's sums over n run by
// warp shuffles in a fixed order (a reduce-scatter of the step's slots,
// the zeros skipped), the two halves of the columns added in order after.
//
// Products.  mma.sync m16n8k16 with f32 accumulators, as K10: an f32
// operand goes in as bf16 pieces, three (common.cuh:split_bf16x3, exact)
// for f32 r, k, v and two (common.cuh:c_to_a_pieces' rounded split, |x -
// x0 - x1| <= 2^-17 |x|) for bf16 r, k, v, whose gradients round to bf16;
// a bf16 v goes in as itself.  The piece products a_i b_j with i + j below
// the pieces' count run, a_0 b_0 in its own accumulator and the rest in a
// second, added once.  Phases, the block's warps taking tasks in turn, one
// barrier between:
//   0  the prep: a thread a (n, sub-chunk) takes its 16 rows of r, k, w
//      (loads first): D', D'', R', K'', e^(T_b) and the bonus's terms
//      (summed over n); dy and S_(g-1) to shared memory; rowsum(S ⊙ G);
//      then a thread a column: e^Lb and the c factors.
//   1a VD's blocks; SD (kept in registers) and σ.
//   1b XI on SD's accumulators; P̃'s blocks into PT (its own rows) and ρ
//      (the K'_b-weighted sums of the earlier rows).
//   2  the walk; dr, dk, dw out; du's partial a column.
//   3  A's blocks below the diagonal on the tensor cores and its diagonal
//      blocks from the walk's sums; dy and G_g to shared memory; dv out.
// v and, in phase 1b, G_g reach the fragments from device memory (mostly
// L2).
//
// What bounds it on an H100.  The function's bytes at rwkv6-7b's train
// shape (B4 T1024 H64 N64, bf16 r, k, v, f32 w): r, k, v read 101 MB; w, dy
// and S_(g-1) 67 MB each; dr, dk, dv written 101 MB, dw 67 MB: ~0.47 GB,
// >= 0.140 ms at 3.35 TB/s.  Its two-level work (chip_smoke.py:
// _k10_bwd_two_level_ops): ~2.1 G CUDA-core operations (~0.031 ms at 67
// TFLOP/s) and ~44 GFLOP of bf16 piece products (~0.045 ms at 989
// TFLOP/s; f32 r, k, v: ~101 GFLOP), so the floor is its bytes; the
// one-level form on the CUDA cores, the first design, needed 17.6 G f32
// operations, 0.263 ms.  Launch 3 holds two blocks an SM (111.6 KB of
// shared memory and at most 128 registers a thread, no spills, at N = C =
// 64); a block's time goes to the walk (~40%), the products (~35%) and
// the prep (~20%), by %globaltimer marks in a probe copy of this source
// (PERF.md §6).
#include "wkv6_common.cuh"

namespace {

constexpr int kSub = 16;           // sub-chunk rows: one m16n8k16 row block
constexpr int kMaxC = 64;
constexpr int kQThreads = 128;     // launch 1
constexpr int kScanThreads = 256;  // launch 2
constexpr int kGradThreads = 256;  // launch 3
constexpr int kScanBatch = 8;      // loads ahead in launch 2
constexpr int kWarps = kGradThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int padded(int C) {
  return (C + kSub - 1) / kSub * kSub;
}

__device__ __forceinline__ float ldf(const void* p, size_t i, bool bf) {
  return bf ? __bfloat162float(static_cast<const repro::bf16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void stf(void* p, size_t i, float x, bool bf) {
  if (bf)
    static_cast<repro::bf16*>(p)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(p)[i] = x;
}

// A chunk's coordinates: g-major, chunk = g·B·H + b·H + h; base is the
// element (b, g·C, h, 0) of a (B,T,H,N) array
struct Chunk {
  long long id;
  int h;
  size_t base, rs;
};

__device__ __forceinline__ Chunk chunk_of(int T, int H, int N, int C,
                                          int G) {
  const long long id = blockIdx.x;
  const long long BH = gridDim.x / G;
  const int g = static_cast<int>(id / BH);
  const long long bh = id % BH;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  return Chunk{id, h, (((size_t)b * T + (size_t)g * C) * H + h) * N,
               (size_t)H * N};
}

// ---- fragments ------------------------------------------------------------

// Two f32 as the P bf16 pieces of one fragment register each: P = 1
// values that are bf16 already, P = 2 the rounded split (common.cuh:
// c_to_a_pieces: x0 = bf16_rn(x), x1 = bf16_rn(x - x0), |x - x0 - x1| <=
// 2^-17 |x|), P = 3 the exact three-way split (common.cuh:split_bf16x3)
template <int P, int R>
__device__ __forceinline__ void pieces_of(float2 x, uint32_t (&d)[P][R],
                                          int r) {
  if constexpr (P == 1) {
    d[0][r] = repro::pack_bf16_bits(__float_as_uint(x.x) >> 16,
                                    __float_as_uint(x.y) >> 16);
  } else if constexpr (P == 2) {
    d[0][r] = repro::pack_bf16_rn(x.x, x.y);
    d[1][r] = repro::pack_bf16_rn(x.x - repro::bf16_lo(d[0][r]),
                                  x.y - repro::bf16_hi(d[0][r]));
  } else {
    uint32_t p0[3], p1[3];
    repro::split_bf16x3(x.x, p0);
    repro::split_bf16x3(x.y, p1);
#pragma unroll
    for (int pc = 0; pc < 3; ++pc)
      d[pc][r] = repro::pack_bf16_bits(p0[pc], p1[pc]);
  }
}

// The A fragment of a 16x16 tile whose elements (i, j) and (i, j + 1) are
// f2(i, j) (j even); the m16n8k16 layout, g = lane / 4, q = lane % 4:
// register r holds row g + 8·(r & 1), columns 2q + 8·(r >> 1) and one more
template <int P, class F>
__device__ __forceinline__ void frag_a(const F& f2, int lane,
                                       uint32_t (&a)[P][4]) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    pieces_of<P>(f2(g + 8 * (r & 1), 2 * q + 8 * (r >> 1)), a, r);
}

// The same for a 16x8 B fragment: register r holds rows (the contraction)
// 2q + 8r and one more, column g; f2(kk, col) gives (kk, col), (kk+1, col)
template <int P, class F>
__device__ __forceinline__ void frag_b(const F& f2, int lane,
                                       uint32_t (&b)[P][2]) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    pieces_of<P>(f2(2 * q + 8 * r, g), b, r);
}

// hi += a0·b0; lo += the other piece products a_i b_j with i + j <= K
template <int K, int PA, int PB>
__device__ __forceinline__ void mma_pieces(float* hi, float* lo,
                                           const uint32_t (&a)[PA][4],
                                           const uint32_t (&b)[PB][2]) {
  repro::mma_bf16(hi, a[0], b[0]);
#pragma unroll
  for (int i = 0; i < PA; ++i)
#pragma unroll
    for (int j = 0; j < PB; ++j)
      if (i + j >= 1 && i + j <= K) repro::mma_bf16(lo, a[i], b[j]);
}

// 4 consecutive elements of a bf16 or f32 array from element i (a multiple
// of 4; the wrapper hands 16-byte aligned tensors) as floats; zeros when
// `in` is false
__device__ __forceinline__ float4 ld4f(const void* p, size_t i, bool bf,
                                       bool in) {
  if (!in) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (bf) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const repro::bf16*>(p) + i));
    return make_float4(repro::bf16_lo(q.x), repro::bf16_hi(q.x),
                       repro::bf16_lo(q.y), repro::bf16_hi(q.y));
  }
  return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) +
                                               i));
}

// Elements o and o + 1 of a shared f32 tile (o even): one 8-byte read
__device__ __forceinline__ float2 f2at(const float* t, int o) {
  return *reinterpret_cast<const float2*>(t + o);
}

// Elements i and i + 1 of a device array of bf16 or f32 (i even), as f32;
// zeros when `in` is false
__device__ __forceinline__ float2 g2at(const void* p, size_t i, bool bf,
                                       bool in) {
  if (!in) return make_float2(0.f, 0.f);
  if (bf) {
    const uint32_t u = __ldg(reinterpret_cast<const unsigned*>(
        static_cast<const repro::bf16*>(p) + i));
    return make_float2(repro::bf16_lo(u), repro::bf16_hi(u));
  }
  return __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(p) +
                                               i));
}

__device__ __forceinline__ float2 scale2(float2 x, float2 c) {
  return make_float2(x.x * c.x, x.y * c.y);
}

// ---- launch 1: (r e^Lp)ᵀ dy ----------------------------------------------

// P: the pieces of an f32 operand, 2 for bf16 r, k, v and 3 for f32
size_t smem_state(int N, int Cp, int P) {
  return (size_t)2 * Cp * (N + 4) * 4 + (size_t)P * Cp * (N + 8) * 2;
}

template <int N, bool BF>
__global__ void __launch_bounds__(kQThreads)
state_grad_kernel(const void* __restrict__ r, const void* __restrict__ w,
                  const float* __restrict__ dy, float* __restrict__ q,
                  int T, int H, int C, int G, int w_bf16) {
  constexpr int FA = N + 4, BT = N + 8;
  constexpr int P = BF ? 2 : 3;
  extern __shared__ __align__(16) float sm[];
  const int Cp = padded(C);
  float* rl = sm;                                  // (Cp, FA) r, r e^Lp
  float* ls = rl + Cp * FA;                        // (Cp, FA) e^l
  unsigned short* dp = reinterpret_cast<unsigned short*>(ls + Cp * FA);
  const int step = Cp * BT;                        // P tiles (Cp, BT) of dy
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Chunk ch = chunk_of(T, H, N, C, G);
  // every load in flight first (4 elements of a row a thread, IT times)
  constexpr int R4 = N / 4;
  constexpr int IT = (kMaxC * R4 + kQThreads - 1) / kQThreads;
  float4 xr[IT], xw[IT], xd[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = tid + it * kQThreads, c = e / R4, n = (e % R4) * 4;
    const size_t gi = ch.base + c * ch.rs + n;
    xr[it] = ld4f(r, gi, BF, c < C);
    xw[it] = ld4f(w, gi, w_bf16, c < C);
    xd[it] = ld4f(dy, gi, false, c < C);
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = tid + it * kQThreads, c = e / R4, n = (e % R4) * 4;
    if (c < Cp) {
      const bool in = c < C;
      *reinterpret_cast<float4*>(rl + c * FA + n) = xr[it];
      const float4 x = xw[it], d = xd[it];
      *reinterpret_cast<float4*>(ls + c * FA + n) =
          in ? make_float4(fmaxf(x.x, 1e-38f), fmaxf(x.y, 1e-38f),
                           fmaxf(x.z, 1e-38f), fmaxf(x.w, 1e-38f))
             : make_float4(1.f, 1.f, 1.f, 1.f);
      uint32_t p01[P][2];  // dy's pieces, two elements a word
      pieces_of<P>(make_float2(d.x, d.y), p01, 0);
      pieces_of<P>(make_float2(d.z, d.w), p01, 1);
#pragma unroll
      for (int pc = 0; pc < P; ++pc)
        *reinterpret_cast<uint2*>(dp + pc * step + c * BT + n) =
            make_uint2(p01[pc][0], p01[pc][1]);
    }
  }
  __syncthreads();
  if (tid < N) {  // e^Lp_c, the product of e^l before c, in order of c
    float d = 1.f;
    for (int c = 0; c < Cp; ++c) {
      rl[c * FA + tid] = __fmul_rn(rl[c * FA + tid], d);
      d = __fmul_rn(d, ls[c * FA + tid]);
    }
  }
  __syncthreads();
  // warps over (row tile of n, 16-column groups of m), as K10's launch A
  constexpr int RT = N / 16, WPR = 4 / RT;
  constexpr int GPW = RT / WPR > 0 ? RT / WPR : 1;
  const int rt = warp / WPR, cg0 = (warp % WPR) * GPW;
  if (cg0 < RT) {  // N = 16: warp 0 alone
  float hi[GPW][2][4] = {}, lo[GPW][2][4] = {};
  for (int cs = 0; cs < Cp / kSub; ++cs) {
    uint32_t af[P][4];  // A = (r e^Lp)ᵀ: row n, column c
    frag_a<P>([&](int i, int j) {
      const int n = rt * 16 + i, c = cs * 16 + j;
      return make_float2(rl[c * FA + n], rl[(c + 1) * FA + n]);
    }, lane, af);
#pragma unroll
    for (int t = 0; t < GPW; ++t) {
      uint32_t bq[2][P][2];  // B = dy: row c, column m; two n8 tiles
#pragma unroll
      for (int pc = 0; pc < P; ++pc) {
        uint32_t x[4];
        repro::ldmatrix_x4_trans(
            x, dp + pc * step + (cs * 16 + (lane & 15)) * BT +
                   (cg0 + t) * 16 + (lane >> 4) * 8);
        bq[0][pc][0] = x[0];
        bq[0][pc][1] = x[1];
        bq[1][pc][0] = x[2];
        bq[1][pc][1] = x[3];
      }
      mma_pieces<P - 1>(hi[t][0], lo[t][0], af, bq[0]);
      mma_pieces<P - 1>(hi[t][1], lo[t][1], af, bq[1]);
    }
  }
  const int gq = lane >> 2, qq = lane & 3;
  float* out = q + ch.id * N * N;
#pragma unroll
  for (int t = 0; t < GPW; ++t)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int n = rt * 16 + gq + 8 * hr;
        const int m = (cg0 + t) * 16 + u * 8 + 2 * qq;
        *reinterpret_cast<float2*>(out + n * N + m) = make_float2(
            hi[t][u][2 * hr] + lo[t][u][2 * hr],
            hi[t][u][2 * hr + 1] + lo[t][u][2 * hr + 1]);
      }
  }
}

// ---- launch 2: the state gradients, g from the last ----------------------

// total = B·H·N²; chunk g's products start at g·total, its e^Ltot at
// g·total / N (K10's workspace layout)
__global__ void __launch_bounds__(kScanThreads)
grad_scan_kernel(const float* __restrict__ ws_e, float* __restrict__ q,
                 int G, int N, long long total) {
  const long long e = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  if (e >= total) return;
  const int nn = N * N;
  const long long bh = e / nn;
  const int n = static_cast<int>(e % nn) / N;
  const float* el = ws_e + bh * N + n;
  const long long ne = total / N;
  float Gd = 0.f;  // the final state takes no gradient
  for (int g1 = G; g1 > 0; g1 -= kScanBatch) {  // kScanBatch loads ahead
    const int cnt = g1 < kScanBatch ? g1 : kScanBatch;
    float qv[kScanBatch], ev[kScanBatch];
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j)
      if (j < cnt) {
        qv[j] = q[(g1 - 1 - j) * total + e];
        ev[j] = el[(g1 - 1 - j) * ne];
      }
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j)
      if (j < cnt) {
        q[(g1 - 1 - j) * total + e] = Gd;  // G_g over chunk g's product
        Gd = __fadd_rn(__fmul_rn(ev[j], Gd), qv[j]);
      }
  }
}

// ---- launch 3: a chunk's gradients ---------------------------------------

// the shared floats of the per-column sums: T_b, e^Lb, c(a, b), σ, ρ,
// rowsum(S ⊙ G), u, du's partials; then A's diagonal blocks in two halves
__host__ __device__ constexpr int small_floats(int N, int ns) {
  return N * (4 * ns + ns * (ns + 1) / 2 + ns * ns + 2) +
         2 * ns * kSub * kSub;
}

// PT has max(Cp, N) rows: it holds S_(g-1) in phase 1a and G_g in 3
size_t smem_grad(int N, int Cp) {
  return 4 * ((size_t)(3 * Cp + (Cp > N ? Cp : N)) * (N + 8) +
              (size_t)Cp * (Cp + 8) + small_floats(N, Cp / kSub));
}

// c(a, b) = e^(Lb_a - Lb_(b+1)), 0 <= b < a <= nsub
__device__ __forceinline__ int cf_at(int a, int b) {
  return a * (a - 1) / 2 + b;
}

// The sum over the NL lanes of a group (NL 16 or 32: a half warp or a
// warp) of 16 slots, scattered: the lane ends with the sum of slot
// slot_of<NL>(lane).  Each round halves the slots a lane holds, in a fixed
// order, so the sum is the same bits every run.
template <int NL>
__device__ __forceinline__ int slot_of(int lane) {
  constexpr int M1 = NL / 2, M2 = NL / 4, M3 = NL / 8, M4 = NL / 16;
  return ((lane & M1) ? 8 : 0) + ((lane & M2) ? 4 : 0) +
         ((lane & M3) ? 2 : 0) + ((lane & M4) ? 1 : 0);
}

template <int NL>
__device__ __forceinline__ float reduce_scatter16(const float (&x)[16],
                                                  int lane, int first) {
  // slots below `first` are zero (a constant where the walk is unrolled),
  // and so is every partial sum made of them alone: no shuffle for those
  constexpr int M1 = NL / 2, M2 = NL / 4, M3 = NL / 8, M4 = NL / 16;
  float y8[8], y4[4], y2[2];
  bool hb = lane & M1;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    y8[j] = j + 8 < first ? 0.f
            : (hb ? x[j + 8] : x[j]) +
                  __shfl_xor_sync(kFull, hb ? x[j] : x[j + 8], M1);
  hb = lane & M2;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y4[j] = j + 12 < first ? 0.f
            : (hb ? y8[j + 4] : y8[j]) +
                  __shfl_xor_sync(kFull, hb ? y8[j] : y8[j + 4], M2);
  hb = lane & M3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    y2[j] = j + 14 < first ? 0.f
            : (hb ? y4[j + 2] : y4[j]) +
                  __shfl_xor_sync(kFull, hb ? y4[j] : y4[j + 2], M3);
  hb = lane & M4;
  float y = (hb ? y2[1] : y2[0]) +
            __shfl_xor_sync(kFull, hb ? y2[0] : y2[1], M4);
  if constexpr (NL == 32) y = y + __shfl_xor_sync(kFull, y, 1);
  return y;
}

// Σ over the 8 lane rows g of a fragment column pair (lanes g·4 + q): the
// result in every lane of the column, the same order in all
__device__ __forceinline__ float sum_rows(float x) {
  x = x + __shfl_xor_sync(kFull, x, 4);
  x = x + __shfl_xor_sync(kFull, x, 8);
  return x + __shfl_xor_sync(kFull, x, 16);
}

template <int N, bool BF>
__global__ void __launch_bounds__(kGradThreads, 2)
chunk_grad_kernel(const void* __restrict__ r, const void* __restrict__ k,
                  const void* __restrict__ v, const void* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ dy,
                  const float* __restrict__ ws_s,
                  const float* __restrict__ gq, void* __restrict__ dr,
                  void* __restrict__ dk, void* __restrict__ dv,
                  void* __restrict__ dw, float* __restrict__ du_part, int T,
                  int H, int C, int G, int w_bf16) {
  constexpr int FC = N + 8;
  constexpr int P = BF ? 2 : 3;          // an f32 operand's pieces
  constexpr int K = P - 1;               // the piece products kept
  constexpr int PV = BF ? 1 : 3;         // v's pieces
  constexpr int CW = N < 32 ? N : 32;    // columns a task
  constexpr int NH = N / CW;             // column tasks a row block
  constexpr int NT = CW / 8;             // n8 tiles a task
  constexpr int NL = N < 32 ? N : 32;    // lanes of a walk group
  constexpr int R4 = N / 4;              // float4s a row
  constexpr int IT = (kMaxC * R4 + kGradThreads - 1) / kGradThreads;
  extern __shared__ __align__(16) float sm[];
  const int Cp = padded(C), ns = Cp / kSub, AS = Cp + 8;
  float* Rp = sm;                   // (Cp, FC) R' = r D' (the walk: r)
  float* Kp = Rp + Cp * FC;         // (Cp, FC) K'' = k D'' (the walk: k)
  float* VA = Kp + Cp * FC;         // (Cp, AS) VD, then A
  float* U1 = VA + Cp * AS;         // (Cp, FC) dy; XI; dy
  float* PT = U1 + Cp * FC;         // (max(Cp, N), FC) S_(g-1); P̃ on its
                                    // own rows; G_g
  float* eT = PT + (Cp > N ? Cp : N) * FC;  // (ns, N) e^(T_b)
  float* eLb = eT + ns * N;         // (ns, N) e^Lb_b
  float* cf = eLb + ns * N;         // (ns(ns+1)/2, N) c(a, b)
  float* sig = cf + ns * (ns + 1) / 2 * N;  // (ns, N) σ; then the bonus
  float* rho = sig + ns * N;        // (ns, ns, N) ρ_b's parts
  float* Y0 = rho + ns * ns * N;    // (N) rowsum(S ⊙ G)
  float* us = Y0 + N;               // (N) u
  float* dup = us + N;              // (ns, N) du's partials
  float* adp = dup + ns * N;        // (2, ns, 16, 16) A's diagonal, bonus
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq_ = lane >> 2, qq = lane & 3;
  const Chunk ch = chunk_of(T, H, N, C, G);
  const float* Sg = ws_s + ch.id * N * N;   // S_(g-1)
  const float* Gg = gq + ch.id * N * N;     // G_g
  const auto vrow = [&](int c) { return ch.base + (size_t)c * ch.rs; };
  // dy's chunk into U1, every load in flight first
  const auto stage_dy = [&]() {
    float4 x[IT];
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int e = tid + it * kGradThreads, c = e / R4, n = (e % R4) * 4;
      x[it] = ld4f(dy, vrow(c) + n, false, c < C);
    }
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int e = tid + it * kGradThreads, c = e / R4, n = (e % R4) * 4;
      if (c < Cp) *reinterpret_cast<float4*>(U1 + c * FC + n) = x[it];
    }
  };
  // a (n, sub-chunk) thread's 16 rows of r, k and e^l, loads first; e^l
  // is negative where w is below the clamp (no gradient to w there)
  const auto rows_of = [&](int n, int o, float (&rv)[kSub], float (&kv)[kSub],
                           float (&ew)[kSub]) {
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const bool in = o + j < C;
      const size_t gi = vrow(o + j) + n;
      rv[j] = in ? ldf(r, gi, BF) : 0.f;
      kv[j] = in ? ldf(k, gi, BF) : 0.f;
      ew[j] = in ? ldf(w, gi, w_bf16) : 1.f;
    }
#pragma unroll
    for (int j = 0; j < kSub; ++j)  // e^l = max(w, 1e-38), exactly
      ew[j] = ew[j] >= 1e-38f ? ew[j] : -1e-38f;
  };
  // R' = r D' and K'' = k D'' of those rows: D'_t the product of the
  // sub-chunk's e^l before t, D''_t of those after t; returns e^(T_b)
  const auto decays = [&](int n, int o, const float (&rv)[kSub],
                          const float (&kv)[kSub], const float (&ew)[kSub]) {
    float d = 1.f;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      Rp[(o + j) * FC + n] = __fmul_rn(rv[j], d);
      d = __fmul_rn(d, fabsf(ew[j]));
    }
    float e = 1.f;
#pragma unroll
    for (int j = kSub - 1; j >= 0; --j) {
      Kp[(o + j) * FC + n] = __fmul_rn(kv[j], e);
      e = __fmul_rn(e, fabsf(ew[j]));
    }
    return d;
  };

  // an N x N f32 matrix (S_(g-1) or G_g) into PT, loads first
  const auto stage_nn = [&](const float* src) {
    constexpr int I2 = (N * N / 4 + kGradThreads - 1) / kGradThreads;
    float4 x[I2];
#pragma unroll
    for (int it = 0; it < I2; ++it) {
      const int e = tid + it * kGradThreads;
      if (e < N * N / 4) x[it] = __ldg(reinterpret_cast<const float4*>(src) + e);
    }
#pragma unroll
    for (int it = 0; it < I2; ++it) {
      const int e = tid + it * kGradThreads;
      if (e < N * N / 4)
        *reinterpret_cast<float4*>(PT + (e / R4) * FC + (e % R4) * 4) = x[it];
    }
  };

  // ---- phase 0: the prep ----
  stage_dy();
  stage_nn(Sg);
  if (warp * 32 < N * ns) {  // a thread a (n, sub-chunk b): its 16 rows
    const int n = tid % N;
    const bool act = tid < N * ns;
    const int b = act ? tid / N : ns - 1;
    const int half = N == 64 ? (n >> 5) : 0;
    float rv[kSub], kv[kSub], ew[kSub], slot[kSub];
    rows_of(n, b * kSub, rv, kv, ew);
    if (act) eT[b * N + n] = decays(n, b * kSub, rv, kv, ew);
    // the bonus Σ_n r u k of the 16 rows, summed over the group's lanes
    const float un = u[ch.h * N + n];
#pragma unroll
    for (int j = 0; j < kSub; ++j) slot[j] = __fmul_rn(__fmul_rn(rv[j], un), kv[j]);
    const float y = reduce_scatter16<NL>(slot, lane, 0);
    const int sl = slot_of<NL>(lane);
    if (act && (NL == 16 || (lane & 1) == 0))
      adp[((half * ns + b) * kSub + sl) * kSub + sl] = y;
  }
  {  // u; rowsum(S ⊙ G), four threads a row, m in order within each
    const int n = tid >> 2, part = tid & 3;
    constexpr int Q4 = N / 16;  // float4s of a quarter row
    float acc = 0.f;
    if (n < N) {
      float4 a[Q4], c[Q4];
#pragma unroll
      for (int j = 0; j < Q4; ++j) {
        a[j] = __ldg(reinterpret_cast<const float4*>(Sg + n * N) +
                     part * Q4 + j);
        c[j] = __ldg(reinterpret_cast<const float4*>(Gg + n * N) +
                     part * Q4 + j);
      }
#pragma unroll
      for (int j = 0; j < Q4; ++j) {
        acc = __fmaf_rn(a[j].x, c[j].x, acc);
        acc = __fmaf_rn(a[j].y, c[j].y, acc);
        acc = __fmaf_rn(a[j].z, c[j].z, acc);
        acc = __fmaf_rn(a[j].w, c[j].w, acc);
      }
    }
    acc = acc + __shfl_xor_sync(kFull, acc, 1);
    acc = acc + __shfl_xor_sync(kFull, acc, 2);
    if (n < N && part == 0) Y0[n] = acc;
    if (tid < N) us[tid] = u[ch.h * N + tid];
  }
  __syncthreads();
  if (tid < N) {  // the boundaries' products: e^Lb and c(a, b)
    float e = 1.f;
    for (int b = 0; b < ns; ++b) {
      eLb[b * N + tid] = e;
      e = __fmul_rn(e, eT[b * N + tid]);
    }
    for (int b = 0; b < ns; ++b) {
      float c = 1.f;
      for (int a = b + 1; a <= ns; ++a) {
        cf[cf_at(a, b) * N + tid] = c;
        if (a < ns) c = __fmul_rn(c, eT[a * N + tid]);
      }
    }
  }
  __syncthreads();

  // ---- phase 1a: VD's blocks; SD and σ ----
  // dy (rows t, columns m) as an A fragment from U1
  const auto dy_a = [&](int row0, int col0, uint32_t (&a)[P][4]) {
    frag_a<P>([&](int i, int j) {
      return f2at(U1, (row0 + i) * FC + col0 + j);
    }, lane, a);
  };
  for (int task = warp; task < ns * (ns + 1) / 2; task += kWarps) {
    int a = 0;
    while ((a + 1) * (a + 2) / 2 <= task) ++a;
    const int bb = task - a * (a + 1) / 2;  // the block (a, bb <= a)
    float hi[2][4] = {}, lo[2][4] = {};
#pragma unroll
    for (int ms = 0; ms < N / 16; ++ms) {
      uint32_t af[P][4], bv[2][PV][2];  // B = vᵀ: row m, column i
#pragma unroll
      for (int t = 0; t < 2; ++t)
        frag_b<PV>([&](int kk, int col) {
          const int i = bb * 16 + t * 8 + col;
          return g2at(v, vrow(i) + ms * 16 + kk, BF, i < C);
        }, lane, bv[t]);
      dy_a(a * 16, ms * 16, af);
#pragma unroll
      for (int t = 0; t < 2; ++t) mma_pieces<K>(hi[t], lo[t], af, bv[t]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(
            VA + (a * 16 + gq_ + 8 * hr) * AS + bb * 16 + t * 8 + 2 * qq) =
            make_float2(hi[t][2 * hr] + lo[t][2 * hr],
                        hi[t][2 * hr + 1] + lo[t][2 * hr + 1]);
  }
  // SD for the row block ra and columns n0.. (task = warp), kept for XI
  const bool xtask = warp < ns * NH;
  const int ra = warp / NH, n0 = (warp % NH) * CW;
  float xh[NT][4] = {}, xl[NT][4] = {};
  if (xtask) {
#pragma unroll 1
    for (int ms = 0; ms < N / 16; ++ms) {
      uint32_t af[P][4];
      dy_a(ra * 16, ms * 16, af);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t bs[P][2];  // B = Sᵀ: row m, column n
        frag_b<P>([&](int kk, int col) {
          return f2at(PT, (n0 + t * 8 + col) * FC + ms * 16 + kk);
        }, lane, bs);
        mma_pieces<K>(xh[t], xl[t], af, bs);
      }
    }
    // σ_ra = Σ over the block's rows of R' ⊙ SD; then XI starts at
    // e^Lb_ra ⊙ SD
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + t * 8 + 2 * qq + e;
        const float s0 = xh[t][e] + xl[t][e], s1 = xh[t][2 + e] + xl[t][2 + e];
        const float x = sum_rows(
            __fadd_rn(__fmul_rn(Rp[(ra * 16 + gq_) * FC + n], s0),
                      __fmul_rn(Rp[(ra * 16 + gq_ + 8) * FC + n], s1)));
        if (gq_ == 0) sig[ra * N + n] = x;
        const float el = eLb[ra * N + n];
        xh[t][e] = __fmul_rn(el, s0);
        xh[t][2 + e] = __fmul_rn(el, s1);
        xl[t][e] = xl[t][2 + e] = 0.f;
      }
  }
  __syncthreads();

  // ---- phase 1b: XI; P̃ into PT and ρ ----
  if (xtask) {
    for (int jb = 0; jb < ra; ++jb) {  // XI += VD[ra, jb] K'_ra[jb]
      uint32_t af[P][4];
      frag_a<P>([&](int i, int j) {
        return f2at(VA, (ra * 16 + i) * AS + jb * 16 + j);
      }, lane, af);
      const float* c = cf + cf_at(ra, jb) * N;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t bk[P][2];  // B = K'_ra: row j, column n
        frag_b<P>([&](int kk, int col) {
          const int n = n0 + t * 8 + col, j = jb * 16 + kk;
          return make_float2(Kp[j * FC + n] * c[n], Kp[(j + 1) * FC + n] * c[n]);
        }, lane, bk);
        mma_pieces<K>(xh[t], xl[t], af, bk);
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(
            U1 + (ra * 16 + gq_ + 8 * hr) * FC + n0 + t * 8 + 2 * qq) =
            make_float2(xh[t][2 * hr] + xl[t][2 * hr],
                        xh[t][2 * hr + 1] + xl[t][2 * hr + 1]);
  }
  // P̃_b's row blocks sb <= b, columns m0..: a task (sb, column half)
  // takes v Gᵀ on its rows once, then each b >= sb: E_b ⊙ (v Gᵀ) + VD[>b,
  // sb]ᵀ R''_b
  for (int task = warp; task < ns * NH; task += kWarps) {
    const int sb = task / NH, m0 = (task % NH) * CW;
    float gv[NT][4];
    {
      float gh[NT][4] = {}, gl[NT][4] = {};
#pragma unroll 1
      for (int ms = 0; ms < N / 16; ++ms) {
        uint32_t av[PV][4];
        frag_a<PV>([&](int i, int j) {
          const int s = sb * 16 + i;
          return g2at(v, vrow(s) + ms * 16 + j, BF, s < C);
        }, lane, av);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          uint32_t bg[P][2];  // B = Gᵀ: row m, column n
          frag_b<P>([&](int kk, int col) {
            return __ldg(reinterpret_cast<const float2*>(
                Gg + (m0 + t * 8 + col) * N + ms * 16 + kk));
          }, lane, bg);
          mma_pieces<K>(gh[t], gl[t], av, bg);
        }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) gv[t][e] = gh[t][e] + gl[t][e];
    }
    for (int b = sb; b < ns; ++b) {
      const float* eb = cf + cf_at(ns, b) * N;  // E_b
      float hi[NT][4], lo[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[t][e] = __fmul_rn(eb[m0 + t * 8 + 2 * qq + (e & 1)], gv[t][e]);
          lo[t][e] = 0.f;
        }
      for (int a = b + 1; a < ns; ++a) {  // VD[a, sb]ᵀ R''_b[a]
        uint32_t af[P][4];
        frag_a<P>([&](int i, int j) {
          return make_float2(VA[(a * 16 + j) * AS + sb * 16 + i],
                             VA[(a * 16 + j + 1) * AS + sb * 16 + i]);
        }, lane, af);
        const float* c = cf + cf_at(a, b) * N;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          uint32_t br[P][2];  // B = R''_b: row t, column n
          frag_b<P>([&](int kk, int col) {
            const int n = m0 + t * 8 + col, tt = a * 16 + kk;
            return make_float2(Rp[tt * FC + n] * c[n],
                               Rp[(tt + 1) * FC + n] * c[n]);
          }, lane, br);
          mma_pieces<K>(hi[t], lo[t], af, br);
        }
      }
      if (sb == b) {
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            *reinterpret_cast<float2*>(
                PT + (sb * 16 + gq_ + 8 * hr) * FC + m0 + t * 8 + 2 * qq) =
                make_float2(hi[t][2 * hr] + lo[t][2 * hr],
                            hi[t][2 * hr + 1] + lo[t][2 * hr + 1]);
      } else {  // ρ_b's part: Σ over the rows of K'_b ⊙ P̃_b
        const float* c = cf + cf_at(b, sb) * N;
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = m0 + t * 8 + 2 * qq + e;
            const int s = sb * 16 + gq_;
            const float x = sum_rows(__fadd_rn(
                __fmul_rn(__fmul_rn(Kp[s * FC + n], c[n]),
                          hi[t][e] + lo[t][e]),
                __fmul_rn(__fmul_rn(Kp[(s + 8) * FC + n], c[n]),
                          hi[t][2 + e] + lo[t][2 + e])));
            if (gq_ == 0) rho[(b * ns + sb) * N + n] = x;
          }
      }
    }
  }
  __syncthreads();

  // ---- phase 2: the walk, a thread a (n, sub-chunk b) ----
  // Whole groups of NL lanes walk (the shuffles need them); a lane past the
  // last sub-chunk walks the last one and writes nothing.  During the walk
  // a thread's own slots (rows of its sub-chunk, column n) of R' and K''
  // hold r and k, and U1's XI; at its end it writes R' and K'' back, the
  // prep's arithmetic and bits.  The pairwise decay E[t, s] = e^(Lp_t -
  // L_s) is the product of the pair's own e^l (s < q < t), one multiply a
  // pair.  Step s takes the pairs of column s (rows t > s, walked up from
  // E[s+1, s] = 1 to E[16b+16, s] = D''_s: dw_s, dk_s, A[t, s], X) and
  // those of row s (keys i < s, walked down from E[s, s-1] = 1: dr_s).
  if (warp * 32 < N * ns) {
    const int n = tid % N;
    const bool act = tid < N * ns;
    const int b = act ? tid / N : ns - 1;
    const int o = b * kSub;
    const int half = N == 64 ? (n >> 5) : 0;
    float X[kSub], ew[kSub];
    const float un = us[n];
    {
      float rv[kSub], kv[kSub];
      rows_of(n, o, rv, kv, ew);
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        X[j] = U1[(o + j) * FC + n];
        if (act) {
          Rp[(o + j) * FC + n] = rv[j];
          Kp[(o + j) * FC + n] = kv[j];
        }
      }
    }
    float Q = __fmul_rn(cf[cf_at(ns, b) * N + n], Y0[n]);
    for (int a = b + 1; a < ns; ++a)
      Q = __fadd_rn(Q, __fmul_rn(cf[cf_at(a, b) * N + n], sig[a * N + n]));
    Q = __fmul_rn(eLb[b * N + n], Q);
    for (int sb = 0; sb < b; ++sb) Q = __fadd_rn(Q, rho[(b * ns + sb) * N + n]);
    float du = 0.f, Dp = 1.f;  // Dp: D'_s
#pragma unroll
    for (int js = 0; js < kSub; ++js) {
      const int s = o + js;
      const float ks = Kp[s * FC + n], rs = Rp[s * FC + n];
      const float es = fabsf(ew[js]);
      const float vdd = VA[s * AS + s], pt = PT[s * FC + n];
      // row s: dr_s = D'_s XI_s + u k_s VD[s,s] + Σ_(i<s) k_i E[s,i] VD[s,i]
      float drs = __fadd_rn(__fmul_rn(Dp, U1[s * FC + n]),
                            __fmul_rn(__fmul_rn(un, ks), vdd));
      float E = 1.f;
#pragma unroll
      for (int ji = js - 1; ji >= 0; --ji) {
        drs = __fmaf_rn(__fmul_rn(Kp[(o + ji) * FC + n], E),
                        VA[s * AS + o + ji], drs);
        E = __fmul_rn(E, fabsf(ew[ji]));
      }
      // column s
      float p = 0.f, dkd = 0.f, slot[kSub];
#pragma unroll
      for (int jt = 0; jt < kSub; ++jt) slot[jt] = 0.f;
      E = 1.f;
#pragma unroll
      for (int jt = js + 1; jt < kSub; ++jt) {
        const float re = __fmul_rn(Rp[(o + jt) * FC + n], E);
        const float vd = VA[(o + jt) * AS + s];
        p = __fmaf_rn(re, X[jt], p);
        dkd = __fmaf_rn(re, vd, dkd);
        slot[jt] = __fmul_rn(re, ks);
        X[jt] = __fadd_rn(__fmul_rn(es, X[jt]), __fmul_rn(ks, vd));
        E = __fmul_rn(E, fabsf(ew[jt]));
      }
      if (act && s < C) {  // E is now D''_s
        const size_t gi = vrow(s) + n;
        stf(dr, gi, drs, BF);
        stf(dw, gi, ew[js] > 0.f ? __fadd_rn(p, __fmul_rn(E, Q)) : 0.f,
            w_bf16);
        stf(dk, gi, __fadd_rn(__fadd_rn(__fmul_rn(E, pt), dkd),
                              __fmul_rn(__fmul_rn(un, rs), vdd)), BF);
      }
      du = __fadd_rn(du, __fmul_rn(__fmul_rn(rs, ks), vdd));
      Q = __fadd_rn(__fmul_rn(es, Q), __fmul_rn(ks, pt));
      Dp = __fmul_rn(Dp, es);
      if (js + 1 < kSub) {  // A[t, s] for t > s, summed over the columns
        const float y = reduce_scatter16<NL>(slot, lane, js + 1);
        const int sl = slot_of<NL>(lane);
        if (act && sl > js && (NL == 16 || (lane & 1) == 0))
          adp[((half * ns + b) * kSub + sl) * kSub + js] = y;
      }
    }
    if (act) {
      float rv[kSub], kv[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        rv[j] = Rp[(o + j) * FC + n];
        kv[j] = Kp[(o + j) * FC + n];
      }
      decays(n, o, rv, kv, ew);  // R' and K'' back, for phase 3
      dup[b * N + n] = du;
    }
  }
  __syncthreads();

  // ---- phase 3: A; dy again; dv ----
  // A's blocks below the diagonal, R'_a K'_aᵀ, over VD's place
  for (int task = warp; task < ns * (ns - 1) / 2; task += kWarps) {
    int a = 1;
    while ((a + 1) * a / 2 <= task) ++a;
    const int bb = task - a * (a - 1) / 2;
    const float* c = cf + cf_at(a, bb) * N;
    float hi[2][4] = {}, lo[2][4] = {};
#pragma unroll
    for (int nsg = 0; nsg < N / 16; ++nsg) {
      uint32_t af[P][4];
      frag_a<P>([&](int i, int j) {
        return f2at(Rp, (a * 16 + i) * FC + nsg * 16 + j);
      }, lane, af);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        uint32_t bk[P][2];  // B = K'_aᵀ: row n, column i
        frag_b<P>([&](int kk, int col) {
          const int nn = nsg * 16 + kk;
          return scale2(f2at(Kp, (bb * 16 + t * 8 + col) * FC + nn),
                        f2at(c, nn));
        }, lane, bk);
        mma_pieces<K>(hi[t], lo[t], af, bk);
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(
            VA + (a * 16 + gq_ + 8 * hr) * AS + bb * 16 + t * 8 + 2 * qq) =
            make_float2(hi[t][2 * hr] + lo[t][2 * hr],
                        hi[t][2 * hr + 1] + lo[t][2 * hr + 1]);
  }
  // its diagonal blocks (strictly lower; zero on and above), the bonus
  for (int e = tid; e < ns * kSub * kSub; e += kGradThreads) {
    const int b = e / (kSub * kSub), jt = (e / kSub) % kSub, js = e % kSub;
    float x = adp[(b * kSub + jt) * kSub + js];
    if (N == 64) x = __fadd_rn(x, adp[((ns + b) * kSub + jt) * kSub + js]);
    VA[(b * kSub + jt) * AS + b * kSub + js] = jt > js ? x : 0.f;
    if (jt == js) sig[b * kSub + jt] = x;
  }
  stage_dy();
  stage_nn(Gg);
  if (tid < N) {  // du's partial of the chunk, the sub-chunks in order
    float x = 0.f;
    for (int b = 0; b < ns; ++b) x = __fadd_rn(x, dup[b * N + tid]);
    du_part[ch.id * N + tid] = x;
  }
  __syncthreads();
  // dv for key block bb, columns m0..: Aᵀ dy + (K'' E_bb) G + bonus dy
  for (int task = warp; task < ns * NH; task += kWarps) {
    const int bb = task / NH, m0 = (task % NH) * CW;
    float hi[NT][4] = {}, lo[NT][4] = {};
    const float* eb = cf + cf_at(ns, bb) * N;
#pragma unroll
    for (int nsg = 0; nsg < N / 16; ++nsg) {
      uint32_t af[P][4];
      frag_a<P>([&](int i, int j) {  // A = K'' E_bb: row i, column n
        const int nn = nsg * 16 + j;
        return scale2(f2at(Kp, (bb * 16 + i) * FC + nn), f2at(eb, nn));
      }, lane, af);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t bg[P][2];  // B = G: row n, column m
        frag_b<P>([&](int kk, int col) {
          const int m = m0 + t * 8 + col, nn = nsg * 16 + kk;
          return make_float2(PT[nn * FC + m], PT[(nn + 1) * FC + m]);
        }, lane, bg);
        mma_pieces<K>(hi[t], lo[t], af, bg);
      }
    }
    for (int a = bb; a < ns; ++a) {
      uint32_t af[P][4];  // A = Aᵀ: row i, column t
      frag_a<P>([&](int i, int j) {
        return make_float2(VA[(a * 16 + j) * AS + bb * 16 + i],
                           VA[(a * 16 + j + 1) * AS + bb * 16 + i]);
      }, lane, af);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t bd[P][2];  // B = dy: row t, column m
        frag_b<P>([&](int kk, int col) {
          const int m = m0 + t * 8 + col, tt = a * 16 + kk;
          return make_float2(U1[tt * FC + m], U1[(tt + 1) * FC + m]);
        }, lane, bd);
        mma_pieces<K>(hi[t], lo[t], af, bd);
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = bb * 16 + gq_ + 8 * hr;
        if (i >= C) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + t * 8 + 2 * qq + e;
          stf(dv, vrow(i) + m,
              __fadd_rn(hi[t][2 * hr + e] + lo[t][2 * hr + e],
                        __fmul_rn(sig[i], U1[i * FC + m])), BF);
        }
      }
  }
}

// The four launches of a call: blocks, threads and dynamic shared bytes
// (kernels/wkv6.py:k10_bwd_plan is their twin on the CPU, held to
// wkv6_chunked_bwd_plan on the card).  False when a grid would pass
// 2^31 - 1.
struct Plan {
  long long blocks[4];
  int threads[4];
  size_t smem[4];
};

bool plan_of(int B, int T, int H, int N, int C, bool bf, Plan* p) {
  const int Cp = padded(C);
  const long long chunks = (long long)B * H * (T / C);
  const long long total = (long long)B * H * N * N;
  *p = Plan{{chunks, (total + kScanThreads - 1) / kScanThreads, chunks,
             ((long long)H * N + wkv6::kSumThreads - 1) / wkv6::kSumThreads},
            {kQThreads, kScanThreads, kGradThreads, wkv6::kSumThreads},
            {smem_state(N, Cp, bf ? 2 : 3), 0, smem_grad(N, Cp), 0}};
  return chunks <= 0x7fffffffLL && p->blocks[1] <= 0x7fffffffLL;
}

struct Args {
  const void *r, *k, *v, *w, *dy;
  const float *u, *ws;
  void *dr, *dk, *dv, *dw;
  float *du, *scratch;
  int B, T, H, C, w_bf16;
};

template <int N, bool BF>
int launch(const Args& a, cudaStream_t st) {
  const int G = a.T / a.C;
  Plan p;
  if (!plan_of(a.B, a.T, a.H, N, a.C, BF, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = p.blocks[0];
  const long long total = (long long)a.B * a.H * N * N;
  float* q = a.scratch;                   // (r e^Lp)ᵀ dy, then G_g
  float* du_part = a.scratch + chunks * N * N;
  const float* ws_e = a.ws + chunks * N * N;
  const auto blocks = static_cast<unsigned>(chunks);

  cudaError_t err = cudaFuncSetAttribute(
      state_grad_kernel<N, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem[0]));
  if (err != cudaSuccess) return static_cast<int>(err);
  state_grad_kernel<N, BF><<<blocks, p.threads[0], p.smem[0], st>>>(
      a.r, a.w, static_cast<const float*>(a.dy), q, a.T, a.H, a.C, G,
      a.w_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  grad_scan_kernel<<<static_cast<unsigned>(p.blocks[1]), p.threads[1], 0,
                     st>>>(ws_e, q, G, N, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(chunk_grad_kernel<N, BF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.smem[2]));
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_grad_kernel<N, BF><<<blocks, p.threads[2], p.smem[2], st>>>(
      a.r, a.k, a.v, a.w, a.u, static_cast<const float*>(a.dy), a.ws, q,
      a.dr, a.dk, a.dv, a.dw, du_part, a.T, a.H, a.C, G, a.w_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return wkv6::du_sum(du_part, a.du, a.B * G, a.H * N, st);  // launch 4
}

}  // namespace

// ws: K10's workspace of the same call; scratch: as large (4·B·H·(T/C)·
// (N² + N) bytes, kernels/wkv6.py:k10_bwd_plan): the state gradients, then
// du's partial sums
extern "C" int wkv6_chunked_bwd(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* dy,
                                const void* ws, void* dr, void* dk, void* dv,
                                void* dw, void* du, void* scratch, int B,
                                int T, int H, int N, int C, int rkv_bf16,
                                int w_bf16, void* stream) {
  if (B < 1 || T < 1 || H < 1 || C < 1 || C > kMaxC || T % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r, k, v, w, dy, static_cast<const float*>(u),
               static_cast<const float*>(ws), dr, dk, dv, dw,
               static_cast<float*>(du), static_cast<float*>(scratch), B, T,
               H, C, w_bf16};
  const auto st = static_cast<cudaStream_t>(stream);
#define K10B_LAUNCH(NN)                                                      \
  return rkv_bf16 ? launch<NN, true>(a, st) : launch<NN, false>(a, st)
  if (N == 64) K10B_LAUNCH(64);
  if (N == 32) K10B_LAUNCH(32);
  if (N == 16) K10B_LAUNCH(16);
#undef K10B_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launches a call would make: out[3i..3i+2] = blocks, threads and
// dynamic shared bytes of launch i (1 to 4), as launch() takes them.
extern "C" int wkv6_chunked_bwd_plan(int B, int T, int H, int N, int C,
                                     int rkv_bf16, int* out) {
  if (B < 1 || T < 1 || H < 1 || C < 1 || C > kMaxC || T % C != 0 ||
      (N != 16 && N != 32 && N != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  if (!plan_of(B, T, H, N, C, rkv_bf16 != 0, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 4; ++i) {
    out[3 * i] = static_cast<int>(p.blocks[i]);
    out[3 * i + 1] = p.threads[i];
    out[3 * i + 2] = static_cast<int>(p.smem[i]);
  }
  return 0;
}
