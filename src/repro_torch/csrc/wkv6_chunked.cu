// K10: the chunked RWKV-6 WKV over a whole sequence (long prefill).
//
// Replaces the TPU kernel kernels/wkv6.py:wkv6_pallas (_kernel), which kept
// a head's (N x N) f32 state on chip across all chunks of C tokens.  The
// function is the same one-level chunked WKV-6 as kernels/wkv6.py:
// wkv6_chunked_plain (the yardstick), per chunk of C tokens:
//   L     = cumsum_c log max(w, 1e-38)        (in order of c; inclusive)
//   Lprev = L - log w                          (exclusive)
//   y     = (r e^Lprev) @ S                    (inter-chunk)
//         + att @ v,  att[s,i] = Σ_n r[s,n] k[i,n] e^(Lprev[s,n] - L[i,n]),
//                     i < s only
//         + (Σ_n r[s,n] u[n] k[s,n]) v[s]      (the u-bonus)
//   S    <- e^Ltot S + (k e^(Ltot - L))ᵀ v     (Ltot = L[C-1])
//
// r, k, v (B,T,H,N) f32 or bf16 (one type); w (B,T,H,N) f32 or bf16;
// u (H,N) f32; s0 (B,H,N,N) f32 or null (zeros) -> y (B,T,H,N) f32 and the
// final state (B,H,N,N) f32.  N in {16, 32, 64}; C <= 64 divides T.
//
// Design.  Only S carries from chunk to chunk, and its update is
// elementwise: S_g = diag(e^Ltot_g) S_(g-1) + ΔS_g with ΔS_g = (k
// e^(Ltot-L))ᵀ v, B·H·N² independent chains of G steps.  Everything else is
// local to a chunk.  So one call runs three launches on the caller's
// stream, each chunk its own block, and no sum is ever split or reordered
// between runs (no atomics: the result is the same bits every run):
//   A  chunk_state_kernel   B·H·G blocks of 128: L, then ΔS_g on the tensor
//                           cores and e^Ltot_g, into the workspace.
//   B  state_scan_kernel    one thread a (b, h, n, m) chain: walks g in
//                           order, writes S_(g-1) over ΔS_g in place, and
//                           the final state.
//   C  chunk_output_kernel  B·H·G blocks of 256: L and Lprev
//                           again, then y = (r e^Lprev) @ S_(g-1) + att @ v
//                           + bonus, every product on the tensor cores but
//                           the diagonal pairs.
// At B1 T32768 H64 that is 32768 blocks a pass on 132 SMs (the earlier
// one-block-a-head kernel ran 64).  Launch C holds two blocks an SM at N = C = 64.
// Chunks and the workspace are g-major (chunk = g·B·H + b·H + h): the
// blocks in flight read neighbouring heads' rows of the same tokens, and
// launch B's threads walk one contiguous window of states (head-major, the
// ~40 heads' chains in flight ran 8 MB apart in step and B read 0.8 TB/s).
//
// Sub-chunks (JAX's two-level form, core/wkv/wkv6.py:wkv6_chunked).  A
// chunk is padded to Cp = 16·n_sub rows (rows >= C: r = k = v = 0, log w =
// 0, so L, Ltot, ΔS and every kept y are unchanged) and cut into sub-chunks
// of 16.  A block of att whose rows s lie in sub-chunk a and keys i in an
// earlier one factors through a's start Lst = Lprev[16a]:
//   e^(Lprev[s] - L[i]) = e^(Lprev[s] - Lst) · e^(Lst - L[i]),
// both exponents <= 0 (L falls with c), and both rounded differences have
// the sign of their sum, so the exponent's rounding is no larger than the
// one-level form's.  That block is the product (r e^(Lprev - Lst)) @ (k
// e^(Lst - L))ᵀ.  The 16x16 diagonal blocks keep the exact pairwise
// exponent, i < s only, on the CUDA cores: 120 pairs a sub-chunk (480 a
// chunk at C = 64, against the one-level 2016).
//
// Products.  mma.sync m16n8k16 with f32 accumulators.  An f32 operand goes
// in as three exact bf16 pieces (csrc/common.cuh:split_bf16x3: x0 + x1 + x2
// == x for |x| >= 2^-110); a bf16 r, k or v goes in as one.  f32 x f32
// products (r e^Lprev @ S, the factored att blocks) take the six piece
// products a_i b_j with i + j <= 2 (what is left out is below 2^-21 of |a
// b|); f32 x bf16 products (att @ v, (k e^(Ltot-L))ᵀ v) take all three, and
// f32 x f32 v six.  a_0 b_0 goes into its own accumulator and the rest into
// a second, added once at the end, so the long sums round at most K/16
// times in the large one.  Against wkv6_chunked_plain only the order of the
// f32 sums differs, and the factored exponents; both sit inside the checks'
// bound (chip_smoke.py:_k10_bound).
//
// Workspace (the wrapper allocates it): ΔS_g, then S_(g-1) in place, for
// every chunk, then e^Ltot_g: 4·B·H·G·(N² + N) bytes, 545 MB at B1 T32768
// H64 N64 (kernels/wkv6.py:k10_plan).
//
// What bounds it on an H100.  Bytes: per element of (B,T,H,N) at bf16 r,
// k, v and f32 w, A reads k, v, w (8 B) and writes ΔS (4N/C B); B reads ΔS
// and writes S (8N/C); C reads r, k, v, w (10 B) and S (4N/C) and writes y
// (4): 38 B at N = C = 64, 5.1 GB at B1 T32768 H64 N64 (~1.52 ms at 3.35
// TB/s), against the function's own 1.88 GB (each input read once, y and
// the state written once: ~0.56 ms).  Operations
// (chip_smoke.py:_k10_two_level_ops): ~1.0 G exact exponentials for the
// diagonal pairs among ~10.3 G CUDA-core operations (~0.15 ms at 67
// TFLOP/s), and ~0.22 T bf16 piece-product flops (~0.22 ms at 989
// TFLOP/s), so the function's floor is its bytes.  Launch C
// is bound by instruction throughput (exponentials and the pieces'
// splits, ~33 k warp instructions a chunk), not its 2.4 GB.  On "NVIDIA
// H100 80GB HBM3, 700.00 W" (tools/bench_k10.py) a call at that shape
// takes ~3.3 ms: A 0.60, B 0.42, C 2.31 (torch.profiler); the earlier
// one-block-a-head kernel 21.98 in the same call.  The build has no fast
// math and -fmad=false; the diagonal pairs sum by fmaf, one rounding fewer
// than eager torch.
#include "common.cuh"

namespace {

constexpr int kSub = 16;                          // sub-chunk rows
constexpr int kMaxC = 64;
constexpr int kPairs = kSub * (kSub - 1) / 2;     // strictly-lower pairs
constexpr int kChunkThreads = 128;                // launch A
constexpr int kScanThreads = 256;                 // launch B
constexpr int kOutThreads = 256;                  // launch C
constexpr int kScanBatch = 8;                     // loads ahead in B

// Row strides (elements): f32 tiles read as fragment pairs (launch C) take
// N + 8 (float2 reads of 16 lanes fill 32 distinct banks); f32 tiles read
// transposed (launch A) take N + 4; bf16 tiles read by ldmatrix take N + 8
// (eight 16-byte rows on distinct bank groups).
template <int N>
struct Ld {
  static constexpr int FA = N + 4;
  static constexpr int FC = N + 8;
  static constexpr int BT = N + 8;
};

__host__ __device__ constexpr int padded(int C) {
  return (C + kSub - 1) / kSub * kSub;
}

size_t smem_state(int N, int Cp, int PV) {
  return (size_t)2 * Cp * (N + 4) * 4 + (size_t)PV * Cp * (N + 8) * 2;
}

size_t smem_output(int N, int Cp, int PV) {
  const size_t pieces = (size_t)3 * N * (N + 8) * 2;  // S_(g-1), launch C's
  const size_t att = (size_t)Cp * (Cp + 8) * 4;       // first half; then att
  return (size_t)4 * Cp * (N + 8) * 4 + (pieces > att ? pieces : att) +
         (size_t)PV * Cp * (N + 8) * 2 + (size_t)(N + Cp) * 4;
}

// 4 consecutive elements of a bf16 or f32 array from element i (a multiple
// of 4; the wrapper hands 16-byte aligned tensors), raw: bf16 in .x and .y
__device__ __forceinline__ uint4 ld4(const void* p, size_t i, bool bf) {
  if (bf) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const repro::bf16*>(p) + i));
    return make_uint4(q.x, q.y, 0u, 0u);
  }
  return __ldg(reinterpret_cast<const uint4*>(static_cast<const float*>(p) +
                                              i));
}

// ld4's raw words as four floats
__device__ __forceinline__ float4 widen4(uint4 q, bool bf) {
  if (bf)
    return make_float4(repro::bf16_lo(q.x), repro::bf16_hi(q.x),
                       repro::bf16_lo(q.y), repro::bf16_hi(q.y));
  return make_float4(__uint_as_float(q.x), __uint_as_float(q.y),
                     __uint_as_float(q.z), __uint_as_float(q.w));
}

__device__ __forceinline__ float4 log4(float4 w) {
  return make_float4(logf(fmaxf(w.x, 1e-38f)), logf(fmaxf(w.y, 1e-38f)),
                     logf(fmaxf(w.z, 1e-38f)), logf(fmaxf(w.w, 1e-38f)));
}

// The bf16 pieces of 4 consecutive f32 (P = 1: exact bf16 values' bits;
// P = 3: the exact three-way split), stored from element e (a multiple of
// 4) of P tiles `step` apart, 8 bytes a tile
template <int P>
__device__ __forceinline__ void store4_pieces(unsigned short* t, int e,
                                              int step, float4 x) {
  if constexpr (P == 1) {
    *reinterpret_cast<uint2*>(t + e) = make_uint2(
        repro::pack_bf16_bits(__float_as_uint(x.x) >> 16,
                              __float_as_uint(x.y) >> 16),
        repro::pack_bf16_bits(__float_as_uint(x.z) >> 16,
                              __float_as_uint(x.w) >> 16));
  } else {
    uint32_t a[3], b[3], c[3], d[3];
    repro::split_bf16x3(x.x, a);
    repro::split_bf16x3(x.y, b);
    repro::split_bf16x3(x.z, c);
    repro::split_bf16x3(x.w, d);
#pragma unroll
    for (int pc = 0; pc < 3; ++pc)
      *reinterpret_cast<uint2*>(t + pc * step + e) =
          make_uint2(repro::pack_bf16_bits(a[pc], b[pc]),
                     repro::pack_bf16_bits(c[pc], d[pc]));
  }
}

// Elements o and o + 1 of a shared f32 tile (o even): one 8-byte read
__device__ __forceinline__ float2 f2at(const float* t, int o) {
  return *reinterpret_cast<const float2*>(t + o);
}

// The three bf16 pieces of a 16x16 A fragment whose elements (i, j) and
// (i, j + 1) are f2(i, j) (j even); the m16n8k16 layout, g = lane / 4,
// q = lane % 4: register r holds row g + 8·(r & 1), columns 2q + 8·(r >> 1)
// and one more
template <class F>
__device__ __forceinline__ void a_pieces(const F& f2, int lane,
                                         uint32_t (&a)[3][4]) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2 x = f2(g + 8 * (r & 1), 2 * q + 8 * (r >> 1));
    uint32_t p0[3], p1[3];
    repro::split_bf16x3(x.x, p0);
    repro::split_bf16x3(x.y, p1);
#pragma unroll
    for (int pc = 0; pc < 3; ++pc)
      a[pc][r] = repro::pack_bf16_bits(p0[pc], p1[pc]);
  }
}

// The same for a 16x8 B fragment: register r holds rows (the contraction)
// 2q + 8r and one more, column g; f2(kk, col) gives elements (kk, col) and
// (kk + 1, col)
template <class F>
__device__ __forceinline__ void b_pieces(const F& f2, int lane,
                                         uint32_t (&b)[3][2]) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float2 x = f2(2 * q + 8 * r, g);
    uint32_t p0[3], p1[3];
    repro::split_bf16x3(x.x, p0);
    repro::split_bf16x3(x.y, p1);
#pragma unroll
    for (int pc = 0; pc < 3; ++pc)
      b[pc][r] = repro::pack_bf16_bits(p0[pc], p1[pc]);
  }
}

// hi += a0·b0; lo += the other piece products with i + j <= 2
template <int PB>
__device__ __forceinline__ void mma_pieces(float* hi, float* lo,
                                           const uint32_t (&a)[3][4],
                                           const uint32_t (&b)[PB][2]) {
  repro::mma_bf16(hi, a[0], b[0]);
  repro::mma_bf16(lo, a[1], b[0]);
  repro::mma_bf16(lo, a[2], b[0]);
  if constexpr (PB == 3) {
    repro::mma_bf16(lo, a[0], b[1]);
    repro::mma_bf16(lo, a[1], b[1]);
    repro::mma_bf16(lo, a[0], b[2]);
  }
}

// The B fragments of two n8 tiles (16 columns from col0) of P bf16 tiles
// stored row-major (contraction rows from row0), by ldmatrix .trans:
// b[pc][t] for tile t
template <int P, int BT>
__device__ __forceinline__ void b_tiles(const unsigned short* t, int step,
                                        int row0, int col0, int lane,
                                        uint32_t (&b)[2][P][2]) {
#pragma unroll
  for (int pc = 0; pc < P; ++pc) {
    uint32_t x[4];
    repro::ldmatrix_x4_trans(
        x, t + pc * step + (row0 + (lane & 15)) * BT + col0 + (lane >> 4) * 8);
    b[0][pc][0] = x[0];
    b[0][pc][1] = x[1];
    b[1][pc][0] = x[2];
    b[1][pc][1] = x[3];
  }
}

// Column n's L (inclusive cumsum of the staged log w, in order of c) in
// place, and Lprev = L - log w when lp is given
template <int FS>
__device__ __forceinline__ void cumsum_col(float* L, float* lp, int n,
                                           int Cp) {
  float lw[kMaxC];  // every read first: only the adds wait on each other
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < Cp) lw[c] = L[c * FS + n];
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < Cp) {
      acc = __fadd_rn(acc, lw[c]);
      L[c * FS + n] = acc;
      if (lp != nullptr) lp[c * FS + n] = __fsub_rn(acc, lw[c]);
    }
}

// ---- launch A: ΔS_g and e^Ltot_g ----------------------------------------

template <int N, bool RKV_BF16>
__global__ void __launch_bounds__(kChunkThreads)
chunk_state_kernel(const void* __restrict__ k, const void* __restrict__ v,
                   const void* __restrict__ w, float* __restrict__ ws_d,
                   float* __restrict__ ws_e, int T, int H, int C, int G,
                   int w_bf16) {
  constexpr int FA = Ld<N>::FA, BT = Ld<N>::BT;
  constexpr int PV = RKV_BF16 ? 1 : 3;
  extern __shared__ __align__(16) float sm[];
  const int Cp = padded(C);
  float* ks = sm;                                  // (Cp, FA) k
  float* Ls = ks + Cp * FA;                        // (Cp, FA) log w, then L
  unsigned short* vs = reinterpret_cast<unsigned short*>(Ls + Cp * FA);
  const int vstep = Cp * BT;                       // PV tiles (Cp, BT) of v
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long chunk = blockIdx.x;       // g-major: chunk = g·B·H + bh
  const long long BH = gridDim.x / G;
  const int g = static_cast<int>(chunk / BH);
  const long long bh = chunk % BH;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const size_t base = (((size_t)b * T + (size_t)g * C) * H + h) * N;
  const size_t rstride = (size_t)H * N;

  // every load in flight first (4 elements of a row a thread, IT times),
  // then the tiles, 16 bytes a store: eight lanes fill the 32 banks
  constexpr int R4 = N / 4;
  constexpr int IT = (kMaxC * R4 + kChunkThreads - 1) / kChunkThreads;
  uint4 xk[IT], xv[IT], xw[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = tid + it * kChunkThreads, c = e / R4, n = (e % R4) * 4;
    if (c < C) {
      const size_t gi = base + c * rstride + n;
      xk[it] = ld4(k, gi, RKV_BF16);
      xv[it] = ld4(v, gi, RKV_BF16);
      xw[it] = ld4(w, gi, w_bf16);
    }
  }
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = tid + it * kChunkThreads, c = e / R4, n = (e % R4) * 4;
    if (c >= Cp) break;
    const bool in = c < C;
    *reinterpret_cast<float4*>(ks + c * FA + n) =
        in ? widen4(xk[it], RKV_BF16) : z4;
    *reinterpret_cast<float4*>(Ls + c * FA + n) =
        in ? log4(widen4(xw[it], w_bf16)) : z4;
    store4_pieces<PV>(vs, c * BT + n, vstep,
                      in ? widen4(xv[it], RKV_BF16) : z4);
  }
  __syncthreads();
  if (tid < N) cumsum_col<FA>(Ls, nullptr, tid, Cp);
  __syncthreads();

  const float* Ltot = Ls + (Cp - 1) * FA;
  // warps over (row tile of n, 16-column groups of m): N = 64 a row tile a
  // warp and all four groups; N = 32 a group; N = 16 warp 0 alone
  constexpr int RT = N / 16, WPR = 4 / RT;
  constexpr int GPW = RT / WPR > 0 ? RT / WPR : 1;
  const int rt = warp / WPR, cg0 = (warp % WPR) * GPW;
  if (cg0 < RT) {
    float hi[GPW][2][4] = {}, lo[GPW][2][4] = {};
    for (int cs = 0; cs < Cp / kSub; ++cs) {
      // A = (k e^(Ltot - L))ᵀ: row n, column c, read across the tile
      uint32_t af[3][4];
      a_pieces([&](int i, int j) {
        const int n = rt * 16 + i, c = cs * 16 + j;
        const float lt = Ltot[n];
        return make_float2(
            ks[c * FA + n] * expf(lt - Ls[c * FA + n]),
            ks[(c + 1) * FA + n] * expf(lt - Ls[(c + 1) * FA + n]));
      }, lane, af);
#pragma unroll
      for (int t = 0; t < GPW; ++t) {
        uint32_t bf[2][PV][2];
        b_tiles<PV, BT>(vs, vstep, cs * 16, (cg0 + t) * 16, lane, bf);
        mma_pieces<PV>(hi[t][0], lo[t][0], af, bf[0]);
        mma_pieces<PV>(hi[t][1], lo[t][1], af, bf[1]);
      }
    }
    const int gq = lane >> 2, q = lane & 3;
    float* out = ws_d + chunk * N * N;
#pragma unroll
    for (int t = 0; t < GPW; ++t)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int n = rt * 16 + gq + 8 * hr;
          const int m = (cg0 + t) * 16 + u * 8 + 2 * q;
          *reinterpret_cast<float2*>(out + n * N + m) = make_float2(
              hi[t][u][2 * hr] + lo[t][u][2 * hr],
              hi[t][u][2 * hr + 1] + lo[t][u][2 * hr + 1]);
        }
  }
  if (tid < N) ws_e[chunk * N + tid] = expf(Ltot[tid]);
}

// ---- launch B: the state recurrence -------------------------------------

// total = B·H·N², the chains; chunk g's states start at g·total and its
// e^Ltot at g·total / N (the workspace is g-major, as the chunks are)
__global__ void __launch_bounds__(kScanThreads)
state_scan_kernel(const float* __restrict__ s0, float* __restrict__ ws_d,
                  const float* __restrict__ ws_e, float* __restrict__ sf,
                  int G, int N, long long total) {
  const long long e = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  if (e >= total) return;
  const int nn = N * N;
  const long long bh = e / nn;
  const int x = static_cast<int>(e % nn), n = x / N;
  float S = s0 != nullptr ? s0[e] : 0.f;
  float* d = ws_d + e;
  const float* el = ws_e + bh * N + n;
  const long long ne = total / N;
  for (int g0 = 0; g0 < G; g0 += kScanBatch) {
    const int cnt = G - g0 < kScanBatch ? G - g0 : kScanBatch;
    float dv[kScanBatch], ev[kScanBatch];
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j)
      if (j < cnt) {
        dv[j] = d[(g0 + j) * total];
        ev[j] = el[(g0 + j) * ne];
      }
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j)
      if (j < cnt) {
        d[(g0 + j) * total] = S;                    // S_(g-1) over ΔS_g
        S = __fadd_rn(__fmul_rn(ev[j], S), dv[j]);
      }
  }
  sf[e] = S;
}

// ---- launch C: y ----------------------------------------------------------

template <int N, bool RKV_BF16>
__global__ void __launch_bounds__(kOutThreads, 2)
chunk_output_kernel(const void* __restrict__ r, const void* __restrict__ k,
                    const void* __restrict__ v, const void* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ ws_s, float* __restrict__ y,
                    int T, int H, int C, int G, int w_bf16) {
  constexpr int FC = Ld<N>::FC, BT = Ld<N>::BT;
  constexpr int PV = RKV_BF16 ? 1 : 3;
  constexpr int NG = N / 16;                 // 16-column groups of y
  constexpr int GPW = NG >= 2 ? NG / 2 : 1;  // a warp's groups
  extern __shared__ __align__(16) float sm[];
  const int Cp = padded(C), nsub = Cp / kSub;
  const int AS = Cp + 8;                     // att's row stride
  float* rs = sm;                            // (Cp, FC) r
  float* ks = rs + Cp * FC;                  // (Cp, FC) k
  float* Ls = ks + Cp * FC;                  // (Cp, FC) log w, then L
  float* Lps = Ls + Cp * FC;                 // (Cp, FC) Lprev
  float* un = Lps + Cp * FC;                 // union: S_(g-1) pieces, att
  const size_t un_f = ((size_t)3 * N * BT / 2 > (size_t)Cp * AS)
                          ? (size_t)3 * N * BT / 2 : (size_t)Cp * AS;
  unsigned short* Ss = reinterpret_cast<unsigned short*>(un);
  float* att = un;                           // (Cp, AS)
  unsigned short* vs = reinterpret_cast<unsigned short*>(un + un_f);
  float* us = reinterpret_cast<float*>(vs + PV * Cp * BT);  // (N) u
  float* bonus = us + N;                                    // (Cp)
  const int sstep = N * BT, vstep = Cp * BT;
  constexpr int nthreads = kOutThreads, nwarps = kOutThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const long long chunk = blockIdx.x;       // g-major: chunk = g·B·H + bh
  const long long BH = gridDim.x / G;
  const int g = static_cast<int>(chunk / BH);
  const long long bh = chunk % BH;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const size_t base = (((size_t)b * T + (size_t)g * C) * H + h) * N;
  const size_t rstride = (size_t)H * N;

  // stage 0: every load in flight first (S_(g-1) as float4s, then 4
  // elements of a row a thread, IT times), then the tiles, 16 bytes a
  // store (eight lanes fill the 32 banks): the chunk's rows, log w,
  // S_(g-1) in pieces, u
  constexpr int R4 = N / 4;
  constexpr int IT = (kMaxC * R4 + kOutThreads - 1) / kOutThreads;
  // S_(g-1) goes to the upper half of the block, which splits it while the
  // lower half runs the cumsum and the bonus
  constexpr int SH = kOutThreads / 2;
  constexpr int SIT = (N * N / 4 + SH - 1) / SH;
  const float4* Sg = reinterpret_cast<const float4*>(ws_s + chunk * N * N);
  float4 s4[SIT];
  if (tid >= SH) {
#pragma unroll
    for (int it = 0; it < SIT; ++it)
      if (tid - SH + it * SH < N * N / 4)
        s4[it] = __ldg(Sg + tid - SH + it * SH);
  }
  uint4 xr[IT], xk[IT], xv[IT], xw[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = tid + it * kOutThreads, c = e / R4, n = (e % R4) * 4;
    if (c < C) {
      const size_t gi = base + c * rstride + n;
      xr[it] = ld4(r, gi, RKV_BF16);
      xk[it] = ld4(k, gi, RKV_BF16);
      xv[it] = ld4(v, gi, RKV_BF16);
      xw[it] = ld4(w, gi, w_bf16);
    }
  }
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = tid + it * kOutThreads, c = e / R4, n = (e % R4) * 4;
    if (c >= Cp) break;
    const bool in = c < C;
    *reinterpret_cast<float4*>(rs + c * FC + n) =
        in ? widen4(xr[it], RKV_BF16) : z4;
    *reinterpret_cast<float4*>(ks + c * FC + n) =
        in ? widen4(xk[it], RKV_BF16) : z4;
    *reinterpret_cast<float4*>(Ls + c * FC + n) =
        in ? log4(widen4(xw[it], w_bf16)) : z4;
    store4_pieces<PV>(vs, c * BT + n, vstep,
                      in ? widen4(xv[it], RKV_BF16) : z4);
  }
  if (tid < N) us[tid] = u[h * N + tid];
  __syncthreads();
  // the cumsum (threads < N, a column each) beside the bonus (a row each;
  // N + Cp <= 128 threads) beside S_(g-1)'s split
  if (tid >= SH) {
#pragma unroll
    for (int it = 0; it < SIT; ++it) {
      const int e = tid - SH + it * SH;
      if (e >= N * N / 4) break;
      store4_pieces<3>(Ss, (e * 4 / N) * BT + (e * 4) % N, sstep, s4[it]);
    }
  } else if (tid < N) {
    cumsum_col<FC>(Ls, Lps, tid, Cp);
  } else if (tid - N < Cp) {
    const int c = tid - N;
    float acc = 0.f;  // row c from column c on: the lanes' banks differ
#pragma unroll 16
    for (int j = 0; j < N; ++j) {
      const int n = (j + c) & (N - 1);
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(rs[c * FC + n], us[n]),
                                     ks[c * FC + n]));
    }
    bonus[c] = acc;
  }
  __syncthreads();

  // stage 1: y = (r e^Lprev) @ S_(g-1), warp (a, half) on sub-chunk a's
  // rows and its half of y's column groups
  const int a = warp >> 1, half = warp & 1;
  const bool owner = warp < 2 * nsub && half * GPW < NG;
  float hi[GPW][2][4] = {}, lo[GPW][2][4] = {};
  if (owner) {
#pragma unroll
    for (int ns = 0; ns < N / 16; ++ns) {
      uint32_t af[3][4];
      a_pieces([&](int i, int j) {
        const int o = (a * 16 + i) * FC + ns * 16 + j;
        const float2 x = f2at(rs, o), lp = f2at(Lps, o);
        return make_float2(x.x * expf(lp.x), x.y * expf(lp.y));
      }, lane, af);
#pragma unroll
      for (int t = 0; t < GPW; ++t) {
        uint32_t bf[2][3][2];
        b_tiles<3, BT>(Ss, sstep, ns * 16, (half * GPW + t) * 16, lane, bf);
        mma_pieces<3>(hi[t][0], lo[t][0], af, bf[0]);
        mma_pieces<3>(hi[t][1], lo[t][1], af, bf[1]);
      }
    }
  }
  __syncthreads();  // S_(g-1)'s pieces are dead: att takes their place

  // stage 2a: the off-diagonal blocks of att, (rows of a) x (keys of
  // sub-chunk bk < a), a block a warp in turn
  for (int blk = warp; blk < nsub * (nsub - 1) / 2; blk += nwarps) {
    int ab = 1;
    while ((ab + 1) * ab / 2 <= blk) ++ab;
    const int bk = blk - ab * (ab - 1) / 2;
    const float* lst = Lps + (ab * 16) * FC;   // Lst = Lprev[16 ab]
    float bh_[2][4] = {}, bl_[2][4] = {};
#pragma unroll
    for (int ns = 0; ns < N / 16; ++ns) {
      uint32_t af[3][4];
      a_pieces([&](int i, int j) {
        const int o = (ab * 16 + i) * FC + ns * 16 + j;
        const float2 x = f2at(rs, o), lp = f2at(Lps, o);
        const float2 l0 = f2at(lst, ns * 16 + j);
        return make_float2(x.x * expf(lp.x - l0.x), x.y * expf(lp.y - l0.y));
      }, lane, af);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        uint32_t bf[3][2];
        b_pieces([&](int kk, int col) {
          const int n = ns * 16 + kk;
          const int o = (bk * 16 + t * 8 + col) * FC + n;
          const float2 x = f2at(ks, o), li = f2at(Ls, o), l0 = f2at(lst, n);
          return make_float2(x.x * expf(l0.x - li.x),
                             x.y * expf(l0.y - li.y));
        }, lane, bf);
        mma_pieces<3>(bh_[t], bl_[t], af, bf);
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(
            att + (ab * 16 + gq + 8 * hr) * AS + bk * 16 + t * 8 + 2 * q) =
            make_float2(bh_[t][2 * hr] + bl_[t][2 * hr],
                        bh_[t][2 * hr + 1] + bl_[t][2 * hr + 1]);
  }
  // stage 2b: the diagonal blocks, each pair i < s with its exact exponent
  for (int p = tid; p < nsub * kPairs; p += nthreads) {
    const int ad = p / kPairs, pq = p % kPairs;
    int s = static_cast<int>(0.5f * (1.f + sqrtf(1.f + 8.f * pq)));
    while (s * (s - 1) / 2 > pq) --s;
    while (s * (s + 1) / 2 <= pq) ++s;
    const int i = pq - s * (s - 1) / 2;
    const int rs_ = ad * 16 + s, ri = ad * 16 + i;
    const float4* rr = reinterpret_cast<const float4*>(rs + rs_ * FC);
    const float4* lp = reinterpret_cast<const float4*>(Lps + rs_ * FC);
    const float4* kk = reinterpret_cast<const float4*>(ks + ri * FC);
    const float4* li = reinterpret_cast<const float4*>(Ls + ri * FC);
    float acc = 0.f;  // from column 4i on: the lanes' banks differ
#pragma unroll 4
    for (int j = 0; j < N / 4; ++j) {
      const int n4 = (j + i) & (N / 4 - 1);
      const float4 x = rr[n4], z = kk[n4], P = lp[n4], Q = li[n4];
      acc = __fmaf_rn(x.x * z.x, expf(P.x - Q.x), acc);
      acc = __fmaf_rn(x.y * z.y, expf(P.y - Q.y), acc);
      acc = __fmaf_rn(x.z * z.z, expf(P.z - Q.z), acc);
      acc = __fmaf_rn(x.w * z.w, expf(P.w - Q.w), acc);
    }
    att[rs_ * AS + ri] = acc;
  }
  __syncthreads();

  // stage 3: y += att @ v over the keys of sub-chunks 0..a (the diagonal
  // block masked to i < s), then the bonus, and out
  if (owner) {
    for (int kb = 0; kb <= a; ++kb) {
      uint32_t af[3][4];
      a_pieces([&](int i, int j) {
        const float2 x = f2at(att, (a * 16 + i) * AS + kb * 16 + j);
        return kb < a ? x : make_float2(j < i ? x.x : 0.f,
                                        j + 1 < i ? x.y : 0.f);
      }, lane, af);
#pragma unroll
      for (int t = 0; t < GPW; ++t) {
        uint32_t bf[2][PV][2];
        b_tiles<PV, BT>(vs, vstep, kb * 16, (half * GPW + t) * 16, lane, bf);
        mma_pieces<PV>(hi[t][0], lo[t][0], af, bf[0]);
        mma_pieces<PV>(hi[t][1], lo[t][1], af, bf[1]);
      }
    }
#pragma unroll
    for (int t = 0; t < GPW; ++t)
#pragma unroll
      for (int uu = 0; uu < 2; ++uu)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int c = a * 16 + gq + 8 * hr;
          if (c >= C) continue;
          const int m = (half * GPW + t) * 16 + uu * 8 + 2 * q;
          float out[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float vv = 0.f;  // v from its pieces (their sum is exact)
#pragma unroll
            for (int pc = 0; pc < PV; ++pc)
              vv = vv + repro::bf16_lo(vs[pc * vstep + c * BT + m + e]);
            out[e] = __fadd_rn(hi[t][uu][2 * hr + e] + lo[t][uu][2 * hr + e],
                               __fmul_rn(bonus[c], vv));
          }
          *reinterpret_cast<float2*>(y + base + c * rstride + m) =
              make_float2(out[0], out[1]);
        }
  }
}

// The three launches of a call: blocks, threads and dynamic shared bytes
// of A, B and C (kernels/wkv6.py:k10_plan is their twin on the CPU, held to
// wkv6_chunked_plan on the card).  False when a grid would pass 2^31 - 1.
struct Plan {
  long long blocks[3];
  int threads[3];
  size_t smem[3];
};

bool plan_of(int B, int T, int H, int N, int C, int PV, Plan* p) {
  const int Cp = padded(C);
  const long long chunks = (long long)B * H * (T / C);
  const long long total = (long long)B * H * N * N;
  *p = Plan{{chunks, (total + kScanThreads - 1) / kScanThreads, chunks},
            {kChunkThreads, kScanThreads, kOutThreads},
            {smem_state(N, Cp, PV), 0, smem_output(N, Cp, PV)}};
  return chunks <= 0x7fffffffLL && p->blocks[1] <= 0x7fffffffLL;
}

template <int N, bool BF>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, float* y, float* sf, float* ws,
           int B, int T, int H, int C, int w_bf16, cudaStream_t st) {
  const int G = T / C;
  Plan p;
  if (!plan_of(B, T, H, N, C, BF ? 1 : 3, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = p.blocks[0];
  float* ws_d = ws;
  float* ws_e = ws + chunks * N * N;

  cudaError_t err = cudaFuncSetAttribute(
      chunk_state_kernel<N, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem[0]));
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_state_kernel<N, BF><<<static_cast<unsigned>(p.blocks[0]), p.threads[0],
                              p.smem[0], st>>>(k, v, w, ws_d, ws_e, T, H, C,
                                               G, w_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long total = (long long)B * H * N * N;
  state_scan_kernel<<<static_cast<unsigned>(p.blocks[1]), p.threads[1], 0,
                      st>>>(s0, ws_d, ws_e, sf, G, N, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(chunk_output_kernel<N, BF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.smem[2]));
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_output_kernel<N, BF><<<static_cast<unsigned>(p.blocks[2]),
                               p.threads[2], p.smem[2], st>>>(
      r, k, v, w, u, ws_d, y, T, H, C, G, w_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ws: 4·B·H·(T/C)·(N² + N) bytes (kernels/wkv6.py:k10_plan)
extern "C" int wkv6_chunked(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* y, void* sf, void* ws, int B, int T, int H,
                            int N, int C, int rkv_bf16, int w_bf16,
                            void* stream) {
  if (B < 1 || T < 1 || H < 1 || C < 1 || C > kMaxC || T % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto uf = static_cast<const float*>(u);
  const auto s0f = static_cast<const float*>(s0);
  const auto yf = static_cast<float*>(y), sff = static_cast<float*>(sf);
  const auto wsf = static_cast<float*>(ws);
#define K10_LAUNCH(NN, BF)                                                   \
  return launch<NN, BF>(r, k, v, w, uf, s0f, yf, sff, wsf, B, T, H, C,       \
                        w_bf16, st)
  if (N == 64) {
    if (rkv_bf16) K10_LAUNCH(64, true); else K10_LAUNCH(64, false);
  } else if (N == 32) {
    if (rkv_bf16) K10_LAUNCH(32, true); else K10_LAUNCH(32, false);
  } else if (N == 16) {
    if (rkv_bf16) K10_LAUNCH(16, true); else K10_LAUNCH(16, false);
  }
#undef K10_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launches a call would make: out[3i..3i+2] = blocks, threads and
// dynamic shared bytes of launch i (A, B, C), as launch() takes them.
extern "C" int wkv6_chunked_plan(int B, int T, int H, int N, int C,
                                 int rkv_bf16, int* out) {
  if (B < 1 || T < 1 || H < 1 || C < 1 || C > kMaxC || T % C != 0 ||
      (N != 16 && N != 32 && N != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  if (!plan_of(B, T, H, N, C, rkv_bf16 ? 1 : 3, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 3; ++i) {
    out[3 * i] = static_cast<int>(p.blocks[i]);
    out[3 * i + 1] = p.threads[i];
    out[3 * i + 2] = static_cast<int>(p.smem[i]);
  }
  return 0;
}
