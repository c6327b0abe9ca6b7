// K5, K5-W4, K5-VQ: out (M,N) bf16 = x (M,K) bf16 @ W, with W decoded
// in-kernel from one quantized plane exactly as unpack_leaf decodes it:
//   dpot_w8_matmul       W8 codes (K,N) u8 + scale (N,) f32
//   dpot_w4_matmul       W4 nibble pairs (K/2,N) u8 + scale (N,) f32
//   vq_matmul            VQ indices (K,N) u8 + codebook (C,) bf16, C <= 256
//   dpot_w8_matmul_f32x, dpot_w4_matmul_f32x, vq_matmul_f32x
//                        the three with an f32 x and an f32 out (M,N): the
//                        bf16 weights promoted, the sum not rounded, as
//                        fused_prefill.py:102, :131 and :161 give
//                        result_type(x, dt); the hardware numerics feed
//                        att.wo an f32 activation
// K1 and K8: out (M,N) = x (M,K) @ (sign·level(code)) · scale (N,), the
// weights the f32 values sign·level·scale (no bf16 rounding), x f32 or
// bf16 and out in x's type:
//   dpot_matmul          W8 codes (K,N) u8, level 2^-q0 + 2^-(q0+Δq1)
//   dpot_matmul_w4       W4 nibble pairs (K/2,N) u8, level 2^-Δq
//
// Replaces the TPU kernels kernels/fused_prefill.py:dpot_chunk_matmul
// (_mm_kernel), w4_chunk_matmul (_mm_kernel_w4) and vq_chunk_matmul
// (_mm_kernel_vq), and kernels/dpot_matmul.py:dpot_matmul (_kernel,
// _decode_w8) and dpot_matmul_w4 (_kernel_w4, _decode_w4).  K5 is used
// for every prefill chunk matmul (M = B·C = 128) and for the prefill and
// decode heads (M = B = 8); K1 and K8 are reached through kernels/ops.py.
//
// What bounds it on an H100: the uint8 codes.  At M <= 128 the product
// does at most 2·M = 256 operations per code byte, under the card's ~295
// flop/byte ridge, so reading the plane once (K·N bytes, K·N/2 for W4)
// at 3.35 TB/s and decoding it are the pace; the bf16 tensor cores are
// not.  The design answers that:
//   * one row tile covers every M <= 128 (BM = 16·ceil(M/16), rows past M
//     skipped a 16-row MMA tile at a time), so each code byte is read
//     from device memory once per call (more rows take more row tiles);
//   * K is cut into slices (fused_prefill.py:chunk_matmul_plan, from K
//     and N only) so the grid (N/128 column tiles × slices) has about two
//     blocks for each of the 132 SMs, or one per 16 KB of codes; slices
//     write f32 partials that a second pass sums in slice order (no
//     atomics), then rounds once to bf16 or, for an f32 x, stores f32;
//   * a 4-stage ring in shared memory holds code tiles (32 × 128 bytes)
//     and x tiles, filled by 16-byte cp.async.cg copies that stay in
//     flight while earlier stages are decoded and multiplied.  A plane
//     whose rows are not 16-byte aligned (rwkv4-169m's head, N = 50277)
//     takes the instance whose producer loads bytes;
//   * each code is decoded once per block, by table, into a bf16 tile in
//     shared memory that every row reuses: W8 a 256-entry f32 table of
//     sign·level (fused_prefill.py builds it, the same f32 value that
//     unpack_leaf forms), W4 a 16-entry one on each nibble, VQ the
//     codebook; the weight is bf16r(T[code]·scale[n]), one f32 multiply
//     and one rounding, as unpack_leaf.  The table is held in 16 copies,
//     lane l reading copy l mod 16, so a lookup conflicts on a bank at
//     most two ways.  Tile t + 1 is decoded into a second buffer while
//     the tensor cores take tile t;
//   * the products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulators in registers), fragments by ldmatrix.
// wgmma is not used: at these operation counts per byte the MMA stage is
// not the limit (ROADMAP keeps it conditional on the readings).
//
// The f32-x forms are instances of the same kernel.  Every decoded weight
// is a bf16 value, and an f32 x is split, at the fragment, into three
// bf16 pieces x0 + x1 + x2 (common.cuh: split_bf16x3, truncating, exact
// for every x whose bits reach no lower than 2^-133); each piece times a
// bf16 weight is exact in f32, so three MMAs on each decoded B fragment
// form the f32 products x·w exactly, and only the order and rounding of
// the f32 sums differ from the plain version (the bound K·2^-24·(|x|@|w|)
// that the checks hold).  Their x ring holds f32 tiles (one ring, not
// three bf16 ones: 80 KB at BM 128 against 120 KB; the split costs a few
// integer ops a value).  Three products a weight triple the MMA work, 768
// operations a code byte at M = 128, past the ridge: at att.wo's (128,
// 768, 768) the operations bound is 0.46 µs against 0.41 µs of bytes,
// both far under what 36 blocks' latency costs at that size.
//
// K1 and K8 are the EXACT instances.  The scale is one per column, so it
// factors out of the sum: out[m][n] = (Σ_k x[m][k]·sign·level[k][n])·
// scale[n].  Every level is exact in bf16 pieces: a W4 level 2^-Δq is one
// bf16 value; a W8 level is two powers of two, split into hi (the level
// with its significand cut to bf16's 7 bits) and lo = level − hi (0 when
// Δq1 <= 7, else sign·2^-(q0+Δq1)), both bf16.  Their tables
// (fused_prefill.py:piece_table) hold each code's pieces as one word, hi
// in the low 16 bits, with no scale; the decode only moves bits into one
// bf16 tile a piece (W8 two, W4 one) and rounds nothing.  Each piece of x
// times each piece of the weight is exact in f32, so a weight takes
// (x pieces)·(weight pieces) MMAs: K1 2 with a bf16 x, 6 with an f32 x;
// K8 1 and 3.  The f32 sum is multiplied by scale[n] once, after the last
// slice (in the epilogue with one slice, in the combine pass with more),
// and rounded once to x's type.  The products are exact, so only the
// order and rounding of the f32 sums, and the scale's one rounding after
// the sum instead of one per weight, differ from the plain version: the
// bound K·2^-24·(|x|@|w|) plus one step of the output's type holds.
// Identity rows give fl(level·scale), the plain version's weight, bit
// for bit.  What bounds them on an H100 (NVIDIA H100 80GB HBM3, 700 W):
// at M 8 the code plane's bytes (rwkv6-7b's head: 0.0805 ms W8, 0.0405
// W4); at M 128 the larger of those bytes and pieces·2·M·K·N bf16
// operations at 989 TFLOP/s (the head: 0.139 ms K1, 0.0695 K8, with a
// bf16 x).
//
// Batch invariance: out[m][n] is the same sequence of m16n8k16 steps over
// each slice, k ascending (for an f32 x, the x0, x1, x2 steps of each k;
// within each, the weight's pieces in order), then the slices summed in
// order, whatever M or the tile the row falls in; so a row's bits never
// depend on which other rows share the call (the plan's slices do not
// depend on M).
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

using repro::bf16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;

constexpr int BN = 128;      // output columns per block
constexpr int BK = 32;       // contraction rows per ring stage
constexpr int STAGES = 4;    // ring depth
constexpr int THREADS = 256;  // 8 warps
constexpr int XS = BK + 8;   // x tile row stride in elements (bf16 rows
                             // 80 B apart: ldmatrix without bank
                             // conflicts; f32 rows 160 B: a half-warp's
                             // 8-byte fragment loads hit 32 banks)
constexpr int BS = BN + 8;   // decoded tile row stride in bf16 (272 B)
constexpr int TCOPIES = 16;  // table copies: lanes l and l + 16 share one

struct Args {
  const void* x;          // (M, K) bf16, or f32 in the f32-x forms
  const uint8_t* codes;
  const float* scale;     // W8, W4: the (N,) channel scales
  const float* table;     // W8: (256,), W4: (16,) sign·level
  const uint32_t* pieces; // EXACT: (256,) or (16,) sign·level as bf16
                          // pieces, hi in bits 15:0, lo in 31:16
  const bf16* codebook;   // VQ: (C,)
  float* ws;              // (slices, M, N) f32 partials when slices > 1
  void* out;              // (M, N) bf16, or f32 in the f32-x forms
  int C, M, K, N, slice_len;
  int x_vec;              // x rows are whole 16-byte chunks, aligned
};

template <bool XF32>
using XType = typename std::conditional<XF32, float, bf16>::type;

__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

// four decoded weights -> one 8-byte store into the bf16 tile
__device__ __forceinline__ void store4(bf16* dst, const float* v, bool ok) {
  uint2 u;
  u.x = repro::pack_bf16_rn(ok ? v[0] : 0.f, ok ? v[1] : 0.f);
  u.y = repro::pack_bf16_rn(ok ? v[2] : 0.f, ok ? v[3] : 0.f);
  *reinterpret_cast<uint2*>(dst) = u;
}

// four piece words -> their bf16 piece HALF (0: bits 15:0, 1: 31:16), one
// 8-byte store into the bf16 tile, no rounding
template <int HALF>
__device__ __forceinline__ void store_piece4(bf16* dst, const uint32_t* p,
                                             bool ok) {
  constexpr unsigned sel = HALF ? 0x7632u : 0x5410u;
  uint2 u;
  u.x = ok ? __byte_perm(p[0], p[1], sel) : 0u;
  u.y = ok ? __byte_perm(p[2], p[3], sel) : 0u;
  *reinterpret_cast<uint2*>(dst) = u;
}

template <int PLANE, bool EXACT>
struct PlaneShape {
  static constexpr int table = PLANE == repro::kPlaneW4 ? 16 : 256;
  static constexpr int code_rows = PLANE == repro::kPlaneW4 ? BK / 2 : BK;
  // bf16 pieces a decoded weight takes: two for an exact W8 level
  static constexpr int pieces = EXACT && PLANE == repro::kPlaneW8 ? 2 : 1;
};

template <int WM, int MT, int PLANE, bool XF32, bool EXACT>
constexpr size_t smem_bytes() {
  return PlaneShape<PLANE, EXACT>::table * TCOPIES * sizeof(float) +
         STAGES * PlaneShape<PLANE, EXACT>::code_rows * BN +
         STAGES * (WM * MT * 16) * XS * sizeof(XType<XF32>) +
         2 * PlaneShape<PLANE, EXACT>::pieces * BK * BS * sizeof(bf16);
}

// One block: output rows [m0, m0 + BM) × columns [n0, n0 + BN), summed
// over the contraction rows of slice blockIdx.y.  8 warps as WM × (8/WM);
// a warp owns MT 16-row tiles × NT 8-column tiles of the output.  VEC:
// the producer copies code rows in 16-byte chunks with cp.async (N % 16
// == 0, a 16-byte aligned plane); else it loads bytes, a stage's loads
// all in flight before any is stored.  x the same way, by a.x_vec.
// XF32: x and out are f32 (the f32-x forms), x split at the fragment.
// EXACT (K1, K8): the piece tables, one bf16 tile a piece, the scale
// after the sum.
template <int WM, int MT, int PLANE, bool VEC, bool XF32, bool EXACT>
__global__ void __launch_bounds__(THREADS, WM == 1 ? 4 : (XF32 ? 1 : 2))
chunk_mm_kernel(const Args a) {
  using XT = XType<XF32>;
  constexpr int WN = 8 / WM;
  constexpr int BM = WM * MT * 16;
  constexpr int WARP_N = BN / WN;
  constexpr int NT = WARP_N / 8;
  constexpr int TLEN = PlaneShape<PLANE, EXACT>::table;
  constexpr int CROWS = PlaneShape<PLANE, EXACT>::code_rows;
  constexpr int BP = PlaneShape<PLANE, EXACT>::pieces;
  constexpr int PIECE = BK * BS;  // a decoded tile's bf16 elements
  constexpr int XCHUNK = 16 / sizeof(XT);  // x elements a 16-byte copy
  static_assert(NT % 2 == 0, "B fragments load 16 columns at a time");

  extern __shared__ __align__(16) unsigned char smem[];
  float* tab = reinterpret_cast<float*>(smem);
  uint8_t* cring = smem + TLEN * TCOPIES * sizeof(float);
  XT* xring = reinterpret_cast<XT*>(cring + STAGES * CROWS * BN);
  bf16* bdec = reinterpret_cast<bf16*>(xring + STAGES * BM * XS);

  const XT* x = static_cast<const XT*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = a.M, K = a.K, N = a.N;
  const int n0 = blockIdx.x * BN;
  const int kb = blockIdx.y * a.slice_len;
  const int ke = min(K, kb + a.slice_len);
  const int m0 = blockIdx.z * BM;
  const int mtiles = (min(BM, M - m0) + 15) / 16;
  const int ntiles_k = (ke - kb + BK - 1) / BK;

  auto load_stage = [&](int slot, int k0) {
    uint8_t* cdst = cring + slot * CROWS * BN;
    XT* xdst = xring + slot * BM * XS;
    const int c0 = PLANE == repro::kPlaneW4 ? k0 / 2 : k0;
    const int cend = PLANE == repro::kPlaneW4 ? K / 2 : K;
    if constexpr (VEC) {
      for (int c = tid; c < CROWS * (BN / 16); c += THREADS) {
        const int r = c / (BN / 16), col = (c % (BN / 16)) * 16;
        const bool ok = c0 + r < cend && n0 + col < N;
        cp_async16(cdst + r * BN + col,
                   ok ? a.codes + (size_t)(c0 + r) * N + n0 + col : a.codes,
                   ok ? 16 : 0);
      }
    } else {
      // a lane loads 4 neighbouring bytes into one word; every load of
      // the stage is issued before any word is stored.  Bytes past the
      // plane's last row or column are read from inside the plane (the
      // index clamped): the decode zeroes rows past K, and columns past N
      // are never stored
      constexpr int CW = CROWS * BN / 4 / THREADS;
      const size_t last = (size_t)cend * N - 1;
      uint32_t v[CW];
#pragma unroll
      for (int q = 0; q < CW; ++q) {
        const int i = 4 * (tid + q * THREADS);
        const size_t at = (size_t)(c0 + i / BN) * N + n0 + i % BN;
        v[q] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          v[q] |= uint32_t(__ldg(a.codes + (at + b < last ? at + b : last)))
                  << (8 * b);
      }
#pragma unroll
      for (int q = 0; q < CW; ++q)
        *reinterpret_cast<uint32_t*>(cdst + 4 * (tid + q * THREADS)) = v[q];
    }
    if (a.x_vec) {
      for (int c = tid; c < BM * (BK / XCHUNK); c += THREADS) {
        const int r = c / (BK / XCHUNK), col = (c % (BK / XCHUNK)) * XCHUNK;
        const bool ok = m0 + r < M && k0 + col < K;
        cp_async16(xdst + r * XS + col,
                   ok ? x + (size_t)(m0 + r) * K + k0 + col : x,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, col = i % BK;
        const bool ok = m0 + r < M && k0 + col < K;
        if constexpr (XF32)
          xdst[r * XS + col] = ok ? x[(size_t)(m0 + r) * K + k0 + col] : 0.f;
        else
          xdst[r * XS + col] = ok ? x[(size_t)(m0 + r) * K + k0 + col]
                                  : __float2bfloat16_rn(0.f);
      }
    }
  };

  // the ring's first stages go out before the table is staged
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles_k) load_stage(s, kb + s * BK);
    cp_async_commit();
  }

  // the table: one load a lane, then entry e's copies at tab[e·TCOPIES +
  // c], lane l reading copy l mod TCOPIES
  for (int e0 = warp * 32; e0 < TLEN; e0 += THREADS) {
    const int e = e0 + lane;
    float v = 0.f;
    if constexpr (PLANE == repro::kPlaneVQ)
      v = e < a.C ? repro::bf2f(a.codebook[e]) : 0.f;
    else if constexpr (EXACT)
      v = e < TLEN ? __uint_as_float(a.pieces[e]) : 0.f;
    else if (e < TLEN)
      v = a.table[e];
    for (int j = 0; j < min(32, TLEN - e0); ++j) {
      const float vj = __shfl_sync(0xffffffffu, v, j);
      if (lane < TCOPIES) tab[(e0 + j) * TCOPIES + lane] = vj;
    }
  }
  // this thread decodes columns n0 + 4·lane + j of every tile row it owns
  float sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 4 * lane + j;
    sc[j] = PLANE != repro::kPlaneVQ && !EXACT && n < N ? a.scale[n] : 0.f;
  }
  const int tl = lane & (TCOPIES - 1);

  // tile t's codes -> its bf16 weights in dst (an EXACT W8 tile: hi at
  // dst, lo at dst + PIECE); each warp takes whole rows, a lane 4 columns
  // (one u32)
  auto decode = [&](int t, bf16* dst) {
    const uint8_t* csrc = cring + (t % STAGES) * CROWS * BN;
    const int k0 = kb + t * BK;
#pragma unroll
    for (int i = 0; i < CROWS / 8; ++i) {
      const int r = warp + 8 * i;
      const uint32_t w =
          *reinterpret_cast<const uint32_t*>(csrc + r * BN + 4 * lane);
      if constexpr (EXACT && PLANE == repro::kPlaneW4) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b = (w >> (8 * j)) & 0xFFu;
          lo[j] = __float_as_uint(tab[(b & 15u) * TCOPIES + tl]);
          hi[j] = __float_as_uint(tab[(b >> 4) * TCOPIES + tl]);
        }
        const bool ok = k0 + 2 * r < K;
        store_piece4<0>(dst + (2 * r) * BS + 4 * lane, lo, ok);
        store_piece4<0>(dst + (2 * r + 1) * BS + 4 * lane, hi, ok);
      } else if constexpr (EXACT) {
        uint32_t p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[j] = __float_as_uint(
              tab[((w >> (8 * j)) & 0xFFu) * TCOPIES + tl]);
        const bool ok = k0 + r < K;
        store_piece4<0>(dst + r * BS + 4 * lane, p, ok);
        store_piece4<1>(dst + PIECE + r * BS + 4 * lane, p, ok);
      } else if constexpr (PLANE == repro::kPlaneW4) {
        float lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b = (w >> (8 * j)) & 0xFFu;
          lo[j] = tab[(b & 15u) * TCOPIES + tl] * sc[j];
          hi[j] = tab[(b >> 4) * TCOPIES + tl] * sc[j];
        }
        const bool ok = k0 + 2 * r < K;  // K is even: both rows or neither
        store4(dst + (2 * r) * BS + 4 * lane, lo, ok);
        store4(dst + (2 * r + 1) * BS + 4 * lane, hi, ok);
      } else {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = tab[((w >> (8 * j)) & 0xFFu) * TCOPIES + tl];
          v[j] = PLANE == repro::kPlaneVQ ? e : e * sc[j];
        }
        store4(dst + r * BS + 4 * lane, v, k0 + r < K);
      }
    }
  };

  const int wm = warp / WN, wn = warp % WN;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // acc += x tile t · the decoded tile (its BP pieces) in src, k16 step
  // by k16 step
  auto multiply = [&](int t, const bf16* src) {
    const XT* xs = xring + (t % STAGES) * BM * XS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t bfr[BP][NT][2];
#pragma unroll
      for (int q = 0; q < BP; ++q)
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t r4[4];
          ldmatrix_x4_trans(r4, src + q * PIECE + (kk + (lane & 15)) * BS +
                                    wn * WARP_N + p * 16 + (lane >> 4) * 8);
          bfr[q][2 * p][0] = r4[0];
          bfr[q][2 * p][1] = r4[1];
          bfr[q][2 * p + 1][0] = r4[2];
          bfr[q][2 * p + 1][1] = r4[3];
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int gt = wm * MT + mt;
        if (gt >= mtiles) continue;
        if constexpr (XF32) {
          // the A fragment's 8 values of this lane (rows g, g + 8; columns
          // 2c, 2c + 1, 2c + 8, 2c + 9), each split in three; piece p of
          // all 8 forms the A fragment of the p-th product
          const float* xr =
              xs + (gt * 16 + (lane >> 2)) * XS + kk + 2 * (lane & 3);
          const float2 v[4] = {
              *reinterpret_cast<const float2*>(xr),
              *reinterpret_cast<const float2*>(xr + 8 * XS),
              *reinterpret_cast<const float2*>(xr + 8),
              *reinterpret_cast<const float2*>(xr + 8 * XS + 8)};
          uint32_t afr[3][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            uint32_t lo[3], hi[3];
            repro::split_bf16x3(v[r].x, lo);
            repro::split_bf16x3(v[r].y, hi);
#pragma unroll
            for (int p = 0; p < 3; ++p)
              afr[p][r] = repro::pack_bf16_bits(lo[p], hi[p]);
          }
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int q = 0; q < BP; ++q)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma_bf16(acc[mt][nt], afr[p], bfr[q][nt]);
        } else {
          uint32_t afr[4];
          ldmatrix_x4(afr, xs + (gt * 16 + (lane & 15)) * XS + kk +
                               (lane >> 4) * 8);
#pragma unroll
          for (int q = 0; q < BP; ++q)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16(acc[mt][nt], afr, bfr[q][nt]);
        }
      }
    }
  };

  // tile 0 is decoded before the loop; step t decodes tile t + 1 into the
  // other buffer while the tensor cores take tile t: one barrier a step
  cp_async_wait<STAGES - 2>();
  __syncthreads();  // tile 0 and the table are in shared memory
  decode(0, bdec);
  for (int t = 0; t < ntiles_k; ++t) {
    cp_async_wait<STAGES - 3>();
    __syncthreads();  // tile t + 1 landed, tile t decoded; t - 1 is done
    {
      const int tn = t + STAGES - 1;  // into the slot tile t - 1 left
      if (tn < ntiles_k) load_stage(tn % STAGES, kb + tn * BK);
      cp_async_commit();
    }
    if (t + 1 < ntiles_k) decode(t + 1, bdec + ((t + 1) & 1) * BP * PIECE);
    multiply(t, bdec + (t & 1) * BP * PIECE);
  }
  cp_async_wait<0>();

  // the accumulators: (row g, cols 2c, 2c+1) and (row g + 8, the same);
  // EXACT: a whole sum times its column's scale
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const bool partial = gridDim.y > 1;
  XT* out = static_cast<XT*>(a.out);
  auto final_value = [&](float v, int n) {
    if constexpr (EXACT) return v * a.scale[n];
    return v;
  };
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int gt = wm * MT + mt;
    if (gt >= mtiles) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + wn * WARP_N + nt * 8 + c2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + gt * 16 + g + 8 * h;
        if (m >= M) continue;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (partial) {
          float* dst = a.ws + ((size_t)blockIdx.y * M + m) * N + n;
          if (n < N) dst[0] = v0;
          if (n + 1 < N) dst[1] = v1;
        } else {
          XT* dst = out + (size_t)m * N + n;
          if (n < N) store_out(dst, final_value(v0, n));
          if (n + 1 < N) store_out(dst + 1, final_value(v1, n + 1));
        }
      }
    }
  }
}

// out = ws[0] + ws[1] + ... + ws[S-1], in that order, times scale[n]
// when a scale is given (K1, K8; none for K5), rounded once to bf16 or
// stored as f32
template <typename OutT>
__global__ void combine_slices_kernel(const float* __restrict__ ws,
                                      const float* __restrict__ scale,
                                      OutT* __restrict__ out, size_t MN,
                                      int N, int S) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int t = 1; t < S; ++t) s += ws[t * MN + i];
    if (scale) s = s * scale[i % N];
    store_out(out + i, s);
  }
}

template <int WM, int MT, int PLANE, bool VEC, bool XF32, bool EXACT>
cudaError_t launch_tile(const Args& a, dim3 grid, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<WM, MT, PLANE, XF32, EXACT>();
  static int sized_on = -1;  // the device whose limit was raised last
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != sized_on) {
    e = cudaFuncSetAttribute(
        chunk_mm_kernel<WM, MT, PLANE, VEC, XF32, EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    sized_on = dev;
  }
  chunk_mm_kernel<WM, MT, PLANE, VEC, XF32, EXACT>
      <<<grid, THREADS, bytes, s>>>(a);
  return cudaGetLastError();
}

template <int PLANE, bool VEC, bool XF32, bool EXACT>
cudaError_t launch_rows(const Args& a, dim3 grid, bool small,
                        cudaStream_t s) {
  return small ? launch_tile<1, 1, PLANE, VEC, XF32, EXACT>(a, grid, s)
               : launch_tile<2, 4, PLANE, VEC, XF32, EXACT>(a, grid, s);
}

// The plan comes from fused_prefill.py:chunk_matmul_plan; it is checked
// here against the tile this file compiles.  `vec` picks the producers:
// bit 0 copies code rows by cp.async, bit 1 x rows.
template <int PLANE, bool XF32, bool EXACT = false>
int launch(Args a, int bm, int bn, int bk, int slices, int vec,
           void* stream) {
  a.x_vec = (vec >> 1) & 1;
  const int M = a.M, K = a.K, N = a.N;
  if (M < 1 || K < 1 || N < 1 || bn != BN || bk != BK || bm % 16 ||
      bm != std::min(128, 16 * ((M + 15) / 16)) || a.slice_len < BK ||
      a.slice_len % BK || slices != (K + a.slice_len - 1) / a.slice_len ||
      (slices > 1 && a.ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = bm <= 16;
  const dim3 grid((N + BN - 1) / BN, slices, small ? 1 : (M + 127) / 128);
  const cudaError_t e =
      vec & 1 ? launch_rows<PLANE, true, XF32, EXACT>(a, grid, small, s)
              : launch_rows<PLANE, false, XF32, EXACT>(a, grid, small, s);
  if (e != cudaSuccess || slices == 1) return static_cast<int>(e);
  const size_t MN = (size_t)M * N;
  const int blocks = (int)std::min<size_t>((MN + 255) / 256, 132 * 8);
  combine_slices_kernel<<<blocks, 256, 0, s>>>(
      a.ws, EXACT ? a.scale : nullptr, static_cast<XType<XF32>*>(a.out), MN,
      N, slices);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* x, const void* codes, void* ws, void* out, int M,
               int K, int N, int slice_len) {
  Args a{};
  a.x = x;
  a.codes = static_cast<const uint8_t*>(codes);
  a.ws = static_cast<float*>(ws);
  a.out = out;
  a.M = M;
  a.K = K;
  a.N = N;
  a.slice_len = slice_len;
  return a;
}

template <bool XF32>
int w8(const void* x, const void* wq, const void* scale, const void* table,
       void* ws, void* out, int M, int K, int N, int bm, int bn, int bk,
       int slice_len, int slices, int vec, void* stream) {
  Args a = make_args(x, wq, ws, out, M, K, N, slice_len);
  a.scale = static_cast<const float*>(scale);
  a.table = static_cast<const float*>(table);
  return launch<repro::kPlaneW8, XF32>(a, bm, bn, bk, slices, vec, stream);
}

template <bool XF32>
int w4(const void* x, const void* wq4, const void* scale, const void* table,
       void* ws, void* out, int M, int K, int N, int bm, int bn, int bk,
       int slice_len, int slices, int vec, void* stream) {
  if (K % 2) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, wq4, ws, out, M, K, N, slice_len);
  a.scale = static_cast<const float*>(scale);
  a.table = static_cast<const float*>(table);
  return launch<repro::kPlaneW4, XF32>(a, bm, bn, bk, slices, vec, stream);
}

// K1 (W8) and K8 (W4): the EXACT instances; x_bf16 picks x's type
template <int PLANE>
int dpot(const void* x, const void* codes, const void* scale,
         const void* pieces, void* ws, void* out, int M, int K, int N, int bm,
         int bn, int bk, int slice_len, int slices, int vec, int x_bf16,
         void* stream) {
  if (PLANE == repro::kPlaneW4 && K % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, codes, ws, out, M, K, N, slice_len);
  a.scale = static_cast<const float*>(scale);
  a.pieces = static_cast<const uint32_t*>(pieces);
  return x_bf16
             ? launch<PLANE, false, true>(a, bm, bn, bk, slices, vec, stream)
             : launch<PLANE, true, true>(a, bm, bn, bk, slices, vec, stream);
}

template <bool XF32>
int vq(const void* x, const void* idx, const void* codebook, int C, void* ws,
       void* out, int M, int K, int N, int bm, int bn, int bk, int slice_len,
       int slices, int vec, void* stream) {
  if (C < 1 || C > 256) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, idx, ws, out, M, K, N, slice_len);
  a.codebook = static_cast<const bf16*>(codebook);
  a.C = C;
  return launch<repro::kPlaneVQ, XF32>(a, bm, bn, bk, slices, vec, stream);
}

}  // namespace

// x (M, K) bf16 -> out (M, N) bf16.  table: (256,) f32 sign·level
// (fused_prefill.py:decode_table); ws: (slices, M, N) f32 when slices > 1
extern "C" int dpot_w8_matmul(const void* x, const void* wq, const void* scale,
                              const void* table, void* ws, void* out, int M,
                              int K, int N, int bm, int bn, int bk,
                              int slice_len, int slices, int vec,
                              void* stream) {
  return w8<false>(x, wq, scale, table, ws, out, M, K, N, bm, bn, bk,
                   slice_len, slices, vec, stream);
}

// wq4 (K/2, N): contraction row k is nibble k & 1 of packed row k / 2;
// table (16,) f32
extern "C" int dpot_w4_matmul(const void* x, const void* wq4,
                              const void* scale, const void* table, void* ws,
                              void* out, int M, int K, int N, int bm, int bn,
                              int bk, int slice_len, int slices, int vec,
                              void* stream) {
  return w4<false>(x, wq4, scale, table, ws, out, M, K, N, bm, bn, bk,
                   slice_len, slices, vec, stream);
}

// idx (K, N) indices into codebook (C,) bf16, 1 <= C <= 256
extern "C" int vq_matmul(const void* x, const void* idx, const void* codebook,
                         int C, void* ws, void* out, int M, int K, int N,
                         int bm, int bn, int bk, int slice_len, int slices,
                         int vec, void* stream) {
  return vq<false>(x, idx, codebook, C, ws, out, M, K, N, bm, bn, bk,
                   slice_len, slices, vec, stream);
}

// The f32-x forms: x (M, K) f32 -> out (M, N) f32, the same arguments
extern "C" int dpot_w8_matmul_f32x(const void* x, const void* wq,
                                   const void* scale, const void* table,
                                   void* ws, void* out, int M, int K, int N,
                                   int bm, int bn, int bk, int slice_len,
                                   int slices, int vec, void* stream) {
  return w8<true>(x, wq, scale, table, ws, out, M, K, N, bm, bn, bk,
                  slice_len, slices, vec, stream);
}

extern "C" int dpot_w4_matmul_f32x(const void* x, const void* wq4,
                                   const void* scale, const void* table,
                                   void* ws, void* out, int M, int K, int N,
                                   int bm, int bn, int bk, int slice_len,
                                   int slices, int vec, void* stream) {
  return w4<true>(x, wq4, scale, table, ws, out, M, K, N, bm, bn, bk,
                  slice_len, slices, vec, stream);
}

extern "C" int vq_matmul_f32x(const void* x, const void* idx,
                              const void* codebook, int C, void* ws,
                              void* out, int M, int K, int N, int bm, int bn,
                              int bk, int slice_len, int slices, int vec,
                              void* stream) {
  return vq<true>(x, idx, codebook, C, ws, out, M, K, N, bm, bn, bk,
                  slice_len, slices, vec, stream);
}

// K1: x (M, K) bf16 (x_bf16 = 1) or f32 (0) @ W8 codes wq (K, N) with
// scale (N,) f32 -> out (M, N) in x's type.  pieces: (256,) u32
// (fused_prefill.py:piece_table); the plan and ws as K5's
extern "C" int dpot_matmul(const void* x, const void* wq, const void* scale,
                           const void* pieces, void* ws, void* out, int M,
                           int K, int N, int bm, int bn, int bk,
                           int slice_len, int slices, int vec, int x_bf16,
                           void* stream) {
  return dpot<repro::kPlaneW8>(x, wq, scale, pieces, ws, out, M, K, N, bm,
                               bn, bk, slice_len, slices, vec, x_bf16,
                               stream);
}

// K8: wq4 (K/2, N), contraction row k nibble k & 1 of packed row k / 2;
// pieces (16,) u32
extern "C" int dpot_matmul_w4(const void* x, const void* wq4,
                              const void* scale, const void* pieces, void* ws,
                              void* out, int M, int K, int N, int bm, int bn,
                              int bk, int slice_len, int slices, int vec,
                              int x_bf16, void* stream) {
  return dpot<repro::kPlaneW4>(x, wq4, scale, pieces, ws, out, M, K, N, bm,
                               bn, bk, slice_len, slices, vec, x_bf16,
                               stream);
}
