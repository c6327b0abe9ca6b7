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
//
// Replaces the TPU kernels kernels/fused_prefill.py:dpot_chunk_matmul
// (_mm_kernel), w4_chunk_matmul (_mm_kernel_w4) and vq_chunk_matmul
// (_mm_kernel_vq).  Used for every prefill chunk matmul (M = B·C = 128)
// and for the prefill and decode heads (M = B = 8).
//
// What bounds it on an H100: the uint8 codes.  At M <= 128 the product
// does at most 2·M = 256 operations per code byte, under the card's ~295
// flop/byte ridge, so reading the plane once (K·N bytes, K·N/2 for W4)
// at 3.35 TB/s and decoding it are the pace; the bf16 tensor cores are
// not.  The design answers that:
//   * one row tile covers every M <= 128 (BM = 16·ceil(M/16), rows past M
//     skipped a 16-row MMA tile at a time), so each code byte is read
//     from device memory once per call;
//   * K is cut into slices (fused_prefill.py:chunk_matmul_plan, from K
//     and N only) so the grid (N/128 column tiles × slices) has about two
//     blocks for each of the 132 SMs, or one per 16 KB of codes; slices
//     write f32 partials that a second pass sums in slice order and
//     rounds once (no atomics);
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
// Batch invariance: out[m][n] is the same sequence of m16n8k16 steps over
// each slice, k ascending, then the slices summed in order, whatever M
// or the tile the row falls in; so a row's bits never depend on which
// other rows share the call (the plan's slices do not depend on M).
//
// The f32-x forms keep a CUDA-core loop (an f32 x has no bf16 tensor-core
// form that keeps its sum; TF32 would round x): out[m][n] accumulates
// x[m][k]·w[k][n] with fmaf for k = 0..K-1 in order, the weight decoded by
// the plane's policy (common.cuh: Decode, which K7 shares).
#include <algorithm>

#include "common.cuh"

namespace {

using repro::bf16;

constexpr int BN = 128;      // output columns per block
constexpr int BK = 32;       // contraction rows per ring stage
constexpr int STAGES = 4;    // ring depth
constexpr int THREADS = 256;  // 8 warps
constexpr int XS = BK + 8;   // x tile row stride in bf16 (ldmatrix rows
                             // 80 B apart: no bank conflicts)
constexpr int BS = BN + 8;   // decoded tile row stride in bf16 (272 B)
constexpr int TCOPIES = 16;  // table copies: lanes l and l + 16 share one

struct Args {
  const bf16* x;
  const uint8_t* codes;
  const float* scale;     // W8, W4: the (N,) channel scales
  const float* table;     // W8: (256,), W4: (16,) sign·level
  const bf16* codebook;   // VQ: (C,)
  float* ws;              // (slices, M, N) f32 partials when slices > 1
  bf16* out;
  int C, M, K, N, slice_len;
  int x_vec;              // x rows are whole 16-byte chunks, aligned
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) · b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four decoded weights -> one 8-byte store into the bf16 tile
__device__ __forceinline__ void store4(bf16* dst, const float* v, bool ok) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(ok ? v[0] : 0.f, ok ? v[1] : 0.f);
  __nv_bfloat162 hi = __floats2bfloat162_rn(ok ? v[2] : 0.f, ok ? v[3] : 0.f);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

template <int PLANE>
struct PlaneShape {
  static constexpr int table = PLANE == repro::kPlaneW4 ? 16 : 256;
  static constexpr int code_rows = PLANE == repro::kPlaneW4 ? BK / 2 : BK;
};

template <int WM, int MT, int PLANE>
constexpr size_t smem_bytes() {
  return PlaneShape<PLANE>::table * TCOPIES * sizeof(float) +
         STAGES * PlaneShape<PLANE>::code_rows * BN +
         STAGES * (WM * MT * 16) * XS * sizeof(bf16) +
         2 * BK * BS * sizeof(bf16);
}

// One block: output rows [m0, m0 + BM) × columns [n0, n0 + BN), summed
// over the contraction rows of slice blockIdx.y.  8 warps as WM × (8/WM);
// a warp owns MT 16-row tiles × NT 8-column tiles of the output.  VEC:
// the producer copies code rows in 16-byte chunks with cp.async (N % 16
// == 0, a 16-byte aligned plane); else it loads bytes, a stage's loads
// all in flight before any is stored.  x the same way, by a.x_vec.
template <int WM, int MT, int PLANE, bool VEC>
__global__ void __launch_bounds__(THREADS, WM == 1 ? 4 : 2)
chunk_mm_kernel(const Args a) {
  constexpr int WN = 8 / WM;
  constexpr int BM = WM * MT * 16;
  constexpr int WARP_N = BN / WN;
  constexpr int NT = WARP_N / 8;
  constexpr int TLEN = PlaneShape<PLANE>::table;
  constexpr int CROWS = PlaneShape<PLANE>::code_rows;
  static_assert(NT % 2 == 0, "B fragments load 16 columns at a time");

  extern __shared__ __align__(16) unsigned char smem[];
  float* tab = reinterpret_cast<float*>(smem);
  uint8_t* cring = smem + TLEN * TCOPIES * sizeof(float);
  bf16* xring = reinterpret_cast<bf16*>(cring + STAGES * CROWS * BN);
  bf16* bdec = xring + STAGES * BM * XS;

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
    bf16* xdst = xring + slot * BM * XS;
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
      for (int c = tid; c < BM * (BK / 8); c += THREADS) {
        const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
        const bool ok = m0 + r < M && k0 + col < K;
        cp_async16(xdst + r * XS + col,
                   ok ? a.x + (size_t)(m0 + r) * K + k0 + col : a.x,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, col = i % BK;
        xdst[r * XS + col] = m0 + r < M && k0 + col < K
                                 ? a.x[(size_t)(m0 + r) * K + k0 + col]
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
    sc[j] = PLANE != repro::kPlaneVQ && n < N ? a.scale[n] : 0.f;
  }
  const int tl = lane & (TCOPIES - 1);

  // tile t's codes -> its bf16 weights in dst; each warp takes whole
  // rows, a lane 4 columns (one u32)
  auto decode = [&](int t, bf16* dst) {
    const uint8_t* csrc = cring + (t % STAGES) * CROWS * BN;
    const int k0 = kb + t * BK;
#pragma unroll
    for (int i = 0; i < CROWS / 8; ++i) {
      const int r = warp + 8 * i;
      const uint32_t w =
          *reinterpret_cast<const uint32_t*>(csrc + r * BN + 4 * lane);
      if constexpr (PLANE == repro::kPlaneW4) {
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

  // acc += x tile t · the decoded tile in src, k16 step by k16 step
  auto multiply = [&](int t, const bf16* src) {
    const bf16* xs = xring + (t % STAGES) * BM * XS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t bfr[NT][2];
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, src + (kk + (lane & 15)) * BS + wn * WARP_N +
                                  p * 16 + (lane >> 4) * 8);
        bfr[2 * p][0] = r4[0];
        bfr[2 * p][1] = r4[1];
        bfr[2 * p + 1][0] = r4[2];
        bfr[2 * p + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int gt = wm * MT + mt;
        if (gt < mtiles) {
          uint32_t afr[4];
          ldmatrix_x4(afr, xs + (gt * 16 + (lane & 15)) * XS + kk +
                               (lane >> 4) * 8);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], afr, bfr[nt]);
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
    if (t + 1 < ntiles_k) decode(t + 1, bdec + ((t + 1) & 1) * BK * BS);
    multiply(t, bdec + (t & 1) * BK * BS);
  }
  cp_async_wait<0>();

  // the accumulators: (row g, cols 2c, 2c+1) and (row g + 8, the same)
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const bool partial = gridDim.y > 1;
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
          bf16* dst = a.out + (size_t)m * N + n;
          if (n < N) dst[0] = __float2bfloat16_rn(v0);
          if (n + 1 < N) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// out = bf16(ws[0] + ws[1] + ... + ws[S-1]), in that order
__global__ void combine_slices_kernel(const float* __restrict__ ws,
                                      bf16* __restrict__ out, size_t MN,
                                      int S) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int t = 1; t < S; ++t) s += ws[t * MN + i];
    out[i] = __float2bfloat16_rn(s);
  }
}

template <int WM, int MT, int PLANE, bool VEC>
cudaError_t launch_tile(const Args& a, dim3 grid, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<WM, MT, PLANE>();
  static int sized_on = -1;  // the device whose limit was raised last
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != sized_on) {
    e = cudaFuncSetAttribute(chunk_mm_kernel<WM, MT, PLANE, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return e;
    sized_on = dev;
  }
  chunk_mm_kernel<WM, MT, PLANE, VEC><<<grid, THREADS, bytes, s>>>(a);
  return cudaGetLastError();
}

template <int PLANE, bool VEC>
cudaError_t launch_rows(const Args& a, dim3 grid, bool small,
                        cudaStream_t s) {
  return small ? launch_tile<1, 1, PLANE, VEC>(a, grid, s)
               : launch_tile<2, 4, PLANE, VEC>(a, grid, s);
}

// The plan comes from fused_prefill.py:chunk_matmul_plan; it is checked
// here against the tile this file compiles.  `vec` picks the producers:
// bit 0 copies code rows by cp.async, bit 1 x rows.
template <int PLANE>
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
  const cudaError_t e = vec & 1
                            ? launch_rows<PLANE, true>(a, grid, small, s)
                            : launch_rows<PLANE, false>(a, grid, small, s);
  if (e != cudaSuccess || slices == 1) return static_cast<int>(e);
  const size_t MN = (size_t)M * N;
  const int blocks = (int)std::min<size_t>((MN + 255) / 256, 132 * 8);
  combine_slices_kernel<<<blocks, 256, 0, s>>>(a.ws, a.out, MN, slices);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* x, const void* codes, void* ws, void* out, int M,
               int K, int N, int slice_len) {
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.codes = static_cast<const uint8_t*>(codes);
  a.ws = static_cast<float*>(ws);
  a.out = static_cast<bf16*>(out);
  a.M = M;
  a.K = K;
  a.N = N;
  a.slice_len = slice_len;
  return a;
}

// K5 f32-x: one thread a column, TM rows a block, k in order with fmaf,
// each weight decoded by the plane's policy (common.cuh: Decode), the
// column's scale read once.
constexpr int FX_TM = 16;  // rows of x a block
constexpr int FX_BK = 64;  // K tile of x staged in shared memory

template <int TM, int PLANE>
__global__ void __launch_bounds__(BN)
matmul_f32x_kernel(const float* __restrict__ x, const repro::Matrix w,
                   float* __restrict__ out, int M, int K, int N) {
  using Dec = repro::Decode<PLANE>;
  __shared__ float xs[TM][FX_BK];
  const int n = blockIdx.x * BN + threadIdx.x;
  const int m0 = blockIdx.y * TM;
  const bool col_ok = n < N;  // ragged N edge (V = 50277 is odd)
  const float cp = col_ok ? Dec::col(w, n) : 0.f;
  float acc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FX_BK) {
    for (int i = threadIdx.x; i < TM * FX_BK; i += BN) {
      const int r = i / FX_BK, c = i % FX_BK;
      const int m = m0 + r, k = k0 + c;
      xs[r][c] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
    __syncthreads();
    const int kn = min(FX_BK, K - k0);
    if (col_ok) {
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float wv = Dec::at(w, k0 + kk, n, N, cp);
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i] = fmaf(xs[i][kk], wv, acc[i]);
      }
    }
    __syncthreads();
  }
  if (col_ok) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + i;
      if (m < M) out[(size_t)m * N + n] = acc[i];
    }
  }
}

}  // namespace

// table: (256,) f32 sign·level (fused_prefill.py:decode_table); ws:
// (slices, M, N) f32 when slices > 1
extern "C" int dpot_w8_matmul(const void* x, const void* wq, const void* scale,
                              const void* table, void* ws, void* out, int M,
                              int K, int N, int bm, int bn, int bk,
                              int slice_len, int slices, int vec,
                              void* stream) {
  Args a = make_args(x, wq, ws, out, M, K, N, slice_len);
  a.scale = static_cast<const float*>(scale);
  a.table = static_cast<const float*>(table);
  return launch<repro::kPlaneW8>(a, bm, bn, bk, slices, vec, stream);
}

// wq4 (K/2, N): contraction row k is nibble k & 1 of packed row k / 2;
// table (16,) f32
extern "C" int dpot_w4_matmul(const void* x, const void* wq4,
                              const void* scale, const void* table, void* ws,
                              void* out, int M, int K, int N, int bm, int bn,
                              int bk, int slice_len, int slices, int vec,
                              void* stream) {
  if (K % 2) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, wq4, ws, out, M, K, N, slice_len);
  a.scale = static_cast<const float*>(scale);
  a.table = static_cast<const float*>(table);
  return launch<repro::kPlaneW4>(a, bm, bn, bk, slices, vec, stream);
}

extern "C" int vq_matmul(const void* x, const void* idx, const void* codebook,
                         int C, void* ws, void* out, int M, int K, int N,
                         int bm, int bn, int bk, int slice_len, int slices,
                         int vec, void* stream) {
  if (C < 1 || C > 256) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, idx, ws, out, M, K, N, slice_len);
  a.codebook = static_cast<const bf16*>(codebook);
  a.C = C;
  return launch<repro::kPlaneVQ>(a, bm, bn, bk, slices, vec, stream);
}

namespace {

// codes and aux: the plane's codes and its f32 scale or bf16 codebook
template <int PLANE>
int launch_f32x(const void* x, const void* codes, const void* aux, void* out,
                int M, int K, int N, void* stream) {
  if (M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const repro::Matrix w{static_cast<const uint8_t*>(codes), aux, PLANE, 0};
  const dim3 grid((N + BN - 1) / BN, (M + FX_TM - 1) / FX_TM);
  matmul_f32x_kernel<FX_TM, PLANE>
      <<<grid, BN, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), w, static_cast<float*>(out), M, K,
          N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) f32 -> out (M, N) f32
extern "C" int dpot_w8_matmul_f32x(const void* x, const void* wq,
                                   const void* scale, void* out, int M, int K,
                                   int N, void* stream) {
  return launch_f32x<repro::kPlaneW8>(x, wq, scale, out, M, K, N, stream);
}

// wq4 (K/2, N), K even
extern "C" int dpot_w4_matmul_f32x(const void* x, const void* wq4,
                                   const void* scale, void* out, int M, int K,
                                   int N, void* stream) {
  if (K % 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32x<repro::kPlaneW4>(x, wq4, scale, out, M, K, N, stream);
}

// idx (K, N) indices into codebook (C,) bf16, 1 <= C <= 256
extern "C" int vq_matmul_f32x(const void* x, const void* idx,
                              const void* codebook, int C, void* out, int M,
                              int K, int N, void* stream) {
  if (C < 1 || C > 256) return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32x<repro::kPlaneVQ>(x, idx, codebook, out, M, K, N, stream);
}
