// K13: fused flash-attention forward.  q (B, Sq, H, d), k and v
// (B, Skv, KVH, d), f32 or bf16; out (B, Sq, H, d) in q's type and,
// when asked, lse (B, H, Sq) f32.  Query head h reads kv head
// h / (H / KVH) (GQA), indexed here: k and v are never repeated.
//
// Replaces the TPU kernel kernels/flash_attention.py:_kernel_fwd (the
// forward of flash_attention, reached through _fwd_call).  Its numerics:
// q·scale in f32 first, f32 scores, the causal mask kpos <= qpos setting
// a score to -1e30, an online softmax with running m, l and acc in f32,
// p·v with the f32 p, out = acc / max(l, 1e-30) rounded once, lse = m +
// log(max(l, 1e-30)).
//
// What bounds it on an H100: operations.  Causal at smollm-135m's prefill
// (B 8, S 2048, H 9, d 64) the two products are 38.7 GFLOP, >= 0.039 ms at
// the 989 TFLOP/s bf16 tensor-core peak, against 50.3 MB of q, k, v and
// out (>= 0.015 ms at 3.35 TB/s).  The bf16 kernel answers with the
// tensor cores, in the FlashAttention-2 shape:
//   * a block owns 16·WARPS query rows of one (batch, head), a warp 16 of
//     them, its q fragments in registers for the whole key loop (8 warps
//     at d <= 64, at the 128-register cap for two blocks an SM; 4 at d <=
//     128, whose accumulators take ~205 registers); the grid walks the
//     query tiles last first, so under the causal mask the longest tiles
//     start first and the short ones fill the last wave;
//   * 64-key tiles of k and v, bf16, go through a two-stage ring in shared
//     memory by 16-byte cp.async (rows padded by 16 bytes: ldmatrix
//     without bank conflicts); the q tile is staged in the second stage
//     before the loop, so shared memory holds the ring alone;
//   * t = q·kᵀ on the raw bf16 q and k (mma.sync m16n8k16, bf16 in, f32
//     accumulators; each product is exact in f32), so s = t·scale, and
//     for d = 16 and 64 that is JAX's q·scale first exactly (a power of
//     two);
//   * d is zero-padded to a multiple of 16 (instances for d <= 64 and d <=
//     128, the k16 steps past the padded d skipped);
//   * the online softmax runs in f32 registers on t, a row's max and sum
//     reduced over its 4 lanes by shuffles: p = 2^(t·c - m·c) with c =
//     scale·log2(e), one fused multiply-add and one exp2 a score (a few
//     ulps from JAX's exp(s - m), which the output and lse bounds of the
//     checks allow), and lse = m·scale + log(l); only tiles that cross
//     the diagonal or the ragged Skv edge are masked, and a warp skips a
//     tile whose keys all lie past its rows;
//   * p·v keeps p's f32 precision: p is split into bf16 pieces straight
//     from the score accumulators (their m16n8 layout is the A operand's,
//     FlashAttention-2's register reuse), p_hi = bf16(p), p_lo = bf16(p -
//     p_hi), and acc += p_hi·v + p_lo·v (`repro::c_to_a_pieces`).  Two
//     pieces leave |p - p_hi - p_lo| <= 2^-17·p, 128 units of 2^-24
//     against the (Skv + d + 8) units of the f32 summation floor that the
//     checks allow, so only a short Skv + d + 8 < 128 could miss it; a
//     third piece, bf16(p - p_hi - p_lo), would make the split exact, and
//     no check has needed it.  Rounding p to bf16 once, as FlashAttention
//     does, leaves up to 2^-8·p, 2^16 units.
// wgmma and TMA are not used: the readings (PERF.md) decide whether a
// later redesign takes them.
//
// The f32 instance (f32 q, k, v) keeps the CUDA-core loop of the first
// port: no model path runs K13 in f32 (the f32 witnesses run the plain
// attention), and an exact bf16 split of f32 q, k, v and p would cost
// about nine products a pair.  One block of 256 threads owns one (batch,
// head) and 64 query rows; a 16x16 thread grid gives each thread 4 rows x
// 4 keys of the score tile and 4 rows x d/16 columns of acc, tiles staged
// as f32 by plain loads.
//
// Keys past Skv and rows past Sq are masked here, so any Sq and Skv work
// (the TPU kernel halved its block instead).  A row's bits do not depend
// on the batch or the other heads that share the call.
#include "common.cuh"

namespace {

using repro::bf16;

constexpr int BKV = 64;        // keys a tile
constexpr float NEG_INF = -1e30f;
constexpr int PIECES = 2;      // bf16 pieces of p in p·v

// ---- bf16: tensor cores --------------------------------------------------

// the ring: two stages of (k, v) tiles, rows of D + 8 bf16 (padded by 16
// bytes); the q tile borrows stage 1
template <int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * 2 * 2 * BKV * (D + 8);
}

template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, D <= 64 ? 2 : 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int Sq, int Skv, int H, int KVH,
                    int d, int causal, float scale, int vec) {
  constexpr int BQ = 16 * WARPS;
  constexpr int LD = D + 8;              // tile row stride in bf16
  constexpr int KC = D / 16;             // k16 steps of q·kᵀ, at most
  constexpr int NTHREADS = WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  auto ks = [&](int st) { return ring + st * 2 * BKV * LD; };
  auto vs = [&](int st) { return ring + st * 2 * BKV * LD + BKV * LD; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last tile first
  const int dpad = (d + 15) & ~15;
  const int dch = dpad / 16;
  const float c = scale * 1.4426950408889634f;  // scale·log2(e)
  const long long qrow = (long long)H * d;      // one position of q / out
  const long long krow = (long long)KVH * d;    // one position of k / v
  const bf16* qb = q + (long long)b * Sq * qrow + (long long)h * d;
  const bf16* kb = k + (long long)b * Skv * krow + (long long)kvh * d;
  const bf16* vb = v + (long long)b * Skv * krow + (long long)kvh * d;

  // keys past the block's last row never count under the causal mask
  const int last = min(q0 + BQ, Sq);
  const int kv_end = causal ? min(Skv, last) : Skv;
  const int ntiles = (kv_end + BKV - 1) / BKV;

  // the q tile into stage 1, k and v tile 0 into stage 0
  repro::load_tile<LD>(ks(1), qb, q0, BQ, Sq, qrow, d, dpad, vec, tid,
                       NTHREADS);
  repro::load_tile<LD>(ks(0), kb, 0, BKV, Skv, krow, d, dpad, vec, tid,
                       NTHREADS);
  repro::load_tile<LD>(vs(0), vb, 0, BKV, Skv, krow, d, dpad, vec, tid,
                       NTHREADS);
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    if (kc < dch)
      repro::ldmatrix_x4(qf[kc], ks(1) + (warp * 16 + (lane & 15)) * LD +
                                     kc * 16 + (lane >> 4) * 8);
  __syncthreads();  // stage 1 is free for tile 1

  // this lane's rows: g and g + 8 of the warp's 16
  const int row0 = q0 + warp * 16 + g;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int st = (t + 1) & 1;
      repro::load_tile<LD>(ks(st), kb, (t + 1) * BKV, BKV, Skv, krow, d,
                           dpad, vec, tid, NTHREADS);
      repro::load_tile<LD>(vs(st), vb, (t + 1) * BKV, BKV, Skv, krow, d,
                           dpad, vec, tid, NTHREADS);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<1>();
    __syncthreads();  // tile t is in shared memory for every warp

    const int k0 = t * BKV;
    // a warp whose rows all precede this tile's keys has nothing in it
    if (!(causal && k0 > q0 + warp * 16 + 15)) {
      const bf16* kt = ks(t & 1);
      const bf16* vt = vs(t & 1);
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (kc >= dch) continue;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t r[4];
          repro::ldmatrix_x4(r, kt + (np * 16 + (lane & 7) +
                                      ((lane >> 4) << 3)) * LD +
                                    kc * 16 + ((lane >> 3) & 1) * 8);
          repro::mma_bf16(s[2 * np], qf[kc], r);
          repro::mma_bf16(s[2 * np + 1], qf[kc], r + 2);
        }
      }

      // the online softmax on the raw score t (see the header)
      const bool edge = k0 + BKV > Skv || (causal && k0 + BKV - 1 > row0 -
                                                                     g);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge) {
            const int kpos = k0 + j * 8 + 2 * c4 + (e & 1);
            const int qpos = row0 + 8 * (e >> 1);
            if (kpos >= Skv || (causal && kpos > qpos)) s[j][e] = NEG_INF;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float alpha[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f((m[i] - m_new) * c);
        m[i] = m_new;
        mc[i] = m_new * c;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked score is -1e30 below a finite running max (key 0 is
          // in every row's first tile), so its p is 0 as in the TPU kernel
          const float p = exp2f(__fmaf_rn(s[j][e], c, -mc[e >> 1]));
          s[j][e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] = l[i] * alpha[i] + rs[i];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

      // acc += p·v, 16 keys a step, p in PIECES bf16 pieces
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) {
        uint32_t pa[PIECES][4];
        repro::c_to_a_pieces<PIECES>(s[2 * kc], s[2 * kc + 1], pa);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          if (dp >= dch) continue;
          uint32_t r[4];
          repro::ldmatrix_x4_trans(r, vt + (kc * 16 + (lane & 15)) * LD +
                                          dp * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int pc = 0; pc < PIECES; ++pc) {
            repro::mma_bf16(o[2 * dp], pa[pc], r);
            repro::mma_bf16(o[2 * dp + 1], pa[pc], r + 2);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage t & 1
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = row0 + 8 * i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    bf16* orow = out + ((long long)b * Sq + qpos) * qrow + (long long)h * d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * c4 + e;
        if (col < d) orow[col] = __float2bfloat16_rn(o[j][2 * i + e] / denom);
      }
    if (lse != nullptr && c4 == 0)
      lse[((long long)b * H + h) * Sq + qpos] = m[i] * scale + logf(denom);
  }
}

template <int D, int WARPS>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int Sq, int Skv, int H, int KVH, int d,
              int causal, float scale, int vec, cudaStream_t s) {
  constexpr int BQ = 16 * WARPS;
  const size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D, WARPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_tc_kernel<D, WARPS><<<grid, WARPS * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Sq, Skv, H,
      KVH, d, causal, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: the CUDA-core loop ---------------------------------------------

constexpr int F_BQ = 64;         // query rows a block
constexpr int F_THREADS = 256;   // a 16 x 16 grid

template <int DMAX>
constexpr size_t f32_smem_bytes() {
  // Qs and Ks padded by one word a row (conflict-free column reads), Vs,
  // and the probability tile Ps padded the same way
  return sizeof(float) * (F_BQ * (DMAX + 1) + BKV * (DMAX + 1) +
                          BKV * DMAX + F_BQ * (BKV + 1));
}

template <int DMAX>
__global__ void __launch_bounds__(F_THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Skv, int H,
                     int KVH, int d, int causal, float scale) {
  constexpr int QLD = DMAX + 1;
  constexpr int PLD = BKV + 1;
  constexpr int NC = DMAX / 16;            // acc columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                        // F_BQ x QLD: q * scale
  float* Ks = Qs + F_BQ * QLD;             // BKV x QLD
  float* Vs = Ks + BKV * QLD;              // BKV x DMAX
  float* Ps = Vs + BKV * DMAX;             // F_BQ x PLD: this tile's p

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.y * F_BQ;
  const long long qrow = (long long)H * d;      // one position of q / out
  const long long krow = (long long)KVH * d;    // one position of k / v
  const float* qb = q + (long long)b * Sq * qrow + (long long)h * d;
  const float* kb = k + (long long)b * Skv * krow + (long long)kvh * d;
  const float* vb = v + (long long)b * Skv * krow + (long long)kvh * d;

  for (int i = tid; i < F_BQ * DMAX; i += F_THREADS) {
    const int r = i / DMAX, c = i % DMAX;
    Qs[r * QLD + c] =
        (q0 + r < Sq && c < d) ? qb[(q0 + r) * qrow + c] * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // keys past the block's last row never count under the causal mask
  const int last = min(q0 + F_BQ, Sq);
  const int kv_end = causal ? min(Skv, last) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();                       // the last tile's readers are done
    for (int i = tid; i < BKV * DMAX; i += F_THREADS) {
      const int r = i / DMAX, c = i % DMAX;
      const bool in = k0 + r < Skv && c < d;
      Ks[r * QLD + c] = in ? kb[(k0 + r) * krow + c] : 0.f;
      Vs[r * DMAX + c] = in ? vb[(k0 + r) * krow + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QLD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QLD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Skv && (!causal || kpos <= qpos);
        if (!ok[j]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();                       // Ps complete

#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PLD + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[j * DMAX + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = out + ((long long)b * Sq + qpos) * qrow + (long long)h * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) orow[col] = acc[i][c] / denom;
    }
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Sq + qpos] = m[i] + logf(denom);
  }
}

template <int DMAX>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Sq, int Skv, int H, int KVH, int d,
               int causal, float scale, cudaStream_t s) {
  const size_t smem = f32_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((Sq + F_BQ - 1) / F_BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * H, (Sq + F_BQ - 1) / F_BQ);
  flash_fwd_f32_kernel<DMAX><<<grid, F_THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Skv,
      H, KVH, d, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); lse:
// (B, H, Sq) f32 or null; scale = f32(1 / sqrt(d)); vec: bf16 rows copied
// in 16-byte chunks (d % 8 == 0 and q, k, v 16-byte aligned), else loaded
// an element at a time.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int B, int Sq, int Skv, int H, int KVH,
                                   int d, int causal, int is_bf16,
                                   float scale, int vec, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || H < 1 || KVH < 1 || H % KVH != 0 ||
      d < 1 || d > 128 || (vec && d % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  if (is_bf16)
    return d <= 64 ? launch_tc<64, 8>(q, k, v, out, lp, B, Sq, Skv, H, KVH,
                                      d, causal, scale, vec, s)
                   : launch_tc<128, 4>(q, k, v, out, lp, B, Sq, Skv, H, KVH,
                                       d, causal, scale, vec, s);
  return d <= 64 ? launch_f32<64>(q, k, v, out, lp, B, Sq, Skv, H, KVH, d,
                                  causal, scale, s)
                 : launch_f32<128>(q, k, v, out, lp, B, Sq, Skv, H, KVH, d,
                                   causal, scale, s);
}
