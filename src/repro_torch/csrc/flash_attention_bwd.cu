// K13's backward: the dq kernel (K13-dq) and the dk/dv kernel (K13-dkv).
// q, dout (B, Sq, H, d) and k, v (B, Skv, KVH, d), f32 or bf16; lse and
// delta (B, H, Sq) f32; dq in q's type, dk and dv in k's.  Query head h
// reads kv head h / (H / KVH) (GQA), indexed here: k and v are never
// repeated.
//
// Replaces the TPU kernels kernels/flash_attention.py:_kernel_dq and
// _kernel_dkv (launched by _bwd_call under the custom VJP).  Their
// numerics, in f32: the scores s = (q·scale)·k with the causal mask
// kpos <= qpos (both counted from 0), p = exp(s - lse) from the forward's
// lse (a masked pair's p is 0), dp = dout·v, ds = p·(dp - delta) with
// delta = rowsum(dout ∘ out) (computed by the wrapper, as JAX computes it
// outside its Pallas calls), dq = scale·Σ_k ds·k, dk = scale·Σ_q ds·q,
// dv = Σ_q p·dout.  Each output is rounded once to its type.  The TPU
// kernel's dk and dv are per query head, rounded to the input type and
// then summed over the group by jnp.repeat's transpose; K13-dkv sums the
// H / KVH heads of a group in f32 inside the block and rounds once.
//
// Deterministic: every output element is written by one thread, which
// sums in a fixed order; no float atomics.
//
// What bounds them on an H100: operations.  Causal at smollm-135m's train
// shape (B 8, S 2048, H 9, KVH 3, d 64) one dot is 2·B·H·S²·d·½ = 19.33
// GFLOP; dq runs 3 (s, dp, dq) = 58.0 GFLOP, >= 0.0586 ms at the 989
// TFLOP/s bf16 tensor-core peak, and dkv 4 (s, dp, dk, dv) = 77.3 GFLOP,
// >= 0.0782 ms.
//
// The bf16 kernels answer with the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulators), in FlashAttention-2's backward shape split
// in two kernels, and keep this numerics contract:
//   * t = q·kᵀ and dp = dout·vᵀ on the raw bf16 operands: every product
//     is exact in f32;
//   * p = exp2(fma(t, c, -lse·log2(e))) with c = scale·log2(e), the
//     forward's form on the forward's natural-log lse (for d 16 and 64 the
//     scale is a power of two, so s = t·scale is JAX's q·scale first
//     exactly); a masked pair's p is 0;
//   * ds = p·(dp - delta) in f32 registers;
//   * the three products with an f32 operand (dq += ds·k, dk += dsᵀ·q, dv
//     += pᵀ·dout) take p or ds in two bf16 pieces, hi = bf16(x) and lo =
//     bf16(x - hi), built straight from the accumulators (the m16n8 C
//     fragment is the next product's A fragment: `repro::c_to_a_pieces`),
//     so |x - hi - lo| <= 2^-17·|x|, 128 units of 2^-24, inside the f32
//     summation floor (rep·Sq + Skv + d + 8)·2^-24 that the checks allow
//     (8,264 units at the train shape); one bf16 rounding, as
//     FlashAttention takes, would leave 2^-8·|x|, 2^16 units;
//   * the scale once, on the finished sum; dk and dv sum the GQA group in
//     f32 and round once.
// d is zero-padded to a multiple of 16 (instances for d <= 64 and d <=
// 128; the k16 steps past the padded d skipped).  Tiles go through a
// two-stage ring in shared memory by 16-byte cp.async (rows padded by 16
// bytes: ldmatrix without bank conflicts), or by element loads where rows
// are not 16-byte aligned (`vec` 0).
//
// K13-dq (`flash_dq_tc_kernel`): a block owns 16·WARPS query rows of one
// (batch, head), a warp 16 of them, its q and dout A fragments in
// registers for the whole key loop (8 warps at d <= 64, two blocks an SM
// at the 128-register cap; 4 at d <= 128), lse·log2(e) and delta in
// registers per row; 64-key k and v tiles through the ring (q and dout
// borrow its two stages first).  Per 16-key step: t and dp take k and v
// as the B operand by ldmatrix, ds·k takes k by ldmatrix.trans (as the
// forward's p·v takes v).  The grid walks query tiles last first, so under
// the causal mask the longest tiles start first; only steps that cross the
// diagonal or the ragged Skv edge are masked, and a warp skips a step
// whose keys all lie past its rows.
//
// K13-dkv (`flash_dkv_tc_kernel`): keys are the MMA rows.  A block owns 64
// keys of one (batch, kv head g), 4 warps of 16, and loops over the H /
// KVH query heads of the group and, for each, over 64-row query tiles
// from the diagonal down; the q and dout tiles go through the ring with
// their lse and delta (64 floats each, by 4-byte cp.async).  sᵀ = k·qᵀ and
// dpᵀ = v·doutᵀ take q and dout as B by ldmatrix; dv += pᵀ·dout and dk +=
// dsᵀ·q take them by ldmatrix.trans.  The k and v A fragments stay in
// registers at d <= 64 (three blocks an SM); at d <= 128 the dk and dv
// accumulators take 128 registers, so k and v stay in shared memory and
// each step loads their fragments (two blocks an SM).  Key tiles are
// walked first to last: under the causal mask the first keys see the
// most rows and start first.
//
// wgmma and TMA are not used: the readings (PERF.md) decide whether a
// later redesign takes them.
//
// The f32 instances (f32 q, k, v, dout) keep the CUDA-core loop of the
// first port: no model path runs K13 in f32 (the f32 witnesses run the
// plain attention), and an exact bf16 split of f32 q, k and v would cost
// about nine products a pair.  K13-dq: one block of 256 threads a (batch,
// query head, 64-row query tile), q·scale and dout in shared memory,
// 64-key tiles up to the diagonal; a 16x16 thread grid gives each thread
// 4 rows x 4 keys of s, dp and ds, and 4 rows x d/16 columns of dq; ds
// goes through shared memory to the ds·k product.  K13-dkv: one block a
// (batch, kv head, 64-key tile), k and v in shared memory, the group's
// query heads and their 64-row tiles from the diagonal down; each thread
// holds 4 keys x 4 rows of the transposed s, dp, p and ds, and 4 keys x
// d/16 columns of dk and dv.
//
// Rows past Sq and keys past Skv are masked here (their p is 0 and their
// q, dout, k, v load as 0), so any Sq and Skv work.
#include "common.cuh"

namespace {

using repro::bf16;

constexpr int BQ = 64;         // query rows a tile (f32 kernels; K13-dkv)
constexpr int BKV = 64;        // keys a tile (K13-dq) or a block (K13-dkv)
constexpr int PIECES = 2;      // bf16 pieces of p and ds
constexpr float LOG2E = 1.4426950408889634f;

// ---- bf16: tensor cores --------------------------------------------------

// K13-dq's ring: two stages of (k, v) tiles, rows of D + 8 bf16; q and
// dout (16·WARPS <= 128 rows each) borrow stage 1 and stage 0 first
template <int D>
constexpr size_t dq_tc_smem_bytes() {
  return sizeof(bf16) * 2 * 2 * BKV * (D + 8);
}

template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 2)
flash_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int Sq, int Skv, int H, int KVH, int d, int causal,
                   float scale, int vec) {
  constexpr int BQW = 16 * WARPS;        // query rows a block
  constexpr int LD = D + 8;              // tile row stride in bf16
  constexpr int KC = D / 16;             // k16 steps over d, at most
  constexpr int NTHREADS = WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  auto ks = [&](int st) { return ring + st * 2 * BKV * LD; };
  auto vs = [&](int st) { return ring + st * 2 * BKV * LD + BKV * LD; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQW;  // last tile first
  const int dpad = (d + 15) & ~15;
  const int dch = dpad / 16;
  const float c = scale * LOG2E;                 // scale·log2(e)
  const long long qrow = (long long)H * d;       // one position of q / dout
  const long long krow = (long long)KVH * d;     // one position of k / v
  const long long qoff = (long long)b * Sq * qrow + (long long)h * d;
  const bf16* kb = k + (long long)b * Skv * krow + (long long)kvh * d;
  const bf16* vb = v + (long long)b * Skv * krow + (long long)kvh * d;

  // keys past the block's last row never count under the causal mask
  const int last = min(q0 + BQW, Sq);
  const int kv_end = causal ? min(Skv, last) : Skv;
  const int ntiles = (kv_end + BKV - 1) / BKV;

  // q into stage 1, dout into stage 0; their fragments into registers
  repro::load_tile<LD>(ks(1), q + qoff, q0, BQW, Sq, qrow, d, dpad, vec,
                       tid, NTHREADS);
  repro::load_tile<LD>(ks(0), dout + qoff, q0, BQW, Sq, qrow, d, dpad, vec,
                       tid, NTHREADS);
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KC][4], of[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    if (kc < dch) {
      const int at = (warp * 16 + (lane & 15)) * LD + kc * 16 +
                     (lane >> 4) * 8;
      repro::ldmatrix_x4(qf[kc], ks(1) + at);
      repro::ldmatrix_x4(of[kc], ks(0) + at);
    }
  __syncthreads();  // both stages are free for the k and v tiles

  // this lane's rows: g and g + 8 of the warp's 16
  const int wrow = q0 + warp * 16;
  const int row0 = wrow + g;
  float nl[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = row0 + 8 * i;
    const long long at = ((long long)b * H + h) * Sq + qpos;
    nl[i] = qpos < Sq ? -(lse[at] * LOG2E) : 0.f;
    dl[i] = qpos < Sq ? delta[at] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  repro::load_tile<LD>(ks(0), kb, 0, BKV, Skv, krow, d, dpad, vec, tid,
                       NTHREADS);
  repro::load_tile<LD>(vs(0), vb, 0, BKV, Skv, krow, d, dpad, vec, tid,
                       NTHREADS);
  repro::cp_async_commit();
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

    const bf16* kt = ks(t & 1);
    const bf16* vt = vs(t & 1);
#pragma unroll
    for (int sb = 0; sb < BKV / 16; ++sb) {
      const int kb0 = t * BKV + sb * 16;
      // keys all past Skv, or all past the warp's rows: nothing here
      if (kb0 >= Skv || (causal && kb0 > wrow + 15)) continue;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (kc >= dch) continue;
        const int at = (sb * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kc * 16 + ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        repro::ldmatrix_x4(r, kt + at);
        repro::mma_bf16(s[0], qf[kc], r);
        repro::mma_bf16(s[1], qf[kc], r + 2);
        repro::ldmatrix_x4(r, vt + at);
        repro::mma_bf16(dp[0], of[kc], r);
        repro::mma_bf16(dp[1], of[kc], r + 2);
      }
      // p, then ds into s (see the header); only edge steps are masked
      const bool edge = kb0 + 16 > Skv || (causal && kb0 + 15 > wrow);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = exp2f(__fmaf_rn(s[j][e], c, nl[i]));
          if (edge) {
            const int kpos = kb0 + j * 8 + 2 * c4 + (e & 1);
            if (kpos >= Skv || (causal && kpos > row0 + 8 * i)) p = 0.f;
          }
          s[j][e] = p * (dp[j][e] - dl[i]);
        }
      // dq += ds·k, ds in PIECES bf16 pieces
      uint32_t a[PIECES][4];
      repro::c_to_a_pieces<PIECES>(s[0], s[1], a);
#pragma unroll
      for (int dc = 0; dc < D / 16; ++dc) {
        if (dc >= dch) continue;
        uint32_t r[4];
        repro::ldmatrix_x4_trans(r, kt + (sb * 16 + (lane & 15)) * LD +
                                        dc * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int pc = 0; pc < PIECES; ++pc) {
          repro::mma_bf16(acc[2 * dc], a[pc], r);
          repro::mma_bf16(acc[2 * dc + 1], a[pc], r + 2);
        }
      }
    }
    __syncthreads();  // every warp is done with stage t & 1
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = row0 + 8 * i;
    if (qpos >= Sq) continue;
    bf16* row = dq + ((long long)b * Sq + qpos) * qrow + (long long)h * d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * c4 + e;
        if (col < d) row[col] = __float2bfloat16_rn(scale * acc[j][2 * i + e]);
      }
  }
}

// K13-dkv's shared memory: the block's k and v tiles (BKV rows each), then
// a two-stage ring whose stage holds a (q, dout) tile pair and the tile's
// lse and delta
template <int D>
__host__ __device__ constexpr size_t dkv_stage_bytes() {
  return sizeof(bf16) * 2 * BQ * (D + 8) + sizeof(float) * 2 * BQ;
}
template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  return sizeof(bf16) * 2 * BKV * (D + 8) + 2 * dkv_stage_bytes<D>();
}

template <int D>
__global__ void __launch_bounds__(128, D <= 64 ? 3 : 2)
flash_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int Sq, int Skv, int H, int KVH,
                    int d, int causal, float scale, int vec) {
  constexpr int NTHREADS = 128;          // 4 warps, 16 keys each
  constexpr int LD = D + 8;
  constexpr int KC = D / 16;
  constexpr bool KV_REGS = D <= 64;      // k, v A fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kvs = reinterpret_cast<bf16*>(smem_raw);     // k, then v
  unsigned char* ring = smem_raw + sizeof(bf16) * 2 * BKV * LD;
  auto qs = [&](int st) {
    return reinterpret_cast<bf16*>(ring + st * dkv_stage_bytes<D>());
  };
  auto os = [&](int st) { return qs(st) + BQ * LD; };
  auto ls = [&](int st) {
    return reinterpret_cast<float*>(qs(st) + 2 * BQ * LD);
  };
  auto dls = [&](int st) { return ls(st) + BQ; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int bg = blockIdx.x, b = bg / KVH, grp = bg % KVH;
  const int rep = H / KVH;
  const int k0 = blockIdx.y * BKV;
  const int kw = k0 + warp * 16;                 // the warp's first key
  const int dpad = (d + 15) & ~15;
  const int dch = dpad / 16;
  const float c = scale * LOG2E;
  const long long qrow = (long long)H * d;
  const long long krow = (long long)KVH * d;
  const long long koff = (long long)b * Skv * krow + (long long)grp * d;

  // a query tile whose last row lies before the first key sees none of
  // the block's keys under the causal mask
  const int q_start = causal ? (k0 / BQ) * BQ : 0;
  const int ntq = q_start < Sq ? (Sq - q_start + BQ - 1) / BQ : 0;
  const int ntiles = rep * ntq;        // (query head, query tile) pairs
  auto load_stage = [&](int t, int st) {
    const int h = grp * rep + t / ntq;
    const int qt0 = q_start + (t % ntq) * BQ;
    const long long qoff = (long long)b * Sq * qrow + (long long)h * d;
    repro::load_tile<LD>(qs(st), q + qoff, qt0, BQ, Sq, qrow, d, dpad, vec,
                         tid, NTHREADS);
    repro::load_tile<LD>(os(st), dout + qoff, qt0, BQ, Sq, qrow, d, dpad,
                         vec, tid, NTHREADS);
    const long long at = ((long long)b * H + h) * Sq + qt0;
    for (int i = tid; i < BQ; i += NTHREADS) {
      const bool ok = qt0 + i < Sq;
      repro::cp_async4(ls(st) + i, ok ? lse + at + i : lse, ok ? 4 : 0);
      repro::cp_async4(dls(st) + i, ok ? delta + at + i : delta,
                       ok ? 4 : 0);
    }
  };

  repro::load_tile<LD>(kvs, k + koff, k0, BKV, Skv, krow, d, dpad, vec, tid,
                       NTHREADS);
  repro::load_tile<LD>(kvs + BKV * LD, v + koff, k0, BKV, Skv, krow, d,
                       dpad, vec, tid, NTHREADS);
  if (ntiles > 0) load_stage(0, 0);
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();
  // the warp's k and v A fragments: k16 step kc at kfrag(kc) / vfrag(kc)
  const int arow = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t kf[KV_REGS ? KC : 1][4], vf[KV_REGS ? KC : 1][4];
  if constexpr (KV_REGS) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      if (kc < dch) {
        repro::ldmatrix_x4(kf[kc], kvs + arow + kc * 16);
        repro::ldmatrix_x4(vf[kc], kvs + BKV * LD + arow + kc * 16);
      }
  }

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_stage(t + 1, (t + 1) & 1);
    repro::cp_async_commit();
    repro::cp_async_wait<1>();
    __syncthreads();  // tile t is in shared memory for every warp

    const int st = t & 1;
    const int qt0 = q_start + (t % ntq) * BQ;
    const bf16* qt = qs(st);
    const bf16* ot = os(st);
    const float* lt = ls(st);
    const float* dlt = dls(st);
#pragma unroll
    for (int sb = 0; sb < BQ / 16; ++sb) {
      const int qb0 = qt0 + sb * 16;
      // rows all past Sq, or all before the warp's keys: nothing here
      if (qb0 >= Sq || (causal && qb0 + 15 < kw)) continue;
      // sᵀ (keys g, g + 8 x this step's 16 rows) and dpᵀ
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (kc >= dch) continue;
        const int at = (sb * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kc * 16 + ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        if constexpr (KV_REGS) {
          repro::ldmatrix_x4(r, qt + at);
          repro::mma_bf16(s[0], kf[kc], r);
          repro::mma_bf16(s[1], kf[kc], r + 2);
          repro::ldmatrix_x4(r, ot + at);
          repro::mma_bf16(dp[0], vf[kc], r);
          repro::mma_bf16(dp[1], vf[kc], r + 2);
        } else {
          uint32_t af[4];
          repro::ldmatrix_x4(af, kvs + arow + kc * 16);
          repro::ldmatrix_x4(r, qt + at);
          repro::mma_bf16(s[0], af, r);
          repro::mma_bf16(s[1], af, r + 2);
          repro::ldmatrix_x4(af, kvs + BKV * LD + arow + kc * 16);
          repro::ldmatrix_x4(r, ot + at);
          repro::mma_bf16(dp[0], af, r);
          repro::mma_bf16(dp[1], af, r + 2);
        }
      }
      // pᵀ into s, dsᵀ into dp; a column's lse and delta serve both rows
      const bool edge = qb0 + 16 > Sq || (causal && qb0 < kw + 15);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int eo = 0; eo < 2; ++eo) {
          const int col = sb * 16 + j * 8 + 2 * c4 + eo;
          const float nl = -(lt[col] * LOG2E), dlc = dlt[col];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 2 * i + eo;
            float p = exp2f(__fmaf_rn(s[j][e], c, nl));
            if (edge) {
              const int qpos = qt0 + col;
              if (qpos >= Sq || (causal && kw + g + 8 * i > qpos)) p = 0.f;
            }
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - dlc);
          }
        }
      // dv += pᵀ·dout, dk += dsᵀ·q, p and ds in PIECES bf16 pieces
      uint32_t pa[PIECES][4], sa[PIECES][4];
      repro::c_to_a_pieces<PIECES>(s[0], s[1], pa);
      repro::c_to_a_pieces<PIECES>(dp[0], dp[1], sa);
#pragma unroll
      for (int dc = 0; dc < D / 16; ++dc) {
        if (dc >= dch) continue;
        const int at = (sb * 16 + (lane & 15)) * LD + dc * 16 +
                       (lane >> 4) * 8;
        uint32_t r[4];
        repro::ldmatrix_x4_trans(r, ot + at);
#pragma unroll
        for (int pc = 0; pc < PIECES; ++pc) {
          repro::mma_bf16(dva[2 * dc], pa[pc], r);
          repro::mma_bf16(dva[2 * dc + 1], pa[pc], r + 2);
        }
        repro::ldmatrix_x4_trans(r, qt + at);
#pragma unroll
        for (int pc = 0; pc < PIECES; ++pc) {
          repro::mma_bf16(dka[2 * dc], sa[pc], r);
          repro::mma_bf16(dka[2 * dc + 1], sa[pc], r + 2);
        }
      }
    }
    __syncthreads();  // every warp is done with stage t & 1
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = kw + g + 8 * i;
    if (kpos >= Skv) continue;
    const long long at = ((long long)b * Skv + kpos) * krow +
                         (long long)grp * d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * c4 + e;
        if (col < d) {
          dk[at + col] = __float2bfloat16_rn(scale * dka[j][2 * i + e]);
          dv[at + col] = __float2bfloat16_rn(dva[j][2 * i + e]);
        }
      }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int D, int WARPS>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int B, int Sq, int Skv, int H, int KVH, int d,
                 int causal, float scale, int vec, cudaStream_t s) {
  constexpr int BQW = 16 * WARPS;
  const size_t smem = dq_tc_smem_bytes<D>();
  if (int err = set_smem(flash_dq_tc_kernel<D, WARPS>, smem)) return err;
  const dim3 grid(B * H, (Sq + BQW - 1) / BQW);
  flash_dq_tc_kernel<D, WARPS><<<grid, WARPS * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dq), Sq, Skv, H, KVH, d, causal, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int B, int Sq, int Skv, int H, int KVH,
                  int d, int causal, float scale, int vec, cudaStream_t s) {
  const size_t smem = dkv_tc_smem_bytes<D>();
  if (int err = set_smem(flash_dkv_tc_kernel<D>, smem)) return err;
  const dim3 grid(B * KVH, (Skv + BKV - 1) / BKV);
  flash_dkv_tc_kernel<D><<<grid, 128, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Skv, H,
      KVH, d, causal, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: the CUDA-core loop ---------------------------------------------

constexpr int THREADS = 256;   // a 16 x 16 grid

// q·scale, dout, k and v tiles padded by one word a row (conflict-free
// column reads), and the ds tile
template <int DMAX>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * BQ * (DMAX + 1) + BQ * (BKV + 1));
}

// k, v, q and dout tiles padded the same way, and the transposed p and ds
// tiles
template <int DMAX>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * BQ * (DMAX + 1) + 2 * BKV * (BQ + 1));
}

// Loads rows [r0, r0 + 64) of head `head` of a (B, S, heads, d) tensor
// into a 64 x LD f32 tile, times `mul`; rows past S and columns past d
// load as 0.
template <int DMAX>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* base,
                                              long long row, int r0, int S,
                                              int d, float mul) {
  constexpr int LD = DMAX + 1;
  for (int i = threadIdx.x; i < 64 * DMAX; i += THREADS) {
    const int r = i / DMAX, c = i % DMAX;
    dst[r * LD + c] =
        (r0 + r < S && c < d) ? base[(r0 + r) * row + c] * mul : 0.f;
  }
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int Sq, int Skv, int H, int KVH, int d, int causal,
                float scale) {
  constexpr int LD = DMAX + 1;
  constexpr int PLD = BKV + 1;
  constexpr int NC = DMAX / 16;            // dq columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                        // BQ x LD: q * scale
  float* dOs = Qs + BQ * LD;               // BQ x LD
  float* Ks = dOs + BQ * LD;               // BKV x LD
  float* Vs = Ks + BKV * LD;               // BKV x LD
  float* dSs = Vs + BKV * LD;              // BQ x PLD: this tile's ds

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.y * BQ;
  const long long qrow = (long long)H * d;      // one position of q / dout
  const long long krow = (long long)KVH * d;    // one position of k / v
  const long long qoff = (long long)b * Sq * qrow + (long long)h * d;
  const float* kb = k + (long long)b * Skv * krow + (long long)kvh * d;
  const float* vb = v + (long long)b * Skv * krow + (long long)kvh * d;

  load_tile_f32<DMAX>(Qs, q + qoff, qrow, q0, Sq, d, scale);
  load_tile_f32<DMAX>(dOs, dout + qoff, qrow, q0, Sq, d, 1.f);
  float lse_r[4], dl_r[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    const long long at = ((long long)b * H + h) * Sq + qpos;
    lse_r[i] = qpos < Sq ? lse[at] : 0.f;
    dl_r[i] = qpos < Sq ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // keys past the tile's last row never count under the causal mask
  const int last = min(q0 + BQ, Sq);
  const int kv_end = causal ? min(Skv, last) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();                       // the last tile's readers are done
    load_tile_f32<DMAX>(Ks, kb, krow, k0, Skv, d, 1.f);
    load_tile_f32<DMAX>(Vs, vb, krow, k0, Skv, d, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LD + c];
        ov[i] = dOs[(ty + 16 * i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + c];
        vv[j] = Vs[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = qpos < Sq && kpos < Skv && (!causal || kpos <= qpos);
        const float p = ok ? expf(s[i][j] - lse_r[i]) : 0.f;
        dSs[(ty + 16 * i) * PLD + tx + 16 * j] = p * (dp[i][j] - dl_r[i]);
      }
    }
    __syncthreads();                       // dSs complete

#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * PLD + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kk = Ks[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    float* row = dq + ((long long)b * Sq + qpos) * qrow + (long long)h * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) row[col] = scale * acc[i][c];
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int Sq, int Skv, int H, int KVH,
                 int d, int causal, float scale) {
  constexpr int LD = DMAX + 1;
  constexpr int PQ = BQ + 1;
  constexpr int NC = DMAX / 16;            // dk, dv columns a thread
  extern __shared__ float smem[];
  float* Ks = smem;                        // BKV x LD
  float* Vs = Ks + BKV * LD;               // BKV x LD
  float* Qs = Vs + BKV * LD;               // BQ x LD: q (unscaled)
  float* dOs = Qs + BQ * LD;               // BQ x LD
  float* Ps = dOs + BQ * LD;               // BKV x PQ: p, transposed
  float* dSs = Ps + BKV * PQ;              // BKV x PQ: ds, transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bg = blockIdx.x, b = bg / KVH, g = bg % KVH;
  const int rep = H / KVH;
  const int k0 = blockIdx.y * BKV;
  const long long qrow = (long long)H * d;
  const long long krow = (long long)KVH * d;
  const long long koff = (long long)b * Skv * krow + (long long)g * d;

  load_tile_f32<DMAX>(Ks, k + koff, krow, k0, Skv, d, 1.f);
  load_tile_f32<DMAX>(Vs, v + koff, krow, k0, Skv, d, 1.f);
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // a query tile whose last row lies before the first key sees none of
  // the tile under the causal mask
  const int q_start = causal ? (k0 / BQ) * BQ : 0;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = g * rep + hh;
    const long long qoff = (long long)b * Sq * qrow + (long long)h * d;
    const float* lse_h = lse + ((long long)b * H + h) * Sq;
    const float* dl_h = delta + ((long long)b * H + h) * Sq;
    for (int q0 = q_start; q0 < Sq; q0 += BQ) {
      __syncthreads();                     // the last tile's readers are done
      load_tile_f32<DMAX>(Qs, q + qoff, qrow, q0, Sq, d, 1.f);
      load_tile_f32<DMAX>(dOs, dout + qoff, qrow, q0, Sq, d, 1.f);
      float lse_r[4], dl_r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qpos = q0 + tx + 16 * j;
        lse_r[j] = qpos < Sq ? lse_h[qpos] : 0.f;
        dl_r[j] = qpos < Sq ? dl_h[qpos] : 0.f;
      }
      __syncthreads();

      // s and dp transposed: key ty + 16 i, row tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < d; ++c) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * LD + c];
          vv[i] = Vs[(ty + 16 * i) * LD + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * LD + c] * scale;
          ov[j] = dOs[(tx + 16 * j) * LD + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
            dp[i][j] = fmaf(ov[j], vv[i], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qpos = q0 + tx + 16 * j;
          const bool ok =
              qpos < Sq && kpos < Skv && (!causal || kpos <= qpos);
          const float p = ok ? expf(s[i][j] - lse_r[j]) : 0.f;
          Ps[(ty + 16 * i) * PQ + tx + 16 * j] = p;
          dSs[(ty + 16 * i) * PQ + tx + 16 * j] = p * (dp[i][j] - dl_r[j]);
        }
      }
      __syncthreads();                     // Ps, dSs complete

#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(ty + 16 * i) * PQ + r];
          dsv[i] = dSs[(ty + 16 * i) * PQ + r];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float ov = dOs[r * LD + tx + 16 * c];
          const float qq = Qs[r * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][c] = fmaf(pv[i], ov, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dsv[i], qq, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= Skv) continue;
    const long long at = ((long long)b * Skv + kpos) * krow + (long long)g * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        dk[at + col] = scale * dk_acc[i][c];
        dv[at + col] = dv_acc[i][c];
      }
    }
  }
}

template <int DMAX>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int Sq,
              int Skv, int H, int KVH, int d, int causal, float scale,
              cudaStream_t s) {
  const size_t smem = dq_smem_bytes<DMAX>();
  if (int err = set_smem(flash_dq_kernel<DMAX>, smem)) return err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_dq_kernel<DMAX><<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), Sq, Skv, H, KVH, d, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int B, int Sq, int Skv, int H, int KVH,
               int d, int causal, float scale, cudaStream_t s) {
  const size_t smem = dkv_smem_bytes<DMAX>();
  if (int err = set_smem(flash_dkv_kernel<DMAX>, smem)) return err;
  const dim3 grid(B * KVH, (Skv + BKV - 1) / BKV);
  flash_dkv_kernel<DMAX><<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv, H,
      KVH, d, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_dims(int B, int Sq, int Skv, int H, int KVH, int d, int vec) {
  return B < 1 || Sq < 1 || Skv < 1 || H < 1 || KVH < 1 || H % KVH != 0 ||
         d < 1 || d > 128 || (vec && d % 8) ||
         (Sq + BQ - 1) / BQ > 65535 || (Skv + BKV - 1) / BKV > 65535;
}

}  // namespace

// q, k, v, dout: contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// lse, delta: (B, H, Sq) f32; dq: (B, Sq, H, d) in q's type; scale =
// f32(1 / sqrt(d)); vec: bf16 rows copied in 16-byte chunks (d % 8 == 0
// and q, k, v, dout 16-byte aligned), else loaded an element at a time.
extern "C" int flash_attention_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, int B, int Sq, int Skv, int H,
                                  int KVH, int d, int causal, int is_bf16,
                                  float scale, int vec, void* stream) {
  if (bad_dims(B, Sq, Skv, H, KVH, d, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (is_bf16)
    return d <= 64 ? launch_dq_tc<64, 8>(q, k, v, dout, lp, dl, dq, B, Sq,
                                         Skv, H, KVH, d, causal, scale, vec,
                                         s)
                   : launch_dq_tc<128, 4>(q, k, v, dout, lp, dl, dq, B, Sq,
                                          Skv, H, KVH, d, causal, scale, vec,
                                          s);
  return d <= 64 ? launch_dq<64>(q, k, v, dout, lp, dl, dq, B, Sq, Skv, H,
                                 KVH, d, causal, scale, s)
                 : launch_dq<128>(q, k, v, dout, lp, dl, dq, B, Sq, Skv, H,
                                  KVH, d, causal, scale, s);
}

// As flash_attention_dq; dk, dv: (B, Skv, KVH, d) in k's type.
extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int Sq,
                                   int Skv, int H, int KVH, int d,
                                   int causal, int is_bf16, float scale,
                                   int vec, void* stream) {
  if (bad_dims(B, Sq, Skv, H, KVH, d, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (is_bf16)
    return d <= 64 ? launch_dkv_tc<64>(q, k, v, dout, lp, dl, dk, dv, B, Sq,
                                       Skv, H, KVH, d, causal, scale, vec, s)
                   : launch_dkv_tc<128>(q, k, v, dout, lp, dl, dk, dv, B,
                                        Sq, Skv, H, KVH, d, causal, scale,
                                        vec, s);
  return d <= 64 ? launch_dkv<64>(q, k, v, dout, lp, dl, dk, dv, B, Sq, Skv,
                                  H, KVH, d, causal, scale, s)
                 : launch_dkv<128>(q, k, v, dout, lp, dl, dk, dv, B, Sq, Skv,
                                   H, KVH, d, causal, scale, s);
}
