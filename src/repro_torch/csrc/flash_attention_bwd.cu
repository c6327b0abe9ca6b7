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
// >= 0.0782 ms.  This first form is simple, like the forward: f32 FMAs on
// the CUDA cores (67 TFLOP/s at most), tiles staged in shared memory by
// plain loads; wgmma and TMA are later work.
//
// K13-dq: one block of 256 threads a (batch, query head, 64-row query
// tile); it keeps the tile's q·scale and dout in shared memory and loops
// over 64-key tiles up to the diagonal (the forward's causal skip).  A
// 16x16 thread grid gives each thread 4 rows x 4 keys of s, dp and ds, and
// 4 rows x d/16 columns of dq; ds goes through shared memory to the
// ds·k product.
//
// K13-dkv: one block a (batch, kv head, 64-key tile); it keeps the tile's
// k and v in shared memory and loops over the H / KVH query heads of the
// group and, for each, over the 64-row query tiles from the diagonal down
// (a key tile j starts at the first query tile i with i·64 + 63 >= j·64),
// so GQA's sum stays in the block.  Each thread holds 4 keys x 4 rows of
// the transposed s, dp, p and ds, and 4 keys x d/16 columns of dk and dv.
//
// Rows past Sq and keys past Skv are masked here (their p is 0 and their
// q, dout, k, v load as 0), so any Sq and Skv work.
#include "common.cuh"

namespace {

using repro::bf16;

constexpr int BQ = 64;         // query rows a tile
constexpr int BKV = 64;        // keys a tile
constexpr int THREADS = 256;   // a 16 x 16 grid

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long row, int r0, int S,
                                          int d, float mul) {
  constexpr int LD = DMAX + 1;
  for (int i = threadIdx.x; i < 64 * DMAX; i += THREADS) {
    const int r = i / DMAX, c = i % DMAX;
    dst[r * LD + c] =
        (r0 + r < S && c < d) ? ld(base[(r0 + r) * row + c]) * mul : 0.f;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                int Skv, int H, int KVH, int d, int causal, float scale) {
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
  const T* kb = k + (long long)b * Skv * krow + (long long)kvh * d;
  const T* vb = v + (long long)b * Skv * krow + (long long)kvh * d;

  load_tile<T, DMAX>(Qs, q + qoff, qrow, q0, Sq, d, scale);
  load_tile<T, DMAX>(dOs, dout + qoff, qrow, q0, Sq, d, 1.f);
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
    load_tile<T, DMAX>(Ks, kb, krow, k0, Skv, d, 1.f);
    load_tile<T, DMAX>(Vs, vb, krow, k0, Skv, d, 1.f);
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
    T* row = dq + ((long long)b * Sq + qpos) * qrow + (long long)h * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) st(row + col, scale * acc[i][c]);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int Sq, int Skv, int H, int KVH, int d,
                 int causal, float scale) {
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

  load_tile<T, DMAX>(Ks, k + koff, krow, k0, Skv, d, 1.f);
  load_tile<T, DMAX>(Vs, v + koff, krow, k0, Skv, d, 1.f);
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
      load_tile<T, DMAX>(Qs, q + qoff, qrow, q0, Sq, d, 1.f);
      load_tile<T, DMAX>(dOs, dout + qoff, qrow, q0, Sq, d, 1.f);
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
        st(dk + at + col, scale * dk_acc[i][c]);
        st(dv + at + col, dv_acc[i][c]);
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

template <typename T, int DMAX>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int Sq,
              int Skv, int H, int KVH, int d, int causal, float scale,
              cudaStream_t s) {
  const size_t smem = dq_smem_bytes<DMAX>();
  if (int err = set_smem(flash_dq_kernel<T, DMAX>, smem)) return err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_dq_kernel<T, DMAX><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Sq, Skv, H, KVH, d, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int B, int Sq, int Skv, int H, int KVH,
               int d, int causal, float scale, cudaStream_t s) {
  const size_t smem = dkv_smem_bytes<DMAX>();
  if (int err = set_smem(flash_dkv_kernel<T, DMAX>, smem)) return err;
  const dim3 grid(B * KVH, (Skv + BKV - 1) / BKV);
  flash_dkv_kernel<T, DMAX><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, KVH, d, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_dims(int B, int Sq, int Skv, int H, int KVH, int d) {
  return B < 1 || Sq < 1 || Skv < 1 || H < 1 || KVH < 1 || H % KVH != 0 ||
         d < 1 || d > 128 || (Sq + BQ - 1) / BQ > 65535 ||
         (Skv + BKV - 1) / BKV > 65535;
}

}  // namespace

// q, k, v, dout: contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// lse, delta: (B, H, Sq) f32; dq: (B, Sq, H, d) in q's type; scale =
// f32(1 / sqrt(d)).
extern "C" int flash_attention_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, int B, int Sq, int Skv, int H,
                                  int KVH, int d, int causal, int is_bf16,
                                  float scale, void* stream) {
  if (bad_dims(B, Sq, Skv, H, KVH, d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (is_bf16)
    return d <= 64 ? launch_dq<bf16, 64>(q, k, v, dout, lp, dl, dq, B, Sq,
                                         Skv, H, KVH, d, causal, scale, s)
                   : launch_dq<bf16, 128>(q, k, v, dout, lp, dl, dq, B, Sq,
                                          Skv, H, KVH, d, causal, scale, s);
  return d <= 64 ? launch_dq<float, 64>(q, k, v, dout, lp, dl, dq, B, Sq,
                                        Skv, H, KVH, d, causal, scale, s)
                 : launch_dq<float, 128>(q, k, v, dout, lp, dl, dq, B, Sq,
                                         Skv, H, KVH, d, causal, scale, s);
}

// As flash_attention_dq; dk, dv: (B, Skv, KVH, d) in k's type.
extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int Sq,
                                   int Skv, int H, int KVH, int d,
                                   int causal, int is_bf16, float scale,
                                   void* stream) {
  if (bad_dims(B, Sq, Skv, H, KVH, d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (is_bf16)
    return d <= 64 ? launch_dkv<bf16, 64>(q, k, v, dout, lp, dl, dk, dv, B,
                                          Sq, Skv, H, KVH, d, causal, scale,
                                          s)
                   : launch_dkv<bf16, 128>(q, k, v, dout, lp, dl, dk, dv, B,
                                           Sq, Skv, H, KVH, d, causal, scale,
                                           s);
  return d <= 64 ? launch_dkv<float, 64>(q, k, v, dout, lp, dl, dk, dv, B,
                                         Sq, Skv, H, KVH, d, causal, scale,
                                         s)
                 : launch_dkv<float, 128>(q, k, v, dout, lp, dl, dk, dv, B,
                                          Sq, Skv, H, KVH, d, causal, scale,
                                          s);
}
