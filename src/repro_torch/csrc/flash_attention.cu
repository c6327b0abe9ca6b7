// K13: fused flash-attention forward.  q (B, Sq, H, d), k and v
// (B, Skv, KVH, d), f32 or bf16; out (B, Sq, H, d) in q's type and,
// when asked, lse (B, H, Sq) f32.  Query head h reads kv head
// h / (H / KVH) (GQA), indexed here: k and v are never repeated.
//
// Replaces the TPU kernel kernels/flash_attention.py:_kernel_fwd (the
// forward of flash_attention, reached through _fwd_call).  Its numerics:
// q·scale in f32 first, f32 scores, the causal mask kpos <= qpos setting
// a score to -1e30, an online softmax with running m, l and acc in f32,
// out = acc / max(l, 1e-30) rounded once, lse = m + log(max(l, 1e-30)).
//
// What bounds it on an H100: operations.  Causal at smollm-135m's prefill
// (B 8, S 2048, H 9, d 64) the two products are 38.7 GFLOP, >= 0.039 ms at
// the 989 TFLOP/s bf16 tensor-core peak, against 50.3 MB of q, k, v and
// out (>= 0.015 ms at 3.35 TB/s).  This first form is simple: it runs
// the products as f32 FMAs on the CUDA cores (67 TFLOP/s at most, and its
// shared-memory reads hold it well under that), not as wgmma, and stages
// tiles with plain loads, not TMA.  One block of 256 threads owns one
// (batch, head) and 64 query rows; it loops over 64-key tiles of k and v
// staged in shared memory as f32, and stops at the tile holding its last
// row's position when causal (the TPU kernel's pl.when skip above the
// diagonal).  A 16x16 thread grid gives each thread 4 rows x 4 keys of
// the score tile and 4 rows x d/16 columns of acc; a row's running max and
// sum are reduced over its 16 lanes with shuffles, so every lane of a row
// holds the same bits.  Keys past Skv and rows past Sq are masked here,
// so any Sq and Skv work (the TPU kernel halved its block instead).
#include "common.cuh"

namespace {

using repro::bf16;

constexpr int BQ = 64;         // query rows a block
constexpr int BKV = 64;        // keys a tile
constexpr int THREADS = 256;   // a 16 x 16 grid
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int DMAX>
constexpr size_t smem_bytes() {
  // Qs and Ks padded by one word a row (conflict-free column reads), Vs,
  // and the probability tile Ps padded the same way
  return sizeof(float) *
         (BQ * (DMAX + 1) + BKV * (DMAX + 1) + BKV * DMAX + BQ * (BKV + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int H, int KVH,
                 int d, int causal, float scale) {
  constexpr int QLD = DMAX + 1;
  constexpr int PLD = BKV + 1;
  constexpr int NC = DMAX / 16;            // acc columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                        // BQ x QLD: q * scale
  float* Ks = Qs + BQ * QLD;               // BKV x QLD
  float* Vs = Ks + BKV * QLD;              // BKV x DMAX
  float* Ps = Vs + BKV * DMAX;             // BQ x PLD: this tile's p

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.y * BQ;
  const long long qrow = (long long)H * d;      // one position of q / out
  const long long krow = (long long)KVH * d;    // one position of k / v
  const T* qb = q + (long long)b * Sq * qrow + (long long)h * d;
  const T* kb = k + (long long)b * Skv * krow + (long long)kvh * d;
  const T* vb = v + (long long)b * Skv * krow + (long long)kvh * d;

  for (int i = tid; i < BQ * DMAX; i += THREADS) {
    const int r = i / DMAX, c = i % DMAX;
    Qs[r * QLD + c] =
        (q0 + r < Sq && c < d) ? ld(qb[(q0 + r) * qrow + c]) * scale : 0.f;
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
  const int last = min(q0 + BQ, Sq);
  const int kv_end = causal ? min(Skv, last) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();                       // the last tile's readers are done
    for (int i = tid; i < BKV * DMAX; i += THREADS) {
      const int r = i / DMAX, c = i % DMAX;
      const bool in = k0 + r < Skv && c < d;
      Ks[r * QLD + c] = in ? ld(kb[(k0 + r) * krow + c]) : 0.f;
      Vs[r * DMAX + c] = in ? ld(vb[(k0 + r) * krow + c]) : 0.f;
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
        // a masked score is -1e30 below a finite running max (key 0 is in
        // every row's first tile), so its exp is 0 in the TPU kernel too
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
    T* orow = out + ((long long)b * Sq + qpos) * qrow + (long long)h * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) st(orow + col, acc[i][c] / denom);
    }
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Sq + qpos] = m[i] + logf(denom);
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Skv, int H, int KVH, int d,
           int causal, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, DMAX><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Skv, H, KVH,
      d, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); lse:
// (B, H, Sq) f32 or null; scale = f32(1 / sqrt(d)).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int B, int Sq, int Skv, int H, int KVH,
                                   int d, int causal, int is_bf16,
                                   float scale, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || H < 1 || KVH < 1 || H % KVH != 0 ||
      d < 1 || d > 128 || (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  if (is_bf16)
    return d <= 64 ? launch<bf16, 64>(q, k, v, out, lp, B, Sq, Skv, H, KVH, d,
                                      causal, scale, s)
                   : launch<bf16, 128>(q, k, v, out, lp, B, Sq, Skv, H, KVH,
                                       d, causal, scale, s);
  return d <= 64 ? launch<float, 64>(q, k, v, out, lp, B, Sq, Skv, H, KVH, d,
                                     causal, scale, s)
                 : launch<float, 128>(q, k, v, out, lp, B, Sq, Skv, H, KVH, d,
                                      causal, scale, s);
}
