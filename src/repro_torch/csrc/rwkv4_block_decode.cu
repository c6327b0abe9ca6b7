// K3: one whole RWKV-4 block decode step per launch, Δ-PoT W8 weights.
//
// Replaces the TPU kernel kernels/fused_decode.py:fused_block_decode with
// the RWKV-4 body (models/rwkv4.py:block_decode, exact numerics) written
// into the kernel: Pallas traced the block function, CUDA cannot.
//
// One launch runs models/rwkv4.py:198-234 for one layer:
//   1. LN1 (single pass, f32)        -> h, the new att_x state
//   2. the three token-shift mixes   -> mr, mk, mv
//   3. r/k/v matvecs, W8 decoded in-kernel, and per channel the WKV-4
//      step in f32 (new wkv_a/b/o state) and y = σ(r)·wkv
//   4. the wo matvec and the residual x2 = x + att
//   5. LN2                           -> h2, the new ffn_x state
//   6. the two channel-mix mixes
//   7. the wk matvec (K=D, N=F) with relu², and the wr matvec with σ
//   8. the wv matvec (K=F) and the gate, then out = x2 + rr·(kk @ wv)
// Every value the JAX trace holds in bf16 is rounded to bf16 here at the
// same place (bf16r): the LN outputs, each of h·p, (1-p), x·(1-p) and
// their sum, each matvec output, σ(r)·out, relu² and the gated products,
// and both residual adds.
//
// Grid: one block per tile of bb batch lanes (bb = B by default, as in
// fused_decode.py:91).  Shared memory holds each lane's intermediates as
// bf16, (6·D + F)·2 bytes a lane (15,360 B at 169M; bb = 8 takes 123 KB,
// dynamic shared memory set with cudaFuncSetAttribute).
//
// What bounds it on an H100: the uint8 weight codes, 5·D² + 2·D·F bytes a
// layer (7.67 MB at 169M), against ~122 MFLOP at B = 8: bytes.  This
// first design reads each code byte once per block and decodes it in
// registers, but runs a layer on as many SMs as there are batch tiles
// (one at bb = B), so it is far from the bandwidth bound.  Splitting a
// layer's columns over many blocks needs a grid-wide barrier between the
// phases; that is the later work that makes it fast.
//
// Batch invariance: each LayerNorm reduction belongs to one warp in a
// fixed order, and each matvec output accumulates over k = 0..K-1 in
// order, whatever bb or the tile a lane falls in.
#include <algorithm>
#include <cstddef>

#include "common.cuh"

namespace {

using repro::bf16;
using repro::bf16r;
using repro::bf2f;

constexpr int kNumPtrs = 37;

struct BlockArgs {
  const bf16* x;
  const bf16 *ln1_w, *ln1_b, *ln2_w, *ln2_b;
  const bf16 *att_mix_r, *att_mix_k, *att_mix_v, *time_decay, *time_first;
  const uint8_t* att_wr; const float* att_wr_s;
  const uint8_t* att_wk; const float* att_wk_s;
  const uint8_t* att_wv; const float* att_wv_s;
  const uint8_t* att_wo; const float* att_wo_s;
  const bf16 *ffn_mix_r, *ffn_mix_k;
  const uint8_t* ffn_wr; const float* ffn_wr_s;
  const uint8_t* ffn_wk; const float* ffn_wk_s;
  const uint8_t* ffn_wv; const float* ffn_wv_s;
  const bf16 *att_x, *ffn_x, *wkv_a, *wkv_b, *wkv_o;
  bf16 *x_out, *att_x_out, *ffn_x_out, *wkv_a_out, *wkv_b_out, *wkv_o_out;
  int B, D, F;
};
// the host fills the pointer fields from a flat array, in order
static_assert(offsetof(BlockArgs, B) == kNumPtrs * sizeof(void*),
              "BlockArgs must start with exactly kNumPtrs pointers");

// σ(x) = 1 / (1 + exp(-x)) with each op rounded to bf16: how XLA expands
// jax.nn.sigmoid on bf16, and what models/rwkv4.py:sigmoid computes.
__device__ __forceinline__ float sigmoid_bf16(float x) {
  return bf16r(1.f / bf16r(1.f + bf16r(expf(-x))));
}

// acc[b] = Σ_k in[b][k] · decode(w[k][col]) over k = 0..K-1 in order.
// `in` is lane b's bf16 row at in + b·lane_stride (K even, 4-byte aligned).
template <int BB>
__device__ __forceinline__ void dot_col(const bf16* in, int lane_stride, int K,
                                        const uint8_t* __restrict__ w, int N,
                                        int col, float sc, float (&acc)[BB]) {
#pragma unroll
  for (int b = 0; b < BB; ++b) acc[b] = 0.f;
  const uint8_t* wp = w + col;
#pragma unroll 2
  for (int k = 0; k < K; k += 2) {
    const float w0 = repro::dpot_w8_decode(__ldg(wp + (size_t)k * N), sc);
    const float w1 = repro::dpot_w8_decode(__ldg(wp + (size_t)(k + 1) * N), sc);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(in + b * lane_stride + k));
      acc[b] = fmaf(xv.x, w0, acc[b]);
      acc[b] = fmaf(xv.y, w1, acc[b]);
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

// Token-shift mix h·p + prev·(1-p), each op rounded to bf16 as in JAX.
__device__ __forceinline__ bf16 mix(float h, float prev, float p) {
  const float hp = bf16r(h * p);
  const float q = bf16r(1.f - p);
  const float xq = bf16r(prev * q);
  return __float2bfloat16_rn(hp + xq);
}

template <int BB>
__global__ void __launch_bounds__(1024)
rwkv4_block_decode_kernel(const BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int D = a.D, F = a.F;
  const int LS = 6 * D + F;  // lane stride in shared memory
  bf16* X = smem;            // residual x, then x2
  bf16* H = smem + D;        // h, then y = σ(r)·wkv, then h2
  bf16* M0 = smem + 2 * D;   // mixes: r / k / v, then ffn r / k
  bf16* M1 = smem + 3 * D;
  bf16* M2 = smem + 4 * D;
  bf16* R = smem + 5 * D;    // σ(ffn r)
  bf16* KK = smem + 6 * D;   // relu²(ffn k), F wide
  const int b0 = blockIdx.x * BB;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < BB * D; i += nt) {
    const int b = i / D, d = i % D;
    X[b * LS + d] = a.x[(size_t)(b0 + b) * D + d];
  }
  __syncthreads();

  // 1. LN1 -> h (also the new att_x state)
  layernorm_lanes<BB>(X, H, LS, a.ln1_w, a.ln1_b, D, a.att_x_out, b0);
  __syncthreads();

  // 2. time-mix token shifts
  for (int i = tid; i < BB * D; i += nt) {
    const int b = i / D, d = i % D;
    const float h = bf2f(H[b * LS + d]);
    const float prev = bf2f(a.att_x[(size_t)(b0 + b) * D + d]);
    M0[b * LS + d] = mix(h, prev, bf2f(a.att_mix_r[d]));
    M1[b * LS + d] = mix(h, prev, bf2f(a.att_mix_k[d]));
    M2[b * LS + d] = mix(h, prev, bf2f(a.att_mix_v[d]));
  }
  __syncthreads();

  // 3. r/k/v matvecs, the WKV step and y = σ(r)·wkv, one channel a thread
  for (int c = tid; c < D; c += nt) {
    float ar[BB], ak[BB], av[BB];
    dot_col<BB>(M0, LS, D, a.att_wr, D, c, a.att_wr_s[c], ar);
    dot_col<BB>(M1, LS, D, a.att_wk, D, c, a.att_wk_s[c], ak);
    dot_col<BB>(M2, LS, D, a.att_wv, D, c, a.att_wv_s[c], av);
    const float w = expf(bf2f(a.time_decay[c]));
    const float u = bf2f(a.time_first[c]);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const size_t g = (size_t)(b0 + b) * D + c;
      float na, nb, no;
      const float out = repro::wkv4_step(
          bf2f(a.wkv_a[g]), bf2f(a.wkv_b[g]), bf2f(a.wkv_o[g]), bf16r(ak[b]),
          bf16r(av[b]), w, u, &na, &nb, &no);
      a.wkv_a_out[g] = __float2bfloat16_rn(na);
      a.wkv_b_out[g] = __float2bfloat16_rn(nb);
      a.wkv_o_out[g] = __float2bfloat16_rn(no);
      const float sr = sigmoid_bf16(bf16r(ar[b]));
      H[b * LS + c] = __float2bfloat16_rn(sr * bf16r(out));
    }
  }
  __syncthreads();

  // 4. att = y @ wo; x2 = x + att
  for (int c = tid; c < D; c += nt) {
    float acc[BB];
    dot_col<BB>(H, LS, D, a.att_wo, D, c, a.att_wo_s[c], acc);
#pragma unroll
    for (int b = 0; b < BB; ++b)
      X[b * LS + c] = __float2bfloat16_rn(bf2f(X[b * LS + c]) + bf16r(acc[b]));
  }
  __syncthreads();

  // 5. LN2 -> h2 (also the new ffn_x state)
  layernorm_lanes<BB>(X, H, LS, a.ln2_w, a.ln2_b, D, a.ffn_x_out, b0);
  __syncthreads();

  // 6. channel-mix token shifts
  for (int i = tid; i < BB * D; i += nt) {
    const int b = i / D, d = i % D;
    const float h = bf2f(H[b * LS + d]);
    const float prev = bf2f(a.ffn_x[(size_t)(b0 + b) * D + d]);
    M0[b * LS + d] = mix(h, prev, bf2f(a.ffn_mix_r[d]));
    M1[b * LS + d] = mix(h, prev, bf2f(a.ffn_mix_k[d]));
  }
  __syncthreads();

  // 7. kk = relu(mk @ wk)², rr = σ(mr @ wr)
  for (int f = tid; f < F; f += nt) {
    float acc[BB];
    dot_col<BB>(M1, LS, D, a.ffn_wk, F, f, a.ffn_wk_s[f], acc);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const float t = fmaxf(bf16r(acc[b]), 0.f);
      KK[b * LS + f] = __float2bfloat16_rn(t * t);
    }
  }
  for (int c = tid; c < D; c += nt) {
    float acc[BB];
    dot_col<BB>(M0, LS, D, a.ffn_wr, D, c, a.ffn_wr_s[c], acc);
#pragma unroll
    for (int b = 0; b < BB; ++b)
      R[b * LS + c] = __float2bfloat16_rn(sigmoid_bf16(bf16r(acc[b])));
  }
  __syncthreads();

  // 8. out = x2 + rr·(kk @ wv)
  for (int c = tid; c < D; c += nt) {
    float acc[BB];
    dot_col<BB>(KK, LS, F, a.ffn_wv, D, c, a.ffn_wv_s[c], acc);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const float ffn = bf16r(bf2f(R[b * LS + c]) * bf16r(acc[b]));
      a.x_out[(size_t)(b0 + b) * D + c] =
          __float2bfloat16_rn(bf2f(X[b * LS + c]) + ffn);
    }
  }
}

template <int BB>
int launch(const BlockArgs& a, cudaStream_t s) {
  const int threads = std::min(1024, ((a.D + 31) / 32) * 32);
  const size_t smem = (size_t)BB * (6 * a.D + a.F) * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      rwkv4_block_decode_kernel<BB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rwkv4_block_decode_kernel<BB><<<a.B / BB, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: the kNumPtrs device pointers in the order of BlockArgs (x, the
// layer's parameters, the five state leaves in, the six outputs).
extern "C" int rwkv4_block_decode(const void* const* ptrs, int n_ptrs, int B,
                                  int D, int F, int bb, void* stream) {
  if (n_ptrs != kNumPtrs || bb < 1 || bb > 8 || B % bb != 0 || D % 2 ||
      F % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  BlockArgs a;
  const void** dst = reinterpret_cast<const void**>(&a);
  for (int i = 0; i < kNumPtrs; ++i) dst[i] = ptrs[i];
  a.B = B;
  a.D = D;
  a.F = F;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bb) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    case 5: return launch<5>(a, s);
    case 6: return launch<6>(a, s);
    case 7: return launch<7>(a, s);
    default: return launch<8>(a, s);
  }
}
