// K10-bwd: the gradients of the chunked RWKV-6 WKV (K10) with respect to r,
// k, v, w and u.
//
// No TPU kernel: the JAX package lets XLA differentiate wkv6_chunked
// (core/wkv/wkv6.py:58).  This is the backward of K10 as the whole-sequence
// forward calls it (models/rwkv6.py:_time_mix_seq): an initial state that
// takes no gradient (the forward's is zero), the final state carrying none.
// kernels/wkv6.py:wkv6_chunked_bwd_plain runs the same passes in torch ops.
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
// walked forward in s from X_0[t] = (S dy_t)_n, Y_0 = rowsum(S ⊙ G)_n:
//   X_(s+1)[t] = w_s X_s[t] + k_s VD[t,s],  Y_(s+1) = w_s Y_s + k_s (G v_s)
// (w_s = e^(l_s)), the sequential form's rowsum(S_(s-1) ⊙ dS_s) gathered
// over the chunk.  No term cancels another, and every exponent that reaches
// exp is <= 0: Lp_t - L_i for i < t, Lp_t - L_s for t > s, Ltot - L, Lp.
//
// r, k, v (B,T,H,N) bf16 or f32 (one type), w f32 or bf16, u (H,N) f32, dy
// (B,T,H,N) f32 and K10's workspace (S_(g-1) and e^Ltot_g of every chunk,
// which the forward's launch B left there) -> dr, dk, dv in r's type, dw
// in w's (each rounded once from f32), du (H,N) f32.  N in {16, 32, 64};
// C <= 64 divides T.
//
// Design, four launches on the caller's stream (chunks g-major, as K10's):
//   1  state_grad_kernel  a block a chunk: L and Lp, then (r e^Lp)ᵀ dy into
//                         the scratch, a thread an (n, m), t in order.
//   2  grad_scan_kernel   a thread a (b, h, n, m) chain over g from the
//                         last: writes G_g over chunk g's increment in
//                         place, then G <- e^Ltot_g G + increment.
//   3  chunk_grad_kernel  a block of 256 a chunk, everything in shared
//                         memory on the CUDA cores, f32 throughout: the
//                         chunk's r, k, v, dy, L, Lp, w, S_(g-1) and G_g;
//                         VD, G v, S dy and k e^(Ltot - L) as tiles; then
//                         dr (a warp a row t, the lanes over n, summing its
//                         keys i < t) and dk, dv (a warp a key i, summing
//                         its rows t > i; A[t,i] by a shuffle tree over the
//                         lanes, the same bits in every lane), written as
//                         they finish; then dw by the forward walk above,
//                         256 / N groups of threads each walking a share of
//                         the rows t for every column n, their partial sums
//                         added in group order; du's partial a column.
//   4  du_sum_kernel      a thread a (h, n): the partials over (g, b) in
//                         order (wkv6_common.cuh).
// No atomics: the same bits every run.  The pairwise decays are taken
// exactly, twice (dr's rows, then dk's keys): C(C-1) exponentials a column
// a chunk; the walk adds C(C-1)/2.  The function needs C(C-1)/2: E[t,i] is
// one table, which dr, dk, A and the walk could share.
//
// What bounds it on an H100.  The function's bytes at rwkv6-7b's train
// shape (B4 T1024 H64 N64, bf16 r, k, v, f32 w): r, k, v read 101 MB; w, dy
// and S_(g-1) 67 MB each; dr, dk, dv written 101 MB, dw 67 MB: ~0.47 GB,
// >= 0.14 ms at 3.35 TB/s.  Its operations, a chunk and column: the four
// products (r e^Lp)ᵀ dy, S dy, G v and Gᵀ (k e^(Ltot - L)) (C·N each), VD
// (C²), the pairwise terms of A, dr, dk and dv (4·C(C-1)/2) and the dw walk
// (2·C(C-1)/2) in multiply-adds, and the C(C-1)/2 exponentials of E: 8.5 G
// multiply-adds and 0.53 G exponentials at that shape, 17.6 G operations,
// >= 0.263 ms at 67 TFLOP/s (chip_smoke.py:_k10_bwd_cost), so the floor is
// its operations.  This first design runs its products on the CUDA cores
// from shared memory (launch 3 holds one block of 8 warps an SM), so it is
// bound by its instruction rate; chip_smoke.py:phase_rwkv6_train times it
// beside its plain version and its bound (PERF.md §6).
#include "wkv6_common.cuh"

namespace {

constexpr int kMaxC = 64;
constexpr int kQThreads = 256;     // launch 1
constexpr int kScanThreads = 256;  // launch 2
constexpr int kGradThreads = 256;  // launch 3
constexpr int kWarps = kGradThreads / 32;

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

__device__ __forceinline__ float log_w(float w) {
  return logf(fmaxf(w, 1e-38f));
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

// x·y over n elements of two shared rows, in order, one rounding a term
__device__ __forceinline__ float dot(const float* x, const float* y, int n) {
  float acc = 0.f;
  for (int m = 0; m < n; ++m) acc = __fmaf_rn(x[m], y[m], acc);
  return acc;
}

// ---- launch 1: (r e^Lp)ᵀ dy ----------------------------------------------

template <int N>
__global__ void __launch_bounds__(kQThreads)
state_grad_kernel(const void* __restrict__ r, const void* __restrict__ w,
                  const float* __restrict__ dy, float* __restrict__ q,
                  int T, int H, int C, int G, int rkv_bf16, int w_bf16) {
  extern __shared__ float sm[];
  float* rl = sm;          // (C, N) r, then r e^Lp
  float* ds = rl + C * N;  // (C, N) dy
  float* ls = ds + C * N;  // (C, N) log w
  const int tid = threadIdx.x;
  const Chunk ch = chunk_of(T, H, N, C, G);
  for (int e = tid; e < C * N; e += kQThreads) {
    const int c = e / N, n = e % N;
    const size_t gi = ch.base + c * ch.rs + n;
    rl[e] = ldf(r, gi, rkv_bf16);
    ds[e] = dy[gi];
    ls[e] = log_w(ldf(w, gi, w_bf16));
  }
  __syncthreads();
  if (tid < N) {  // the forward's cumsum, in order of c
    float acc = 0.f;
    for (int c = 0; c < C; ++c) {
      const float lw = ls[c * N + tid];
      acc = __fadd_rn(acc, lw);
      rl[c * N + tid] = __fmul_rn(rl[c * N + tid], expf(__fsub_rn(acc, lw)));
    }
  }
  __syncthreads();
  float* out = q + ch.id * N * N;
  for (int e = tid; e < N * N; e += kQThreads) {
    const int n = e / N, m = e % N;
    float acc = 0.f;
    for (int c = 0; c < C; ++c)
      acc = __fmaf_rn(rl[c * N + n], ds[c * N + m], acc);
    out[e] = acc;
  }
}

// ---- launch 2: the state gradients, g from the last ----------------------

// total = B·H·N²; chunk g's increments start at g·total, its e^Ltot at
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
  for (int g = G - 1; g >= 0; --g) {
    const float qv = q[g * total + e], ev = el[g * ne];
    q[g * total + e] = Gd;  // G_g over chunk g's increment
    Gd = __fadd_rn(__fmul_rn(ev, Gd), qv);
  }
}

// ---- launch 3: a chunk's gradients ---------------------------------------

__host__ __device__ constexpr int pad(int n) { return n + 1; }

size_t smem_grad(int N, int C) {
  // S, G (N, N+1); v then S dy (C, N+1); r, k, dy, L, Lp, w, k e^(Ltot-L),
  // G v (C, N); VD (C, C); u, Y (N); the bonus (C); the groups' partials
  return 4 * ((size_t)2 * N * pad(N) + (size_t)C * pad(N) +
              (size_t)8 * C * N + (size_t)C * C + 2 * N + C + kGradThreads);
}

template <int N>
__global__ void __launch_bounds__(kGradThreads)
chunk_grad_kernel(const void* __restrict__ r, const void* __restrict__ k,
                  const void* __restrict__ v, const void* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ dy,
                  const float* __restrict__ ws_s,
                  const float* __restrict__ gq, void* __restrict__ dr,
                  void* __restrict__ dk, void* __restrict__ dv,
                  void* __restrict__ dw, float* __restrict__ du_part, int T,
                  int H, int C, int G, int rkv_bf16, int w_bf16) {
  constexpr int FP = pad(N);
  constexpr int NPL = (N + 31) / 32;  // columns a lane
  constexpr int NG = kGradThreads / N;  // groups of the dw walk
  extern __shared__ float sm[];
  float* Ss = sm;               // (N, FP) S_(g-1)
  float* Gs = Ss + N * FP;      // (N, FP) G_g
  float* vs = Gs + N * FP;      // (C, FP) v, then S dy (X of the walk)
  float* rs = vs + C * FP;      // (C, N) r
  float* ks = rs + C * N;       // (C, N) k
  float* ds = ks + C * N;       // (C, N) dy
  float* Ls = ds + C * N;       // (C, N) log w, then L
  float* Lps = Ls + C * N;      // (C, N) Lp
  float* ew = Lps + C * N;      // (C, N) e^(log max(w, 1e-38))
  float* kfs = ew + C * N;      // (C, N) k e^(Ltot - L)
  float* gvs = kfs + C * N;     // (C, N) G v
  float* VD = gvs + C * N;      // (C, C) VD[t][i] = v_i·dy_t
  float* us = VD + C * C;       // (N) u
  float* Ys = us + N;           // (N) rowsum(S ⊙ G)
  float* bk = Ys + N;           // (C) Σ_n r u k
  float* part = bk + C;         // (NG, N) the walk's partial sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Chunk ch = chunk_of(T, H, N, C, G);
  const bool bf = rkv_bf16 != 0;

  // stage 0: the chunk, S_(g-1), G_g and u into shared memory
  for (int e = tid; e < C * N; e += kGradThreads) {
    const int c = e / N, n = e % N;
    const size_t gi = ch.base + c * ch.rs + n;
    rs[e] = ldf(r, gi, bf);
    ks[e] = ldf(k, gi, bf);
    vs[c * FP + n] = ldf(v, gi, bf);
    ds[e] = dy[gi];
    Ls[e] = log_w(ldf(w, gi, w_bf16));
  }
  for (int e = tid; e < N * N; e += kGradThreads) {
    const int n = e / N, m = e % N;
    Ss[n * FP + m] = ws_s[ch.id * N * N + e];
    Gs[n * FP + m] = gq[ch.id * N * N + e];
  }
  if (tid < N) us[tid] = u[ch.h * N + tid];
  __syncthreads();

  // stage 1: the cumsum a column; the bonus a row; du's partial a column;
  // Y_0 a row of S ⊙ G
  if (tid < N) {
    float acc = 0.f;
    for (int c = 0; c < C; ++c) {
      const float lw = Ls[c * N + tid];
      acc = __fadd_rn(acc, lw);
      Ls[c * N + tid] = acc;
      Lps[c * N + tid] = __fsub_rn(acc, lw);
      ew[c * N + tid] = expf(lw);
    }
  } else if (tid < N + C) {
    const int c = tid - N;
    float acc = 0.f;  // from column c on: the rows' banks differ
    for (int j = 0; j < N; ++j) {
      const int n = (j + c) % N;
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(rs[c * N + n], us[n]),
                                     ks[c * N + n]));
    }
    bk[c] = acc;
  } else if (tid < 2 * N + C) {
    const int n = tid - N - C;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) {
      const float vdy = dot(vs + c * FP, ds + c * N, N);
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(rs[c * N + n], ks[c * N + n]),
                                     vdy));
    }
    du_part[ch.id * N + n] = acc;
  } else if (tid < 3 * N + C) {
    const int n = tid - 2 * N - C;
    float acc = 0.f;
    for (int m = 0; m < N; ++m)
      acc = __fmaf_rn(Ss[n * FP + m], Gs[n * FP + m], acc);
    Ys[n] = acc;
  }
  __syncthreads();

  // stage 2a: VD; k e^(Ltot - L) and G v a (c, n)
  for (int e = tid; e < C * C; e += kGradThreads) {
    const int t = e / C, i = e % C;
    VD[e] = dot(vs + i * FP, ds + t * N, N);
  }
  for (int e = tid; e < C * N; e += kGradThreads) {
    const int c = e / N, n = e % N;
    kfs[e] = __fmul_rn(ks[e], expf(__fsub_rn(Ls[(C - 1) * N + n], Ls[e])));
    float acc = 0.f;
    for (int m = 0; m < N; ++m)
      acc = __fmaf_rn(Gs[n * FP + m], vs[c * FP + m], acc);
    gvs[e] = acc;
  }
  __syncthreads();
  // stage 2b: S dy over v, which no later stage reads
  for (int e = tid; e < C * N; e += kGradThreads) {
    const int c = e / N, n = e % N;
    float acc = 0.f;
    for (int m = 0; m < N; ++m)
      acc = __fmaf_rn(Ss[n * FP + m], ds[c * N + m], acc);
    vs[c * FP + n] = acc;
  }
  __syncthreads();

  // stage 3: dr a row t (its keys i < t), then dk and dv a key i (its rows
  // t > i), a warp each in turn, the lanes over n (and m for dv)
  for (int t = warp; t < C; t += kWarps) {
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int n = lane + 32 * j;
      if (n >= N) continue;
      const float lp = Lps[t * N + n];
      float acc = 0.f;
      for (int i = 0; i < t; ++i)
        acc = __fmaf_rn(__fmul_rn(ks[i * N + n],
                                  expf(__fsub_rn(lp, Ls[i * N + n]))),
                        VD[t * C + i], acc);
      const float inter = __fmul_rn(expf(lp), vs[t * FP + n]);
      const float bonus = __fmul_rn(__fmul_rn(us[n], ks[t * N + n]),
                                    VD[t * C + t]);
      stf(dr, ch.base + t * ch.rs + n,
          __fadd_rn(__fadd_rn(inter, acc), bonus), bf);
    }
  }
  for (int i = warp; i < C; i += kWarps) {
    float ak[NPL], av[NPL];
#pragma unroll
    for (int j = 0; j < NPL; ++j) ak[j] = av[j] = 0.f;
    for (int t = i + 1; t < C; ++t) {
      const float vd = VD[t * C + i];
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int n = lane + 32 * j;
        if (n >= N) continue;
        const float q_ = __fmul_rn(
            rs[t * N + n], expf(__fsub_rn(Lps[t * N + n], Ls[i * N + n])));
        ak[j] = __fmaf_rn(q_, vd, ak[j]);
        a = __fmaf_rn(q_, ks[i * N + n], a);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int m = lane + 32 * j;
        if (m < N) av[j] = __fmaf_rn(a, ds[t * N + m], av[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int n = lane + 32 * j;
      if (n >= N) continue;
      const size_t gi = ch.base + i * ch.rs + n;
      const float ef = expf(__fsub_rn(Ls[(C - 1) * N + n], Ls[i * N + n]));
      const float bonus = __fmul_rn(__fmul_rn(us[n], rs[i * N + n]),
                                    VD[i * C + i]);
      stf(dk, gi, __fadd_rn(__fadd_rn(ak[j], __fmul_rn(ef, gvs[i * N + n])),
                            bonus), bf);
      float gk = 0.f;  // Gᵀ (k_i e^(Ltot - L_i)), column m = n
      for (int nn = 0; nn < N; ++nn)
        gk = __fmaf_rn(kfs[i * N + nn], Gs[nn * FP + n], gk);
      stf(dv, gi, __fadd_rn(__fadd_rn(av[j], gk),
                            __fmul_rn(bk[i], ds[i * N + n])), bf);
    }
  }
  __syncthreads();

  // stage 4: dw, the running state walked forward in s; group q of the
  // threads takes the rows t ≡ q (mod NG), group 0 also Y
  const int grp = tid / N, n = tid % N;
  float Y = Ys[n];
  const float lt = Ls[(C - 1) * N + n];
  for (int s = 0; s < C; ++s) {
    const float lsn = Ls[s * N + n], es = ew[s * N + n];
    const float kn = ks[s * N + n];
    float p = 0.f;
    for (int t = s + 1 + ((grp - s - 1) % NG + NG) % NG; t < C; t += NG) {
      const float x = vs[t * FP + n];
      p = __fmaf_rn(__fmul_rn(rs[t * N + n],
                              expf(__fsub_rn(Lps[t * N + n], lsn))),
                    x, p);
      vs[t * FP + n] = __fadd_rn(__fmul_rn(es, x),
                                 __fmul_rn(kn, VD[t * C + s]));
    }
    part[grp * N + n] = p;
    __syncthreads();
    if (grp == 0) {
      float acc = 0.f;
      for (int q = 0; q < NG; ++q) acc = __fadd_rn(acc, part[q * N + n]);
      acc = __fadd_rn(acc, __fmul_rn(expf(__fsub_rn(lt, lsn)), Y));
      const size_t gi = ch.base + s * ch.rs + n;
      stf(dw, gi, ldf(w, gi, w_bf16) >= 1e-38f ? acc : 0.f, w_bf16);
      Y = __fadd_rn(__fmul_rn(es, Y), __fmul_rn(kn, gvs[s * N + n]));
    }
    __syncthreads();
  }
}

struct Args {
  const void *r, *k, *v, *w, *dy;
  const float *u, *ws;
  void *dr, *dk, *dv, *dw;
  float *du, *scratch;
  int B, T, H, C, rkv_bf16, w_bf16;
};

template <int N>
int launch(const Args& a, cudaStream_t st) {
  const int G = a.T / a.C;
  const long long chunks = (long long)a.B * a.H * G;
  const long long total = (long long)a.B * a.H * N * N;
  if (chunks > 0x7fffffffLL || total / kScanThreads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  float* q = a.scratch;                   // (r e^Lp)ᵀ dy, then G_g
  float* du_part = a.scratch + chunks * N * N;
  const float* ws_e = a.ws + chunks * N * N;
  const auto blocks = static_cast<unsigned>(chunks);

  const size_t sq = (size_t)3 * a.C * N * 4;
  state_grad_kernel<N><<<blocks, kQThreads, sq, st>>>(
      a.r, a.w, static_cast<const float*>(a.dy), q, a.T, a.H, a.C, G,
      a.rkv_bf16, a.w_bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  grad_scan_kernel<<<static_cast<unsigned>((total + kScanThreads - 1) /
                                           kScanThreads),
                     kScanThreads, 0, st>>>(ws_e, q, G, N, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t sg = smem_grad(N, a.C);
  err = cudaFuncSetAttribute(chunk_grad_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sg));
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_grad_kernel<N><<<blocks, kGradThreads, sg, st>>>(
      a.r, a.k, a.v, a.w, a.u, static_cast<const float*>(a.dy), a.ws, q,
      a.dr, a.dk, a.dv, a.dw, du_part, a.T, a.H, a.C, G, a.rkv_bf16,
      a.w_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return wkv6::du_sum(du_part, a.du, a.B * G, a.H * N, st);  // launch 4
}

}  // namespace

// ws: K10's workspace of the same call; scratch: as large (4·B·H·(T/C)·
// (N² + N) bytes, kernels/wkv6.py:k10_plan): the state gradients, then
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
               H, C, rkv_bf16, w_bf16};
  const auto st = static_cast<cudaStream_t>(stream);
  if (N == 64) return launch<64>(a, st);
  if (N == 32) return launch<32>(a, st);
  if (N == 16) return launch<16>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
