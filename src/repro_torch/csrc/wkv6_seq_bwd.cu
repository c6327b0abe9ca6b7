// K6-bwd: the gradients of the sequential RWKV-6 WKV (K6's exact form) with
// respect to r, k, v, w and u.
//
// No TPU kernel: the JAX package lets XLA differentiate wkv6_scan
// (core/wkv/wkv6.py:38).  This is the backward of K6 as the whole-sequence
// forward calls it where it takes no chunks (models/rwkv6.py:
// _time_mix_seq, S <= 64 or S % 64 != 0): f32 operands, an initial state
// s0 that takes no gradient (the forward's is zero), no valid mask, no
// carry snap; the final state carries no gradient.
// kernels/wkv6.py:wkv6_seq_bwd_plain runs the same passes in torch ops.
//
// The recurrence, per head, S_(t-1) the state before step t:
//   y_t = Σ_n r_tn (S_(t-1)[n,:] + u_n k_tn v_t)
//   S_t = w_t ⊙rows S_(t-1) + k_t ⊗ v_t.
// Walking t backward with G_t = dS_t, G_(T-1) = 0:
//   dr_tn = Σ_m (S_(t-1)[n,m] + u_n (k_tn v_tm)) dy_tm
//   dk_tn = u_n r_tn (v_t·dy_t) + (G_t v_t)_n
//   dv_t  = (Σ_n r_tn u_n k_tn) dy_t + G_tᵀ k_t
//   dw_tn = Σ_m S_(t-1)[n,m] G_t[n,m]
//   du   += r_t k_t (v_t·dy_t)                          (then over b)
//   G_(t-1) = w_t ⊙rows G_t + r_t ⊗ dy_t.
// S_(t-1) cannot be had from S_t by dividing by w (w underflows), so it is
// recomputed: the first pass runs the state forward and keeps it at the
// start of every window of kWin steps (K2-bwd's pattern,
// csrc/wkv4_bwd.cu); the second takes the windows from the last, reruns
// each from its checkpoint with the forward's own update (so the forward's
// bits: -fmad=false, w·S then k·v, then the add) and walks its steps
// backward.
//
// f32 r, k, v, w, dy (B,T,H,N), u (H,N), s0 (B,H,N,N) -> dr, dk, dv, dw
// (B,T,H,N) f32, du (H,N) f32.  N in {16, 32, 64}.
//
// Design.  A block a (b, h) pair, as K6's, of N threads: thread n keeps
// row n of the state and of G in registers (K6 keeps a column: here three
// of the four sums run over m, the row, and only dv sums over n).  Each
// window's v and dy reach shared memory once; a step reads r, k, w of its
// row from device memory.  dv_t sums G_t[n,m] k_tn over the rows through a
// shared (N, N+1) tile, thread m summing its column in order of n, one
// barrier a step.  The recomputed states of a window go to a scratch of
// kWin·N² floats a block, [s][m][n], so a step's store and load are whole
// rows across the threads.  du's partial a (b, h, n), summed over b in
// order by a second launch (wkv6_common.cuh): no atomics, the same bits
// every run.
//
// What bounds it on an H100.  The function's bytes at the forward's K6
// shape of the train step (B2 T40 H64 N64): r, k, v, w, dy read and dr,
// dk, dv, dw written, f32, 11.8 MB (3.5 µs at 3.35 TB/s); its operations
// 14 an (n, m) a step (the state's update w·S + k·v 3, dr's S dy 2, dk's
// G v 2, dv's Gᵀ k 2, dw's S ⊙ G 2, G's update w·G + r·dy 3; the bonus
// terms are O(N) a step), 294 M (4.4 µs at 67 TFLOP/s), the floor.  This design is
// bound by the chain of T steps a block runs, each a loop of N
// over its registers and a barrier, at B·H = 128 blocks on 132 SMs, and by
// the window scratch (2·4·B·H·T·N² bytes written and read back, 84 MB at
// that shape, most of it in L2); chip_smoke.py:phase_rwkv6_train times it.
#include "wkv6_common.cuh"

namespace {

constexpr int kWin = 32;  // steps between checkpoints

template <int N>
__global__ void __launch_bounds__(N)
seq_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               const float* __restrict__ dy,
               float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dw,
               float* __restrict__ ckpt, float* __restrict__ win,
               float* __restrict__ du_part, int T, int H) {
  constexpr int FP = N + 1;
  extern __shared__ float sm[];
  float* vw = sm;                // (kWin, N) the window's v
  float* dyw = vw + kWin * N;    // (kWin, N) the window's dy
  float* prod = dyw + kWin * N;  // (N, FP) G[n][m]·k[n]
  float* ruk = prod + N * FP;    // (N) r·u·k
  const int n = threadIdx.x;
  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  const size_t row = (size_t)H * N;
  const size_t base = (size_t)b * T * row + (size_t)h * N;
  const int nwin = (T + kWin - 1) / kWin;
  float* ck = ckpt + (size_t)bh * nwin * N * N;  // [j][m][n]
  float* sw = win + (size_t)bh * kWin * N * N;   // [s][m][n]
  const float un = u[h * N + n];

  const auto stage = [&](int t0, int len, bool with_dy) {
    __syncthreads();  // the previous window's readers are done
    for (int e = n; e < len * N; e += N) {
      const size_t gi = base + (size_t)(t0 + e / N) * row + e % N;
      vw[e] = v[gi];
      if (with_dy) dyw[e] = dy[gi];
    }
    __syncthreads();
  };
// the forward's update of the kept row at window step s, element gi
#define K6B_ADVANCE(s, gi)                                                \
  {                                                                       \
    const float kn_ = k[gi], wn_ = w[gi];                                 \
    _Pragma("unroll") for (int m = 0; m < N; ++m) S[m] = __fadd_rn(       \
        __fmul_rn(wn_, S[m]), __fmul_rn(kn_, vw[(s) * N + m]));           \
  }

  float S[N];
  const size_t srow = ((size_t)bh * N + n) * N;
#pragma unroll
  for (int m = 0; m < N; ++m) S[m] = s0[srow + m];
  // pass 1: the state forward, kept at the start of every window
  for (int j = 0; j < nwin; ++j) {
    const int t0 = j * kWin, len = min(kWin, T - t0);
    stage(t0, len, false);
#pragma unroll
    for (int m = 0; m < N; ++m) ck[((size_t)j * N + m) * N + n] = S[m];
    for (int s = 0; s < len; ++s)
      K6B_ADVANCE(s, base + (size_t)(t0 + s) * row + n)
  }
  // pass 2: the windows from the last, each rerun from its checkpoint and
  // walked backward
  float Gd[N];
#pragma unroll
  for (int m = 0; m < N; ++m) Gd[m] = 0.f;
  float du = 0.f;
  for (int j = nwin - 1; j >= 0; --j) {
    const int t0 = j * kWin, len = min(kWin, T - t0);
    stage(t0, len, true);
#pragma unroll
    for (int m = 0; m < N; ++m) S[m] = ck[((size_t)j * N + m) * N + n];
    for (int s = 0; s < len; ++s) {
#pragma unroll
      for (int m = 0; m < N; ++m) sw[((size_t)s * N + m) * N + n] = S[m];
      K6B_ADVANCE(s, base + (size_t)(t0 + s) * row + n)
    }
    for (int s = len - 1; s >= 0; --s) {
      const size_t gi = base + (size_t)(t0 + s) * row + n;
      const float rn = r[gi], kn = k[gi], wn = w[gi];
      const float* vs = vw + s * N;
      const float* ds = dyw + s * N;
      float vdy = 0.f, drv = 0.f, dkg = 0.f, dwv = 0.f;
#pragma unroll
      for (int m = 0; m < N; ++m) {
        const float sp = sw[((size_t)s * N + m) * N + n];
        vdy = __fmaf_rn(vs[m], ds[m], vdy);
        drv = __fmaf_rn(__fadd_rn(sp, __fmul_rn(un, __fmul_rn(kn, vs[m]))),
                        ds[m], drv);
        dkg = __fmaf_rn(Gd[m], vs[m], dkg);
        dwv = __fmaf_rn(sp, Gd[m], dwv);
        prod[n * FP + m] = __fmul_rn(Gd[m], kn);
      }
      ruk[n] = __fmul_rn(__fmul_rn(rn, un), kn);
      dr[gi] = drv;
      dk[gi] = __fadd_rn(__fmul_rn(__fmul_rn(un, rn), vdy), dkg);
      dw[gi] = dwv;
      du = __fadd_rn(du, __fmul_rn(__fmul_rn(rn, kn), vdy));
      __syncthreads();
      float bsum = 0.f, gk = 0.f;  // thread n as column m = n
      for (int i = 0; i < N; ++i) {
        bsum = __fadd_rn(bsum, ruk[i]);
        gk = __fadd_rn(gk, prod[i * FP + n]);
      }
      dv[gi] = __fadd_rn(__fmul_rn(bsum, ds[n]), gk);
      __syncthreads();  // prod and ruk are read before the next step
#pragma unroll
      for (int m = 0; m < N; ++m)
        Gd[m] = __fadd_rn(__fmul_rn(wn, Gd[m]), __fmul_rn(rn, ds[m]));
    }
  }
  du_part[(size_t)bh * N + n] = du;
}
#undef K6B_ADVANCE

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, const float* dy,
           float* dr, float* dk, float* dv, float* dw, float* du,
           float* scratch, int B, int T, int H, cudaStream_t st) {
  const long long pairs = (long long)B * H;
  if (pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int nwin = (T + kWin - 1) / kWin;
  float* ckpt = scratch;
  float* win = ckpt + pairs * nwin * N * N;
  float* du_part = win + pairs * kWin * N * N;
  const size_t smem = 4 * ((size_t)2 * kWin * N + (size_t)N * (N + 1) + N);
  seq_bwd_kernel<N><<<static_cast<unsigned>(pairs), N, smem, st>>>(
      r, k, v, w, u, s0, dy, dr, dk, dv, dw, ckpt, win, du_part, T, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return wkv6::du_sum(du_part, du, B, H * N, st);
}

}  // namespace

// scratch: B·H·((⌈T/kWin⌉ + kWin)·N² + N) floats (kernels/wkv6.py:
// wkv6_seq_bwd): the checkpoints, a window's states, du's partial sums
extern "C" int wkv6_seq_bwd(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            const void* dy, void* dr, void* dk, void* dv,
                            void* dw, void* du, void* scratch, int B, int T,
                            int H, int N, void* stream) {
  if (B < 1 || T < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
  const auto st = static_cast<cudaStream_t>(stream);
#define K6B_LAUNCH(NN)                                                      \
  return launch<NN>(f(r), f(k), f(v), f(w), f(u), f(s0), f(dy), o(dr),      \
                    o(dk), o(dv), o(dw), o(du), o(scratch), B, T, H, st)
  if (N == 64) K6B_LAUNCH(64);
  if (N == 32) K6B_LAUNCH(32);
  if (N == 16) K6B_LAUNCH(16);
#undef K6B_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
