// K6-bwd: the gradients of the sequential RWKV-6 WKV (K6's exact form) with
// respect to r, k, v, w and u.
//
// No TPU kernel: the JAX package lets XLA differentiate wkv6_scan
// (core/wkv/wkv6.py:38).  This is the backward of K6 as the whole-sequence
// forward calls it where it takes no chunks (models/rwkv6.py:
// _time_mix_seq, S <= 64 or S % 64 != 0): f32 operands, an initial state
// s0 that takes no gradient (the forward's is zero), no valid mask, no
// carry snap; the final state carries no gradient.
// kernels/wkv6.py:wkv6_seq_bwd_plain runs the same passes in torch ops;
// tests/test_torch_k6_bwd_plan.py:wkv6_seq_bwd_twin transcribes this
// source's layout and sums.
//
// The recurrence, per head, S_(t-1) the state before step t:
//   y_t = Σ_n r_tn (S_(t-1)[n,:] + u_n k_tn v_t)
//   S_t = w_t ⊙rows S_(t-1) + k_t ⊗ v_t.
// Walking t backward with G_t = dS_t, G_(T-1) = 0:
//   dr_tn = Σ_m S_(t-1)[n,m] dy_tm + u_n k_tn (v_t·dy_t)
//   dk_tn = u_n r_tn (v_t·dy_t) + (G_t v_t)_n
//   dv_t  = (Σ_n r_tn u_n k_tn) dy_t + G_tᵀ k_t
//   dw_tn = Σ_m S_(t-1)[n,m] G_t[n,m]
//   du   += r_t k_t (v_t·dy_t)                          (then over b)
//   G_(t-1) = w_t ⊙rows G_t + r_t ⊗ dy_t.
// S_(t-1) cannot be had from S_t by dividing by w (w underflows), so it is
// recomputed: the first pass runs the state forward and keeps it at the
// start of every group of kWin steps; the second takes the groups from the
// last, reruns each from its checkpoint with the forward's own update (so
// the forward's bits: -fmad=false, w·S then k·v, then the add) and walks
// its steps backward.
//
// f32 r, k, v, w, dy (B,T,H,N), u (H,N), s0 (B,H,N,N) -> dr, dk, dv, dw
// (B,T,H,N) f32, du (H,N) f32.  N in {16, 32, 64}; any T.
//
// Design.  A block a (b, h) pair of 4N threads: thread 4n + j holds row n,
// columns j·N/4 .. (j + 1)·N/4 - 1 of the state and of G, so a step's
// elementwise work is N/4 elements a thread (the first design gave each of
// N threads a whole row, so every step ran N-long dependent loops).  Rows
// of S and G are independent in both updates: dr, dk, dw and v·dy sum over
// m, in the four threads of a row (two shuffles, a fixed order); dv sums
// over n: each step parks G_t in the thread's own slots of the state it
// has just read, and after the group a thread a column sums G_t k_t over n
// in order, through shared memory (a few barriers a group, none a step).
// A group's r, k, v, w and dy reach one of two shared buffers by cp.async
// while the group before is worked on; its recomputed states stay in
// shared memory, each thread's own elements (no scratch in device memory;
// the first design wrote them to a scratch of 84 MB at the train shape).
// The checkpoints, one state a group, go to device memory; du's partial a
// (b, h, n), summed over b in order by a second launch (wkv6_common.cuh).
// No atomics: the same bits every run.
//
// What bounds it on an H100.  The function's bytes at the forward's K6
// shape of the train step (B2 T40 H64 N64): r, k, v, w, dy read and dr,
// dk, dv, dw written, f32, 11.8 MB (3.5 µs at 3.35 TB/s); its operations
// 14 an (n, m) a step (the state's update w·S + k·v 3, dr's S dy 2, dk's
// G v 2, dv's Gᵀ k 2, dw's S ⊙ G 2, G's update w·G + r·dy 3; the bonus
// terms are O(N) a step), 294 M (4.4 µs at 67 TFLOP/s), the floor.  This
// design runs B·H = 128 blocks of 256 threads at that shape, one an SM
// (150 KB of shared memory: the group's states); each step is ~N²/4·14
// operations a thread spread over 8 warps, and T steps of the walk (and 2T
// of the forward) follow one another.
#include "wkv6_common.cuh"

namespace {

constexpr int kWin = 8;          // steps a group: a checkpoint, a barrier
constexpr int kRowLanes = 4;     // threads a state row
constexpr unsigned kFull = 0xffffffffu;

// The launch: blocks, threads, dynamic shared bytes and scratch floats
// (kernels/wkv6.py:k6_bwd_plan is its twin, held to wkv6_seq_bwd_plan)
struct Plan {
  long long blocks;
  int threads, window;
  size_t smem;
  long long scratch;
};

bool plan_of(int B, int T, int H, int N, Plan* p) {
  const long long nwin = (T + kWin - 1) / kWin;
  *p = Plan{(long long)B * H, kRowLanes * N, kWin,
            4 * ((size_t)kWin * N * N + (size_t)2 * 5 * kWin * N +
                 (size_t)kWin * N + kWin),
            (long long)B * H * (nwin * N * N + N)};
  return p->blocks <= 0x7fffffffLL;
}

template <int N>
__global__ void __launch_bounds__(kRowLanes * N)
seq_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               const float* __restrict__ dy,
               float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dw,
               float* __restrict__ ckpt, float* __restrict__ du_part, int T,
               int H) {
  constexpr int NT = kRowLanes * N;       // threads
  constexpr int SEG = N / kRowLanes;      // columns a thread
  constexpr int S4 = SEG / 4;             // float4s a thread's row part
  extern __shared__ __align__(16) float sm[];
  float4* win = reinterpret_cast<float4*>(sm);  // [s][e4][tid] states
  float* stg = sm + kWin * N * N;               // [2][5][s][N] r k v w dy
  float* bon = stg + 2 * 5 * kWin * N;          // [s][n] r u k, the bonus's
  float* bsum = bon + kWin * N;                 // [s] terms; their sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = tid / kRowLanes, j = tid % kRowLanes, m0 = j * SEG;
  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  const size_t row = (size_t)H * N;
  const size_t base = (size_t)b * T * row + (size_t)h * N;
  const int nwin = (T + kWin - 1) / kWin;
  float* ck = ckpt + (size_t)bh * nwin * N * N + (size_t)n * N + m0;
  const float un = u[h * N + n];

  // The groups in the order the two passes take them: pass 1 the first
  // nwin - 1 (the last group's states are never needed forward), pass 2
  // all from the last.  Each group's rows of r, k, v, w, dy reach one of
  // two stage buffers by cp.async while the group before is worked on.
  const int n1 = nwin - 1, nseq = n1 + nwin;
  const auto group_of = [&](int i) { return i < n1 ? i : nwin - 1 - (i - n1); };
  const auto issue = [&](int i) {
    const int t0 = group_of(i) * kWin, len = min(kWin, T - t0);
    float* dst = stg + (i & 1) * 5 * kWin * N;
    for (int e = tid; e < 5 * len * (N / 4); e += NT) {
      const int a = e / (len * (N / 4)), rr = e % (len * (N / 4));
      const int s = rr / (N / 4), c4 = (rr % (N / 4)) * 4;
      const float* src = a == 0 ? r : a == 1 ? k : a == 2 ? v : a == 3 ? w
                                                                   : dy;
      repro::cp_async16(dst + (a * kWin + s) * N + c4,
                        src + base + (size_t)(t0 + s) * row + c4, 16);
    }
    repro::cp_async_commit();
  };

  float S[SEG];
#pragma unroll
  for (int i = 0; i < S4; ++i)
    reinterpret_cast<float4*>(S)[i] = __ldg(reinterpret_cast<const float4*>(
        s0 + ((size_t)bh * N + n) * N + m0) + i);
  float Gd[SEG];
#pragma unroll
  for (int i = 0; i < SEG; ++i) Gd[i] = 0.f;
  float du = 0.f;
  issue(0);
  for (int i = 0; i < nseq; ++i) {
    const int g = group_of(i);
    const int t0 = g * kWin, len = min(kWin, T - t0);
    const float* st = stg + (i & 1) * 5 * kWin * N;
    const float *rw = st, *kw = st + kWin * N, *vw = kw + kWin * N;
    const float *ww = vw + kWin * N, *dyw = ww + kWin * N;
    // the forward's update of the thread's elements at group step s
    const auto advance = [&](float (&Sx)[SEG], int s) {
      const float kn = kw[s * N + n], wn = ww[s * N + n];
#pragma unroll
      for (int q = 0; q < SEG; ++q)
        Sx[q] = __fadd_rn(__fmul_rn(wn, Sx[q]),
                          __fmul_rn(kn, vw[s * N + m0 + q]));
    };
    __syncthreads();  // the buffer the next issue fills is read by no one
    if (i + 1 < nseq) {
      issue(i + 1);
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();  // group i's rows are in
    if (i < n1) {  // pass 1: keep the group's first state, run it forward
#pragma unroll
      for (int q = 0; q < S4; ++q)
        reinterpret_cast<float4*>(ck + (size_t)g * N * N)[q] =
            reinterpret_cast<float4*>(S)[q];
      for (int s = 0; s < len; ++s) advance(S, s);
      continue;
    }
    // pass 2: the group rerun from its checkpoint (the last one's is the
    // state pass 1 ended with), then walked backward
    if (g < n1) {
#pragma unroll
      for (int q = 0; q < S4; ++q)
        reinterpret_cast<float4*>(S)[q] =
            reinterpret_cast<const float4*>(ck + (size_t)g * N * N)[q];
    }
    for (int s = 0; s < len; ++s) {
#pragma unroll
      for (int q = 0; q < S4; ++q)
        win[(s * S4 + q) * NT + tid] = reinterpret_cast<float4*>(S)[q];
      if (s + 1 < len) advance(S, s);
    }
    for (int s = len - 1; s >= 0; --s) {
      const float rn = rw[s * N + n], kn = kw[s * N + n], wn = ww[s * N + n];
      const float* vs = vw + s * N + m0;
      const float* ds = dyw + s * N + m0;
      float sp[SEG];
#pragma unroll
      for (int q = 0; q < S4; ++q)
        reinterpret_cast<float4*>(sp)[q] = win[(s * S4 + q) * NT + tid];
      float vdy = 0.f, drv = 0.f, dkg = 0.f, dwv = 0.f;
#pragma unroll
      for (int q = 0; q < SEG; ++q) {
        vdy = __fmaf_rn(vs[q], ds[q], vdy);
        drv = __fmaf_rn(sp[q], ds[q], drv);
        dkg = __fmaf_rn(Gd[q], vs[q], dkg);
        dwv = __fmaf_rn(sp[q], Gd[q], dwv);
      }
      // dv's terms need G_t: park it in this thread's own slots of the
      // state just read (summed with k over n after the group)
#pragma unroll
      for (int q = 0; q < S4; ++q)
        win[(s * S4 + q) * NT + tid] = reinterpret_cast<float4*>(Gd)[q];
      // the row's four threads: lanes 4n' + j, summed j in a fixed order
#pragma unroll
      for (int mask = 1; mask < kRowLanes; mask <<= 1) {
        vdy = vdy + __shfl_xor_sync(kFull, vdy, mask);
        drv = drv + __shfl_xor_sync(kFull, drv, mask);
        dkg = dkg + __shfl_xor_sync(kFull, dkg, mask);
        dwv = dwv + __shfl_xor_sync(kFull, dwv, mask);
      }
      const size_t gi = base + (size_t)(t0 + s) * row + n;
      if (j == 0) {  // dr = Σ_m S dy + u k (v·dy)
        dr[gi] = __fadd_rn(drv, __fmul_rn(__fmul_rn(un, kn), vdy));
        dk[gi] = __fadd_rn(__fmul_rn(__fmul_rn(un, rn), vdy), dkg);
        dw[gi] = dwv;
        du = __fadd_rn(du, __fmul_rn(__fmul_rn(rn, kn), vdy));
      }
      // the bonus's r u k of the row
      if (j == 0) bon[s * N + n] = __fmul_rn(__fmul_rn(rn, un), kn);
#pragma unroll
      for (int q = 0; q < SEG; ++q)
        Gd[q] = __fmaf_rn(wn, Gd[q], __fmul_rn(rn, ds[q]));
    }
    __syncthreads();
    // dv of the group: Σ over the rows n in order of G_t[n, m] k_tn and
    // of the bonus's terms.  A lane takes column m = 16j' + 4q' + r' from
    // index bits (r' 0-1, j' 2-3, q' 4-5) and starts at row q' & 1, so a
    // warp's 32 reads fall on 32 banks (word 16n + 4j' + r' mod 32).
    if (tid < len) {
      float x = 0.f;
      for (int i = 0; i < N; ++i) x = __fadd_rn(x, bon[tid * N + i]);
      bsum[tid] = x;
    }
    __syncthreads();
    const float* wf = reinterpret_cast<const float*>(win);
    for (int e = tid; e < len * N; e += NT) {
      const int s = e / N, x = e % N;
      const int jj = (x >> 2) & 3, q = (x >> 4) * 4 + (x & 3);
      const int m = jj * SEG + q;
      const float* col = wf + (size_t)(s * S4 + q / 4) * NT * 4 + jj * 4 + q % 4;
      const int r0 = (x >> 4) & 1;
      float cs = 0.f;
      for (int i = 0; i < N; ++i) {
        const int nn = (i + r0) & (N - 1);
        cs = __fmaf_rn(col[nn * kRowLanes * 4], kw[s * N + nn], cs);
      }
      dv[base + (size_t)(t0 + s) * row + m] =
          __fadd_rn(__fmul_rn(bsum[s], dyw[s * N + m]), cs);
    }
  }
  if (j == 0) du_part[(size_t)bh * N + n] = du;
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, const float* dy,
           float* dr, float* dk, float* dv, float* dw, float* du,
           float* scratch, int B, int T, int H, cudaStream_t st) {
  Plan p;
  if (!plan_of(B, T, H, N, &p)) return static_cast<int>(cudaErrorInvalidValue);
  const int nwin = (T + kWin - 1) / kWin;
  float* ckpt = scratch;
  float* du_part = ckpt + (size_t)B * H * nwin * N * N;
  cudaError_t err = cudaFuncSetAttribute(
      seq_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  seq_bwd_kernel<N><<<static_cast<unsigned>(p.blocks), p.threads, p.smem,
                      st>>>(r, k, v, w, u, s0, dy, dr, dk, dv, dw, ckpt,
                            du_part, T, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return wkv6::du_sum(du_part, du, B, H * N, st);
}

}  // namespace

// scratch: kernels/wkv6.py:k6_bwd_plan(...).scratch_floats floats, B·H·
// (⌈T/kWin⌉·N² + N): the checkpoints, du's partial sums
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

// The launch a call would make: out = blocks, threads, steps a group,
// dynamic shared bytes, scratch floats, as launch() takes them.
extern "C" int wkv6_seq_bwd_plan(int B, int T, int H, int N,
                                 long long* out) {
  if (B < 1 || T < 1 || H < 1 || (N != 16 && N != 32 && N != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  if (!plan_of(B, T, H, N, &p)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = p.blocks;
  out[1] = p.threads;
  out[2] = p.window;
  out[3] = static_cast<long long>(p.smem);
  out[4] = p.scratch;
  return 0;
}
