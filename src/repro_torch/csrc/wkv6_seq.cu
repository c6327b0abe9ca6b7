// K6: the masked sequential RWKV-6 WKV recurrence over a prompt chunk.
//
// Replaces the TPU kernel kernels/wkv6.py:wkv6_seq_pallas (_seq_kernel):
// the exact per-step wkv6_step math, with the `valid` commit mask and the
// bf16 carry snap of the chunked prefill.
//
// r, k, v, w (B,T,H,N) f32; u (H,N) f32; s0 (B,H,N,N) f32 or bf16 (the
// pool state itself: bf16 -> f32 is exact); valid (B,T) i32 or null
// -> y (B,T,H,N) f32 and the final state (B,H,N,N) f32.
//
// Each step, per head, with the state S (N x N):
//   y[m] = Σ_n r[n]·(S[n,m] + u[n]·(k[n]·v[m]))   (n in order, from +0)
//   S[n,m] <- w[n]·S[n,m] + k[n]·v[m]              (kept where valid == 0)
//   S <- bf16(S)                                    (bf16 carry)
// in JAX's operation order with no contraction (the build has -fmad=false,
// common.cuh:wkv6_term).  The state update has no reduction, so it
// matches the plain version bit for bit; y sums n in order from +0.0, as
// kernels/wkv6.py:wkv6_seq_inorder does with eager ops.
//
// What bounds it on an H100: instruction issue.  A step costs 7 f32
// operations and a bf16 snap for each (n, m) of a head, ~8.75
// instructions with the loads of r, k, w (B8 T16 H64 N64: 33.5 M terms,
// ~7.6 µs of issue over 132 SMs at the prefill's masks, 8.9 with every
// step valid), beside ~23 MB read and written once (6.9 µs at 3.35 TB/s).
// The first design gave a block of N threads a head, kept the state in
// shared memory and loaded each step's r, k, w from device memory between
// two barriers: every step walked 64 rows of shared memory, 3.3 µs a
// step.  This one keeps state column m of a head in registers from the
// load of s0 to the store of the final state: q lanes own it, each N/q
// rows, unrolled over n (N a template parameter: instances at 16, 32 and
// 64), so a step's row updates overlap.  The window's r, k, w, v and
// valid flags reach shared memory by cp.async in a ring of tiles of kTile
// steps, four tiles ahead of the step that reads them, the state and u
// with the first (16-byte chunks, not a load a value), so no step waits on
// device memory.  A step reads r, k and w as 16-byte broadcasts, four rows
// a load, and holds u in registers; the mask is one branch a step
// (valid[b, t] is uniform over a warp).  y keeps its order: lane j of a
// column runs j steps behind lane j - 1 and takes that lane's running sum
// of the step through shared memory, then adds its own rows in order, so
// no lane adds another's rows and the chain of adds is the first
// design's.  With two lanes a column an SM holds four blocks of four
// warps at N 64, and a step runs at ~87% of the issue rate; two lanes
// beat one at every B timed (B8 0.0280 against 0.0287 ms, B16 0.0479
// against 0.0507 on an H100 at 700 W: PERF.md, K6's section).
// The carry snaps in one conversion (snap: cvt.rn.bf16x2.f32 of (x, 0),
// whose 32 bits are the f32 bf16r(x); one F2FP), held to bf16r over every
// f32 bit pattern by wkv6_snap_check.
//
// One owner: plan_of computes every number of a launch; the C query
// wkv6_seq_plan returns them, and kernels/wkv6.py:k6_plan is their twin on
// the CPU (held to wkv6_seq_plan on the card by tests/test_torch_cuda.py).
// N other than 16, 32 and 64 (any N <= 64) takes the 64-row instance
// with one lane a column, its rows past N left out of y's sum.
#include <string.h>

#include "common.cuh"

namespace wkv6seq {

constexpr int kMaxN = 64;
constexpr int kTile = 4;          // steps a ring stage
constexpr int kStages = 6;        // ring stages a block (4 tiles ahead:
                                  // the last lane reads a tile behind)
constexpr int kLanes = 2;         // lanes a column (a ragged N: one)
constexpr int kMinBlocks = 4;     // blocks an SM must hold (registers
                                  // capped to fit): B8 H64 is 3.9 an SM
constexpr long long kMaxSmem = 232448;

// floats of one stage for np rows: the tile's r, k, w and v rows, then
// its valid flags (i32; kTile is a multiple of 4)
__host__ __device__ constexpr int stage_floats(int np) {
  return 4 * kTile * np + kTile;
}

struct Plan {
  long long blocks, threads, lanes, rows, np, tile, stages, smem, ragged;
};
constexpr int kPlanFields = sizeof(Plan) / sizeof(long long);

// A block is one (b, h) pair, np·q threads:
// thread j·np + m holds rows j·np/q .. (j+1)·np/q - 1 of column m; its
// shared memory the ring, the lanes' hand-off buffer, u and the initial
// state.  A column takes kLanes lanes, a ragged N one.  False where a
// value is out of range.
inline bool plan_of(int B, int T, int H, int N, Plan* p) {
  if (B < 1 || T < 1 || H < 1 || N < 1 || N > kMaxN) return false;
  const bool ragged = N != 16 && N != 32 && N != 64;
  const int np = ragged ? kMaxN : N;
  const int q = ragged ? 1 : kLanes;
  *p = Plan{static_cast<long long>(B) * H, np * q, q, np / q, np,
            kTile, kStages,
            4LL * (kStages * stage_floats(np) + 2 * (q - 1) * np + np +
                   N * N),
            ragged ? 1 : 0};
  return p->blocks <= 0x7fffffffLL && p->smem <= kMaxSmem;
}

}  // namespace wkv6seq

namespace {

using repro::bf16;
using wkv6seq::kLanes;
using wkv6seq::kStages;
using wkv6seq::kTile;

struct Args {
  const float *r, *k, *v, *w, *u;
  const void* s0;
  const int32_t* valid;  // null: every step commits
  float *y, *sf;
  int T, H, N, s0_bf16, vec, svec;  // svec: s0 16-byte aligned, N exact
};

// x snapped through bf16 (round to nearest even) and back in one
// conversion: cvt.rn.bf16x2.f32 puts bf16(x) in the high half and bf16(0)
// = 0 in the low half, which is the f32 bf16r(x)
__device__ __forceinline__ float snap(float x) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(x), "f"(0.f));
  return __uint_as_float(d);
}

// Tile t0 .. t0 + kTile - 1 of pair (b, h) into stage `st`: row s of
// array a (r, k, w, v) at st[(a·kTile + s)·NP], the valid flags after;
// steps at or past T and rows at or past N land as zeros.  VEC: 16-byte
// copies (N % 4 == 0 and 16-byte aligned rows).
template <int NP, int NT, bool MASK>
__device__ __forceinline__ void stage_tile(float* st, const Args& a, int b,
                                           int h, int t0, int tid) {
  const auto row = [&](int arr, int t) {
    const float* base = arr == 0 ? a.r : arr == 1 ? a.k : arr == 2 ? a.w
                                                                   : a.v;
    return base + ((static_cast<size_t>(b) * a.T + t) * a.H + h) * a.N;
  };
  if (a.vec) {  // kTile·NP 16-byte chunks, kTile / Q a thread
    constexpr int C4 = NP / 4;
#pragma unroll
    for (int it = 0; it < kTile * NP / NT; ++it) {
      const int c = tid + it * NT;
      const int arr = c / (kTile * C4), s = c / C4 % kTile, q = c % C4;
      const bool ok = t0 + s < a.T && 4 * q < a.N;
      repro::cp_async16(st + (arr * kTile + s) * NP + 4 * q,
                        ok ? row(arr, t0 + s) + 4 * q : a.r, ok ? 16 : 0);
    }
  } else {  // 4·kTile·NP floats, 4·kTile / Q a thread
#pragma unroll 1
    for (int it = 0; it < 4 * kTile * NP / NT; ++it) {
      const int c = tid + it * NT;
      const int arr = c / (kTile * NP), s = c / NP % kTile, n = c % NP;
      const bool ok = t0 + s < a.T && n < a.N;
      repro::cp_async4(st + (arr * kTile + s) * NP + n,
                       ok ? row(arr, t0 + s) + n : a.r, ok ? 4 : 0);
    }
  }
  if (MASK && tid < kTile) {
    const bool ok = t0 + tid < a.T;
    repro::cp_async4(st + 4 * kTile * NP + tid,
                     ok ? a.valid + static_cast<size_t>(b) * a.T + t0 + tid
                        : a.valid,
                     ok ? 4 : 0);
  }
}

__device__ __forceinline__ float widen(bf16 x) { return repro::bf2f(x); }
__device__ __forceinline__ float widen(float x) { return x; }

// Pair bh's initial state (N·N values, f32 or bf16, as they lie in s0)
// and the head's u into shared memory: 16-byte cp.async chunks where s0
// allows (svec), else element by element; u past N lands as zeros.
template <int NP, int NT>
__device__ __forceinline__ void stage_state(void* ss, float* su,
                                            const Args& a, int bh, int h,
                                            int tid) {
  const int N = a.N, esz = a.s0_bf16 ? 2 : 4;
  const char* src = static_cast<const char*>(a.s0) +
                    static_cast<size_t>(bh) * N * N * esz;
  if (a.svec) {
    for (int c = tid; c < N * N * esz / 16; c += NT)
      repro::cp_async16(static_cast<char*>(ss) + 16 * c, src + 16 * c, 16);
  } else if (a.s0_bf16) {
    for (int e = tid; e < N * N; e += NT)
      static_cast<bf16*>(ss)[e] = reinterpret_cast<const bf16*>(src)[e];
  } else {
    for (int e = tid; e < N * N; e += NT)
      static_cast<float*>(ss)[e] = reinterpret_cast<const float*>(src)[e];
  }
  if (tid < NP)
    repro::cp_async4(su + tid, tid < N ? a.u + h * N + tid : a.u,
                     tid < N ? 4 : 0);
}

// One step of a lane's R rows: each row's term r·(s + u·(k·v)) added to
// *acc in n order (rows past N left out under RAGGED) and, where COMMIT,
// its new state w·s + k·v; then under SNAP the state through bf16,
// committed, or kept at the window's first step (later a kept state is a
// snap's output already, which the snap leaves as it is).
template <int R, bool COMMIT, bool SNAP, bool RAGGED>
__device__ __forceinline__ void step_rows(float* S, const float* U,
                                          const float4* r4, const float4* k4,
                                          const float4* w4, float vm,
                                          float* acc, int n0, int N,
                                          bool first) {
#pragma unroll
  for (int g = 0; g < R / 4; ++g) {
    const float4 rr = r4[g], kk = k4[g], ww = w4[g];
    const float rg[4] = {rr.x, rr.y, rr.z, rr.w};
    const float kg[4] = {kk.x, kk.y, kk.z, kk.w};
    const float wg[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * g + e;
      float ns;
      const float t =
          repro::wkv6_term(S[i], rg[e], kg[e], vm, U[i], wg[e], &ns);
      if constexpr (COMMIT) S[i] = ns;
      if (SNAP && (COMMIT || first)) S[i] = snap(S[i]);
      if (!RAGGED || n0 + i < N) *acc = *acc + t;
    }
  }
}

// One block: pair (b, h) = blockIdx.x; thread j·NP + m holds rows
// j·R .. j·R + R - 1 of column m in registers and runs j steps behind
// lane 0 of its column: at iteration t it takes step t - j, its running
// sum of that step from lane j - 1 (written at iteration t - 1 into
// `hand`), and hands its own on, so every lane adds only its own rows and
// the sum keeps n's order.  One barrier an
// iteration serves the hand-off (Q > 1), one a tile the ring.  RAGGED: N
// < NP, rows and columns past N computed on zeros and left out of y and
// the stores.
template <int NP, int Q, bool RAGGED, bool MASK, bool SNAP>
__global__ void __launch_bounds__(NP* Q, wkv6seq::kMinBlocks)
    wkv6_seq_kernel(const Args a) {
  constexpr int R = NP / Q;  // rows a lane
  constexpr int NT = NP * Q;
  constexpr int SF = wkv6seq::stage_floats(NP);
  static_assert(R % 4 == 0, "a lane reads its rows four at a time");
  static_assert(!RAGGED || Q == 1, "a ragged N takes one lane a column");
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* hand = ring + kStages * SF;       // (2, Q - 1, NP) running sums
  float* su = hand + 2 * (Q - 1) * NP;     // (NP,) u
  float* ss = su + NP;                     // (N, N) s0's f32 or bf16
  const int tid = threadIdx.x, j = tid / NP, m = tid % NP, n0 = j * R;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int N = a.N, tiles = (a.T + kTile - 1) / kTile;

  // the state and u travel with tile 0, tile 1 behind them
  stage_state<NP, NT>(ss, su, a, bh, h, tid);
#pragma unroll
  for (int i = 0; i < kStages - 2; ++i) {
    if (i < tiles) stage_tile<NP, NT, MASK>(ring + i * SF, a, b, h,
                                            i * kTile, tid);
    repro::cp_async_commit();
  }
  repro::cp_async_wait<kStages - 3>();
  __syncthreads();

  // the column's rows of the state and the head's u, into registers for
  // the window
  float S[R], U[R];
  const size_t soff = static_cast<size_t>(bh) * N * N;
  const auto state = [&](auto* sv) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int n = n0 + i;
      S[i] = !RAGGED || (n < N && m < N) ? widen(sv[n * N + m]) : 0.f;
      U[i] = su[n];
    }
  };
  if (a.s0_bf16)
    state(reinterpret_cast<const bf16*>(ss));
  else
    state(static_cast<const float*>(ss));

  for (int t = 0; t < a.T + Q - 1; ++t) {
    if (t % kTile == 0) {
      // tile t / kTile has landed for every thread, and tile t / kTile - 2
      // (which the last lane left at t - kTile + Q - 1) is free
      repro::cp_async_wait<kStages - 3>();
      __syncthreads();
      const int nx = t / kTile + kStages - 2;
      if (nx < tiles)
        stage_tile<NP, NT, MASK>(ring + (nx % kStages) * SF, a, b, h,
                                 nx * kTile, tid);
      repro::cp_async_commit();
    } else if (Q > 1) {
      __syncthreads();  // iteration t - 1's sums are handed on
    }
    const int s = t - j;
    if (s < 0 || s >= a.T) continue;
    const float* st = ring + (s / kTile % kStages) * SF;
    const int sr = s % kTile;
    const float4* r4 = reinterpret_cast<const float4*>(st + sr * NP + n0);
    const float4* k4 =
        reinterpret_cast<const float4*>(st + (kTile + sr) * NP + n0);
    const float4* w4 =
        reinterpret_cast<const float4*>(st + (2 * kTile + sr) * NP + n0);
    const float vm = st[(3 * kTile + sr) * NP + m];
    // y in n order from +0, continued from lane j - 1's sum
    float acc = 0.f;
    if (Q > 1 && j > 0)
      acc = hand[((t - 1) & 1) * (Q - 1) * NP + (j - 1) * NP + m];
    bool commit = true;
    if constexpr (MASK)
      commit = reinterpret_cast<const int32_t*>(st + 4 * kTile * NP)[sr] != 0;
    if (commit)
      step_rows<R, true, SNAP, RAGGED>(S, U, r4, k4, w4, vm, &acc, n0, N,
                                       true);
    else
      step_rows<R, false, SNAP, RAGGED>(S, U, r4, k4, w4, vm, &acc, n0, N,
                                        s == 0);
    if (j < Q - 1)
      hand[(t & 1) * (Q - 1) * NP + j * NP + m] = acc;
    else if (!RAGGED || m < N)
      a.y[((static_cast<size_t>(b) * a.T + s) * a.H + h) * N + m] = acc;
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int n = n0 + i;
    if (!RAGGED || (n < N && m < N))
      a.sf[soff + static_cast<size_t>(n) * N + m] = S[i];
  }
}

template <int NP, int Q, bool RAGGED, bool MASK, bool SNAP>
int launch(const wkv6seq::Plan& p, const Args& a, cudaStream_t st) {
  auto kern = wkv6_seq_kernel<NP, Q, RAGGED, MASK, SNAP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned>(p.blocks), static_cast<unsigned>(p.threads),
         p.smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int NP, int Q, bool RAGGED = false>
int launch_form(const wkv6seq::Plan& p, const Args& a, int snap_bf16,
                cudaStream_t st) {
  if (a.valid)
    return snap_bf16 ? launch<NP, Q, RAGGED, true, true>(p, a, st)
                     : launch<NP, Q, RAGGED, true, false>(p, a, st);
  return snap_bf16 ? launch<NP, Q, RAGGED, false, true>(p, a, st)
                   : launch<NP, Q, RAGGED, false, false>(p, a, st);
}

int run(const void* r, const void* k, const void* v, const void* w,
        const void* u, const void* s0, const void* valid, void* y, void* sf,
        int B, int T, int H, int N, int s0_bf16, int snap_bf16,
        void* stream) {
  wkv6seq::Plan p;
  if (!wkv6seq::plan_of(B, T, H, N, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto al16 = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  const bool vec = N % 4 == 0 && al16(r) && al16(k) && al16(v) && al16(w);
  const bool svec = !p.ragged && al16(s0);
  const Args a{static_cast<const float*>(r), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(w),
               static_cast<const float*>(u), s0,
               static_cast<const int32_t*>(valid), static_cast<float*>(y),
               static_cast<float*>(sf), T, H, N, s0_bf16 != 0, vec, svec};
  const auto st = static_cast<cudaStream_t>(stream);
  if (p.ragged) return launch_form<64, 1, true>(p, a, snap_bf16, st);
  switch (p.np) {  // plan_of gives each kLanes lanes a column
    case 16: return launch_form<16, kLanes>(p, a, snap_bf16, st);
    case 32: return launch_form<32, kLanes>(p, a, snap_bf16, st);
    case 64: return launch_form<64, kLanes>(p, a, snap_bf16, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[0] counts the f32 bit patterns whose snap differs from bf16r; out[1]
// the least such pattern (the caller sets it to ~0 first)
__global__ void snap_check_kernel(unsigned long long* out) {
  const unsigned long long total = 1ULL << 32;
  for (unsigned long long i = blockIdx.x * static_cast<unsigned long long>(
                                               blockDim.x) + threadIdx.x;
       i < total; i += static_cast<unsigned long long>(gridDim.x) *
                        blockDim.x) {
    const uint32_t x = static_cast<uint32_t>(i);
    const float f = __uint_as_float(x);
    const bool bad = __float_as_uint(snap(f)) !=
                     __float_as_uint(repro::bf16r(f));
    const unsigned mask = __ballot_sync(__activemask(), bad);
    if (mask && (threadIdx.x & 31) == __ffs(mask) - 1) {  // the warp's least
      atomicAdd(out, static_cast<unsigned long long>(__popc(mask)));
      atomicMin(out + 1, static_cast<unsigned long long>(x));
    }
  }
}

}  // namespace

extern "C" int wkv6_seq(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        const void* valid, void* y, void* sf, int B, int T,
                        int H, int N, int s0_bf16, int snap_bf16,
                        void* stream) {
  return run(r, k, v, w, u, s0, valid, y, sf, B, T, H, N, s0_bf16,
             snap_bf16, stream);
}

// The plan of a K6 call for (B, T, H, N): out[wkv6seq::kPlanFields] in the
// order of wkv6seq::Plan.
extern "C" int wkv6_seq_plan(int B, int T, int H, int N, long long* out) {
  wkv6seq::Plan p;
  if (!wkv6seq::plan_of(B, T, H, N, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  memcpy(out, &p, sizeof p);
  return 0;
}

// snap against bf16r over all 2^32 f32 bit patterns: out (2,) u64
extern "C" int wkv6_snap_check(void* out, void* stream) {
  snap_check_kernel<<<1056, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
