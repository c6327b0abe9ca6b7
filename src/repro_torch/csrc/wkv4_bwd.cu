// K2-bwd: the gradients of the RWKV-4 WKV sequence (K2's exact form) with
// respect to k, v, w and u.
//
// No TPU kernel: the JAX package lets XLA differentiate wkv4_scan.  This
// is the backward of K2 as the forward calls it (models/rwkv4.py:
// _wkv_operands): exact numerics, no valid mask, no carry snap, an initial
// state (a0, b0, o0) that takes no gradient (the forward's is a = b = 0,
// o = -1e38).
//
// The recurrence (core/wkv/wkv4.py, w > 0 the decay), in unscaled form:
//   P_t, Q_t = Σ_{i<t} e^{-(t-1-i)w + k_i} (v_i, 1)  (+ the initial state)
//   D_t = Q_t + e^{u+k_t},  y_t = (P_t + e^{u+k_t} v_t) / D_t
// and the forward carries (a, b, o) with P_t = a_t e^{o_t}, Q_t = b_t e^{o_t}.
// For the output gradient g_t, with GP_i = Σ_{t>i} (g_t/D_t) e^{-(t-1-i)w}
// and GQ_i = Σ_{t>i} (g_t y_t/D_t) e^{-(t-1-i)w}:
//   gv_i = g_i e^{u+k_i}/D_i + e^{k_i} GP_i
//   gk_i = g_i e^{u+k_i}(v_i − y_i)/D_i + e^{k_i}(v_i GP_i − GQ_i)
//   gu   = Σ_t g_t e^{u+k_t}(v_t − y_t)/D_t
//   gw   = Σ_t g_t (∂P_t/∂w − y_t ∂Q_t/∂w)/D_t,
// where ∂P/∂w follows P's recurrence: with da_t = e^{-o_t} ∂P_t/∂w,
// da_{t+1} = e^{o_t − w − o_{t+1}} (da_t − a_t) (and db likewise).
// Every exponential is taken against a running max, as in the forward:
// the forward pass keeps K2's own (a, b, o), so 1/D_t = e^{-n_t}/den_t with
// n_t = max(o_t, u + k_t) and den_t K2's denominator; the reverse pass
// keeps (GP, GQ) = (gp, gq)·e^{og}, og the max of the exponents -n_t it
// has summed (e^{k_i + og}·gp stays ≤ ~Σ|g|, since D_t ≥ e^{k_i-(t-1-i)w}).
// At t = 0 from o0 = -1e38, every e^{o - ...} is e^{-1e38} = 0 and the
// state terms vanish; -1e38 − w stays finite, so no inf − inf makes a NaN.
//
// What bounds it on an H100: the serial chains, then bytes.  The function
// reads k, v and gy and writes gk and gv (B8 T1024 C768: 126 MB, >= 0.0376
// ms at 3.35 TB/s).  Its two passes are serial chains of a step's latency
// each (exponentials and divisions), one a channel.  The first design gave
// a thread a channel, loaded every step's operands inside the loop (a
// device-memory round trip a step) and kept the forward's (y, den, n) of
// every step in a (3, B, T, C) f32 scratch (151 MB more).  This one gives
// a block of two warps 32 consecutive channels of one batch row, a lane a
// channel (wkv4_common.cuh):
//   forward pass, chunk by chunk: k, v and gy through a ring of three
//     chunk buffers in shared memory (cp.async, a chunk ahead); warp 0
//     runs K2's state over a chunk, storing the carried (a, b, o) at its
//     start to a checkpoint buffer (3, B, ⌈T/Lc⌉, C) f32 (B8 T1024 C768,
//     Lc 32: 2.4 MB) and each step's weights, fraction and ∂/∂w terms into
//     the chunk's buffer, while warp 1 takes the previous chunk's three
//     divisions a step and sums gw and gu in step order as before.
//   reverse pass, chunk by chunk from the last: while warp 1 walks chunk j
//     backward from its buffer (its gk and gv into two more rows, stored
//     as whole rows at the chunk's end), warp 0 re-runs chunk j-1's
//     forward from its checkpoint and writes its (y, den, n, e^(u+k-n))
//     into that chunk's buffer, and copies chunk j-2's k, v and gy into
//     the third
//     (one barrier a chunk).  The forward pass and the recompute share
//     fwd_front, so the recomputed (y, den, n) are the forward pass's
//     bits, and gk, gv, gw and gu the first design's.
// gw and gu are per-(b, c) partials, summed over b in order by a second
// kernel: no atomics, the same bits every run.
#include "wkv4_common.cuh"

namespace {

using wkv4::kLanes;

// The forward pass, its recompute and the reverse pass each run their
// steps in groups ordered by phase (wkv4_common.cuh:run_groups): first the
// running maxima, which depend on o (og) and the inputs alone, then the
// exponentials of all G steps, then the chains in (a, b) or (gp, gq), then
// the divisions.  Every value is the first design's, from the same
// operations on the same operands.  fwd_front is the shared first two
// phases of the forward and the recompute, so that the recompute's (y,
// den, n) are the forward pass's bits.
template <int G>
struct Front {
  float n[G], A[G], Bu[G], A2[G], B2[G];
};
template <int G>
__device__ __forceinline__ Front<G> fwd_front(float& o, const float* kt,
                                              float wc, float uc) {
  Front<G> f;
  wkv4::ExpPair p1[G], p2[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float uk = uc + kt[g], ow = o - wc;
    f.n[g] = fmaxf(o, uk);
    const float n2 = fmaxf(ow, kt[g]);
    p1[g] = wkv4::ExpPair(o, uk, f.n[g]);
    p2[g] = wkv4::ExpPair(ow, kt[g], n2);
    o = n2;
  }
  const repro::ExactUnits ex{};  // expf, whose e^(±0) is 1
#pragma unroll
  for (int g = 0; g < G; ++g) {
    p1[g].exp(ex);
    p2[g].exp(ex);
    f.A[g] = p1[g].ex(1.f);
    f.Bu[g] = p1[g].ez(1.f);
    f.A2[g] = p2[g].ex(1.f);
    f.B2[g] = p2[g].ez(1.f);
  }
  return f;
}

// the carries of the three loops
struct Fwd1 {
  float a, b, o, da, db, gw, gu;
};
struct Carry {
  float a, b, o;
};
struct Rev {
  float gp, gq, og;
};

template <bool VEC>
__global__ void __launch_bounds__(wkv4::kBwdThreads)
wkv4_bwd_kernel(const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ a0, const float* __restrict__ b0,
                const float* __restrict__ o0, const float* __restrict__ gy,
                float* __restrict__ gk, float* __restrict__ gv,
                float* __restrict__ gw_part, float* __restrict__ gu_part,
                float* __restrict__ ckpt, int B, int T, int C, int Lc) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int c0 = blockIdx.x * kLanes, b = blockIdx.y, c = c0 + lane;
  const bool live = c < C;
  const int NC = (T + Lc - 1) / Lc;
  const int rows = Lc * kLanes;            // floats of one buffer row
  auto buf = [&](int j) {
    return smem + (j % wkv4::kBufs) * wkv4::kRows * rows;
  };
  const size_t row0 = static_cast<size_t>(b) * T;
  const size_t idx = static_cast<size_t>(b) * C + c;
  const size_t plane = static_cast<size_t>(B) * NC * C;
  float* ck = ckpt + (static_cast<size_t>(b) * NC) * C + c;  // + j·C
  // a lane past C runs on zeros and stores nothing
  const float wc = live ? w[c] : 0.f, uc = live ? u[c] : 0.f;
  // k, v and gy of chunk j into its buffer (rows 0-2); one group a call
  auto issue = [&](int j, bool real) {
    if (real) {
      const int t0 = j * Lc, n = min(Lc, T - t0);
      float* d = buf(j);
      wkv4::stage_rows<VEC>(d, k, row0 + t0, n, C, c0, lane);
      wkv4::stage_rows<VEC>(d + rows, v, row0 + t0, n, C, c0, lane);
      wkv4::stage_rows<VEC>(d + 2 * rows, gy, row0 + t0, n, C, c0, lane);
    }
    repro::cp_async_commit();
  };

  // forward pass, round i = 0 .. NC: warp 0 runs chunk i's chain in (a, b,
  // o, da, db), a checkpoint at its start, and writes each step's A, Bu,
  // den, num, da and db into rows 3-8 of its buffer; warp 1 turns chunk
  // i-1's rows into y and the gw and gu sums (three divisions a step), in
  // step order; chunk i+1's k, v and gy copies run a round ahead, into the
  // buffer warp 1 left
  Fwd1 st{live ? a0[idx] : 0.f, live ? b0[idx] : 0.f,
          live ? o0[idx] : 0.f, 0.f, 0.f, 0.f, 0.f};
  if (warp == 0) issue(0, true);
  for (int i = 0; i <= NC; ++i) {
    if (warp == 0 && i < NC) {
      issue(i + 1, i + 1 < NC);
      repro::cp_async_wait<1>();
      __syncwarp();
      if (live) {
        ck[static_cast<size_t>(i) * C] = st.a;
        ck[plane + static_cast<size_t>(i) * C] = st.b;
        ck[2 * plane + static_cast<size_t>(i) * C] = st.o;
      }
      float* d = buf(i);
      auto group = [&](Fwd1& cs, int s0, auto size) {
        constexpr int G = decltype(size)::value;
        float kt[G];
#pragma unroll
        for (int g = 0; g < G; ++g) kt[g] = d[(s0 + g) * kLanes + lane];
        const Front<G> f = fwd_front<G>(cs.o, kt, wc, uc);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int e = (s0 + g) * kLanes + lane;
          const float vt = d[rows + e];
          d[3 * rows + e] = f.A[g];
          d[4 * rows + e] = f.Bu[g];
          d[5 * rows + e] = f.A[g] * cs.b + f.Bu[g];
          d[6 * rows + e] = f.A[g] * cs.a + f.Bu[g] * vt;
          d[7 * rows + e] = cs.da;
          d[8 * rows + e] = cs.db;
          cs.da = f.A2[g] * (cs.da - cs.a);
          cs.db = f.A2[g] * (cs.db - cs.b);
          cs.a = f.A2[g] * cs.a + f.B2[g] * vt;
          cs.b = f.A2[g] * cs.b + f.B2[g];
        }
      };
      const int n = min(Lc, T - i * Lc);
      int s = 0;
      for (; s + wkv4::kGroup <= n; s += wkv4::kGroup)
        group(st, s, std::integral_constant<int, wkv4::kGroup>{});
      for (; s < n; ++s) group(st, s, std::integral_constant<int, 1>{});
    } else if (warp == 1 && i >= 1) {
      const float* d = buf(i - 1);
      wkv4::run_groups(
          min(Lc, T - (i - 1) * Lc), !live, st,
          [&](Fwd1& cs, int s0, const auto& un, auto size) {
            constexpr int G = decltype(size)::value;
            float y[G], ra[G], rb[G];
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const int e = (s0 + g) * kLanes + lane;
              const float den = d[5 * rows + e];
              y[g] = un.div(d[6 * rows + e], den);
              ra[g] = un.div(d[3 * rows + e], den);
              rb[g] = un.div(d[4 * rows + e], den);
            }
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const int e = (s0 + g) * kLanes + lane;
              const float vt = d[rows + e], gt = d[2 * rows + e];
              cs.gw = cs.gw +
                      gt * (d[7 * rows + e] - y[g] * d[8 * rows + e]) * ra[g];
              cs.gu = cs.gu + gt * (vt - y[g]) * rb[g];
            }
          });
    }
    __syncthreads();
  }
  if (warp == 0) repro::cp_async_wait<0>();
  if (warp == 1 && live) {
    gw_part[idx] = st.gw;
    gu_part[idx] = st.gu;
  }
  // reverse pass: round i, warp 0 recomputes chunk NC-1-i, warp 1 walks
  // chunk NC-i backward.  Chunks NC-3 .. NC-1 are still in their buffers
  // from the forward pass; chunk jr-1's copies run a round ahead.
  Rev rv{0.f, 0.f, -1e38f};                // warp 1's (GP, GQ)·e^{og}
  Carry nx{0.f, 0.f, 0.f};                 // warp 0's next checkpoint
  if (warp == 0 && live) {
    nx.a = ck[static_cast<size_t>(NC - 1) * C];
    nx.b = ck[plane + static_cast<size_t>(NC - 1) * C];
    nx.o = ck[2 * plane + static_cast<size_t>(NC - 1) * C];
  }
  for (int i = 0; i <= NC; ++i) {
    const int jr = NC - 1 - i;
    if (warp == 0 && jr >= 0) {
      issue(jr - 1, jr - 1 >= 0 && jr - 1 <= NC - 4);
      Carry st = nx;
      if (live && jr >= 1) {
        nx.a = ck[static_cast<size_t>(jr - 1) * C];
        nx.b = ck[plane + static_cast<size_t>(jr - 1) * C];
        nx.o = ck[2 * plane + static_cast<size_t>(jr - 1) * C];
      }
      repro::cp_async_wait<1>();
      __syncwarp();
      float* d = buf(jr);
      wkv4::run_groups(
          min(Lc, T - jr * Lc), !live, st,
          [&](Carry& cs, int s0, const auto& un, auto size) {
            constexpr int G = decltype(size)::value;
            float kt[G], vt[G];
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const int e = (s0 + g) * kLanes + lane;
              kt[g] = d[e];
              vt[g] = d[rows + e];
            }
            const Front<G> f = fwd_front<G>(cs.o, kt, wc, uc);
            float num[G], den[G];
#pragma unroll
            for (int g = 0; g < G; ++g) {
              den[g] = f.A[g] * cs.b + f.Bu[g];
              num[g] = f.A[g] * cs.a + f.Bu[g] * vt[g];
              cs.a = f.A2[g] * cs.a + f.B2[g] * vt[g];
              cs.b = f.A2[g] * cs.b + f.B2[g];
            }
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const int e = (s0 + g) * kLanes + lane;
              d[3 * rows + e] = un.div(num[g], den[g]);
              d[4 * rows + e] = den[g];
              d[5 * rows + e] = f.n[g];
              d[6 * rows + e] = f.Bu[g];
            }
          });
    } else if (warp == 1 && i >= 1) {
      const int jc = NC - i;
      float* d = buf(jc);
      const int t0 = jc * Lc, n = min(Lc, T - t0);
      wkv4::run_groups(n, !live, rv, [&](Rev& cs, int r0, const auto& un,
                                         auto size) {
        constexpr int G = decltype(size)::value;
        int e[G];
        float E[G], q1[G], q2[G];
        wkv4::ExpPair P[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {  // backward through the chunk
          e[g] = (n - 1 - r0 - g) * kLanes + lane;
          const float kt = d[e[g]], nt = d[5 * rows + e[g]];
          const float ogw = cs.og - wc, nog = fmaxf(ogw, -nt);
          E[g] = kt + cs.og;
          P[g] = wkv4::ExpPair(ogw, -nt, nog);  // e^(og-w-nog), e^(-n-nog)
          cs.og = nog;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          E[g] = expf(E[g]);
          P[g].exp(un);
        }
        // e^(u+k-n) is the forward's Bu, kept by the recompute
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float den = d[4 * rows + e[g]];
          q1[g] = un.div(d[6 * rows + e[g]], den);
          q2[g] = un.div(d[2 * rows + e[g]], den);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float vt = d[rows + e[g]], gt = d[2 * rows + e[g]],
                      y = d[3 * rows + e[g]];
          const float direct = gt * q1[g], Bt = P[g].ez(1.f) * q2[g];
          const float A = P[g].ex(1.f);
          d[7 * rows + e[g]] =
              direct * (vt - y) + E[g] * (cs.gp * vt - cs.gq);
          d[8 * rows + e[g]] = direct + E[g] * cs.gp;
          cs.gp = A * cs.gp + Bt;
          cs.gq = A * cs.gq + Bt * y;
        }
      });
      __syncwarp();  // the chunk's gk and gv rows out, whole rows
      wkv4::unstage_rows<VEC>(gk, d + 7 * rows, row0 + t0, n, C, c0, lane);
      wkv4::unstage_rows<VEC>(gv, d + 8 * rows, row0 + t0, n, C, c0, lane);
    }
    __syncthreads();
  }
  if (warp == 0) repro::cp_async_wait<0>();
}

// gw[c], gu[c] = Σ_b of the (b, c) partials, b in order
__global__ void wkv4_bwd_reduce(const float* __restrict__ gw_part,
                                const float* __restrict__ gu_part,
                                float* __restrict__ gw, float* __restrict__ gu,
                                int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sw = 0.f, su = 0.f;
  for (int b = 0; b < B; ++b) {
    sw = sw + gw_part[static_cast<size_t>(b) * C + c];
    su = su + gu_part[static_cast<size_t>(b) * C + c];
  }
  gw[c] = sw;
  gu[c] = su;
}

}  // namespace

// k, v, gy (B,T,C) f32; w, u (C,); a0, b0, o0 (B,C) -> gk, gv (B,T,C),
// gw, gu (C,); part (2, B, C) and ckpt (3, B, ⌈T/Lc⌉, C) f32 work space
// (kernels/wkv4.py:k2_plan); chunk: Lc, 0 for the plan's default (the
// outputs do not depend on it).
extern "C" int wkv4_seq_bwd(const void* k, const void* v, const void* w,
                            const void* u, const void* a0, const void* b0,
                            const void* o0, const void* gy, void* gk,
                            void* gv, void* gw, void* gu, void* part,
                            void* ckpt, int B, int T, int C, int chunk,
                            void* stream) {
  wkv4::Plan p;
  if (T < 1 || !wkv4::plan_of(B, T, C, false, 0, 0, chunk, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* gw_part = static_cast<float*>(part);
  float* gu_part = gw_part + static_cast<size_t>(B) * C;
  const void* ptrs[] = {k, v, gy, gk, gv};
  auto kern = wkv4_bwd_kernel<false>;
  if (wkv4::vec_ok(C, ptrs, 5)) kern = wkv4_bwd_kernel<true>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.bwd_smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(static_cast<unsigned>(p.bwd_grid_x),
              static_cast<unsigned>(p.bwd_grid_y)),
         static_cast<unsigned>(p.bwd_threads), p.bwd_smem, st>>>(
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(a0), static_cast<const float*>(b0),
      static_cast<const float*>(o0), static_cast<const float*>(gy),
      static_cast<float*>(gk), static_cast<float*>(gv), gw_part, gu_part,
      static_cast<float*>(ckpt), B, T, C, static_cast<int>(p.chunk));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv4_bwd_reduce<<<(C + 255) / 256, 256, 0, st>>>(
      gw_part, gu_part, static_cast<float*>(gw), static_cast<float*>(gu), B,
      C);
  return static_cast<int>(cudaGetLastError());
}
