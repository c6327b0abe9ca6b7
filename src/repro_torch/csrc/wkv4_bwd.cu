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
// What bounds it on an H100: bytes, and in practice the serial chain.
// The function reads k, v and gy and writes gk and gv (B8 T1024 C768:
// 126 MB): ≥ 0.0376 ms at 3.35 TB/s.  This design also stores the
// per-step (y, den, n) that the reverse pass needs and reads them back
// (151 MB more, ≥ 0.083 ms with them), traffic of its own.  The
// known design for this recurrence (RWKV-LM's public wkv_cuda.cu) gives
// one thread one (b, c) channel for both passes, as K2's forward does:
// the state lives in registers, and neighbouring threads touch
// neighbouring channels, so every access is coalesced.  The per-step
// values go to a (3, B, T, C) f32 scratch in device memory (the same
// thread writes and reads them, so no barrier).  gw and gu are per-(b, c)
// partials, summed over b in order by a second kernel: no atomics, the
// same bits every run.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
wkv4_bwd_kernel(const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ a0, const float* __restrict__ b0,
                const float* __restrict__ o0, const float* __restrict__ gy,
                float* __restrict__ gk, float* __restrict__ gv,
                float* __restrict__ gw_part, float* __restrict__ gu_part,
                float* __restrict__ scratch, int B, int T, int C) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * C) return;
  const int b = idx / C, c = idx % C;
  const size_t plane = static_cast<size_t>(B) * T * C;
  float* sy = scratch;
  float* sden = scratch + plane;
  float* sn = scratch + 2 * plane;
  const float wc = w[c], uc = u[c];
  // forward pass: K2's state, the per-step values, gw and gu
  float a = a0[idx], bb = b0[idx], o = o0[idx];
  float da = 0.f, db = 0.f, gw = 0.f, gu = 0.f;
  for (int t = 0; t < T; ++t) {
    const size_t off = (static_cast<size_t>(b) * T + t) * C + c;
    const float kt = k[off], vt = v[off], gt = gy[off];
    const float n = fmaxf(o, uc + kt);
    const float A = expf(o - n);
    const float Bu = expf(uc + kt - n);
    const float den = A * bb + Bu;
    const float y = (A * a + Bu * vt) / den;
    gw = gw + gt * (da - y * db) * (A / den);
    gu = gu + gt * (vt - y) * (Bu / den);
    sy[off] = y;
    sden[off] = den;
    sn[off] = n;
    const float n2 = fmaxf(o - wc, kt);
    const float A2 = expf(o - wc - n2);
    const float B2 = expf(kt - n2);
    da = A2 * (da - a);
    db = A2 * (db - bb);
    a = A2 * a + B2 * vt;
    bb = A2 * bb + B2;
    o = n2;
  }
  gw_part[idx] = gw;
  gu_part[idx] = gu;
  // reverse pass: (GP, GQ) = (gp, gq)·e^{og}
  float gp = 0.f, gq = 0.f, og = -1e38f;
  for (int t = T - 1; t >= 0; --t) {
    const size_t off = (static_cast<size_t>(b) * T + t) * C + c;
    const float kt = k[off], vt = v[off], gt = gy[off];
    const float y = sy[off], den = sden[off], n = sn[off];
    const float direct = gt * (expf(uc + kt - n) / den);
    const float E = expf(kt + og);
    gk[off] = direct * (vt - y) + E * (gp * vt - gq);
    gv[off] = direct + E * gp;
    const float nog = fmaxf(og - wc, -n);
    const float A = expf(og - wc - nog);
    const float Bt = expf(-n - nog) * (gt / den);
    gp = A * gp + Bt;
    gq = A * gq + Bt * y;
    og = nog;
  }
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
// gw, gu (C,); part (2, B, C) and scratch (3, B, T, C) f32 work space
extern "C" int wkv4_seq_bwd(const void* k, const void* v, const void* w,
                            const void* u, const void* a0, const void* b0,
                            const void* o0, const void* gy, void* gk,
                            void* gv, void* gw, void* gu, void* part,
                            void* scratch, int B, int T, int C,
                            void* stream) {
  if (B < 1 || T < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* gw_part = static_cast<float*>(part);
  float* gu_part = gw_part + static_cast<size_t>(B) * C;
  wkv4_bwd_kernel<<<(B * C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(a0), static_cast<const float*>(b0),
      static_cast<const float*>(o0), static_cast<const float*>(gy),
      static_cast<float*>(gk), static_cast<float*>(gv), gw_part, gu_part,
      static_cast<float*>(scratch), B, T, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv4_bwd_reduce<<<(C + 255) / 256, 256, 0, st>>>(
      gw_part, gu_part, static_cast<float*>(gw), static_cast<float*>(gu), B,
      C);
  return static_cast<int>(cudaGetLastError());
}
