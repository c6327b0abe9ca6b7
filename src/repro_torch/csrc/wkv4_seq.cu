// K2: the masked RWKV-4 WKV recurrence over a prompt chunk.
//
// Replaces the TPU kernel kernels/wkv4.py:wkv4_pallas (_kernel), with the
// `valid` commit mask, the bf16 carry snap and both numerics: exact (expf
// and division) or, given the exp_table/div_table operands, the paper's
// hardware units (hw_units.cuh: LUT exp, LUT division), both tables staged
// in shared memory as the TPU kernel kept them in VMEM.
//
// k, v (B,T,C) f32; w, u (C,) f32; a0, b0, o0 (B,C) f32; valid (B,T) i32;
// exp_tab, div_tab (256,) f32 or both null -> y (B,T,C) f32 and the final
// (a, b, o) (B,C) f32.
//
// What bounds it on an H100: the serial chain of each channel, then bytes.
// Each (b, c) channel is an independent recurrence of ~20 f32 operations
// (four exponentials and a division) a step; the function reads k and v
// and writes y once (B8 T1024 C768: 75.5 MB, >= 0.0226 ms at 3.35 TB/s).
// A step's output waits on its exponentials and division, and the next
// step on the state, so a channel runs at the latency of a step, and the
// card is only as fast as it keeps every channel's next operands on chip.
// The first design loaded k and v inside the step loop, one thread a
// channel: every step waited on a device-memory round trip (0.69 us a
// step, 3% of the bytes rate).  This one gives a warp 32 consecutive
// channels of one batch row (a lane a channel, the state in registers)
// and copies k, v and the valid flags of whole tiles of steps into a ring
// of shared-memory stages by cp.async (wkv4_common.cuh: each step's row of
// the warp's channels one 128-byte line; 16-byte copies where C and the
// pointers allow), three tiles ahead of the step that reads them.  At B8
// C768 that is 192 warps, one or two an SM.  y goes into the stage beside
// k and v and leaves as whole rows (16-byte stores) when the tile is done.
// The steps run in checked groups of 8 (wkv4_common.cuh:run_groups),
// ordered by phase so that a channel's consecutive steps overlap, one
// exponential for each pair of a step's exponentials.
//
// Each step is repro::wkv4_step's arithmetic (kernels/wkv4.py:61-85):
// output from the carried state, state update, commit only where valid,
// then snap the carry through bf16 (__float2bfloat16_rn) and back, as the
// per-op oracle stores its state in the bf16 pool between steps.  Every
// value is the first design's, from the same operations on the same
// operands (the groups reorder independent operations only), so the
// outputs keep its bits for every tile, grid and block shape.
#include <string.h>

#include <type_traits>

#include "hw_units.cuh"
#include "wkv4_common.cuh"

namespace {

using wkv4::kLanes;
using wkv4::kStages;

// one warp's recurrence over its 32 channels of batch row b
template <bool VEC, bool MASK, bool SNAP, class Units>
__device__ __forceinline__ void wkv4_seq_warp(
    const float* __restrict__ k, const float* __restrict__ v, float wc,
    float uc, const int32_t* __restrict__ valid, float* __restrict__ y,
    float* ring, float* sa, float* sb, float* so, int b, int c0, int lane,
    int T, int C, int tile, const Units& un) {
  const int sf = wkv4::stage_floats(tile);
  const int c = c0 + lane;
  const bool live = c < C;
  const size_t row0 = static_cast<size_t>(b) * T;
  const int tiles = (T + tile - 1) / tile;
  auto issue = [&](int j) {
    if (j < tiles) {
      const int t0 = j * tile, n = min(tile, T - t0);
      float* st = ring + (j % kStages) * sf;
      wkv4::stage_rows<VEC>(st, k, row0 + t0, n, C, c0, lane);
      wkv4::stage_rows<VEC>(st + tile * kLanes, v, row0 + t0, n, C, c0, lane);
      if constexpr (MASK)
        for (int s = lane; s < n; s += kLanes)
          repro::cp_async4(st + 3 * tile * kLanes + s, valid + row0 + t0 + s,
                           4);
    }
    repro::cp_async_commit();  // empty past the end: one group a tile
  };
  for (int j = 0; j < kStages - 1; ++j) issue(j);
  const float one = un.exp(0.f);  // the e^(±0) of every exponential pair
  struct Carry {
    float a, b, o;
  } st{*sa, *sb, *so};
  for (int j = 0; j < tiles; ++j) {
    repro::cp_async_wait<kStages - 2>();
    __syncwarp();  // tile j landed for every lane; tile j - 1 read by all
    issue(j + kStages - 1);
    float* ks = ring + (j % kStages) * sf;
    float* vs = ks + tile * kLanes;
    float* ys = vs + tile * kLanes;
    const int32_t* vm = reinterpret_cast<const int32_t*>(ys + tile * kLanes);
    const int t0 = j * tile, n = min(tile, T - t0);
    // steps s0 .. s0+G-1 of the tile, each repro::wkv4_step's operations
    // on its operands, ordered by phase (wkv4_common.cuh:run_groups): the
    // running max o of all G steps (committed where valid, snapped), the
    // exponentials, the (a, b) chain with each step's fraction, then the
    // divisions into the stage's y row
    auto group = [&](Carry& cs, int s0, const auto& units, auto size) {
      constexpr int G = decltype(size)::value;
      float A[G], B[G], A2[G], B2[G], vt[G];
      wkv4::ExpPair P1[G], P2[G];
      bool ok[G];
      float o = cs.o;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int e = (s0 + g) * kLanes + lane;
        const float kt = ks[e], uk = uc + kt, ow = o - wc;
        vt[g] = vs[e];
        const float no1 = fmaxf(o, uk), no2 = fmaxf(ow, kt);
        P1[g] = wkv4::ExpPair(o, uk, no1);  // e^(o-no1), e^(uk-no1)
        P2[g] = wkv4::ExpPair(ow, kt, no2);  // e^(ow-no2), e^(kt-no2)
        float no = no2;
        if constexpr (MASK) {
          ok[g] = vm[s0 + g] != 0;
          no = ok[g] ? no : o;
        }
        if constexpr (SNAP) no = repro::bf16r(no);
        o = no;
      }
      cs.o = o;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        P1[g].exp(units);
        P2[g].exp(units);
        A[g] = P1[g].ex(one);
        B[g] = P1[g].ez(one);
        A2[g] = P2[g].ex(one);
        B2[g] = P2[g].ez(one);
      }
      float num[G], den[G], a = cs.a, b = cs.b;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        num[g] = A[g] * a + B[g] * vt[g];
        den[g] = A[g] * b + B[g];
        float na = A2[g] * a + B2[g] * vt[g], nb = A2[g] * b + B2[g];
        if constexpr (MASK) {
          na = ok[g] ? na : a;
          nb = ok[g] ? nb : b;
        }
        if constexpr (SNAP) {
          na = repro::bf16r(na);
          nb = repro::bf16r(nb);
        }
        a = na;
        b = nb;
      }
      cs.a = a;
      cs.b = b;
#pragma unroll
      for (int g = 0; g < G; ++g)
        ys[(s0 + g) * kLanes + lane] = units.div(num[g], den[g]);
    };
    if constexpr (std::is_same<Units, repro::ExactUnits>::value) {
      wkv4::run_groups(n, !live, st, group);
    } else {  // the LUT units: their own division, no check
      int s = 0;
      for (; s + wkv4::kGroup <= n; s += wkv4::kGroup)
        group(st, s, un, std::integral_constant<int, wkv4::kGroup>{});
      for (; s < n; ++s) group(st, s, un, std::integral_constant<int, 1>{});
    }
    __syncwarp();  // the tile's y rows out, whole rows
    wkv4::unstage_rows<VEC>(y, ys, row0 + t0, n, C, c0, lane);
  }
  repro::cp_async_wait<0>();
  *sa = st.a;
  *sb = st.b;
  *so = st.o;
}

template <bool HW, bool VEC, bool MASK, bool SNAP>
__global__ void __launch_bounds__(wkv4::kMaxWarps * kLanes)
wkv4_seq_kernel(const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ a0, const float* __restrict__ b0,
                const float* __restrict__ o0,
                const int32_t* __restrict__ valid,
                const float* __restrict__ exp_tab,
                const float* __restrict__ div_tab, float* __restrict__ y,
                float* __restrict__ af, float* __restrict__ bf,
                float* __restrict__ of, int T, int C, int tile) {
  extern __shared__ __align__(16) float smem[];
  float* tabs = smem;
  if constexpr (HW) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
      tabs[i] = exp_tab[i];
      tabs[256 + i] = div_tab[i];
    }
    __syncthreads();
  }
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int warps = blockDim.x / kLanes;
  const int c0 = (blockIdx.x * warps + warp) * kLanes;
  if (c0 >= C) return;
  const int b = blockIdx.y, c = c0 + lane;
  const bool live = c < C;
  float* ring = smem + (HW ? wkv4::kTabFloats : 0) +
                warp * kStages * wkv4::stage_floats(tile);
  const size_t idx = static_cast<size_t>(b) * C + c;
  // a lane past C runs on zeros and stores nothing
  float sa = live ? a0[idx] : 0.f, sb = live ? b0[idx] : 0.f,
        so = live ? o0[idx] : 0.f;
  const float wc = live ? w[c] : 0.f, uc = live ? u[c] : 0.f;
  if constexpr (HW)
    wkv4_seq_warp<VEC, MASK, SNAP>(k, v, wc, uc, valid, y, ring, &sa, &sb,
                                   &so, b, c0, lane, T, C, tile,
                                   repro::LutUnits{tabs, tabs + 256});
  else
    wkv4_seq_warp<VEC, MASK, SNAP>(k, v, wc, uc, valid, y, ring, &sa, &sb,
                                   &so, b, c0, lane, T, C, tile,
                                   repro::ExactUnits());
  if (live) {
    af[idx] = sa;
    bf[idx] = sb;
    of[idx] = so;
  }
}

template <bool HW, bool VEC, bool MASK, bool SNAP>
int launch(const wkv4::Plan& p, const float* k, const float* v,
           const float* w, const float* u, const float* a0, const float* b0,
           const float* o0, const int32_t* valid, const float* et,
           const float* dt, float* y, float* af, float* bf, float* of, int T,
           int C, cudaStream_t st) {
  auto kern = wkv4_seq_kernel<HW, VEC, MASK, SNAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.fwd_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(static_cast<unsigned>(p.fwd_grid_x),
              static_cast<unsigned>(p.fwd_grid_y)),
         static_cast<unsigned>(p.fwd_threads), p.fwd_smem, st>>>(
      k, v, w, u, a0, b0, o0, valid, et, dt, y, af, bf, of, T, C,
      static_cast<int>(p.tile));
  return static_cast<int>(cudaGetLastError());
}

// q = div_rn_fast(x, y) elementwise, whether each quotient is in its
// range, and ref = x / y as the compiler divides (the on-card tests hold
// q to ref where it is in range)
__global__ void div_fast_kernel(const float* __restrict__ x,
                                const float* __restrict__ y,
                                float* __restrict__ q, int8_t* __restrict__ in,
                                float* __restrict__ ref, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    bool ok;
    q[i] = wkv4::div_rn_fast(x[i], y[i], &ok);
    in[i] = ok;
    ref[i] = x[i] / y[i];
  }
}

}  // namespace

// x, y, q, ref (n,) f32; in (n,) i8
extern "C" int wkv4_div_fast(const void* x, const void* y, void* q, void* in,
                             void* ref, long long n, void* stream) {
  div_fast_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(q), static_cast<int8_t*>(in),
      static_cast<float*>(ref), n);
  return static_cast<int>(cudaGetLastError());
}

// tile, warps: steps a ring stage and warps a block, 0 for the plan's
// defaults (wkv4_common.cuh); the outputs do not depend on either.
extern "C" int wkv4_seq(const void* k, const void* v, const void* w,
                        const void* u, const void* a0, const void* b0,
                        const void* o0, const void* valid, const void* exp_tab,
                        const void* div_tab, void* y, void* af, void* bf,
                        void* of, int B, int T, int C, int snap_bf16,
                        int tile, int warps, void* stream) {
  if ((exp_tab == nullptr) != (div_tab == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  wkv4::Plan p;
  if (!wkv4::plan_of(B, T, C, exp_tab != nullptr, tile, warps, 0, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {k, v, y};
  const bool vec = wkv4::vec_ok(C, ptrs, 3);
  const int form = (exp_tab ? 8 : 0) | (vec ? 4 : 0) | (valid ? 2 : 0) |
                   (snap_bf16 ? 1 : 0);
  const auto st = static_cast<cudaStream_t>(stream);
#define K2_ARGS                                                             \
  p, static_cast<const float*>(k), static_cast<const float*>(v),           \
      static_cast<const float*>(w), static_cast<const float*>(u),          \
      static_cast<const float*>(a0), static_cast<const float*>(b0),        \
      static_cast<const float*>(o0), static_cast<const int32_t*>(valid),   \
      static_cast<const float*>(exp_tab), static_cast<const float*>(div_tab), \
      static_cast<float*>(y), static_cast<float*>(af),                     \
      static_cast<float*>(bf), static_cast<float*>(of), T, C, st
#define K2_CASE(F, HW, VEC, MASK, SNAP) \
  case F:                               \
    return launch<HW, VEC, MASK, SNAP>(K2_ARGS);
  switch (form) {
    K2_CASE(0, false, false, false, false)
    K2_CASE(1, false, false, false, true)
    K2_CASE(2, false, false, true, false)
    K2_CASE(3, false, false, true, true)
    K2_CASE(4, false, true, false, false)
    K2_CASE(5, false, true, false, true)
    K2_CASE(6, false, true, true, false)
    K2_CASE(7, false, true, true, true)
    K2_CASE(8, true, false, false, false)
    K2_CASE(9, true, false, false, true)
    K2_CASE(10, true, false, true, false)
    K2_CASE(11, true, false, true, true)
    K2_CASE(12, true, true, false, false)
    K2_CASE(13, true, true, false, true)
    K2_CASE(14, true, true, true, false)
    K2_CASE(15, true, true, true, true)
  }
#undef K2_CASE
#undef K2_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan of a K2 / K2-bwd call for (B, T, C) (hw: the LUT tables;
// tile, warps, chunk: 0 for the defaults): out[wkv4::kPlanFields] in the
// order of wkv4::Plan.
extern "C" int wkv4_plan(int B, int T, int C, int hw, int tile, int warps,
                         int chunk, long long* out) {
  wkv4::Plan p;
  if (!wkv4::plan_of(B, T, C, hw != 0, tile, warps, chunk, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  memcpy(out, &p, sizeof p);
  return 0;
}
