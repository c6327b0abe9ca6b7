// The RWKV-6 layer decode body, shared by K7-block (rwkv6_block_decode.cu,
// one layer per launch) and K7-model (rwkv6_model_decode.cu, every layer
// in one launch): one kernel, `rwkv6_decode_kernel`, whose instances and
// launch live in rwkv6_model_decode.cu, so both forms run the same code and
// give the same bits.
//
// One call runs models/rwkv6.py:block_decode (exact numerics) for each of
// its layers and all B <= 8 lanes, spread over the whole card: a
// cooperative launch of one 384-thread block an SM (8 consumer warps and 4
// producer warps, one of each kind an SM sub-partition).
//
// What bounds it on an H100: bytes.  A rwkv6-7b layer reads 220 MB of W8
// codes (440 MB of plain bf16 weights), 68 µs at 3.35 TB/s, against ~3.5
// GFLOP at B 8.  The design before this one ran CUDA-core FMA chains over
// weights it read one dependent L2 round trip a row, decoded each W8
// weight with ~20 instructions and paid ten grid barriers a layer: 0.648
// ms a W8 layer on "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md §6, PR 21
// run 8).  This one:
//
// 1. Streams the weights through a ring of kSlots 16 KB stages in shared
//    memory, filled by the producer warps with 16-byte cp.async (4-byte
//    where a matrix's rows are not 16-byte aligned), each slot's arrival
//    counted on an mbarrier.  A block's stages follow a fixed order,
//    (layer, phase, item, stage), that no activation changes, so the ring
//    runs ahead across phases and, in K7-model, across layers: when a grid
//    barrier opens a phase, the block's first stages of it are on chip.
//    Four producer warps, not one, so that the copies' issue never waits
//    on a sub-partition busy with decoding (PERF.md §6, PR 28 run 15).
// 2. Runs the products on the tensor cores: mma.sync m16n8k16, the weights
//    the A operand (16 output columns x 16 k), the lanes the n8 operand,
//    f32 accumulators.  Each weight is decoded once, in registers, with
//    the bits of unpack_leaf: a W8 or W4 code through a 256- or 16-entry
//    table of sign·level in shared memory (kTabCopies copies, one a bank)
//    times the column's f32 scale, rounded once to bf16 (common.cuh:
//    dpot_w8_decode, dpot_w4_decode); a VQ code through the codebook,
//    staged the same way; plain bf16 weights as they are (ldmatrix.trans).
//    A bf16 weight times a bf16 x is exact in f32, so one MMA per 16x16
//    weight tile suffices.  The activation operand sits in shared memory
//    in fragment order (one 8-byte load a thread a k-step); the inputs
//    that other blocks produce are written to the scratch in that order
//    and copied in by one round of cp.async, those a block mixes itself
//    (the LayerNorms' outputs) computed there.
// 3. Deals the work so that every SM has some in every phase.  An item is a
//    strip of 32 columns whose rows are whole 32-byte sectors (two for
//    plain bf16 weights); a phase's items are cut into G contiguous
//    ranges, one a block.  maa_w1 (160 columns) is cut along K into
//    slices of kSliceRows rows across blocks; each slice writes f32
//    partials that the next phase sums in slice order.  The WKV phase
//    deals its (lane, head) items over every block.
// 4. Pays seven grid barriers a layer (the design before, ten): every
//    block recomputes LN1 and the xxx mix for its maa_w1 slice, and LN2 and
//    the channel-mix mixes for its items; td_w2 (K 64) runs inside the WKV
//    phase, each (lane, head) item computing its head's N decays.  Phases:
//      A. LN1 statistics (each block), att_x, h, dx (spread); maa_w1's
//         K slices -> f32 partials.                             barrier
//      B. dmix = tanh(Σ slices); x_s = h + dx·(μ_s + dmix_s @ maa_w2[s])
//         for s in (w, k, v, r, g).                             barrier
//      C. r, k, v = x_s @ W; g = silu(x_g @ wg); a = tanh(x_w @ td_w1).
//                                                               barrier
//      D. per (lane, head): w = exp(-exp(time_decay + a @ td_w2)), the
//         WKV-6 step (new wkv_s), GroupNorm, y·g.              barrier
//      E. x2 = x + (y·g) @ wo.                                  barrier
//      F. LN2 statistics (each block), ffn_x (spread); rr = σ(mr @
//         ffn.wr), kk = relu(mk @ ffn.wk)², mr and mk mixed per block.
//                                                               barrier
//      G. x = x2 + rr·(kk @ ffn.wv); kk staged 4096 rows at a time.
//    and one barrier between layers in K7-model (the launch's end in
//    K7-block).  The grid barrier is the consumers' own (a counter in the
//    scratch), so the producers never wait on it.
//
// Where it stands (PR 28 run 27, the card above): K7-block W8 0.294 ms a
// layer, 4.3x its bytes bound; K7-model 9.13 ms W8, 10.26 MIXED, 10.17
// plain bf16.  A probe (PERF.md §6, PR 28) finds the products ~10% of a
// layer: what binds is the work around the stream (each item's end: its
// warps' sums and epilogue; the mixes each block computes; LayerNorm and
// WKV; the barriers), during which the ring fills and the stream stops, and
// the loop state ptxas spills (a 12-warp block has 168 registers a
// thread), reloaded each stage: the block keeps its shared memory within
// the 164 KB carve-out, so that the L1 holds those spills.
//
// Every value the JAX trace holds in bf16 is rounded to bf16 at the same
// place (bf16r): the LN outputs, each op of the mixes, each matvec output,
// tanh, the five delta rows, time_decay + lora, y after the WKV step, the
// GroupNorm output, the silu expansion and y·g, relu², the gated products
// and both residual adds.  The element-wise reads of time_maa_x, time_maa,
// time_faaaa and td_w2 go through decode_elem, the plane's policy
// (common.cuh: Decode).  A W4 leaf must pair rows within a layer: a (L, D)
// leaf that pack_leaf paired across layers is refused by the wrappers.
//
// The sum order, on which the identities rest: within an item, warp w of
// the 8 consumer warps takes the k-steps (16 rows) k ≡ w (mod 8) of the
// item in ascending order, each k-step's 16 products summed by one MMA
// from zero and added to the warp's sum by an f32 add; the warps' sums are
// added as a pairwise tree ((w0 + w1) + (w2 + w3)) + ...; a K-sliced
// output adds its slices' sums in slice order.  The slices and k-steps
// depend on (K, N) alone, the MMA's output columns on nothing but their
// own weights and lanes, every LayerNorm is one warp's per lane in a fixed
// order (recomputed by each block), td_w2 and every GroupNorm are fixed
// chains and trees: a lane's bits do not depend on B, on the grid, on the
// other lanes or on the launch form (K7-model = L K7-block launches).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace rwkv6 {

constexpr int kLanes = 8;        // batch lanes one launch carries (B <= 8)
constexpr int kWarps = 8;        // consumer warps a block
constexpr int kConsumers = 32 * kWarps;
constexpr int kProducers = 4;    // producer warps, one an SM sub-partition
constexpr int kThreads = kConsumers + 32 * kProducers;
constexpr int kMaaRank = 32;     // models/rwkv6.py:MAA_RANK
constexpr int kTdRank = 64;      // models/rwkv6.py:TD_RANK
constexpr int kMaxCodebook = 256;  // VQ codebook entries (uint8 indices)
// PLANES of a layer whose matrices' planes are read at run time
constexpr int kPlaneAny = -1;
constexpr int kRowBytes = 32;    // a code strip's row: one 32-byte sector
constexpr int kSlotRows = 512;   // code strip rows a ring slot holds
constexpr int kSlotBytes = kRowBytes * kSlotRows;
constexpr int kSlots = 4;        // ring slots
constexpr int kXRows = 4096;     // activation rows the x buffer holds
constexpr int kSliceRows = 256;  // rows of a K slice of maa_w1
constexpr int kTabCopies = 16;   // decode table copies (a bank each)
constexpr int kTabWords = 256 * kTabCopies;
constexpr int kRedFloats = kWarps * 32 * kLanes;  // warps' partial sums
constexpr int kBarriersPerLayer = 7;

// the layer's bf16 vectors, each (D,)
enum Vec {
  LN1_W, LN1_B, LN2_W, LN2_B, TIME_DECAY, LNX_W, LNX_B, FFN_MIX_R,
  FFN_MIX_K, kNumVecs
};
// the layer's matrices (each a W8, W4 or VQ plane or bf16 weights):
// time_maa_x (D), time_maa (5, D), time_faaaa (H, N), maa_w1 (D, 160),
// maa_w2 (5, 32, D), td_w1 (D, 64), td_w2 (64, D), att.wr/wk/wv/wg/wo and
// ffn.wr (D, D), ffn.wk (D, F), ffn.wv (F, D)
enum Mat {
  TIME_MAA_X, TIME_MAA, TIME_FAAAA, MAA_W1, MAA_W2, TD_W1, TD_W2, ATT_WR,
  ATT_WK, ATT_WV, ATT_WG, ATT_WO, FFN_WR, FFN_WK, FFN_WV, kNumMats
};
// the recurrent state leaves of one layer: att_x, ffn_x (B, D), wkv_s
// (B, H, N, N), all bf16
enum State { ATT_X, FFN_X, WKV_S, kNumState };
// the phases with matvec items (the WKV phase D has none)
enum Phase { kPA, kPB, kPC, kPE, kPF, kPG, kNumPhases };

// Dynamic shared memory, bytes from a 128-byte aligned base
// (kernels/fused_decode.py:k7_plan mirrors it): the ring, the x buffer
// (kXRows x 8 lanes bf16 in fragment order; phase D's arrays), the decode
// table, the warps' partial sums (two buffers, items alternating), each
// slot's 32 column scales (W8, W4),
// each slot's full and empty barriers, two LN statistics a lane.
struct Smem {
  int ring, x, tab, red, scl, bars, stats, total;
};
__host__ __device__ constexpr Smem smem_layout() {
  constexpr int ring = 0;
  constexpr int x = ring + kSlots * kSlotBytes;
  constexpr int tab = x + kXRows * kLanes * 2;
  constexpr int red = tab + kTabWords * 4;
  constexpr int scl = red + 2 * kRedFloats * 4;
  constexpr int bars = scl + kSlots * 32 * 4;
  constexpr int stats = bars + 2 * kSlots * 8;
  return Smem{ring, x, tab, red, scl, bars, stats, stats + 2 * kLanes * 4};
}
constexpr int kSmemBytes = smem_layout().total;

// The block's dynamic shared memory; its regions at compile-time offsets,
// so that no pointer to them lives in a register.
extern __shared__ __align__(128) unsigned char k7_smem[];
__device__ __forceinline__ unsigned char* s_ring() {
  return k7_smem + smem_layout().ring;
}
__device__ __forceinline__ bf16* s_x() {
  return reinterpret_cast<bf16*>(k7_smem + smem_layout().x);
}
__device__ __forceinline__ float* s_tab() {
  return reinterpret_cast<float*>(k7_smem + smem_layout().tab);
}
__device__ __forceinline__ float* s_red() {
  return reinterpret_cast<float*>(k7_smem + smem_layout().red);
}
__device__ __forceinline__ float* s_scl() {
  return reinterpret_cast<float*>(k7_smem + smem_layout().scl);
}
__device__ __forceinline__ uint64_t* s_full() {
  return reinterpret_cast<uint64_t*>(k7_smem + smem_layout().bars);
}
__device__ __forceinline__ uint64_t* s_empty() { return s_full() + kSlots; }
__device__ __forceinline__ float* s_mu() {
  return reinterpret_cast<float*>(k7_smem + smem_layout().stats);
}
__device__ __forceinline__ float* s_rs() { return s_mu() + kLanes; }

// The intermediates, carved from the wrapper's scratch (zeroed).  Rows
// are lane-major, (8, ·), except the matvec inputs that the x buffer
// copies (xs, y, kk): those are x-buffer images (image_at), Kp x 8 values
// for Kp = K padded to a multiple of 16 (Dp, pad16(F)).  Lanes >= B and
// the pads are never written.
struct Scratch {
  unsigned* sync;        // [0] grid-barrier arrivals, [1] blocks finished
  bf16 *h, *dx;          // (8, D)
  float* part;           // (slices, 160, 8): maa_w1's partial sums
  bf16* xs;              // 5 images of Dp x 8: x_w, x_k, x_v, x_r, x_g
  bf16* tda;             // (8, 64): tanh(x_w @ td_w1)
  bf16 *r, *k, *v, *g;   // (8, D)
  bf16* y;               // image of Dp x 8: GroupNorm(y)·g
  bf16 *x2, *rr;         // (8, D)
  bf16* kk;              // image of pad16(F) x 8: relu(mk @ ffn.wk)²
  bf16* xres;            // (8, D): the residual between layers
  int Dp;
};

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline int maa_slices(int D) {
  return (D + kSliceRows - 1) / kSliceRows;
}

// Lays out the scratch from `base` (if s is not null) and returns its size
// in bytes; every buffer is 256-byte aligned.
inline size_t carve(unsigned char* base, int D, int F, Scratch* s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  const int Dp = pad16(D), Fp = pad16(F);
  const size_t lane_d = (size_t)kLanes * D * sizeof(bf16);
  const size_t lane_dp = (size_t)kLanes * Dp * sizeof(bf16);
  Scratch t;
  t.sync = reinterpret_cast<unsigned*>(take(2 * sizeof(unsigned)));
  t.h = reinterpret_cast<bf16*>(take(lane_d));
  t.dx = reinterpret_cast<bf16*>(take(lane_d));
  t.part = reinterpret_cast<float*>(take(
      (size_t)maa_slices(D) * 5 * kMaaRank * kLanes * sizeof(float)));
  t.xs = reinterpret_cast<bf16*>(take(5 * lane_dp));
  t.tda = reinterpret_cast<bf16*>(
      take((size_t)kLanes * kTdRank * sizeof(bf16)));
  t.r = reinterpret_cast<bf16*>(take(lane_d));
  t.k = reinterpret_cast<bf16*>(take(lane_d));
  t.v = reinterpret_cast<bf16*>(take(lane_d));
  t.g = reinterpret_cast<bf16*>(take(lane_d));
  t.y = reinterpret_cast<bf16*>(take(lane_dp));
  t.x2 = reinterpret_cast<bf16*>(take(lane_d));
  t.rr = reinterpret_cast<bf16*>(take(lane_d));
  t.kk = reinterpret_cast<bf16*>(take((size_t)kLanes * Fp * sizeof(bf16)));
  t.xres = reinterpret_cast<bf16*>(take(lane_d));
  t.Dp = Dp;
  if (s) *s = t;
  return off;
}

// What one launch runs, L layers (K7-block: L = 1): layer l's matrix m
// starts mat_layer[m] bytes after layer l - 1's, its vectors vec_layer
// elements after, its state leaves st_layer[k] elements after.  The
// scales and codebooks (aux) are shared by every layer.
struct Net {
  const uint8_t* mat[kNumMats];  // layer 0's codes (BF16: its weights)
  long long mat_layer[kNumMats];
  const void* aux[kNumMats];     // W8, W4: f32 scale; VQ: bf16 codebook
  int plane[kNumMats];           // enum Plane
  int aux_len[kNumMats];         // VQ: the codebook's entries
  const bf16* vec[kNumVecs];
  long long vec_layer;
  const bf16* st_in[kNumState];  // lane 0 of layer 0's leaf
  bf16* st_out[kNumState];
  long long st_layer[kNumState];
  const bf16* x;                 // (B, D)
  bf16* x_out;                   // (B, D)
  Scratch s;
  int L, B, D, F, H, N;
};

// ---- the launch plan: phases, jobs, items, stages -------------------------

__host__ __device__ inline int strip_cols(int) { return 32; }
// bytes of a strip row: 32 code bytes, or 32 bf16 weights (two sectors)
__host__ __device__ inline int row_bytes(int plane) {
  return plane == kPlaneBF16 ? 2 * kRowBytes : kRowBytes;
}
// strip rows a slot holds
__host__ __device__ inline int slot_rows(int plane) {
  return kSlotBytes / row_bytes(plane);
}
// contraction rows a strip row (byte row) holds
__host__ __device__ inline int rows_per_byte_row(int plane) {
  return plane == kPlaneW4 ? 2 : 1;
}
// W8 and VQ codes are read one word (4 columns) a row at rows c, c + 4,
// c + 8, c + 12 of a k-step, so the k order inside a k-step is permuted
// (the x operand follows it); W4 and BF16 keep k in order.
__host__ __device__ inline bool k_permuted(int plane) {
  return plane == kPlaneW8 || plane == kPlaneVQ;
}

__host__ __device__ inline int num_jobs(int p) {
  return p == kPB || p == kPC ? 5 : p == kPF ? 2 : 1;
}

// One matvec of a phase: rows [row0, row0 + K) of matrix m, N columns;
// sliced: K is cut into kSliceRows slices that sum into f32 partials.
struct Job {
  int m, row0, K, N, sliced;
};

__host__ __device__ inline Job job_of(int p, int j, int D, int F) {
  switch (p) {
    case kPA: return {MAA_W1, 0, D, 5 * kMaaRank, 1};
    case kPB: return {MAA_W2, j * kMaaRank, kMaaRank, D, 0};
    case kPC:
      return {j == 0 ? ATT_WR : j == 1 ? ATT_WK : j == 2 ? ATT_WV
              : j == 3 ? ATT_WG : TD_W1, 0, D, j == 4 ? kTdRank : D, 0};
    case kPE: return {ATT_WO, 0, D, D, 0};
    case kPF: return {j ? FFN_WK : FFN_WR, 0, D, j ? F : D, 0};
    default: return {FFN_WV, 0, F, D, 0};
  }
}

__host__ __device__ inline int job_slices(const Job& jb) {
  return jb.sliced ? (jb.K + kSliceRows - 1) / kSliceRows : 1;
}
__host__ __device__ inline int job_items(const Job& jb, int plane) {
  const int c = strip_cols(plane);
  return (jb.N + c - 1) / c * job_slices(jb);
}

__host__ __device__ inline int phase_items(int p, const int* planes, int D,
                                           int F) {
  int t = 0;
  for (int j = 0; j < num_jobs(p); ++j) {
    const Job jb = job_of(p, j, D, F);
    t += job_items(jb, planes[jb.m]);
  }
  return t;
}

// An item: strip `strip` of job `job`, contraction rows [k0, k1) of the
// job (its slice), columns [col0, col0 + ncols) clipped to N.
struct Item {
  Job jb;
  int job, plane, strip, slice, k0, k1, col0, ncols;
};

__host__ __device__ inline Item item_of(int p, int idx, const int* planes,
                                        int D, int F) {
  Item it;
  int j = 0;
  for (;; ++j) {
    it.jb = job_of(p, j, D, F);
    const int n = job_items(it.jb, planes[it.jb.m]);
    if (idx < n || j == num_jobs(p) - 1) break;
    idx -= n;
  }
  it.job = j;
  it.plane = planes[it.jb.m];
  const int S = job_slices(it.jb);
  it.strip = idx / S;
  it.slice = idx % S;
  it.k0 = it.jb.sliced ? it.slice * kSliceRows : 0;
  it.k1 = it.jb.sliced ? (it.k0 + kSliceRows < it.jb.K ? it.k0 + kSliceRows
                                                       : it.jb.K)
                       : it.jb.K;
  it.ncols = strip_cols(it.plane);
  it.col0 = it.strip * it.ncols;
  return it;
}

// Block b's items of a phase of T: [lo, hi), contiguous.
__host__ __device__ inline void block_range(int T, int G, int b, int* lo,
                                            int* hi) {
  *lo = (int)((long long)T * b / G);
  *hi = (int)((long long)T * (b + 1) / G);
}

// A stage: strip rows [br0, br0 + rows) of the item (relative to its
// first), nks k-steps, prow rows copied (the pad zero-filled), its first
// contraction row kst (job-relative).
struct Stage {
  int br0, rows, nks, prow, kst;
};

__host__ __device__ inline int item_byte_rows(const Item& it) {
  return (it.k1 - it.k0) / rows_per_byte_row(it.plane);
}
__host__ __device__ inline int item_stages(const Item& it) {
  const int r = item_byte_rows(it);
  const int sr = slot_rows(it.plane);
  return r <= 0 ? 1 : (r + sr - 1) / sr;
}
__host__ __device__ inline Stage stage_of(const Item& it, int st) {
  const int kpr = rows_per_byte_row(it.plane);
  const int total = item_byte_rows(it);
  Stage s;
  const int sr = slot_rows(it.plane);
  s.br0 = st * sr;
  s.rows = total - s.br0 < sr ? total - s.br0 : sr;
  s.nks = (s.rows * kpr + 15) / 16;
  s.prow = s.nks * 16 / kpr;
  s.kst = it.k0 + s.br0 * kpr;
  return s;
}

// Host side: the plan the kernel runs at these widths and grid, for the
// C plan query (kernels/fused_decode.py:k7_plan is its twin).  out: the
// block's threads, consumer warps, ring slots, slot bytes, x-buffer rows,
// K-slice rows, shared bytes, grid barriers a layer, the items of phases
// A, B, C, E, F, G, the stages of a layer over the grid and the most a
// block takes, the WKV (lane, head) items, the most a block takes, the
// shared offsets of the ring, x buffer, table, partial sums, slot
// scales, barriers and statistics.
constexpr int kPlanInts = 25;
inline void plan_of(const int* planes, int D, int F, int H, int B, int G,
                    int* out) {
  const Smem sm = smem_layout();
  int i = 0;
  out[i++] = kThreads;
  out[i++] = kWarps;
  out[i++] = kSlots;
  out[i++] = kSlotBytes;
  out[i++] = kXRows;
  out[i++] = kSliceRows;
  out[i++] = sm.total;
  out[i++] = kBarriersPerLayer;
  long long total = 0;
  int most = 0;
  int per_block[1024] = {0};
  for (int p = 0; p < kNumPhases; ++p) {
    const int T = phase_items(p, planes, D, F);
    out[i++] = T;
    for (int b = 0; b < G && b < 1024; ++b) {
      int lo, hi;
      block_range(T, G, b, &lo, &hi);
      for (int t = lo; t < hi; ++t) {
        const int n = item_stages(item_of(p, t, planes, D, F));
        per_block[b] += n;
        total += n;
      }
    }
  }
  for (int b = 0; b < G && b < 1024; ++b)
    most = per_block[b] > most ? per_block[b] : most;
  out[i++] = (int)total;
  out[i++] = most;
  out[i++] = B * H;
  out[i++] = (B * H + G - 1) / G;
  out[i++] = sm.ring;
  out[i++] = sm.x;
  out[i++] = sm.tab;
  out[i++] = sm.red;
  out[i++] = sm.scl;
  out[i++] = sm.bars;
  out[i++] = sm.stats;
}

// ---- device helpers -------------------------------------------------------

__device__ __forceinline__ float ldf(const bf16* p) {
  return bf2f(__ldcg(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A wait that lasts kWaitLimitNs traps: a fault the launch reports, never
// a card that hangs (the longest legitimate wait, a whole layer on one
// block, is some milliseconds).
constexpr unsigned long long kWaitLimitNs = 20000000000ULL;
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ void watchdog(unsigned long long t0) {
  if (now_ns() - t0 > kWaitLimitNs) __trap();
}

// The consumer warps' own barrier (named barrier 1): the producer warps
// never take part.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// A barrier of every block's consumers: arrivals counted in sync[0] (a
// target of (barrier index + 1) x blocks), each block's writes published
// before its arrival, as cooperative_groups' grid sync does.
__device__ __forceinline__ void grid_barrier(unsigned* sync,
                                             unsigned target) {
  consumers_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(sync, 1u);
    const unsigned long long t0 = now_ns();
    unsigned v;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(sync)
                   : "memory");
      if (v >= target) break;
      watchdog(t0);
    }
    __threadfence();
  }
  consumers_sync();
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!mbar_try_wait(bar, parity)) watchdog(t0);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// One arrival on `bar` once every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// The layer being run, in shared memory (a table in registers would land
// on each thread's stack): its vectors, state rows, matrices, residual in
// (x, or the previous layer's output) and out (x_out for the last layer).
struct Layer {
  const bf16* vec[kNumVecs];
  const bf16* st_in[kNumState];
  bf16* st_out[kNumState];
  Matrix mat[kNumMats];
  const bf16* xin;
  bf16* xout;
};

// Element (r, n) of an (R, N) matrix of a layer of form PLANES, by the
// plane's policy; under kPlaneAny the plane is read from m (uniform across
// m, so the branch does not diverge).
template <int PLANES>
__device__ __forceinline__ float decode_elem(const Matrix& m, int r, int n,
                                             int N) {
  if constexpr (PLANES != kPlaneAny) {
    return Decode<PLANES>::at(m, r, n, N, Decode<PLANES>::col(m, n));
  } else {
    switch (m.plane) {
      case kPlaneW4: return decode_elem<kPlaneW4>(m, r, n, N);
      case kPlaneVQ: return decode_elem<kPlaneVQ>(m, r, n, N);
      case kPlaneBF16: return decode_elem<kPlaneBF16>(m, r, n, N);
      default: return decode_elem<kPlaneW8>(m, r, n, N);
    }
  }
}

// The decode table of a plane: sign·level of each W8 code (bits of
// dpot_w8_decode before the scale), of each W4 nibble, or the VQ
// codebook's entries; entry e's copy for lane L at tab[16·e + L % 16]
// (lanes L and L + 16 share a copy: at worst a 2-way bank conflict, for
// 16 KB of shared memory the L1 keeps).
__device__ inline void build_table(float* tab, int plane, const void* aux,
                                   int aux_len) {
  for (int i = threadIdx.x; i < kTabWords; i += kConsumers) {
    const int e = i / kTabCopies;
    float t = 0.f;
    if (plane == kPlaneW8) {
      const int dq0 = e & 7, dq1 = (e >> 3) & 15;
      float lvl = 0.f;
      if (dq0) {
        lvl = exp2_neg(dq0);
        if (dq1) lvl += exp2_neg(dq0 + dq1);
      }
      t = (e & 0x80) ? -lvl : lvl;
    } else if (plane == kPlaneW4) {
      if (e < 16) {
        const int q = e & 7;
        const float lvl = q ? exp2_neg(q) : 0.f;
        t = (e & 8) ? -lvl : lvl;
      }
    } else if (plane == kPlaneVQ) {
      if (e < aux_len) t = bf2f(static_cast<const bf16*>(aux)[e]);
    }
    tab[i] = t;
  }
}

// Entry e of the lane's table copy; tl is the copy's shared address
// (the table's + 4·(lane % 16)), so the lookup is one byte extract, one
// shifted add and the load.
__device__ __forceinline__ float tab_at(uint32_t tl, uint32_t e) {
  float v;
  asm("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(tl + (e << 6)));
  return v;
}

// One code byte (byte j of w) through the table, times the column scale
// (W8; VQ entries are the weights themselves).
template <int PLANE>
__device__ __forceinline__ float tab_weight(uint32_t tl, uint32_t w, int j,
                                            float sc) {
  const float t = tab_at(tl, __byte_perm(w, 0, 0x4440 + j));
  if constexpr (PLANE == kPlaneVQ) {
    return t;
  } else {
    return t * sc;
  }
}

// An A-operand register of two weights of one column, each rounded to
// bf16 (the low half the first).
template <int PLANE>
__device__ __forceinline__ uint32_t pair8(uint32_t tl, uint32_t w0,
                                          uint32_t w1, int j, float sc) {
  return pack_bf16_rn(tab_weight<PLANE>(tl, w0, j, sc),
                      tab_weight<PLANE>(tl, w1, j, sc));
}
__device__ __forceinline__ uint32_t pair4(uint32_t tl, uint32_t w, int j,
                                          float sc) {
  return pack_bf16_rn(tab_at(tl, (w >> (8 * j)) & 15u) * sc,
                      tab_at(tl, (w >> (8 * j + 4)) & 15u) * sc);
}

// The A fragments (two 16-column tiles) and the B fragment of k-step kb
// of a stage.  sp: the stage's strip rows; xb: the x buffer (fragment
// order), xkb0 the stage's first k-step in it; sc: the scales of the
// thread's four columns (4g + j).  Byte planes: tile 0 holds columns 4g
// (MMA row g) and 4g + 1 (row g + 8), tile 1 columns 4g + 2 and 4g + 3.
// BF16: tile 0 columns g and g + 8, tile 1 columns 16 + g and 24 + g.
template <int PLANE>
__device__ __forceinline__ void frags(const unsigned char* sp, int kb,
                                      const uint2* xb, int xkb0, uint32_t tl,
                                      const float (&sc)[4], uint32_t (&a0)[4],
                                      uint32_t (&a1)[4], uint32_t (&b)[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const uint2 xv = xb[(xkb0 + kb) * 32 + lane];
  b[0] = xv.x;
  b[1] = xv.y;
  if constexpr (PLANE == kPlaneBF16) {
    // rows of 64 bytes: columns 0-15 (tile 0) then 16-31 (tile 1)
    const int mi = lane >> 3, r = lane & 7;
    const unsigned char* q =
        sp + (kb * 16 + (mi >> 1) * 8 + r) * (2 * kRowBytes) + (mi & 1) * 16;
    ldmatrix_x4_trans(a0, q);
    ldmatrix_x4_trans(a1, q + kRowBytes);
  } else if constexpr (PLANE == kPlaneW4) {
    const unsigned char* q = sp + (kb * 8 + c) * kRowBytes + 4 * g;
    const uint32_t wa = *reinterpret_cast<const uint32_t*>(q);
    const uint32_t wb = *reinterpret_cast<const uint32_t*>(q + 4 * kRowBytes);
    a0[0] = pair4(tl, wa, 0, sc[0]);
    a0[1] = pair4(tl, wa, 1, sc[1]);
    a0[2] = pair4(tl, wb, 0, sc[0]);
    a0[3] = pair4(tl, wb, 1, sc[1]);
    a1[0] = pair4(tl, wa, 2, sc[2]);
    a1[1] = pair4(tl, wa, 3, sc[3]);
    a1[2] = pair4(tl, wb, 2, sc[2]);
    a1[3] = pair4(tl, wb, 3, sc[3]);
  } else {
    const unsigned char* q = sp + (kb * 16 + c) * kRowBytes + 4 * g;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = *reinterpret_cast<const uint32_t*>(q + 4 * j * kRowBytes);
    a0[0] = pair8<PLANE>(tl, w[0], w[1], 0, sc[0]);
    a0[1] = pair8<PLANE>(tl, w[0], w[1], 1, sc[1]);
    a0[2] = pair8<PLANE>(tl, w[2], w[3], 0, sc[0]);
    a0[3] = pair8<PLANE>(tl, w[2], w[3], 1, sc[1]);
    a1[0] = pair8<PLANE>(tl, w[0], w[1], 2, sc[2]);
    a1[1] = pair8<PLANE>(tl, w[0], w[1], 3, sc[3]);
    a1[2] = pair8<PLANE>(tl, w[2], w[3], 2, sc[2]);
    a1[3] = pair8<PLANE>(tl, w[2], w[3], 3, sc[3]);
  }
}

// A k-step's two tiles: each MMA sums its 16 products from zero, and the
// k-step's sums join the thread's with f32 adds (rounded to nearest), so
// that no long chain runs through the tensor cores' accumulation, which
// truncates (a bias that over 32 layers widened the tail of K7-model's
// gap to its plain version, PERF.md §6, PR 28 run 28).
__device__ __forceinline__ void kstep_mma(float (&acc)[8],
                                          const uint32_t (&a0)[4],
                                          const uint32_t (&a1)[4],
                                          const uint32_t (&b)[2]) {
  float t[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  mma_bf16(t, a0, b);
  mma_bf16(t + 4, a1, b);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] += t[i];
}

// The k-steps of one stage that are this warp's (kb = warp, warp + 8,
// ...), two at a time: both k-steps' loads and decodes first (straight
// code the scheduler interleaves), then their sums in k order.
template <int PLANE>
__device__ __forceinline__ void ksteps(const unsigned char* sp, int nks,
                                       const uint2* xb, int xkb0,
                                       uint32_t tl, const float (&sc)[4],
                                       float (&acc)[8]) {
  const int warp = threadIdx.x >> 5;
  for (int kb = warp; kb < nks; kb += 2 * kWarps) {
    const bool two = kb + kWarps < nks;
    uint32_t a0[4], a1[4], b0[2], c0[4], c1[4], b1[2];
    frags<PLANE>(sp, kb, xb, xkb0, tl, sc, a0, a1, b0);
    frags<PLANE>(sp, two ? kb + kWarps : kb, xb, xkb0, tl, sc, c0, c1, b1);
    kstep_mma(acc, a0, a1, b0);
    if (two) kstep_mma(acc, c0, c1, b1);
  }
}

// Where row o (0..15) of a k-step sits in the x buffer's fragment order:
// thread c's j-th value (j 0-1 the first B register, 2-3 the second).
__device__ __forceinline__ int frag_pos(int o, bool perm) {
  const int c = perm ? (o & 3) : ((o & 7) >> 1);
  const int j = perm ? (o >> 2) : ((o & 1) | ((o >> 3) << 1));
  return c * 4 + j;
}

// Two values rounded to bf16 at once (one packed conversion; the bits of
// bf16r on each).
__device__ __forceinline__ void bf16r2(float& a, float& b) {
  const uint32_t u = pack_bf16_rn(a, b);
  a = bf16_lo(u);
  b = bf16_hi(u);
}

// 8 bf16 values as floats from a 16-byte word.
__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_lo(w[i]);
    v[2 * i + 1] = bf16_hi(w[i]);
  }
}

// Elements off .. off + 7 of a bf16 array at `base`: past the L1 (other
// blocks write the scratch between barriers), or through it (RO: read
// only in the launch, weights and inputs); one 16-byte load when VEC
// (base + off 16-byte aligned), else element loads that stop at K (k the
// first element's index against K); zeros when !ok.  The load is issued
// whatever ok says (from base when !ok), and VEC is a template argument,
// so that a caller's loads carry no branch and overlap.
template <bool VEC, bool RO = false>
__device__ __forceinline__ void row8(bool ok, const bf16* base, size_t off,
                                     int K, int k, float (&v)[8]) {
  if constexpr (VEC) {
    const uint4* p = reinterpret_cast<const uint4*>(ok ? base + off : base);
    uint4 u = RO ? __ldg(p) : __ldcg(p);
    if (!ok) u = make_uint4(0u, 0u, 0u, 0u);
    unpack8(u, v);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = ok && k + i < K
                 ? (RO ? bf16_lo(__ldg(reinterpret_cast<const unsigned short*>(
                             base + off + i)))
                       : ldf(base + off + i))
                 : 0.f;
  }
}

// Rows [k0, k0 + nrows) of an input into the x buffer, in fragment order:
// entry (k-step kb, lane g, thread c, j) at ((kb·32 + 4g + c)·4 + j),
// thread c's j-th value row c + 4j of the k-step (perm) or 2c + (j & 1) +
// 8(j >> 1).  A unit is one k-step of one lane: src(ok, g, k, v) sets lane
// g's values at rows k .. k + 7 (k a multiple of 8) when ok, else zeros,
// twice; the unit's 32 bytes go out as two 16-byte stores.  Rows >= K and
// lanes >= B are zero.  U units a thread at a time, all their loads issued
// before the first store.
template <int U, class Src>
__device__ void stage_x(bf16* xs, bool perm, int k0, int nrows, int K,
                        int B, Src src) {
  const int units = (nrows + 15) / 16 * kLanes;
  uint4* dst = reinterpret_cast<uint4*>(xs);
  for (int u0 = threadIdx.x; u0 < units; u0 += U * kConsumers) {
    float v[U][2][8];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int u = u0 + q * kConsumers;
      const int g = u & 7, k = k0 + 16 * (u >> 3);
      const bool ok = u < units && g < B;
      src(ok && k < K, g, k, v[q][0]);
      src(ok && k + 8 < K, g, k + 8, v[q][1]);
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int u = u0 + q * kConsumers;
      if (u >= units) break;
      const int g = u & 7, kb = u >> 3, k = k0 + 16 * kb;
      float x[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        x[i] = g < B && k + i < K ? v[q][i >> 3][i & 7] : 0.f;
      uint32_t w[8];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float a0 = perm ? x[c] : x[2 * c];
        const float a1 = perm ? x[c + 4] : x[2 * c + 1];
        const float a2 = perm ? x[c + 8] : x[2 * c + 8];
        const float a3 = perm ? x[c + 12] : x[2 * c + 9];
        w[2 * c] = pack_bf16_rn(a0, a1);
        w[2 * c + 1] = pack_bf16_rn(a2, a3);
      }
      dst[kb * 16 + 2 * g] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[kb * 16 + 2 * g + 1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
}

// Where value (row n, lane b) of a matvec input sits in its x-buffer
// image (stage_x's layout): the scratch copies of the inputs (xs, y, kk)
// are written there, in the k order of the matrix that reads them, so
// staging them is a plain copy.
__device__ __forceinline__ size_t image_at(int n, int b, bool perm) {
  return ((size_t)(n >> 4) * 32 + 4 * b) * 4 + frag_pos(n & 15, perm);
}

// Rows [k0, k0 + nrows) (k0 a multiple of 16) of an x-buffer image in the
// scratch into the x buffer: 16-byte asynchronous copies, all in flight at
// once, waited for here (the caller's barrier then publishes them).  The
// image's pad rows and lanes >= B are zero.
__device__ inline void stage_image(bf16* xs, const bf16* img, int k0,
                                   int nrows) {
  const int n = (nrows + 15) / 16 * 16;  // 16-byte chunks, 16 a k-step
  const uint4* src = reinterpret_cast<const uint4*>(img) + (k0 >> 4) * 16;
  uint4* dst = reinterpret_cast<uint4*>(xs);
  for (int i = threadIdx.x; i < n; i += kConsumers)
    cp_async16(dst + i, src + i, 16);
  cp_async_commit();
  cp_async_wait<0>();
}

// The inputs a block mixes itself, into the x buffer (stage_x), with
// their own registers (__noinline__: they run a few times a layer).
// xxx = h + dx·μ_x, h = LN1(x) from the block's statistics (mu, rs), dx =
// att_x - h, μ_x time_maa_x (mx) by its plane's policy (phase A).
template <int PLANES, bool V>
static __device__ __noinline__ void stage_xxx(
    bf16* xs, bool perm, int k0, int rows, int D, int B, const bf16* xin,
    const bf16* ax, const bf16* w1, const bf16* b1, const float* mu,
    const float* rs, const Matrix* mx) {
  stage_x<2>(xs, perm, k0, rows, D, B,
             [=](bool ok, int g, int k, float (&v)[8]) {
    float x[8], a[8], w[8], b[8];
    row8<V>(ok, xin, (size_t)g * D + k, D, k, x);
    row8<V, true>(ok, ax, (size_t)g * D + k, D, k, a);
    row8<V, true>(ok, w1, k, D, k, w);
    row8<V, true>(ok, b1, k, D, k, b);
    const float m = mu[g & 7], r = rs[g & 7];
    float t[8];  // clamped columns: no branch around the loads
#pragma unroll
    for (int i = 0; i < 8; ++i)
      t[i] = decode_elem<PLANES>(*mx, 0, k + i < D ? k + i : D - 1, D);
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      float h0 = (x[i] - m) * r * w[i] + b[i];
      float h1 = (x[i + 1] - m) * r * w[i + 1] + b[i + 1];
      bf16r2(h0, h1);
      float d0 = a[i] - h0, d1 = a[i + 1] - h1;
      bf16r2(d0, d1);
      float t0 = d0 * t[i], t1 = d1 * t[i + 1];
      bf16r2(t0, t1);
      v[i] = h0 + t0;  // rounded where the stager packs it
      v[i + 1] = h1 + t1;
    }
  });
}

// mix(h2, ffn_x, p) of common.cuh, h2 = LN2(x2) from the block's
// statistics, two values a conversion (phase F: mr, or mk).
template <bool V>
static __device__ __noinline__ void stage_mix(
    bf16* xs, bool perm, int k0, int rows, int D, int B, const bf16* x2,
    const bf16* fx, const bf16* w2, const bf16* b2, const bf16* pm,
    const float* mu, const float* rs) {
  stage_x<2>(xs, perm, k0, rows, D, B,
             [=](bool ok, int g, int k, float (&v)[8]) {
    float x[8], pv[8], w[8], b[8], m[8];
    row8<V>(ok, x2, (size_t)g * D + k, D, k, x);
    row8<V, true>(ok, fx, (size_t)g * D + k, D, k, pv);
    row8<V, true>(ok, w2, k, D, k, w);
    row8<V, true>(ok, b2, k, D, k, b);
    row8<V, true>(ok, pm, k, D, k, m);
    const float mm = mu[g & 7], r = rs[g & 7];
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      float h0 = (x[i] - mm) * r * w[i] + b[i];
      float h1 = (x[i + 1] - mm) * r * w[i + 1] + b[i + 1];
      bf16r2(h0, h1);
      float p0 = h0 * m[i], p1 = h1 * m[i + 1];
      bf16r2(p0, p1);
      float q0 = 1.f - m[i], q1 = 1.f - m[i + 1];
      bf16r2(q0, q1);
      float r0 = pv[i] * q0, r1 = pv[i + 1] * q1;
      bf16r2(r0, r1);
      v[i] = p0 + r0;  // rounded where the stager packs it
      v[i + 1] = p1 + r1;
    }
  });
}

// LayerNorm statistics of each lane's row of x (B rows of D, lane-major):
// mu[b] and rs[b] = rsqrt(E[x²] - mu² + 1e-5), the single-pass form of
// models/layers.py:apply_norm.  One warp per lane, lane t of the warp
// summing 8-element chunks t, t + 32, ... in order (eight chunks' loads in
// flight at once), then a butterfly: every block computes the same bits.
// Ends with the consumers' barrier.
template <bool VEC>
__device__ inline void ln_sums(const bf16* row, int D, float& s, float& s2) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < D; base += 8 * 256) {
    float v[8][8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int d0 = base + 256 * q + 8 * lane;
      row8<VEC>(d0 < D, row, d0, D, d0, v[q]);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s += v[q][i];
        s2 += v[q][i] * v[q][i];
      }
  }
}

static __device__ __noinline__ void ln_stats(const bf16* x, int B, int D,
                                      float* mu, float* rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < B) {
    const bf16* row = x + (size_t)warp * D;
    float s = 0.f, s2 = 0.f;
    if (D % 8 == 0 && aligned16(x))
      ln_sums<true>(row, D, s, s2);
    else
      ln_sums<false>(row, D, s, s2);
    {
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      const float m = s / (float)D;
      mu[warp] = m;
      rs[warp] = rsqrtf(s2 / (float)D - m * m + 1e-5f);
    }
  }
  consumers_sync();
}

// The matrix m's rows of a layer as the producer copies them: the first
// strip row of the item (its slice, its strip), the row stride (bytes),
// the strip row's valid bytes, and whether 16-byte copies reach it.
struct Source {
  const uint8_t* p;
  long long rb;
  int sb;  // a strip row's bytes in the slot (row_bytes)
  int vb;
  bool vec;
};

__device__ __forceinline__ Source source_of(const Net& n, int l,
                                            const Item& it) {
  const int kpr = rows_per_byte_row(it.plane);
  const long long rb = it.plane == kPlaneBF16 ? 2LL * it.jb.N : it.jb.N;
  const uint8_t* base = n.mat[it.jb.m] + (long long)l * n.mat_layer[it.jb.m] +
                        (long long)((it.jb.row0 + it.k0) / kpr) * rb;
  Source s;
  const int sb = row_bytes(it.plane);
  s.p = base + (long long)sb * it.strip;
  s.rb = rb;
  s.sb = sb;
  const long long left = rb - (long long)sb * it.strip;
  s.vb = left < sb ? (int)left : sb;
  s.vec = aligned16(base) && rb % 16 == 0;
  return s;
}

// The producers' copy of one stage into a slot, the 32·kProducers lanes
// taking the stage's 16-byte pieces (4-byte where rows are not 16-byte
// aligned) row after row, each lane the same piece of every few rows:
// rows past the stage and bytes past the strip zero-filled.
__device__ __forceinline__ void issue_stage(unsigned char* dst,
                                            const Source& s, const Stage& sg,
                                            int pl) {
  constexpr int P = 32 * kProducers;
  const uint8_t* src0 = s.p + (long long)sg.br0 * s.rb;
  const int w = s.vec ? 16 : 4;       // bytes a copy
  const int per = s.sb / w;           // copies a row (a power of two)
  const int h = pl % per;
  const bool live = w * h < s.vb;
  int r = pl / per;
  const int rs = P / per;             // rows a sweep
  const uint8_t* sp = src0 + (long long)r * s.rb + w * h;
  unsigned char* dp = dst + r * s.sb + w * h;
  const long long step = (long long)rs * s.rb;
  if (s.vec) {
#pragma unroll 4
    for (; r < sg.prow; r += rs, sp += step, dp += rs * s.sb) {
      const int nb = r < sg.rows && live ? 16 : 0;
      cp_async16(dp, nb ? sp : src0, nb);
    }
  } else {
    for (; r < sg.prow; r += rs, sp += step, dp += rs * s.sb) {
      const int nb = r < sg.rows && live ? 4 : 0;
      cp_async4(dp, nb ? sp : src0, nb);
    }
  }
}

// The producer: every stage of the block's items, in the consumers' order,
// each into the next ring slot once the consumers have freed it, with the
// strip's 32 column scales (W8, W4; past N zero) beside it; each lane's
// arrival on the slot's barrier comes once its copies have landed.
__device__ inline void produce(const Net& n, unsigned char* ring,
                               float* scl, uint64_t* full, uint64_t* empty) {
  const int lane = threadIdx.x & 31;
  const int pl = threadIdx.x - kConsumers;  // producer lane
  unsigned cnt = 0;
  for (int l = 0; l < n.L; ++l) {
    for (int p = 0; p < kNumPhases; ++p) {
      int lo, hi;
      block_range(phase_items(p, n.plane, n.D, n.F), gridDim.x, blockIdx.x,
                  &lo, &hi);
      for (int t = lo; t < hi; ++t) {
        const Item it = item_of(p, t, n.plane, n.D, n.F);
        const Source src = source_of(n, l, it);
        const bool scaled = it.plane == kPlaneW8 || it.plane == kPlaneW4;
        const float* sc = static_cast<const float*>(n.aux[it.jb.m]);
        const int ns = item_stages(it);
        for (int st = 0; st < ns; ++st, ++cnt) {
          const int slot = cnt % kSlots;
          if (cnt >= (unsigned)kSlots)
            mbar_wait(empty + slot, ((cnt / kSlots) - 1) & 1);
          issue_stage(ring + slot * kSlotBytes, src, stage_of(it, st), pl);
          if (scaled && pl < 32) {
            const int c = it.col0 + lane;
            cp_async4(scl + slot * 32 + lane, c < it.jb.N ? sc + c : sc,
                      c < it.jb.N ? 4 : 0);
          }
          cp_async_arrive(full + slot);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The consumers' state across items (scalars, passed by value and
// returned, so that the item's loop keeps them in registers): the ring
// position, what the x buffer and the decode table hold.
struct Ctx {
  unsigned cnt;        // stages consumed
  unsigned items;      // items run (their parity picks the sums' buffer)
  int x_lp, x_job, x_k0;  // x buffer: layer·phases + phase, job, first row
  int t_plane;         // the decode table's plane (-1: none)
  const void* t_aux;
};

// Operands an item's epilogue reads, loaded by pre(it, n, b) before its
// stages so that their latency hides behind the MMAs.
struct Pre {
  float a, b, c;
};

// The stages of one item, its plane P: the x buffer (re)staged where the
// stage's rows leave it (stager(it, first row, rows, permuted)), each
// stage's k-steps, then the warps' sums added as a pairwise tree in warp
// order into epi(it, n, b, sum, pre(it, n, b)) for every column n < N,
// lane b < B (the operands loaded before the stages, so that their latency
// hides behind them).
template <int P, class Stager, class Fetch, class Epi>
__device__ Ctx run_item(const Item& it, int lp, Ctx cx, int B, bool synced,
                        Stager stager, Fetch pre, Epi epi) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int on = it.col0 + (tid >> 3), ob = tid & 7;
  const bool out = tid < it.ncols * kLanes && ob < B && on < it.jb.N;
  const Pre pv = out ? pre(it, on, ob) : Pre{0.f, 0.f, 0.f};
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  const uint32_t tl = smem_u32(s_tab()) + 4 * (lane % kTabCopies);
  const int ns = item_stages(it);
  bool need = !synced;
  for (int st = 0; st < ns; ++st) {
    const Stage sg = stage_of(it, st);
    const int ck = it.jb.sliced ? it.k0 : sg.kst / kXRows * kXRows;
    if (cx.x_lp != lp || cx.x_job != it.job || cx.x_k0 != ck) {
      if (st > 0) consumers_sync();  // every warp is done with the old rows
      const int end = it.jb.sliced ? it.k1
                      : ck + kXRows < it.jb.K ? ck + kXRows : it.jb.K;
      stager(it, ck, end - ck, k_permuted(P));
      cx.x_lp = lp;
      cx.x_job = it.job;
      cx.x_k0 = ck;
      need = true;
    }
    if (need) {
      consumers_sync();
      need = false;
    }
    const int slot = cx.cnt % kSlots;
    mbar_wait(s_full() + slot, (cx.cnt / kSlots) & 1);
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (P == kPlaneW8 || P == kPlaneW4) {
      const float4 s4 =
          *reinterpret_cast<const float4*>(s_scl() + slot * 32 + 4 * g);
      sc[0] = s4.x;
      sc[1] = s4.y;
      sc[2] = s4.z;
      sc[3] = s4.w;
    }
    ksteps<P>(s_ring() + slot * kSlotBytes, sg.nks,
              reinterpret_cast<const uint2*>(s_x()), (sg.kst - ck) / 16, tl,
              sc, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(s_empty() + slot);
    ++cx.cnt;
  }
  const int kst = (it.k1 - it.k0 + 15) / 16;
  const int nw = kst < kWarps ? kst : kWarps;
  float* red = s_red() + (cx.items++ & 1) * kRedFloats;
  if (warp < nw) {
    float* r = red + warp * 32 * kLanes;
    if constexpr (P == kPlaneBF16) {
#pragma unroll
      for (int j = 0; j < 4; ++j)  // columns g, g + 8, 16 + g, 24 + g
        *reinterpret_cast<float2*>(r + (g + 8 * j) * kLanes + 2 * c) =
            make_float2(acc[2 * j], acc[2 * j + 1]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(r + (4 * g + j) * kLanes + 2 * c) =
            make_float2(acc[2 * j], acc[2 * j + 1]);
    }
  }
  consumers_sync();
  if (out) {
    // the warps' sums as a pairwise tree in warp order over 16 slots
    // (slots past the item's warps as zeros, which change no sum)
    float p[16];
#pragma unroll
    for (int w = 0; w < 16; ++w)
      p[w] = w < kWarps && w < nw ? red[w * 32 * kLanes + tid] : 0.f;
#pragma unroll
    for (int h = 8; h > 0; h >>= 1)
#pragma unroll
      for (int w = 0; w < h; ++w) p[w] = p[2 * w] + p[2 * w + 1];
    epi(it, on, ob, p[0], pv);
  }
  // no barrier here: every warp is past its k-steps (the x buffer and
  // table are free), and the next item's sums go to the other buffer
  return cx;
}

// One item under the layer's form PLANES: the table rebuilt first when the
// item's plane or codebook differs from the one it holds (kPlaneAny; an
// all-W8 layer builds it once), then run_item for the item's plane.
template <int PLANES, class Stager, class Fetch, class Epi>
__device__ void item(const Item& it, int lp, const Matrix& m, Ctx& cx,
                     int B, Stager stager, Fetch pre, Epi epi) {
  if constexpr (PLANES != kPlaneAny) {
    cx = run_item<PLANES>(it, lp, cx, B, true, stager, pre, epi);
  } else {
    bool synced = true;
    if (it.plane != kPlaneBF16 &&
        (cx.t_plane != it.plane || cx.t_aux != m.aux)) {
      build_table(s_tab(), it.plane, m.aux, m.aux_len);
      cx.t_plane = it.plane;
      cx.t_aux = m.aux;
      synced = false;
    }
    switch (it.plane) {
      case kPlaneW4:
        cx = run_item<kPlaneW4>(it, lp, cx, B, synced, stager, pre, epi);
        break;
      case kPlaneVQ:
        cx = run_item<kPlaneVQ>(it, lp, cx, B, synced, stager, pre, epi);
        break;
      case kPlaneBF16:
        cx = run_item<kPlaneBF16>(it, lp, cx, B, synced, stager, pre, epi);
        break;
      default:
        cx = run_item<kPlaneW8>(it, lp, cx, B, synced, stager, pre, epi);
    }
  }
}

// Every item of phase p that is this block's (`item` above).
template <int PLANES, class Stager, class Fetch, class Epi>
__device__ void phase(int p, const Net& n, const Layer& ly, int l, Ctx& cx,
                      Stager stager, Fetch pre, Epi epi) {
  int lo, hi;
  block_range(phase_items(p, n.plane, n.D, n.F), gridDim.x, blockIdx.x, &lo,
              &hi);
  for (int t = lo; t < hi; ++t) {
    const Item it = item_of(p, t, n.plane, n.D, n.F);
    item<PLANES>(it, l * kNumPhases + p, ly.mat[it.jb.m], cx, n.B, stager,
                 pre, epi);
  }
}

// The sum of v over each group of N consecutive consumer threads (N a
// power of two dividing kConsumers): a butterfly within the warp, then for
// N > 32 the group's warps' sums in warp order through part (kWarps
// floats).  Every consumer thread calls it (uniform barriers).
__device__ __forceinline__ float group_sum(float v, int N, float* part) {
  const int w = N < 32 ? N : 32;
  for (int off = 1; off < w; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (N <= 32) return v;
  const int warp = threadIdx.x >> 5, per = N / 32;
  consumers_sync();
  if ((threadIdx.x & 31) == 0) part[warp] = v;
  consumers_sync();
  const int first = warp / per * per;
  float t = part[first];
  for (int i = 1; i < per; ++i) t += part[first + i];
  return t;
}

// Phase D: per (lane, head) item, N threads a head, thread m owning
// column d = h·N + m: w = exp(-exp(time_decay + a @ td_w2)) (an ordered
// chain over td_w2's 64 rows), the WKV-6 step, GroupNorm over the head,
// y·g.  Item i goes to block i mod G; a block runs its items kConsumers /
// N at a time.  Its arrays sit in the x buffer (f32).
template <int PLANES>
__device__ __noinline__ void wkv_phase(const Net& n, const Layer& ly,
                                       float* buf) {
  const int B = n.B, D = n.D, H = n.H, N = n.N;
  const Scratch& s = n.s;
  const int tid = threadIdx.x;
  const int G = kConsumers / N;
  const int gi = tid / N, m = tid % N;
  float* R = buf;
  float* Kh = R + kConsumers;
  float* W = Kh + kConsumers;
  float* U = W + kConsumers;
  float* Y = U + kConsumers;
  float* A = Y + kConsumers;  // G x 64
  float* part = A + G * kTdRank;  // group_sum's warp sums
  const int o = gi * N;
  const int total = B * H;
  const int mine = (int)blockIdx.x < total
                       ? (total - (int)blockIdx.x + (int)gridDim.x - 1) /
                             (int)gridDim.x
                       : 0;
  const Matrix& td2 = ly.mat[TD_W2];
  for (int base = 0; base < mine; base += G) {
    const int t = base + gi;
    const bool live = t < mine;
    const int item = (int)blockIdx.x + t * (int)gridDim.x;
    const int b = live ? item / H : 0, h = live ? item % H : 0;
    const int d = h * N + m;
    const size_t bd = (size_t)b * D + d;
    if (live)
      for (int j = m; j < kTdRank; j += N)
        A[gi * kTdRank + j] = ldf(s.tda + b * kTdRank + j);
    consumers_sync();
    if (live) {
      float acc = 0.f;
      const float* a = A + gi * kTdRank;
      // 32 weights' loads in flight, then their 32 FMAs in order
      auto chain = [&](auto dec) {
        for (int j0 = 0; j0 < kTdRank; j0 += 32) {
          float wv[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) wv[i] = dec(j0 + i);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc = fmaf(a[j0 + i], wv[i], acc);
        }
      };
      if constexpr (PLANES == kPlaneAny) {
        switch (td2.plane) {
          case kPlaneW4: {
            const float c = Decode<kPlaneW4>::col(td2, d);
            chain([&](int j) { return Decode<kPlaneW4>::at(td2, j, d, D, c); });
            break;
          }
          case kPlaneVQ:
            chain([&](int j) { return Decode<kPlaneVQ>::at(td2, j, d, D, 0.f); });
            break;
          case kPlaneBF16:
            chain([&](int j) {
              return Decode<kPlaneBF16>::at(td2, j, d, D, 0.f);
            });
            break;
          default: {
            const float c = Decode<kPlaneW8>::col(td2, d);
            chain([&](int j) { return Decode<kPlaneW8>::at(td2, j, d, D, c); });
          }
        }
      } else {
        const float c = Decode<PLANES>::col(td2, d);
        chain([&](int j) { return Decode<PLANES>::at(td2, j, d, D, c); });
      }
      const float dd = bf16r(bf2f(ly.vec[TIME_DECAY][d]) + bf16r(acc));
      W[o + m] = expf(-expf(dd));
      R[o + m] = ldf(s.r + bd);
      Kh[o + m] = ldf(s.k + bd);
      U[o + m] = decode_elem<PLANES>(ly.mat[TIME_FAAAA], h, m, N);
    }
    consumers_sync();
    if (live) {
      const float vm = ldf(s.v + bd);
      const size_t so = (size_t)(b * H + h) * N * N + m;
      const bf16* Sin = ly.st_in[WKV_S] + so;
      bf16* Sout = ly.st_out[WKV_S] + so;
      // 32 state rows' loads in flight (the state in is read only, so no
      // store can alias them), then their steps in order of k
      float y = 0.f;
      for (int k0 = 0; k0 < N; k0 += 32) {
        float sv[32];
#pragma unroll
        for (int i = 0; i < 32; ++i)  // a clamped row: no branch
          sv[i] = bf2f(__ldg(Sin + (size_t)(k0 + i < N ? k0 + i : N - 1) * N));
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int k = k0 + i;
          if (k < N) {
            float ns;
            y = y + wkv6_term(sv[i], R[o + k], Kh[o + k], vm, U[o + k],
                              W[o + k], &ns);
            Sout[(size_t)k * N] = __float2bfloat16_rn(ns);
          }
        }
      }
      Y[o + m] = bf16r(y);
    }
    // GroupNorm over the head: its N values summed as a butterfly within
    // each warp, then the head's warps in order (N > 32)
    const float yv = live ? Y[o + m] : 0.f;
    const float mean = group_sum(yv, N, part) / (float)N;
    const float cc = yv - mean;
    const float sq = group_sum(cc * cc, N, part);
    if (live) {
      const float r = rsqrtf(sq / (float)N + 64e-5f);
      const float gn = bf16r(cc * r * bf2f(ly.vec[LNX_W][d]) +
                             bf2f(ly.vec[LNX_B][d]));
      s.y[image_at(d, b, k_permuted(n.plane[ATT_WO]))] =
          __float2bfloat16_rn(gn * ldf(s.g + bd));
    }
    consumers_sync();
  }
}

// Thread 0 points the shared Layer at layer l.
__device__ inline void set_layer(const Net& n, int l, Layer& ly) {
  for (int v = 0; v < kNumVecs; ++v) ly.vec[v] = n.vec[v] + l * n.vec_layer;
  for (int k = 0; k < kNumState; ++k) {
    ly.st_in[k] = n.st_in[k] + l * n.st_layer[k];
    ly.st_out[k] = n.st_out[k] + l * n.st_layer[k];
  }
  for (int m = 0; m < kNumMats; ++m)
    ly.mat[m] = {n.mat[m] + l * n.mat_layer[m], n.aux[m], n.plane[m],
                 n.aux_len[m]};
  ly.xin = l == 0 ? n.x : n.s.xres;
  ly.xout = l == n.L - 1 ? n.x_out : n.s.xres;
}

// The consumers: every layer's seven phases, the grid barriers between.
// The stagers, epilogue loads and epilogues are lambdas that capture
// pointers and integers by value (a capture by reference would put the
// captured locals on the stack).
template <int PLANES>
__device__ void consume(const Net& n, Layer& ly, Ctx& cx) {
  const int B = n.B, D = n.D;
  const Net* np = &n;
  const Scratch* sp = &n.s;
  const Layer* lyp = &ly;
  bf16* xs = s_x();
  const float* mu = s_mu();
  const float* rs = s_rs();
  const int tid = threadIdx.x;
  const int gtid = blockIdx.x * kConsumers + tid;
  const int gsz = gridDim.x * kConsumers;
  const int Dp = n.s.Dp;
  const bool vd = D % 8 == 0;
  unsigned nbar = 0;
  auto barrier = [&]() { grid_barrier(n.s.sync, ++nbar * gridDim.x); };
  auto none = [](const Item&, int, int) { return Pre{0.f, 0.f, 0.f}; };
  // a matvec input copied from its x-buffer image in the scratch
  auto copy_from = [xs](const bf16* img) {
    return [xs, img](const Item&, int k0, int rows, bool) {
      stage_image(xs, img, k0, rows);
    };
  };
  // whether the matrix that reads an input permutes its k order
  auto perm_of = [np](int m) { return k_permuted(np->plane[m]); };
  if constexpr (PLANES != kPlaneAny) {
    build_table(s_tab(), PLANES, nullptr, 0);
    consumers_sync();
  }
  for (int l = 0; l < n.L; ++l) {
    if (tid == 0) set_layer(n, l, ly);
    consumers_sync();
    const bf16* xin = ly.xin;
    const bf16* const* vec = ly.vec;

    // A. LN1; att_x = h, dx = att_x - h (spread); maa_w1's K slices of
    //    xxx = h + dx·μ_x, each block mixing its slice's rows itself
    ln_stats(xin, B, D, s_mu(), s_rs());
    for (int i = gtid; i < D * kLanes; i += gsz) {
      const int d = i >> 3, b = i & 7;
      if (b >= B) continue;
      const size_t bd = (size_t)b * D + d;
      const float h = bf16r((ldf(xin + bd) - mu[b]) * rs[b] *
                                bf2f(vec[LN1_W][d]) + bf2f(vec[LN1_B][d]));
      ly.st_out[ATT_X][bd] = __float2bfloat16_rn(h);
      sp->h[bd] = __float2bfloat16_rn(h);
      sp->dx[bd] = __float2bfloat16_rn(bf16r(bf2f(ly.st_in[ATT_X][bd]) - h));
    }
    {
      const bf16* ax = ly.st_in[ATT_X];
      const bf16* w1 = vec[LN1_W];
      const bf16* b1 = vec[LN1_B];
      const bool vec16 = vd && aligned16(xin) && aligned16(ax) &&
                         aligned16(w1) && aligned16(b1);
      phase<PLANES>(kPA, n, ly, l, cx,
          [=](const Item&, int k0, int rows, bool perm) {
            const Matrix* mx = &lyp->mat[TIME_MAA_X];
            if (vec16)
              stage_xxx<PLANES, true>(xs, perm, k0, rows, D, B, xin, ax, w1,
                                      b1, mu, rs, mx);
            else
              stage_xxx<PLANES, false>(xs, perm, k0, rows, D, B, xin, ax, w1,
                                       b1, mu, rs, mx);
          },
          none,
          [=](const Item& it, int nn, int b, float a, const Pre&) {
            sp->part[((size_t)it.slice * 5 * kMaaRank + nn) * kLanes + b] = a;
          });
    }
    barrier();

    // B. dmix_s = tanh(Σ slices, in slice order); x_s = h + dx·(time_maa[s]
    //    + dmix_s @ maa_w2[s])
    phase<PLANES>(kPB, n, ly, l, cx,
        [=](const Item& it, int, int, bool perm) {
          const int S = maa_slices(D);
          if (tid < kMaaRank * kLanes) {
            const int r = tid >> 3, g = tid & 7;
            float a = 0.f;
            if (g < B) {
              const float* p =
                  sp->part + (size_t)(it.job * kMaaRank + r) * kLanes + g;
#pragma unroll 16
              for (int sl = 0; sl < S; ++sl)
                a += __ldcg(p + (size_t)sl * 5 * kMaaRank * kLanes);
              a = bf16r(tanhf(bf16r(a)));
            }
            xs[((r >> 4) * 32 + 4 * g) * 4 + frag_pos(r & 15, perm)] =
                __float2bfloat16_rn(a);
          }
        },
        [=](const Item& it, int d, int b) {
          const size_t bd = (size_t)b * D + d;
          return Pre{ldf(sp->h + bd), ldf(sp->dx + bd),
                     decode_elem<PLANES>(lyp->mat[TIME_MAA], it.job, d, D)};
        },
        [=](const Item& it, int d, int b, float a, const Pre& q) {
          const float m = bf16r(q.c + bf16r(a));
          const int reader = it.job == 0 ? TD_W1 : it.job == 1 ? ATT_WK
                             : it.job == 2 ? ATT_WV : it.job == 3 ? ATT_WR
                                                                  : ATT_WG;
          sp->xs[(size_t)it.job * kLanes * Dp +
                 image_at(d, b, perm_of(reader))] =
              __float2bfloat16_rn(q.a + bf16r(q.b * m));
        });
    barrier();

    // C. r, k, v; g = silu(xg @ wg); a = tanh(xw @ td_w1); job j's input
    //    is x_r, x_k, x_v, x_g, x_w
    phase<PLANES>(kPC, n, ly, l, cx,
        [=](const Item& it, int k0, int rows, bool perm) {
          const int j = it.job;
          const int which = j == 0 ? 3 : j == 1 ? 1 : j == 2 ? 2 : j == 3 ? 4
                                                                         : 0;
          copy_from(sp->xs + (size_t)which * kLanes * Dp)(it, k0, rows, perm);
        },
        none,
        [=](const Item& it, int nn, int b, float a, const Pre&) {
          const float t = bf16r(a);
          const size_t bn = (size_t)b * D + nn;
          switch (it.job) {
            case 0: sp->r[bn] = __float2bfloat16_rn(t); break;
            case 1: sp->k[bn] = __float2bfloat16_rn(t); break;
            case 2: sp->v[bn] = __float2bfloat16_rn(t); break;
            case 3:
              sp->g[bn] = __float2bfloat16_rn(t * sigmoid_bf16(t));
              break;
            default:
              sp->tda[b * kTdRank + nn] = __float2bfloat16_rn(tanhf(t));
          }
        });
    barrier();

    // D. the decays, the WKV step, GroupNorm, y·g
    wkv_phase<PLANES>(n, ly, reinterpret_cast<float*>(s_x()));
    cx.x_lp = -1;  // phase D used the x buffer
    barrier();

    // E. x2 = x + (y·g) @ wo
    phase<PLANES>(kPE, n, ly, l, cx, copy_from(sp->y),
        [=](const Item&, int d, int b) {
          return Pre{ldf(xin + (size_t)b * D + d), 0.f, 0.f};
        },
        [=](const Item&, int d, int b, float a, const Pre& q) {
          sp->x2[(size_t)b * D + d] = __float2bfloat16_rn(q.a + bf16r(a));
        });
    barrier();

    // F. LN2 -> h2 (the new ffn_x, spread); rr = σ(mr @ ffn.wr), kk =
    //    relu(mk @ ffn.wk)², each block mixing mr and mk itself
    ln_stats(sp->x2, B, D, s_mu(), s_rs());
    for (int i = gtid; i < D * kLanes; i += gsz) {
      const int d = i >> 3, b = i & 7;
      if (b >= B) continue;
      const size_t bd = (size_t)b * D + d;
      ly.st_out[FFN_X][bd] = __float2bfloat16_rn(
          bf16r((ldf(sp->x2 + bd) - mu[b]) * rs[b] * bf2f(vec[LN2_W][d]) +
                bf2f(vec[LN2_B][d])));
    }
    {
      const bf16* fx = ly.st_in[FFN_X];
      const bf16* x2 = sp->x2;
      const bf16* w2 = vec[LN2_W];
      const bf16* b2 = vec[LN2_B];
      const bf16* pr = vec[FFN_MIX_R];
      const bf16* pk = vec[FFN_MIX_K];
      const bool vec16 = vd && aligned16(fx) && aligned16(w2) &&
                         aligned16(b2) && aligned16(pr) && aligned16(pk);
      const bool pkv = perm_of(FFN_WV);
      phase<PLANES>(kPF, n, ly, l, cx,
          [=](const Item& it, int k0, int rows, bool perm) {
            const bf16* pm = it.job ? pk : pr;
            if (vec16)
              stage_mix<true>(xs, perm, k0, rows, D, B, x2, fx, w2, b2, pm,
                              mu, rs);
            else
              stage_mix<false>(xs, perm, k0, rows, D, B, x2, fx, w2, b2, pm,
                               mu, rs);
          },
          none,
          [=](const Item& it, int nn, int b, float a, const Pre&) {
            const float t = bf16r(a);
            if (it.job == 0) {
              sp->rr[(size_t)b * D + nn] =
                  __float2bfloat16_rn(sigmoid_bf16(t));
            } else {
              const float q = fmaxf(t, 0.f);
              sp->kk[image_at(nn, b, pkv)] = __float2bfloat16_rn(q * q);
            }
          });
    }
    barrier();

    // G. x = x2 + rr·(kk @ ffn.wv)
    {
      bf16* xout = ly.xout;
      phase<PLANES>(kPG, n, ly, l, cx, copy_from(sp->kk),
          [=](const Item&, int d, int b) {
            const size_t bd = (size_t)b * D + d;
            return Pre{ldf(sp->x2 + bd), ldf(sp->rr + bd), 0.f};
          },
          [=](const Item&, int d, int b, float a, const Pre& q) {
            const float ffn = bf16r(q.b * bf16r(a));
            xout[(size_t)b * D + d] = __float2bfloat16_rn(q.a + ffn);
          });
    }
    if (l < n.L - 1) barrier();  // the layer's output is whole
  }
  // the last block out resets the barrier counters for the next launch
  // on this scratch (no block is still waiting on them)
  consumers_sync();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(n.s.sync + 1, 1u) == gridDim.x - 1) {
      n.s.sync[0] = 0;
      n.s.sync[1] = 0;
      __threadfence();
    }
  }
}

// The kernel both forms launch (instances in rwkv6_model_decode.cu).
template <int PLANES>
__global__ void __launch_bounds__(kThreads, 1)
    rwkv6_decode_kernel(const Net a) {
  __shared__ Net n;
  __shared__ Layer ly;
  uint64_t* full = s_full();
  uint64_t* empty = s_empty();
  if (threadIdx.x == 0) {
    n = a;
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(full + i, 32 * kProducers);  // the producers' lanes
      mbar_init(empty + i, kWarps);  // the consumer warps
    }
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    produce(n, s_ring(), s_scl(), full, empty);
    return;
  }
  Ctx cx;
  cx.cnt = 0;
  cx.items = 0;
  cx.x_lp = -1;
  cx.x_job = -1;
  cx.x_k0 = -1;
  cx.t_plane = -1;
  cx.t_aux = nullptr;
  consume<PLANES>(n, ly, cx);
}

// Host side: whether a matrix's plane and codebook length are ones the
// body takes.
inline bool valid_matrix(int plane, int aux_len) {
  if (plane == kPlaneVQ) return 1 <= aux_len && aux_len <= kMaxCodebook;
  return plane == kPlaneW8 || plane == kPlaneW4 || plane == kPlaneBF16;
}

// Host side: the PLANES a layer with these 15 matrix planes is compiled
// for: kPlaneW8 when every matrix is W8 (that loop alone), else
// kPlaneAny.
inline int planes_of(const int* planes) {
  for (int m = 0; m < kNumMats; ++m)
    if (planes[m] != kPlaneW8) return kPlaneAny;
  return kPlaneW8;
}

// Host side (rwkv6_model_decode.cu): the largest cooperative grid of the
// instance for these planes on the current device (0 without cooperative
// launch), and the launch of `net` on `grid` blocks.
int max_grid(const int* planes, int* coop, int* blocks);
int launch(const int* planes, const Net& net, int grid, cudaStream_t s);

}  // namespace rwkv6
}  // namespace repro
