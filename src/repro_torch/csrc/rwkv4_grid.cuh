// The RWKV-4 decode spread over the whole card: the body of K3 (one layer
// a launch, rwkv4_block_decode.cu) and K4 (every layer in one launch,
// rwkv4_model_decode.cu), a cooperative launch of as many blocks as fit
// at once that loops over the launch's layers, with grid-wide barriers
// only where a phase needs a whole vector.  Every output is a chain
// acc = fmaf(x[k], w[k], acc) over k = 0..K-1 in order from acc = 0, with
// rwkv4_body.cuh's bf16 roundings, so the bits do not depend on the grid,
// the tile or the number of layers a launch runs: one K4 launch and L K3
// launches give the same bits.
//
// Work items are column slices of the layer's matrices (common.cuh:
// Matrix), 16 columns: 16 bytes of codes a row for a W8, VQ or W4 plane
// (a W4 byte pairs two rows), 32 for plain bf16 weights.  An item is one
// tile of bb batch lanes × one slice.  The phases of a layer, items spread
// over the grid:
//   A. every block runs LN1 and the three token-shift mixes for the tile
//      (and their A9 maxima under HW) itself; items: the r, k and v
//      columns of a channel slice, then per channel the WKV-4 step, the
//      new wkv state and y = σ(r)·wkv into a scratch in L2.  -> barrier
//   B. every block reads all of y (A9 under HW); items: att.wo's columns,
//      x2 = x + att.                                          -> barrier
//   C. every block runs LN2 and the two mixes; items: ffn.wk's columns
//      (relu², kk) and ffn.wr's (σ, rr).                      -> barrier
//   D. every block reads all of kk (A9 under HW); items: ffn.wv's columns,
//      x = x2 + rr·(kk @ wv).  Under HW the gated product's A9 maximum
//      spans the tile: each item adds its columns' maximum (atomicMax on
//      the bits of a non-negative float, exact in any order) ->
//      barrier, then E writes x.
// A layer's output x is the next layer's input: between layers it is a
// (B, D) bf16 row in device memory, rounded where a single layer writes
// its x_out, and a barrier ends every layer but the last.  Item i of
// phase p goes to block (i + off_p) mod G, off_p the items of the phases
// before p, so the slices of consecutive phases land on different blocks;
// every layer deals its items the same way.  Each vector that other
// blocks write within the launch (the scratch, and the residual between
// layers) is read with __ldcg, past the L1, whose lines may be stale.
//
// The weights on chip: a block's stages (an item's rows, kc at a time in
// phase A's three matrices, 3·kc in the others, with the slices' column
// scales) are copied into a ring of ns slots of shared memory by the
// tensor-copy unit, one box of a 3-D map (row bytes × rows × layers) a
// matrix and stage.  The ring runs over the launch, not the layer: at
// launch it holds the block's first ns stages (every block's share of a
// quantized rwkv4-169m layer and the start of the next), and each stage
// consumed frees a slot that the next stage in (layer, phase, item,
// chunk) order takes, so layer l + 1's weights stream in behind layer l's
// compute.  Issuing is the cost: a slice row is one 16-byte request, and
// requests queue with the block's shared-memory traffic.  A stage is
// decoded once (the decode of unpack_leaf: dpot_w8_decode,
// dpot_w4_decode, vq_decode, or the bf16 weights as they are) into an f32
// tile, column major; two tiles let the threads that own no chain decode
// stage k + 1 while the chains run stage k, one barrier a stage, and each
// phase's (and each layer's) first stage is decoded before the grid
// barrier that opens it, beside the next layer's vectors.  Rows not
// 16-byte aligned (or a ragged last slice) take byte copies.
//
// The arithmetic: a thread owns one (column, lane) chain (two lanes in
// phase A, where three matrices leave few threads to decode), acc =
// fmaf(x[b][k], w[k][c], acc) for k ascending from acc = 0; the stage
// pads past K are zeros in both operands, which leave acc unchanged (acc
// is never -0).  The floor is the longest chain: ffn.wv's F FMAs (3072 at
// rwkv4-169m, ~7 µs at 4 cycles an FMA); splitting K would remove it but
// changes the bits.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>

#include "rwkv4_body.cuh"

namespace repro {
namespace rwkv4 {
namespace grid {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWidth = 16;         // columns a slice
constexpr int kMaxStages = 24;     // ring slots at most
constexpr int kScaleBytes = 64;    // a slice's 16 f32 column scales

enum Phase { kA, kB, kC, kD, kNumPhases };

// Bytes of a slice's row of codes (a W4 row pair) for a layer of PLANES.
template <int PLANES>
__host__ __device__ constexpr int row_bytes() {
  return PLANES == kPlaneBF16 ? 2 * kWidth : kWidth;
}

// A padded row of K activations, in elements: K up to a multiple of 8
// (the chains read 8 at a time), then 8 more (16 bytes, so that lanes'
// rows fall on different banks).
__host__ __device__ inline int pad8(int k) { return (k + 7) / 8 * 8 + 8; }

// A ring slot: a stage's codes (3 matrices × kc rows, or one × 3·kc, of
// rb bytes), then its matrices' column scales, rounded up to 128 bytes
// (a tensor copy's destination is 128-byte aligned).
__host__ __device__ inline size_t slot_bytes(int kc, int rb) {
  return ((size_t)3 * rb * kc + 3 * kScaleBytes + 127) / 128 * 128;
}

// Shared memory offsets, bytes, from a 128-byte aligned base
// (kernels/fused_decode.py:_k3_smem mirrors it): the ring, then each
// slot's barrier; act, the tile's phase inputs (bb lanes of four D-wide
// bf16 rows: three inputs and the LN output, or one D-wide f32, or one
// F-wide bf16); vecs, the layer's 11 vectors; two f32 tiles of decoded
// stages; res, phase A's r, k, v sums; the hardware numerics' tables and
// reduction room; total counts 128 bytes of slack for the alignment.
struct Layout {
  size_t slots, bars, act, vecs, tile, tile_elems, res, hw, total;
};

__host__ __device__ inline Layout layout(int bb, int D, int F, bool hw,
                                         int kc, int ns, int rb) {
  const size_t LD = pad8(D), LF = pad8(F);
  size_t a = 4 * LD * 2;
  if (hw && LD * 4 > a) a = LD * 4;
  if (LF * 2 > a) a = LF * 2;
  const size_t tA = 3 * (size_t)kWidth * (kc + 4);
  const size_t tS = (size_t)kWidth * (3 * kc + 4);
  Layout l;
  size_t off = 0;
  l.slots = off;
  off += (size_t)ns * slot_bytes(kc, rb);
  l.bars = off;
  off += (size_t)kMaxStages * 8;
  l.act = off;
  off += bb * a;
  l.vecs = off;
  off += kNumVecs * LD * 2;
  l.tile = off;
  l.tile_elems = tA > tS ? tA : tS;
  off += 2 * l.tile_elems * 4;
  l.res = off;
  off += (size_t)3 * kWidth * bb * 4;
  l.hw = off;
  if (hw) off += kHwScratch * sizeof(float);
  l.total = off + 128;
  return l;
}

// The scratch vectors in device memory, (B, ·) each: y (f32; exact: the
// bf16 value), x2, kk, rr (f32; exact: the bf16 σ), the gated FFN output g
// and each layer's and tile's max |g| (hardware numerics; L · B/bb), and
// the two residual rows that alternate between layers (null for one).
struct Scratch {
  float* y;
  bf16* x2;
  bf16* kk;
  float* rr;
  float* g;
  unsigned* gmax;
  bf16* res[2];
};

struct Args {
  CUtensorMap tmap[kNumMats];  // each matrix's codes as a 3-D byte tensor
                               // (row bytes × rows × layers), boxes of one
                               // slice × kc rows (kc / 2 byte rows for
                               // W4) × one layer; set where vec's bit 0 is
  LayerWeights w;              // layer 0's, and the strides to layer l
  LayerState st;               // layer 0's; layer l's lie l·B·D further
  Scratch s;
  const bf16* x;
  bf16* x_out;
  const float* exp_tab;  // null: exact numerics
  const float* div_tab;
  int L, B, D, F, bb, kc, ns;
  int vec;  // bit 0: every matrix's slice rows and scales are 16-byte
            // aligned (tensor and bulk copies; else byte copies); bit 1:
            // so are x, the state rows and the vectors, with D and F
            // multiples of 8 (16-byte loads)
};

// The shared-memory barrier that counts a slot's copied bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
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
// One box of a 3-D tensor map (x bytes into a row, row y, layer z) into
// shared memory, its bytes counted on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int x, int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
      "r"(smem_u32(bar))
      : "memory");
}
// `bytes` (a multiple of 16) contiguous bytes into shared memory.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The layer being run, in shared memory, where its pointers cost no
// registers: its state rows, its residual in (x, or the previous layer's
// output) and out (x_out for the last layer), its tiles' max |g|.
struct Layer {
  LayerState st;
  const bf16* x;
  bf16* x_out;
  unsigned* gmax;
};

// The launch's item counts, and per phase its items' stages and this
// block's first item (>= its items: none), computed once: the ring's
// bookkeeping runs in every thread at every stage.  Item i of phase p goes
// to block (i + off_p) mod G, off_p the items of the phases before p.
struct Geo {
  int L, G, tiles, kc, sd, nwk;  // sd: slices of a D-wide matrix
  int chA, chBC, chD;         // stages of an item of phase A, B or C, D
  int f[kNumPhases];          // first items (read with constant indices)
};

__device__ __forceinline__ int slices(const Geo& g, int p) {
  return p == kC ? g.nwk + g.sd : g.sd;
}
__device__ __forceinline__ int items(const Geo& g, int p) {
  return g.tiles * slices(g, p);
}
__device__ __forceinline__ int chunks_of(const Geo& g, int p) {
  return p == kA ? g.chA : p == kD ? g.chD : g.chBC;
}
__device__ __forceinline__ int first_item(const Geo& g, int p) {
  return p == kA ? g.f[kA] : p == kB ? g.f[kB] : p == kC ? g.f[kC] : g.f[kD];
}

__device__ inline Geo make_geo(const Args& a) {
  Geo g;
  g.L = a.L;
  g.G = gridDim.x;
  g.tiles = a.B / a.bb;
  g.kc = a.kc;
  g.sd = (a.D + kWidth - 1) / kWidth;
  g.nwk = (a.F + kWidth - 1) / kWidth;
  g.chA = (a.D + a.kc - 1) / a.kc;
  g.chBC = (a.D + 3 * a.kc - 1) / (3 * a.kc);
  g.chD = (a.F + 3 * a.kc - 1) / (3 * a.kc);
  int before = 0;
#pragma unroll
  for (int p = 0; p < kNumPhases; ++p) {
    g.f[p] = ((int)blockIdx.x - before % g.G + g.G) % g.G;
    before += items(g, p);
  }
  return g;
}

struct Item {
  int tile, slice, c0;
  int nm;       // matrices: 3 (phase A: att.wr, wk, wv) or 1
  int mat0;     // enum Mat of the first; matrix mi is mat0 + mi
  int in0;      // act region of the first's input; matrix mi's is in0 + mi
  int K, N;     // rows, columns of the matrices
  int rows;     // rows a stage
  int chunks;   // stages
};

__device__ inline Item item_of(const Geo& g, const Args& a, int p, int i) {
  Item it;
  const int S = slices(g, p);
  it.tile = i / S;
  it.slice = i % S;
  it.nm = 1;
  it.in0 = 0;
  it.K = a.D;
  it.N = a.D;
  it.rows = 3 * g.kc;
  it.c0 = it.slice * kWidth;
  if (p == kA) {
    it.nm = 3;
    it.mat0 = ATT_WR;  // then ATT_WK, ATT_WV (enum Mat), inputs 0, 1, 2
    it.rows = g.kc;
  } else if (p == kB) {
    it.mat0 = ATT_WO;
  } else if (p == kC) {
    if (it.slice < g.nwk) {
      it.mat0 = FFN_WK;
      it.in0 = 1;
      it.N = a.F;
    } else {
      it.mat0 = FFN_WR;
      it.c0 = (it.slice - g.nwk) * kWidth;
    }
  } else {
    it.mat0 = FFN_WV;
    it.K = a.F;
  }
  it.chunks = chunks_of(g, p);
  return it;
}

// A place in this block's sequence of stages over the launch: layer and
// phase (as one count, which costs a register less), item, stage; layer
// == L past the end.
struct Cursor {
  int lp, i, chunk;  // lp: layer · kNumPhases + phase
};

__device__ inline void settle(Cursor& c, const Geo& g) {
  while (c.lp < g.L * kNumPhases && c.i >= items(g, c.lp % kNumPhases)) {
    ++c.lp;
    c.i = first_item(g, c.lp % kNumPhases);
  }
}

__device__ inline void advance(Cursor& c, const Geo& g) {
  if (++c.chunk < chunks_of(g, c.lp % kNumPhases)) return;
  c.chunk = 0;
  c.i += g.G;
  settle(c, g);
}

template <int PLANES>
__device__ __forceinline__ int plane_of(const Matrix& m) {
  return PLANES == kPlaneAny ? m.plane : PLANES;
}

// The column scales in a slot holding a stage of `it`: after its codes.
template <int PLANES, typename U>
__device__ __forceinline__ float* slot_scales(U* slot, const Item& it) {
  return reinterpret_cast<float*>(const_cast<unsigned char*>(slot) +
                                  (size_t)row_bytes<PLANES>() * it.rows *
                                      it.nm);
}

// Copy stage `chunk` of item `it` of layer l into a slot: for each
// matrix, its byte rows [r0, r0 + nrows) (W4: halved) of the slice from
// column c0, and its 16 column scales (W8, W4; shared by the layers)
// after the codes; the slot's barrier counts them.  vec: thread t0 issues
// tensor boxes of kc rows (rows past the matrix read as zeros) and a bulk
// copy of the scales; else the team t0.. of nteam copies bytes (columns
// past N as zeros) and t0 arrives.
template <int PLANES>
__device__ void issue_stage(const Args& a, const LayerWeights& w,
                            const Item& it, int l, int chunk,
                            unsigned char* slot, uint64_t* bar, bool vec,
                            int t0, int nteam) {
  constexpr int RB = row_bytes<PLANES>();
  const int r0 = chunk * it.rows;
  const int nrows = min(it.rows, it.K - r0);
  const int me = threadIdx.x - t0;
  float* scales = slot_scales<PLANES>(slot, it);
  if (vec) {
    if (me != 0) return;
    int bytes = 0;
    for (int mi = 0; mi < it.nm; ++mi) {
      const int plane = plane_of<PLANES>(w.mat[it.mat0 + mi]);
      const int half = plane == kPlaneW4 ? 2 : 1;
      const int box = a.kc / half;  // byte rows a box
      bytes += (nrows / half + box - 1) / box * box * RB +
               (plane <= kPlaneW4 ? kScaleBytes : 0);
    }
    mbar_arrive_expect(bar, bytes);
    for (int mi = 0; mi < it.nm; ++mi) {
      const Matrix& m = w.mat[it.mat0 + mi];
      const int plane = plane_of<PLANES>(m);
      const int half = plane == kPlaneW4 ? 2 : 1;
      const int box = a.kc / half;
      const int esz = plane == kPlaneBF16 ? 2 : 1;
      unsigned char* dst = slot + (size_t)mi * it.rows * RB;
      for (int r = 0; r < nrows / half; r += box)
        tma_box(dst + r * RB, &a.tmap[it.mat0 + mi], it.c0 * esz,
                r0 / half + r, l, bar);
      if (plane <= kPlaneW4)
        bulk_copy(scales + mi * (kScaleBytes / 4),
                  static_cast<const float*>(m.aux) + it.c0, kScaleBytes,
                  bar);
    }
    return;
  }
  for (int mi = 0; mi < it.nm; ++mi) {
    const Matrix& m = w.mat[it.mat0 + mi];
    const int plane = plane_of<PLANES>(m);
    const int esz = plane == kPlaneBF16 ? 2 : 1;
    const int half = plane == kPlaneW4 ? 2 : 1;
    const int nbr = nrows / half;
    const size_t rowbytes = (size_t)it.N * esz;
    const uint8_t* src = m.codes + l * w.mat_stride[it.mat0 + mi] +
                         (size_t)(r0 / half) * rowbytes + (size_t)it.c0 * esz;
    unsigned char* dst = slot + (size_t)mi * it.rows * RB;
    const size_t live = rowbytes - (size_t)it.c0 * esz;
    for (int i = me; i < nbr * RB; i += nteam) {
      const int r = i / RB, j = i % RB;
      dst[i] = (size_t)j < live ? src[r * rowbytes + j] : 0;
    }
    if (plane <= kPlaneW4 && me < kScaleBytes / 4) {
      const float* msc = static_cast<const float*>(m.aux) + it.c0;
      scales[mi * (kScaleBytes / 4) + me] =
          it.c0 + me < it.N ? msc[me] : 0.f;
    }
  }
  if (me == 0) mbar_arrive_expect(bar, 0);
}

__device__ __forceinline__ uint32_t byte_of(uint32_t word, int j) {
  return (word >> (8 * j)) & 0xffu;
}

// Decode one matrix of a landed stage into its tile rows (column j at
// row j, stride TS floats, rows [0, round8(nrows)), zeros past nrows).
// A unit is one 4-byte word q of a row pair: 4 columns of codes (2 of
// bf16 weights) × 2 rows, stored as float pairs.
template <int PLANE, int RB>
__device__ __forceinline__ void decode_matrix(const Matrix& m,
                                              const unsigned char* src,
                                              const float* msc, float* out,
                                              int nrows, int npairs, int TS,
                                              int me, int nteam) {
  constexpr int QW = RB / 4;  // words a row
  for (int u = me; u < QW * npairs; u += nteam) {
    const int q = u % QW, kp = u / QW;
    const bool live = 2 * kp < nrows;
    uint32_t a = 0u, b = 0u;
    if (live) {
      const unsigned char* row =
          src + (PLANE == kPlaneW4 ? kp : 2 * kp) * RB + 4 * q;
      a = *reinterpret_cast<const uint32_t*>(row);
      if (PLANE != kPlaneW4)
        b = *reinterpret_cast<const uint32_t*>(row + RB);
    }
    if constexpr (PLANE == kPlaneBF16) {
      *reinterpret_cast<float2*>(out + (2 * q) * TS + 2 * kp) =
          make_float2(bf16_lo(a), bf16_lo(b));
      *reinterpret_cast<float2*>(out + (2 * q + 1) * TS + 2 * kp) =
          make_float2(bf16_hi(a), bf16_hi(b));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float w0 = 0.f, w1 = 0.f;
        if (live) {
          if constexpr (PLANE == kPlaneVQ) {
            const bf16* cb = static_cast<const bf16*>(m.aux);
            w0 = vq_decode(byte_of(a, j), cb);
            w1 = vq_decode(byte_of(b, j), cb);
          } else if constexpr (PLANE == kPlaneW4) {
            w0 = dpot_w4_decode(byte_of(a, j), 0, msc[4 * q + j]);
            w1 = dpot_w4_decode(byte_of(a, j), 1, msc[4 * q + j]);
          } else {
            w0 = dpot_w8_decode(byte_of(a, j), msc[4 * q + j]);
            w1 = dpot_w8_decode(byte_of(b, j), msc[4 * q + j]);
          }
        }
        *reinterpret_cast<float2*>(out + (4 * q + j) * TS + 2 * kp) =
            make_float2(w0, w1);
      }
    }
  }
}

// Decode a landed stage into a tile: matrix mi's column j at tile row
// mi·16 + j; threads t0.. of a team of nteam take part; the column scales
// (W8, W4) come with the stage.
template <int PLANES>
__device__ void decode_stage(const LayerWeights& w, const Item& it, int chunk,
                             const unsigned char* slot, float* tile, int t0,
                             int nteam) {
  constexpr int RB = row_bytes<PLANES>();
  const int r0 = chunk * it.rows;
  const int nrows = min(it.rows, it.K - r0);
  const int npairs = (nrows + 7) / 8 * 4;
  const int TS = it.rows + 4;
  const int me = threadIdx.x - t0;
  for (int mi = 0; mi < it.nm; ++mi) {
    const Matrix& m = w.mat[it.mat0 + mi];
    const unsigned char* src = slot + (size_t)mi * it.rows * RB;
    float* out = tile + (size_t)mi * kWidth * TS;
    const float* msc = slot_scales<PLANES>(slot, it) + mi * (kScaleBytes / 4);
    if constexpr (PLANES != kPlaneAny) {
      decode_matrix<PLANES, RB>(m, src, msc, out, nrows, npairs, TS, me,
                                nteam);
    } else {
      switch (m.plane) {
        case kPlaneW4:
          decode_matrix<kPlaneW4, RB>(m, src, msc, out, nrows, npairs, TS, me,
                                      nteam);
          break;
        case kPlaneVQ:
          decode_matrix<kPlaneVQ, RB>(m, src, msc, out, nrows, npairs, TS, me,
                                      nteam);
          break;
        default:
          decode_matrix<kPlaneW8, RB>(m, src, msc, out, nrows, npairs, TS, me,
                                      nteam);
      }
    }
  }
}

// acc = fmaf(x[k], w[k], acc) for k = 0..n-1 in order (n a multiple of 8):
// x a bf16 (or f32) row of act, w an f32 row of a tile; the next 8 values
// are loaded before this 8's FMAs, so the loads hide under the chain.
__device__ __forceinline__ void fma8(const uint4& xv, const float4& w0,
                                     const float4& w1, float& acc) {
  acc = fmaf(bf16_lo(xv.x), w0.x, acc);
  acc = fmaf(bf16_hi(xv.x), w0.y, acc);
  acc = fmaf(bf16_lo(xv.y), w0.z, acc);
  acc = fmaf(bf16_hi(xv.y), w0.w, acc);
  acc = fmaf(bf16_lo(xv.z), w1.x, acc);
  acc = fmaf(bf16_hi(xv.z), w1.y, acc);
  acc = fmaf(bf16_lo(xv.w), w1.z, acc);
  acc = fmaf(bf16_hi(xv.w), w1.w, acc);
}

__device__ __forceinline__ float chain(const bf16* x, const float* w, int n,
                                       float acc) {
  const uint4* xp = reinterpret_cast<const uint4*>(x);
  const float4* wp = reinterpret_cast<const float4*>(w);
  uint4 xv = xp[0];
  float4 w0 = wp[0], w1 = wp[1];
#pragma unroll 2
  for (int k = 1; k < n / 8; ++k) {
    const uint4 xn = xp[k];
    const float4 a0 = wp[2 * k], a1 = wp[2 * k + 1];
    fma8(xv, w0, w1, acc);
    xv = xn;
    w0 = a0;
    w1 = a1;
  }
  fma8(xv, w0, w1, acc);
  return acc;
}

// The same for two lanes' rows x0, x1 against one tile row (two chains).
__device__ __forceinline__ void chain2(const bf16* x0, const bf16* x1,
                                       const float* w, int n, float& acc0,
                                       float& acc1) {
  const uint4* p0 = reinterpret_cast<const uint4*>(x0);
  const uint4* p1 = reinterpret_cast<const uint4*>(x1);
  const float4* wp = reinterpret_cast<const float4*>(w);
  uint4 a = p0[0], b = p1[0];
  float4 w0 = wp[0], w1 = wp[1];
#pragma unroll 2
  for (int k = 1; k < n / 8; ++k) {
    const uint4 an = p0[k], bn = p1[k];
    const float4 v0 = wp[2 * k], v1 = wp[2 * k + 1];
    fma8(a, w0, w1, acc0);
    fma8(b, w0, w1, acc1);
    a = an;
    b = bn;
    w0 = v0;
    w1 = v1;
  }
  fma8(a, w0, w1, acc0);
  fma8(b, w0, w1, acc1);
}

// The same over f32 rows x0, x1 (the hardware numerics' y).
__device__ __forceinline__ void chain2(const float* x0, const float* x1,
                                       const float* w, int n, float& acc0,
                                       float& acc1) {
  for (int k = 0; k < n; k += 4) {
    const float4 a = *reinterpret_cast<const float4*>(x0 + k);
    const float4 b = *reinterpret_cast<const float4*>(x1 + k);
    const float4 v = *reinterpret_cast<const float4*>(w + k);
    acc0 = fmaf(a.x, v.x, acc0);
    acc0 = fmaf(a.y, v.y, acc0);
    acc0 = fmaf(a.z, v.z, acc0);
    acc0 = fmaf(a.w, v.w, acc0);
    acc1 = fmaf(b.x, v.x, acc1);
    acc1 = fmaf(b.y, v.y, acc1);
    acc1 = fmaf(b.z, v.z, acc1);
    acc1 = fmaf(b.w, v.w, acc1);
  }
}

__device__ __forceinline__ float chain(const float* x, const float* w, int n,
                                       float acc) {
  for (int k = 0; k < n; k += 4) {
    const float4 a = *reinterpret_cast<const float4*>(x + k);
    const float4 v = *reinterpret_cast<const float4*>(w + k);
    acc = fmaf(a.x, v.x, acc);
    acc = fmaf(a.y, v.y, acc);
    acc = fmaf(a.z, v.z, acc);
    acc = fmaf(a.w, v.w, acc);
  }
  return acc;
}

__device__ __forceinline__ float ldcgf(const bf16* p) {
  return bf2f(__ldcg(p));
}

// common.cuh's mix for two adjacent elements, each operation rounded to
// bf16 as there, two values a conversion.
__device__ __forceinline__ __nv_bfloat162 mix2(__nv_bfloat162 h,
                                               __nv_bfloat162 prev,
                                               __nv_bfloat162 p) {
  const float2 hf = __bfloat1622float2(h), pf = __bfloat1622float2(p);
  const float2 vf = __bfloat1622float2(prev);
  const float2 hp =
      __bfloat1622float2(__floats2bfloat162_rn(hf.x * pf.x, hf.y * pf.y));
  const float2 q =
      __bfloat1622float2(__floats2bfloat162_rn(1.f - pf.x, 1.f - pf.y));
  const float2 xq =
      __bfloat1622float2(__floats2bfloat162_rn(vf.x * q.x, vf.y * q.y));
  return __floats2bfloat162_rn(hp.x + xq.x, hp.y + xq.y);
}

// Copy rows r < rows of n bf16 values from src(r) (device memory) to
// dst(r) (shared memory): 16 bytes a load where v16 (n a multiple of 8,
// every row 16-byte aligned), else one value; up to 8 loads in flight a
// thread before their stores.  cg: past the L1 (scratch other blocks
// wrote).
template <class Src, class Dst>
__device__ void copy_rows(int rows, int n, bool v16, bool cg, Src src,
                          Dst dst) {
  constexpr int kDepth = 8;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (v16) {
    const int per = n / 8, total = rows * per;
    for (int i0 = tid; i0 < total; i0 += kDepth * nt) {
      uint4 v[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int i = i0 + u * nt;
        if (i < total) {
          const uint4* p = reinterpret_cast<const uint4*>(src(i / per)) +
                           i % per;
          v[u] = cg ? __ldcg(p) : __ldg(p);
        }
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int i = i0 + u * nt;
        if (i < total)
          reinterpret_cast<uint4*>(dst(i / per))[i % per] = v[u];
      }
    }
  } else {
    const int total = rows * n;
    for (int i0 = tid; i0 < total; i0 += kDepth * nt) {
      bf16 v[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int i = i0 + u * nt;
        if (i < total)
          v[u] = cg ? __ldcg(src(i / n) + i % n) : src(i / n)[i % n];
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int i = i0 + u * nt;
        if (i < total) dst(i / n)[i % n] = v[u];
      }
    }
  }
}

// The same for bb rows of n f32 scratch values (y) into T rows of stride
// LS (f32 under the hardware numerics; exact: the bf16 values they hold).
template <typename T>
__device__ void copy_f32_rows(T* dst, int LS, const float* src, int bb,
                              int n) {
  constexpr int kDepth = 8;
  const int tid = threadIdx.x, nt = blockDim.x, total = bb * n;
  for (int i0 = tid; i0 < total; i0 += kDepth * nt) {
    float v[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int i = i0 + u * nt;
      if (i < total) v[u] = __ldcg(src + i);
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int i = i0 + u * nt;
      if (i < total) {
        if constexpr (sizeof(T) == sizeof(bf16))
          dst[(i / n) * LS + i % n] = __float2bfloat16_rn(v[u]);
        else
          dst[(i / n) * LS + i % n] = v[u];
      }
    }
  }
}

// Zero the pads [n, LS) of bb rows of stride LS.
template <typename T>
__device__ void zero_pads(T* rows, int bb, int LS, int n) {
  const int w = LS - n;
  for (int i = threadIdx.x; i < bb * w; i += blockDim.x) {
    T& v = rows[(i / w) * LS + n + i % w];
    if constexpr (sizeof(T) == sizeof(bf16))
      v = __float2bfloat16_rn(0.f);
    else
      v = 0.f;
  }
}

// A9 of N tensors of bb rows × n values in place (tensor j at buf +
// j·tstride, rows of stride LS), each scale from its own max|v| over the
// block, with hw_units.cuh's a9 bits (a9_rcp: a multiply where a9
// divides), a bf16 tensor's dequantized value rounded to bf16
// (`.astype(x.dtype)`), an f32 one's kept; the N tensors' values taken
// together so their work overlaps.  Ends with a barrier.
template <int N, typename T>
__device__ __forceinline__ void a9_rows(T* buf, int tstride, int bb, int LS,
                                        int n, float* red) {
  float m[N];
#pragma unroll
  for (int j = 0; j < N; ++j) m[j] = 0.f;
  for (int b = 0; b < bb; ++b)
#pragma unroll 2
    for (int d = threadIdx.x; d < n; d += blockDim.x)
#pragma unroll
      for (int j = 0; j < N; ++j)
        m[j] = fmaxf(m[j], fabsf(as_f32(buf[j * tstride + b * LS + d])));
  block_max<N>(m, red);
  float rcp[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    m[j] = a9_scale(m[j]);
    rcp[j] = 1.f / m[j];
  }
  for (int b = 0; b < bb; ++b)
#pragma unroll 2
    for (int d = threadIdx.x; d < n; d += blockDim.x)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T& v = buf[j * tstride + b * LS + d];
        if constexpr (sizeof(T) == sizeof(bf16))
          v = __float2bfloat16_rn(a9_rcp(as_f32(v), m[j], rcp[j]));
        else
          v = a9_rcp(as_f32(v), m[j], rcp[j]);
      }
  __syncthreads();
}

// This block's ring of stages over the launch: the next stage to issue,
// how many it has issued and how many it has consumed (decoded: their
// slots are free).  Stage k (counted over every layer) lands in slot
// k mod ns, whose barrier completes once a use: phase parity (k / ns) & 1.
struct Ring {
  Cursor next;
  int issued, consumed;
};

// Issue up to `most` stages into free slots (thread t0 issues tensor
// copies; byte copies take the team t0.. of nteam).
template <int PLANES>
__device__ void ring_fill(Ring& r, int most, const LayerWeights& w,
                          const Geo& g, const Args& a, unsigned char* slots,
                          uint64_t* bars, bool vec, int t0, int nteam) {
  const size_t sb = slot_bytes(a.kc, row_bytes<PLANES>());
  for (int k = 0; k < most && r.next.lp < g.L * kNumPhases &&
                  r.issued < r.consumed + a.ns;
       ++k) {
    const int slot = r.issued % a.ns;
    if (threadIdx.x >= t0)
      issue_stage<PLANES>(a, w, item_of(g, a, r.next.lp % kNumPhases,
                                        r.next.i),
                          r.next.lp / kNumPhases,
                          r.next.chunk, slots + slot * sb, bars + slot, vec,
                          t0, nteam);
    ++r.issued;
    advance(r.next, g);
  }
}

// Wait until stage `stage` has landed in its slot (byte copies: the
// caller's next barrier makes them visible).
__device__ __forceinline__ void ring_wait(const Ring& r, uint64_t* bars,
                                          int ns, int stage) {
  while (!mbar_try_wait(bars + stage % ns, (stage / ns) & 1)) {
  }
}

// Every layer of the launch for every lane; the caller is a cooperative
// kernel of kThreads threads with `smem` of layout(...).total bytes, and
// w, cur (layer 0's, which the loop moves on a layer at a time) and g
// (make_geo) in shared memory, where they cost no registers.
template <int PLANES, bool HW>
__device__ void run(const LayerWeights& w, Layer& cur, const Geo& g,
                    const Args& a, unsigned char* smem) {
  constexpr int W = kWidth;
  cg::grid_group gridg = cg::this_grid();
  const int bb = a.bb, D = a.D, F = a.F;
  const Layout lay = layout(bb, D, F, HW, a.kc, a.ns, row_bytes<PLANES>());
  smem += (128 - smem_u32(smem) % 128) % 128;
  const int LD = pad8(D), LF = pad8(F);
  bf16* act = reinterpret_cast<bf16*>(smem + lay.act);
  float* actf = reinterpret_cast<float*>(smem + lay.act);
  bf16* H = act + 3 * bb * LD;  // the LN output (phases A and C)
  bf16* vecs = reinterpret_cast<bf16*>(smem + lay.vecs);
  float* tiles = reinterpret_cast<float*>(smem + lay.tile);
  float* res = reinterpret_cast<float*>(smem + lay.res);
  unsigned char* slots = smem + lay.slots;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  const size_t sb = slot_bytes(a.kc, row_bytes<PLANES>());
  float* hws = reinterpret_cast<float*>(smem + lay.hw);
  float* red = HW ? hws + kHwTabs : nullptr;
  const LutUnits units{hws, HW ? hws + 256 : nullptr};
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool vec = (a.vec & 1) != 0, rows16 = (a.vec & 2) != 0;
  const Scratch& s = a.s;
  auto vec_of = [&](int v) { return vecs + v * LD; };
  // layer l's vectors into shared memory
  auto stage_vecs = [&](int l) {
    copy_rows(kNumVecs, D, rows16, false,
              [&](int r) { return w.vec[r] + l * w.vec_stride; },
              [&](int r) { return vecs + r * LD; });
  };

  // the ring: the block's first ns stages in flight from the start, then
  // layer 0's vectors (and under HW the tables) into shared memory
  if (tid < a.ns) mbar_init(bars + tid, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  Ring ring{{kA, first_item(g, kA), 0}, 0, 0};
  settle(ring.next, g);
  ring_fill<PLANES>(ring, a.ns, w, g, a, slots, bars, vec, 0, nt);
  if constexpr (HW) {
    stage_luts(hws, a.exp_tab, a.div_tab);
    if (blockIdx.x == 0)
      for (int t = tid; t < g.L * g.tiles; t += nt) s.gmax[t] = 0u;
  }
  const LayerState& st = cur.st;
  stage_vecs(0);
  bool ready = false;  // the next stage to consume is decoded in tile 0

  // the end of layer l's work in this block: layer l + 1's pointers
  // taken, its vectors staged and its first stage decoded, while other
  // blocks finish layer l (the caller's grid barrier then opens l + 1)
  auto next_layer = [&](int l) {
    __syncthreads();  // this block's work on layer l is done
    if (tid < kNumState) {
      const size_t BD = (size_t)a.B * D;
      cur.st.in[tid] += BD;
      cur.st.out[tid] += BD;
    } else if (tid == kNumState) {
      // layer l wrote res[l & 1]; layer l + 1 writes the other, or x_out
      // (constant indices: a parameter indexed at run time lands on the
      // stack)
      cur.x = l & 1 ? s.res[1] : s.res[0];
      cur.x_out = l + 2 == g.L ? a.x_out : l & 1 ? s.res[0] : s.res[1];
      cur.gmax += g.tiles;
    }
    stage_vecs(l + 1);
    if (first_item(g, kA) < items(g, kA)) {
      ring_wait(ring, bars, a.ns, ring.consumed);
      __syncthreads();  // its copies landed
      decode_stage<PLANES>(w, item_of(g, a, kA, first_item(g, kA)), 0,
                           slots + (ring.consumed % a.ns) * sb, tiles, 0,
                           nt);
      ready = true;
    }
  };

  for (int l = 0; l < g.L; ++l) {
    for (int p = 0; p < kNumPhases; ++p) {
      int held = -1;  // the tile whose inputs act holds
      for (int i = first_item(g, p); i < items(g, p); i += g.G) {
        const Item it = item_of(g, a, p, i);
        const int b0 = it.tile * bb;
        __syncthreads();  // the last item's chains and epilogue are done
        if (it.tile != held) {
          // the phase's inputs for this tile; the block with the tile's
          // first slice writes the LN state rows
          const bool owner = it.slice == 0;
          if (p == kA || p == kC) {
            // x (A) or x2 (C) into act region 2, the previous token's row
            // into region 0, then LN into H and the mixes over regions 0..
            bf16* X = act + 2 * bb * LD;
            const bf16* xp = p == kA ? cur.x : s.x2;
            const bf16* prev = st.in[p == kA ? ATT_X : FFN_X];
            copy_rows(2 * bb, D, rows16, true,
                      [&](int r) {
                        return r < bb ? xp + (size_t)(b0 + r) * D
                                      : prev + (size_t)(b0 + r - bb) * D;
                      },
                      [&](int r) {
                        return r < bb ? X + r * LD : act + (r - bb) * LD;
                      });
            __syncthreads();
            layernorm_lanes_n(bb, X, H, LD, vec_of(p == kA ? LN1_W : LN2_W),
                              vec_of(p == kA ? LN1_B : LN2_B), D,
                              owner ? st.out[p == kA ? ATT_X : FFN_X]
                                    : nullptr,
                              b0);
            __syncthreads();
            const int nmix = p == kA ? 3 : 2;
            const int vm = p == kA ? ATT_MIX_R : FFN_MIX_R;
            for (int b = 0; b < bb; ++b)
              for (int d = 2 * tid; d < D; d += 2 * nt) {  // D is even
                const __nv_bfloat162 h =
                    *reinterpret_cast<const __nv_bfloat162*>(H + b * LD + d);
                const __nv_bfloat162 pv =
                    *reinterpret_cast<const __nv_bfloat162*>(act + b * LD +
                                                             d);
                for (int j = 0; j < nmix; ++j)
                  *reinterpret_cast<__nv_bfloat162*>(act + (j * bb + b) * LD +
                                                     d) =
                      mix2(h, pv,
                           *reinterpret_cast<const __nv_bfloat162*>(
                               vec_of(vm + j) + d));
              }
            zero_pads(act, nmix * bb, LD, D);
            __syncthreads();
            if constexpr (HW) {
              if (p == kA)
                a9_rows<3>(act, bb * LD, bb, LD, D, red);
              else
                a9_rows<2>(act, bb * LD, bb, LD, D, red);
            }
          } else if (p == kB) {
            if constexpr (HW) {
              copy_f32_rows(actf, LD, s.y + (size_t)b0 * D, bb, D);
              zero_pads(actf, bb, LD, D);
            } else {
              copy_f32_rows(act, LD, s.y + (size_t)b0 * D, bb, D);
              zero_pads(act, bb, LD, D);
            }
            __syncthreads();
            if constexpr (HW) a9_rows<1>(actf, 0, bb, LD, D, red);
          } else {
            copy_rows(bb, F, rows16, true,
                      [&](int r) { return s.kk + (size_t)(b0 + r) * F; },
                      [&](int r) { return act + r * LF; });
            zero_pads(act, bb, LF, F);
            __syncthreads();
            if constexpr (HW) a9_rows<1>(act, 0, bb, LF, F, red);
          }
          held = it.tile;
        }

        // the chains: thread t < nchain owns matrix mi, column c0 + j and
        // lps lanes from b (two in phase A when bb is even, so that more
        // threads decode there); the others decode the next stage meanwhile
        const int lps = p == kA && bb % 2 == 0 ? 2 : 1;
        const int per = W * bb / lps;
        const int nchain = it.nm * per;
        const bool chainer = tid < nchain;
        const int mi = tid / per, j = tid % per % W, b = tid % per / W * lps;
        const int LS = p == kD ? LF : LD;
        const int TS = it.rows + 4;
        if (!ready) {  // stage 0, decoded by every thread
          ring_wait(ring, bars, a.ns, ring.consumed);
          __syncthreads();  // its copies landed
          decode_stage<PLANES>(w, it, 0,
                               slots + (ring.consumed % a.ns) * sb, tiles, 0,
                               nt);
        }
        ready = false;
        float acc = 0.f, acc1 = 0.f;
        for (int ch = 0; ch < it.chunks; ++ch) {
          const bool more = ch + 1 < it.chunks;
          if (more) ring_wait(ring, bars, a.ns, ring.consumed + 1);
          __syncthreads();  // stage ch decoded; stage ch + 1 landed; the
                            // chains of stage ch - 1 are done
          ++ring.consumed;  // stage ch's slot
          ring_fill<PLANES>(ring, 3, w, g, a, slots, bars, vec, nchain,
                            nt - nchain);
          const float* now = tiles + (ch & 1) * lay.tile_elems;
          if (chainer) {
            const int r0 = ch * it.rows;
            const int n = (min(it.rows, it.K - r0) + 7) / 8 * 8;
            const float* wr = now + (size_t)(mi * W + j) * TS;
            const bf16* xr =
                act + ((size_t)(it.in0 + mi) * bb + b) * LS + r0;
            const float* xf = actf + (size_t)b * LD + r0;
            if (HW && p == kB && lps == 2)
              chain2(xf, xf + LD, wr, n, acc, acc1);
            else if (HW && p == kB)
              acc = chain(xf, wr, n, acc);
            else if (lps == 2)
              chain2(xr, xr + LS, wr, n, acc, acc1);
            else
              acc = chain(xr, wr, n, acc);
          } else if (more) {
            decode_stage<PLANES>(w, it, ch + 1,
                                 slots + (ring.consumed % a.ns) * sb,
                                 tiles + ((ch + 1) & 1) * lay.tile_elems,
                                 nchain, nt - nchain);
          }
        }

        // the item's outputs
        const int c = it.c0 + j;
        if (p == kA) {
          if (chainer) {
            res[(mi * bb + b) * W + j] = acc;
            if (lps == 2) res[(mi * bb + b + 1) * W + j] = acc1;
          }
          __syncthreads();
          for (int e = tid; e < W * bb; e += nt) {
            const int ce = it.c0 + e % W, be = e / W;
            if (ce >= D) continue;
            const float ar = res[(0 * bb + be) * W + e % W];
            const float ak = res[(1 * bb + be) * W + e % W];
            const float av = res[(2 * bb + be) * W + e % W];
            const float wd = expf(bf2f(vec_of(TIME_DECAY)[ce]));
            const float u = bf2f(vec_of(TIME_FIRST)[ce]);
            const size_t gi = (size_t)(b0 + be) * D + ce;
            float na, nb, no;
            if constexpr (HW) {
              const float out = wkv4_step(
                  bf2f(st.in[WKV_A][gi]), bf2f(st.in[WKV_B][gi]),
                  bf2f(st.in[WKV_O][gi]), bf16r(ak), bf16r(av), wd, u, &na,
                  &nb, &no, units);
              s.y[gi] = sigmoid_pwl(bf16r(ar)) * bf16r(out);
            } else {
              const float out = wkv4_step(
                  bf2f(st.in[WKV_A][gi]), bf2f(st.in[WKV_B][gi]),
                  bf2f(st.in[WKV_O][gi]), bf16r(ak), bf16r(av), wd, u, &na,
                  &nb, &no);
              const float sr = sigmoid_bf16(bf16r(ar));
              s.y[gi] = bf16r(sr * bf16r(out));
            }
            st.out[WKV_A][gi] = __float2bfloat16_rn(na);
            st.out[WKV_B][gi] = __float2bfloat16_rn(nb);
            st.out[WKV_O][gi] = __float2bfloat16_rn(no);
          }
        } else if (chainer && c < it.N) {
          for (int l2 = 0; l2 < lps; ++l2) {  // the thread's lanes
            const float sum = l2 ? acc1 : acc;
            const size_t lane = (size_t)(b0 + b + l2);
            const size_t gi = lane * D + c;
            if (p == kB) {
              s.x2[gi] =
                  __float2bfloat16_rn(ldcgf(cur.x + gi) + bf16r(sum));
            } else if (p == kC && it.mat0 == FFN_WK) {
              const float t = fmaxf(bf16r(sum), 0.f);
              s.kk[lane * F + c] = __float2bfloat16_rn(t * t);
            } else if (p == kC) {
              s.rr[gi] =
                  HW ? sigmoid_pwl(bf16r(sum)) : sigmoid_bf16(bf16r(sum));
            } else if constexpr (HW) {
              const float gv = __ldcg(s.rr + gi) * bf16r(sum);
              s.g[gi] = gv;
              atomicMax(cur.gmax + it.tile, __float_as_uint(fabsf(gv)));
            } else {
              const float ffn = bf16r(__ldcg(s.rr + gi) * bf16r(sum));
              cur.x_out[gi] = __float2bfloat16_rn(ldcgf(s.x2 + gi) + ffn);
            }
          }
        }
      }
      if (p < kD) {
        // the next phase's first stage, decoded while other blocks finish
        if (first_item(g, p + 1) < items(g, p + 1)) {
          ring_wait(ring, bars, a.ns, ring.consumed);
          __syncthreads();  // its copies landed; the tiles are free
          decode_stage<PLANES>(
              w, item_of(g, a, p + 1, first_item(g, p + 1)), 0,
              slots + (ring.consumed % a.ns) * sb, tiles, 0, nt);
          ready = true;
        }
        gridg.sync();
      } else if (HW) {
        gridg.sync();  // every item's maximum is in
      } else if (l + 1 < g.L) {
        next_layer(l);
        gridg.sync();  // x is whole for the next layer
      }
    }

    // E (hardware numerics): the gated product's A9 over its tile, and the
    // residual add, for the columns of this block's phase-D items
    if constexpr (HW) {
      for (int i = first_item(g, kD); i < items(g, kD); i += g.G) {
        const Item it = item_of(g, a, kD, i);
        const float scale =
            a9_scale(__uint_as_float(__ldcg(cur.gmax + it.tile)));
        for (int e = tid; e < W * bb; e += nt) {
          const int c = it.c0 + e % W;
          if (c >= D) continue;
          const size_t gi = (size_t)(it.tile * bb + e / W) * D + c;
          const float ffn =
              bf16r(a9_rcp(__ldcg(s.g + gi), scale, 1.f / scale));
          cur.x_out[gi] = __float2bfloat16_rn(ldcgf(s.x2 + gi) + ffn);
        }
      }
      if (l + 1 < g.L) {
        next_layer(l);
        gridg.sync();  // x is whole for the next layer
      }
    }
  }
}

// The kernel: K3 is its launch with L = 1, K4 with the stack's L.  The
// tables are read from shared memory, as K7 reads its own: indexed at run
// time, a parameter-space table lands on each thread's stack.  So is the
// launch's geometry.
template <int PLANES, bool HW>
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ LayerWeights w;
  __shared__ Layer cur;
  __shared__ Geo g;
  if (threadIdx.x == 0) {
    w = a.w;
    cur = {a.st, a.x, a.L == 1 ? a.x_out : a.s.res[0], a.s.gmax};
    g = make_geo(a);
  }
  __syncthreads();
  run<PLANES, HW>(w, cur, g, a, smem);
}

// Host side (rwkv4_model_decode.cu).  Whether the device has cooperative
// launch, and the largest grid of the instance for `planes` (planes_of)
// and the numerics at `smem` bytes of shared memory a block that fits on
// it at once.
int max_grid(int planes, bool hw, int smem, int* coop, int* blocks);
// Check the launch's sizes against the plan (`width`, a.kc, a.ns, `smem`:
// kernels/fused_decode.py:k3_plan), encode each matrix's tensor map where
// a.vec's bit 0 is, and launch `grid` blocks; returns a cudaError_t.
int launch(Args& a, int planes, int width, int smem, int grid,
           cudaStream_t stream);

}  // namespace grid
}  // namespace rwkv4
}  // namespace repro
