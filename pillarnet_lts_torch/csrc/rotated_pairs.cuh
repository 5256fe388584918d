// Pair-tile machinery shared by the rotated-box pair kernels
// (rotated_overlap.cu, K2; suppression_mask.cu, K3), for Hopper (sm_90a).
//
// A block owns a tile of kTileRows row boxes x kTileCols column boxes. Its
// prologue stages each box's per-box values once in shared memory (corners,
// corner mean, bounding-circle radius, area). Then, for every pair of the
// tile:
//
//   1. the separation test (`may_meet`): the pair's two bounding circles,
//      about the corner means of the row quad A and the enlarged column
//      quad B+ (B scaled by 1 + 1e-5 about its corner mean, so the 1 + 1e-5
//      widening is in B+'s own radius), cannot meet when the distance of
//      the means exceeds rA + rB+ + kMargin. Such a pair gets its "far"
//      value in the shared output tile at once; nothing else is computed.
//      (A second, separating-axis stage on the circle-near pairs halved
//      the pairs clipped on served candidates but made the kernel slower:
//      the cull loop, not the clip, holds most of its time);
//   2. compaction: the pairs that may meet are appended to a shared list
//      (a warp ballot, one shared atomic per warp, a prefix popcount), and
//      the block's warps then run the full clip over that list, so a warp
//      holds 32 near pairs and not 1 near pair among 31 far ones;
//   3. the tile store: the output tile leaves shared memory once, in
//      16-byte stores where the row pitch allows it.
//
// Why the far value is exact. If the circles are apart by more than
// kMargin, the polygons A and B+ are apart by more than kMargin less the
// rounding of the test (below 1e-4 m). For rectangles, every point at
// distance g from one lies at least g / sqrt(2) outside one of its edge
// lines, so every edge of A misses B+ (and every edge of B+ misses A) by
// that much on some clip plane, while the clip bounds' rounding moves a
// plane by at most a few ulp of |e| |p - c| / |e|: ~4e-5 m for coordinates
// within +-150 m (f32 ulp 1.5e-5 m at 150 m). So every clipped edge
// interval comes out empty, each Green integral is the literal 0.0f, their
// sum is +0, and the clamps keep +0: the plain versions give exactly the
// far value. A zero-size box (padding) has area 0, so both kernels' area
// clamp gives +0 there too, whatever its clips sum to. kMargin = 1e-3 m
// keeps the test an order of magnitude clear of that rounding; it is also
// far below any box the head decodes (dims >= 0.3 m).
//
// `ops/iou3d.py::pairs_may_meet` repeats the test in PyTorch with the same
// operations in the same order (built with -fmad=false), so the CPU tests
// pin that the plain versions give the far value wherever it says "cannot
// meet", and `chip_smoke.py` counts the near pairs its bound charges.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rpairs {

constexpr int kTileRows = 32;
constexpr int kTileCols = 128;
constexpr int kThreads = 256;
// Blocks an SM (__launch_bounds__): registers capped at 64, ~88 bytes of the
// clip spilled; on the H100 4 blocks ran ~18% faster than the 2 that 98
// registers allow, and ahead of 3 (80 registers).
constexpr int kMinBlocks = 4;
constexpr int kTilePairs = kTileRows * kTileCols;  // a multiple of kThreads
constexpr float kMargin = 1e-3f;   // m, see above
constexpr float kScale = 1.00001f;  // 1 + iou3d.py::_ENLARGE

static_assert(kTilePairs % kThreads == 0, "whole warps in the cull loop");
static_assert(kTilePairs <= 65536, "pair slots fit uint16");

// Corner mean ((q0 + q1) + q2) + q3, / 4 (exact: a power of two; the
// plain version's scalar divide is a multiply by 0.25 on the card).
__device__ __forceinline__ void corner_mean(const float (&q)[8], float& mx,
                                            float& my) {
  mx = (((q[0] + q[2]) + q[4]) + q[6]) / 4.0f;
  my = (((q[1] + q[3]) + q[5]) + q[7]) / 4.0f;
}

// B+ = B scaled by 1 + 1e-5 about its corner mean (iou3d.py::_scale_quad).
__device__ __forceinline__ void scale_quad(const float (&q)[8],
                                           float (&p)[8]) {
  float mx, my;
  corner_mean(q, mx, my);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    p[2 * k] = mx + (q[2 * k] - mx) * kScale;
    p[2 * k + 1] = my + (q[2 * k + 1] - my) * kScale;
  }
}

// Bounding circle about the corner mean: radius = sqrt of the largest
// squared corner distance (maximum taken left to right).
__device__ __forceinline__ void bounding_circle(const float (&q)[8],
                                                float& mx, float& my,
                                                float& r) {
  corner_mean(q, mx, my);
  float r2 = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float dx = q[2 * k] - mx;
    const float dy = q[2 * k + 1] - my;
    const float d2 = dx * dx + dy * dy;
    r2 = k == 0 ? d2 : fmaxf(r2, d2);
  }
  r = sqrtf(r2);
}

// The separation test: false only when the circles cannot meet (NaN
// coordinates take the full evaluation).
__device__ __forceinline__ bool may_meet(float ax, float ay, float ar,
                                         float bx, float by, float br) {
  const float dx = ax - bx;
  const float dy = ay - by;
  const float reach = (ar + br) + kMargin;
  return !(dx * dx + dy * dy > reach * reach);
}

// One box's staged values, structure of arrays (conflict-free when a warp
// reads consecutive boxes).
template <int N>
struct BoxTile {
  float q[8][N];  // corners x0 y0 x1 y1 ... (A for rows, B+ for columns)
  float mx[N], my[N], r[N];
  float area[N];
};

template <int N>
__device__ __forceinline__ void stage_box(BoxTile<N>& t, int slot,
                                          const float (&q)[8], float area) {
  float mx, my, r;
  bounding_circle(q, mx, my, r);
#pragma unroll
  for (int c = 0; c < 8; ++c) t.q[c][slot] = q[c];
  t.mx[slot] = mx;
  t.my[slot] = my;
  t.r[slot] = r;
  t.area[slot] = area;
}

template <int N>
__device__ __forceinline__ void load_quad(const BoxTile<N>& t, int slot,
                                          float (&q)[8]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) q[c] = t.q[c][slot];
}

template <int NR, int NC>
__device__ __forceinline__ bool tile_may_meet(const BoxTile<NR>& rows,
                                              const BoxTile<NC>& cols, int r,
                                              int c) {
  return may_meet(rows.mx[r], rows.my[r], rows.r[r], cols.mx[c], cols.my[c],
                  cols.r[c]);
}

// Pass 1 over the tile's pairs p = r * kTileCols + c. decide(r, c, v)
// returns true for a pair that needs the full evaluation; for any other
// pair it sets v, which goes straight into the output tile. The near
// pairs' slots are appended to `list`; `*count` (zeroed by the caller
// before a barrier) ends as their number once the block has synced.
template <class Decide>
__device__ __forceinline__ void cull_pairs(Decide decide, float* tile,
                                           uint16_t* list, int* count) {
  const int lane = threadIdx.x & 31;
  for (int p = threadIdx.x; p < kTilePairs; p += kThreads) {
    const int r = p / kTileCols;
    const int c = p % kTileCols;
    float v = 0.0f;
    const bool near = decide(r, c, v);
    if (!near) tile[p] = v;
    const unsigned ballot = __ballot_sync(0xffffffffu, near);
    int base = 0;
    if (lane == 0 && ballot != 0u) base = atomicAdd(count, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (near) list[base + __popc(ballot & ((1u << lane) - 1u))] = (uint16_t)p;
  }
}

// Pass 2: eval(r, c) for every listed pair, into its tile slot.
template <class Eval>
__device__ __forceinline__ void eval_listed(Eval eval, float* tile,
                                            const uint16_t* list, int count) {
  for (int n = threadIdx.x; n < count; n += kThreads) {
    const int p = list[n];
    tile[p] = eval(p / kTileCols, p % kTileCols);
  }
}

// The tile's rows [0, nrows) x columns [0, ncols) to out (row pitch ld
// floats): 16-byte stores when ld and out allow them (a vector that starts
// inside the row then ends inside it: ld % 4 == 0), else one float each.
__device__ __forceinline__ void store_tile(const float* tile, float* out,
                                           int64_t ld, int nrows, int ncols) {
  constexpr int kVecs = kTileCols / 4;
  const bool vec = (ld & 3) == 0 && ((uintptr_t)out & 15) == 0;
  for (int n = threadIdx.x; n < kTileRows * kVecs; n += kThreads) {
    const int r = n / kVecs;
    const int c = (n % kVecs) * 4;
    if (r >= nrows || c >= ncols) continue;
    const float4 v = *reinterpret_cast<const float4*>(tile + r * kTileCols + c);
    float* dst = out + (int64_t)r * ld + c;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      dst[0] = v.x;
      if (c + 1 < ncols) dst[1] = v.y;
      if (c + 2 < ncols) dst[2] = v.z;
      if (c + 3 < ncols) dst[3] = v.w;
    }
  }
}

// The same tile shape filled with `v` (K3's tiles below the diagonal).
__device__ __forceinline__ void fill_tile(float* out, int64_t ld, int nrows,
                                          int ncols, float v) {
  const float4 v4 = make_float4(v, v, v, v);
  constexpr int kVecs = kTileCols / 4;
  const bool vec = (ld & 3) == 0 && ((uintptr_t)out & 15) == 0;
  for (int n = threadIdx.x; n < kTileRows * kVecs; n += kThreads) {
    const int r = n / kVecs;
    const int c = (n % kVecs) * 4;
    if (r >= nrows || c >= ncols) continue;
    float* dst = out + (int64_t)r * ld + c;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = v4;
    } else {
      for (int k = 0; k < 4 && c + k < ncols; ++k) dst[k] = v;
    }
  }
}

// Block tile -> (t, row0, col0) for a 1-D grid over t-major, row tiles,
// column tiles (no grid-dimension limits beyond 2^31 - 1 tiles).
__device__ __forceinline__ void tile_origin(int64_t row_tiles,
                                            int64_t col_tiles, int64_t& t,
                                            int64_t& row0, int64_t& col0) {
  const int64_t b = blockIdx.x;
  const int64_t per_t = row_tiles * col_tiles;
  t = b / per_t;
  const int64_t rest = b - t * per_t;
  row0 = (rest / col_tiles) * kTileRows;
  col0 = (rest % col_tiles) * kTileCols;
}

}  // namespace rpairs
