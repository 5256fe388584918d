// Pairwise rotated-BEV intersection area of convex CCW quads, for Hopper
// (sm_90a).
//
// out[t, i, j] = area(A[t, i] ^ B[t, j]) for corner quads A (T, Ka, 4, 2) and
// B (T, Kb, 4, 2), f32. Same math, constants and operation order as the
// plain version pillarnet_lts_torch/ops/iou3d.py::_convex_intersection_area:
//
//   area = one_sided(A, B+) + one_sided(B+, A), clipped to
//          [0, min(shoelace(A), shoelace(B))],
//
// where one_sided(P, Q) sums the Green's-theorem integrals
// cross(v0, v1) / 2 of P's edges clipped to the inside of Q, and B+ is B
// scaled by 1 + 1e-5 about its corner mean (the boundary regularisation of
// iou3d.py::_ENLARGE: collinear shared edges are then counted once).
//
// Replaces the TPU kernel
// pillarnet_lts_tpu/ops/pallas/iou_kernel.py::convex_intersection_area_pallas,
// which computes every pair of its (8 x 128) tiles in full, in two
// pallas_calls (one per side). Built with -fmad=false (ops/_kernels.py):
// products of coordinates near 54 m round at ~2e-4 m^2, so FMA contraction
// alone moved areas by up to 3.7e-4 m^2 from the plain version; without it
// the two agree bit for bit.
//
// Design (rotated_pairs.cuh): a block owns 32 row quads x 128 column quads.
// Its prologue stages each row quad's corners, bounding circle and
// shoelace area, and each column quad's B+ corners, B+'s bounding circle
// and B's shoelace area, once. A pair whose circles cannot meet is written
// +0.0 (what the plain version returns there, bit for bit) with nothing
// else computed; the pairs that may meet are compacted into a shared list
// that the block's warps clip at full occupancy; the tile leaves shared
// memory in 16-byte stores.
//
// What bounds it on the card: the output. A near pair costs ~610 f32
// operations and 32 divides, a far pair ~9 for the test; on NMS candidates
// only a few percent of pairs are near (chip_smoke.py prints the share), so
// the 4 bytes a pair written once (24 MB at the flagship's 6 x 1000^2, ~7 us
// at 3.35 TB/s) are the floor.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rotated_pairs.cuh"

namespace {

using namespace rpairs;

constexpr float kEps = 1e-8f;  // iou_kernel.py::_EPS
constexpr float kBig = 1e9f;   // iou_kernel.py::_BIG

// Sum over P's 4 edges of the Green integral of the part inside convex Q.
__device__ __forceinline__ float one_sided(const float (&p)[8],
                                           const float (&q)[8]) {
  float total = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int en = (e + 1) & 3;
    const float px = p[2 * e], py = p[2 * e + 1];
    const float dx = p[2 * en] - px;
    const float dy = p[2 * en + 1] - py;
    float lower = -kBig;
    float upper = kBig;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int kn = (k + 1) & 3;
      const float cx = q[2 * k], cy = q[2 * k + 1];
      const float ex = q[2 * kn] - cx;
      const float ey = q[2 * kn + 1] - cy;
      const float relx = px - cx;
      const float rely = py - cy;
      const float alpha = ex * rely - ey * relx;
      const float beta = ex * dy - ey * dx;
      const bool parallel = fabsf(beta) < kEps;
      const float bound = -alpha / (parallel ? 1.0f : beta);
      // beta > 0: t >= bound; beta < 0: t <= bound; parallel: all t or none
      const float lo =
          parallel ? (alpha >= -kEps ? -kBig : kBig) : (beta > 0.0f ? bound : -kBig);
      const float up = parallel ? kBig : (beta > 0.0f ? kBig : bound);
      lower = fmaxf(lower, lo);
      upper = fminf(upper, up);
    }
    const float t0 = fmaxf(lower, 0.0f);
    const float t1 = fminf(upper, 1.0f);
    const float v0x = px + t0 * dx;
    const float v0y = py + t0 * dy;
    const float v1x = px + t1 * dx;
    const float v1y = py + t1 * dy;
    const float integ = 0.5f * (v0x * v1y - v0y * v1x);
    total = total + (t1 > t0 ? integ : 0.0f);
  }
  return total;
}

__device__ __forceinline__ float shoelace(const float (&q)[8]) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int kn = (k + 1) & 3;
    s = s + (q[2 * k] * q[2 * kn + 1] - q[2 * k + 1] * q[2 * kn]);
  }
  return 0.5f * fabsf(s);
}

__device__ __forceinline__ void load_box(const float* src, float (&q)[8]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) q[c] = src[c];
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
rotated_overlap_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ out,
                       int64_t ka, int64_t kb, int64_t row_tiles,
                       int64_t col_tiles) {
  __shared__ BoxTile<kTileRows> rows;   // A
  __shared__ BoxTile<kTileCols> cols;   // B+, with B's area
  __shared__ __align__(16) float tile[kTilePairs];
  __shared__ uint16_t list[kTilePairs];
  __shared__ int count;

  int64_t t, row0, col0;
  tile_origin(row_tiles, col_tiles, t, row0, col0);
  const int nrows = ka - row0 < kTileRows ? (int)(ka - row0) : kTileRows;
  const int ncols = kb - col0 < kTileCols ? (int)(kb - col0) : kTileCols;
  const int tid = threadIdx.x;

  if (tid == 0) count = 0;
  if (tid < kTileRows) {
    if (tid < nrows) {
      float q[8];
      load_box(a + (t * ka + row0 + tid) * 8, q);
      stage_box(rows, tid, q, shoelace(q));
    }
  } else if (tid < kTileRows + kTileCols) {
    const int slot = tid - kTileRows;
    if (slot < ncols) {
      float q[8], qp[8];
      load_box(b + (t * kb + col0 + slot) * 8, q);
      scale_quad(q, qp);
      stage_box(cols, slot, qp, shoelace(q));
    }
  }
  __syncthreads();

  // far pairs: every clipped interval empty, the plain version's +0.0
  cull_pairs(
      [&](int r, int c, float& v) {
        v = 0.0f;
        return r < nrows && c < ncols && tile_may_meet(rows, cols, r, c);
      },
      tile, list, &count);
  __syncthreads();

  eval_listed(
      [&](int r, int c) {
        float qa[8], qp[8];
        load_quad(rows, r, qa);
        load_quad(cols, c, qp);
        const float area = one_sided(qa, qp) + one_sided(qp, qa);
        const float cap = fminf(rows.area[r], cols.area[c]);
        return fminf(fmaxf(area, 0.0f), cap);
      },
      tile, list, count);
  __syncthreads();

  store_tile(tile, out + (t * ka + row0) * kb + col0, kb, nrows, ncols);
}

}  // namespace

// a (T, Ka, 4, 2), b (T, Kb, 4, 2), out (T, Ka, Kb): f32, contiguous. The
// grid is one block per 32 x 128 tile: T * ceil(Ka / 32) * ceil(Kb / 128)
// must stay below 2^31 (the wrapper checks). Returns the cudaError_t of
// the launch.
extern "C" int rotated_overlap_f32(const float* a, const float* b, float* out,
                                   int64_t t, int64_t ka, int64_t kb,
                                   void* stream) {
  if (t == 0 || ka == 0 || kb == 0) return 0;
  const int64_t row_tiles = (ka + kTileRows - 1) / kTileRows;
  const int64_t col_tiles = (kb + kTileCols - 1) / kTileCols;
  const int64_t blocks = t * row_tiles * col_tiles;
  if (blocks >= (int64_t(1) << 31)) return (int)cudaErrorInvalidConfiguration;
  rotated_overlap_kernel<<<(unsigned int)blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      a, b, out, ka, kb, row_tiles, col_tiles);
  return (int)cudaGetLastError();
}
