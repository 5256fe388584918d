// NMS suppression mask from rotated-BEV IoU, for Hopper (sm_90a).
//
// out[r, j, i] = (j < i) * (IoU_bev(j, i) > thresh[r]) as f32, for rows
// r < R of K score-sorted det3d boxes (R, K, D >= 7) each. The kernel makes
// each box's corners itself, in the order of operations of
// pillarnet_lts_torch/ops/nms.py::mask_kernel_corners on the card: the
// det3d -> pcdet swap (x, y, l, w, -yaw - pi/2), cosf/sinf, the corners
// ((lx cos - ly sin) + x, (lx sin + ly cos) + y), and B+ = the corners
// scaled by 1 + 1e-5 about their mean. The IoU is the TPU kernel's own
// formula, not rotated_iou_bev's:
//
//   inter = one running sum of the Green integrals of A's edges clipped to
//           B+, then of B+'s edges clipped to A (edge by edge);
//   area_a = shoelace(A), area_b = shoelace(B+) / (1 + 1e-5)^2 (no abs);
//   inter clipped to [0, min(area_a, area_b)];
//   IoU = inter / max(area_a + area_b - inter, 1e-8).
//
// Same constants and order of operations as the plain version
// ops/nms.py::_suppression_matrix_plain; built with -fmad=false
// (ops/_kernels.py) so that no product is contracted into an FMA and the
// two masks agree bit for bit.
//
// Replaces the TPU kernel
// pillarnet_lts_tpu/ops/pallas/nms_kernel.py::suppression_matrix_pallas. On
// the TPU every (32 x 128) pair tile is computed whole and masked, the
// corners are made by XLA outside the kernel, and the eight clip passes run
// as a fori_loop whose edge operands are picked with one-hot selects
// (Mosaic's limits).
//
// Design (rotated_pairs.cuh, shared with rotated_overlap.cu): a block owns
// 32 rows j x 128 columns i. A tile wholly below the diagonal (every
// j >= i) is stored as zeros with 16-byte stores and stages nothing. Any
// other tile stages its row boxes' A corners, circle and area and its
// column boxes' B+ corners, circle and area, computed once from the boxes.
// A pair with j >= i is 0; a pair whose circles cannot meet gets what the
// plain version computes from an intersection of +0 (IoU +0 > thresh, so
// 0 for thresh >= 0); the rest are compacted and clipped at full warps;
// the tile leaves shared memory in 16-byte stores.
//
// What bounds it on the card: the output. A near pair above the diagonal
// costs ~575 f32 operations and 32 divides, a far one ~9 for the test; the
// Waymo grouped shape (3, 2048, 2048) writes 50 MB (15 us at 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rotated_pairs.cuh"

namespace {

using namespace rpairs;

constexpr float kEps = 1e-8f;                // nms_kernel.py::_EPS
constexpr float kBig = 1e9f;                 // nms_kernel.py::_BIG
constexpr float kEnlargeSq = 1.0000200001f;  // (1 + 1e-5)^2
constexpr float kHalfPi = 1.57079632679489662f;  // f32(math.pi / 2)

// Shoelace area without abs, summed left to right from 0
// (nms_kernel.py::_quad_area).
__device__ __forceinline__ float mask_area(const float (&q)[8]) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int kn = (k + 1) & 3;
    s = s + (q[2 * k] * q[2 * kn + 1] - q[2 * k + 1] * q[2 * kn]);
  }
  return 0.5f * s;
}

// Corners (CCW) of det3d box `b` (x, y, z, w, l, h, ..., yaw at d - 1):
// iou3d.py::box_corners_bev(to_pcdet_bev(b)), operation by operation.
__device__ __forceinline__ void box_corners(const float* b, int d,
                                            float (&q)[8]) {
  const float x = b[0], y = b[1];
  const float dx = b[4], dy = b[3];  // pcdet (dx, dy) = det3d (l, w)
  const float heading = -b[d - 1] - kHalfPi;
  const float c = cosf(heading);
  const float s = sinf(heading);
  const float hx = dx * 0.5f, hy = dy * 0.5f;
  const float lx[4] = {hx, -hx, -hx, hx};
  const float ly[4] = {hy, hy, -hy, -hy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q[2 * k] = (lx[k] * c - ly[k] * s) + x;
    q[2 * k + 1] = (lx[k] * s + ly[k] * c) + y;
  }
}

// total += the Green integrals of P's 4 edges clipped to the inside of
// convex CCW Q, edge by edge (nms_kernel.py::_suppress_kernel_loop body).
__device__ __forceinline__ float clip_edges(const float (&p)[8],
                                            const float (&q)[8],
                                            float total) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int en = (e + 1) & 3;
    const float px = p[2 * e], py = p[2 * e + 1];
    const float dx = p[2 * en] - px;
    const float dy = p[2 * en + 1] - py;
    float t0 = 0.0f, t1 = 1.0f;
    bool empty = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cn = (c + 1) & 3;
      const float c0x = q[2 * c], c0y = q[2 * c + 1];
      const float ex = q[2 * cn] - c0x;
      const float ey = q[2 * cn + 1] - c0y;
      const float alpha = ex * (py - c0y) - ey * (px - c0x);
      const float beta = ex * dy - ey * dx;
      const bool par = fabsf(beta) < kEps;
      const float bound = -alpha / (par ? 1.0f : beta);
      const bool is_lower = beta > 0.0f;
      const float lo = (par || !is_lower) ? -kBig : bound;
      const float hi = (par || is_lower) ? kBig : bound;
      t0 = fmaxf(t0, lo);
      t1 = fminf(t1, hi);
      empty = empty || (par && alpha < -kEps);
    }
    const bool keep = (t1 > t0) && !empty;
    const float v0x = px + t0 * dx;
    const float v0y = py + t0 * dy;
    const float v1x = px + t1 * dx;
    const float v1y = py + t1 * dy;
    total = total + (keep ? 0.5f * (v0x * v1y - v0y * v1x) : 0.0f);
  }
  return total;
}

// The mask bit from an intersection sum, in the plain version's order.
__device__ __forceinline__ float mask_bit(float inter, float area_a,
                                          float area_b, float th) {
  inter = fminf(fmaxf(inter, 0.0f), fminf(area_a, area_b));
  const float iou = inter / fmaxf((area_a + area_b) - inter, kEps);
  return iou > th ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
suppression_mask_kernel(const float* __restrict__ boxes, int d,
                        const float* __restrict__ thresh, float thresh_value,
                        float* __restrict__ out, int64_t k,
                        int64_t row_tiles, int64_t col_tiles) {
  __shared__ BoxTile<kTileRows> rows;   // A of boxes j
  __shared__ BoxTile<kTileCols> cols;   // B+ of boxes i
  __shared__ __align__(16) float tile[kTilePairs];
  __shared__ uint16_t list[kTilePairs];
  __shared__ int count;

  int64_t r, row0, col0;
  tile_origin(row_tiles, col_tiles, r, row0, col0);
  const int nrows = k - row0 < kTileRows ? (int)(k - row0) : kTileRows;
  const int ncols = k - col0 < kTileCols ? (int)(k - col0) : kTileCols;
  float* o = out + (r * k + row0) * k + col0;

  // below the diagonal: every pair has j >= i
  if (row0 >= col0 + ncols - 1) {
    fill_tile(o, k, nrows, ncols, 0.0f);
    return;
  }

  const int tid = threadIdx.x;
  const float* rb = boxes + r * k * d;
  if (tid == 0) count = 0;
  if (tid < kTileRows) {
    if (tid < nrows) {
      float q[8];
      box_corners(rb + (row0 + tid) * d, d, q);
      stage_box(rows, tid, q, mask_area(q));
    }
  } else if (tid < kTileRows + kTileCols) {
    const int slot = tid - kTileRows;
    if (slot < ncols) {
      float q[8], qp[8];
      box_corners(rb + (col0 + slot) * d, d, q);
      scale_quad(q, qp);
      stage_box(cols, slot, qp, mask_area(qp) / kEnlargeSq);
    }
  }
  __syncthreads();

  const float th = thresh != nullptr ? thresh[r] : thresh_value;
  cull_pairs(
      [&](int jj, int ii, float& v) {
        v = 0.0f;
        if (jj >= nrows || ii >= ncols || row0 + jj >= col0 + ii) return false;
        if (tile_may_meet(rows, cols, jj, ii)) return true;
        // far: every clipped interval empty, so the plain sum is +0
        v = mask_bit(0.0f, rows.area[jj], cols.area[ii], th);
        return false;
      },
      tile, list, &count);
  __syncthreads();

  eval_listed(
      [&](int jj, int ii) {
        float a[8], b[8];
        load_quad(rows, jj, a);
        load_quad(cols, ii, b);
        float inter = clip_edges(a, b, 0.0f);
        inter = clip_edges(b, a, inter);
        return mask_bit(inter, rows.area[jj], cols.area[ii], th);
      },
      tile, list, count);
  __syncthreads();

  store_tile(tile, o, k, nrows, ncols);
}

// The staged corners of every box, for checking them against
// mask_kernel_corners: A and B+, (N, 4, 2) each.
__global__ void mask_corners_kernel(const float* __restrict__ boxes, int d,
                                    float* __restrict__ ca,
                                    float* __restrict__ cb, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float q[8], qp[8];
  box_corners(boxes + i * d, d, q);
  scale_quad(q, qp);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    ca[i * 8 + c] = q[c];
    cb[i * 8 + c] = qp[c];
  }
}

}  // namespace

// boxes (N, D) f32 det3d boxes -> ca, cb (N, 4, 2): the corners the mask
// kernel makes (A, B+). Returns the cudaError_t of the launch.
extern "C" int suppression_mask_corners_f32(const float* boxes, float* ca,
                                            float* cb, int64_t n, int64_t d,
                                            void* stream) {
  if (n == 0) return 0;
  if (d < 7) return (int)cudaErrorInvalidConfiguration;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  mask_corners_kernel<<<(unsigned int)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(boxes, (int)d, ca,
                                                             cb, n);
  return (int)cudaGetLastError();
}

// boxes (R, K, D) f32 det3d boxes (D >= 7, yaw last); thresh (R,) f32, or
// null for one threshold `thresh_value` on every row; out (R, K, K) f32.
// All contiguous; R * ceil(K / 32) * ceil(K / 128) below 2^31. Returns the
// cudaError_t of the launch.
extern "C" int suppression_mask_f32(const float* boxes, const float* thresh,
                                    float thresh_value, float* out, int64_t r,
                                    int64_t k, int64_t d, void* stream) {
  if (r == 0 || k == 0) return 0;
  const int64_t row_tiles = (k + kTileRows - 1) / kTileRows;
  const int64_t col_tiles = (k + kTileCols - 1) / kTileCols;
  const int64_t blocks = r * row_tiles * col_tiles;
  if (blocks >= (int64_t(1) << 31) || d < 7)
    return (int)cudaErrorInvalidConfiguration;
  suppression_mask_kernel<<<(unsigned int)blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      boxes, (int)d, thresh, thresh_value, out, k, row_tiles, col_tiles);
  return (int)cudaGetLastError();
}
