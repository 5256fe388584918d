// NMS suppression mask from rotated-BEV IoU, for Hopper (sm_90a).
//
// out[r, j, i] = (j < i) * (IoU_bev(j, i) > thresh[r]) as f32, for rows
// r < R of K score-sorted boxes each, given their corners A (R, K, 4, 2) and
// the corners of B+ (R, K, 4, 2): each box scaled by 1 + 1e-5 about its
// corner mean (pillarnet_lts_torch/ops/nms.py::mask_kernel_corners). The
// IoU is the TPU kernel's own formula, not rotated_iou_bev's:
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
// the TPU every (32 x 128) pair tile is computed whole and masked, and the
// eight clip passes run as a fori_loop whose edge operands are picked with
// one-hot selects (Mosaic's limits). Here one thread evaluates one pair in
// registers, and only pairs with j < i are computed: a block covers a
// 32 x 32 tile, tiles below the diagonal only write zeros, and on the
// diagonal tile the threads with j >= i write 0 without computing.
//
// What bounds it on the card: it is compute-bound. A pair costs about 600
// f32 operations and 32 divides (16 clip planes per direction); the Waymo
// grouped shape (3, 2048, 2048) has 6.3 M pairs above the diagonal, the
// output is 50 MB (15 us at 3.35 TB/s). The corners of the tile's 32 row
// boxes and 32 column boxes (and their areas) are staged once in shared
// memory; each thread then reads a row quad (a broadcast) and its own
// column quad (stride 9 floats, no bank conflicts).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;             // pairs per block: kTile x kTile
constexpr int kRowsPerPass = 8;       // threadIdx.y extent
constexpr float kEps = 1e-8f;         // nms_kernel.py::_EPS
constexpr float kBig = 1e9f;          // nms_kernel.py::_BIG
constexpr float kEnlargeSq = 1.0000200001f;  // (1 + 1e-5)^2

// Shoelace area without abs, summed left to right from 0
// (nms_kernel.py::_quad_area).
__device__ __forceinline__ float mask_area(const float* q) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int kn = (k + 1) & 3;
    s = s + (q[2 * k] * q[2 * kn + 1] - q[2 * k + 1] * q[2 * kn]);
  }
  return 0.5f * s;
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

__global__ void __launch_bounds__(kTile * kRowsPerPass)
suppression_mask_kernel(const float* __restrict__ ca,
                        const float* __restrict__ cb,
                        const float* __restrict__ thresh,
                        float* __restrict__ out, int k) {
  const int r = blockIdx.z;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  float* o = out + (int64_t)r * k * k;
  const int i = col0 + tx;

  if (row0 > col0) {  // below the diagonal: every pair has j > i
    for (int jj = ty; jj < kTile; jj += kRowsPerPass) {
      const int j = row0 + jj;
      if (j < k && i < k) o[(int64_t)j * k + i] = 0.0f;
    }
    return;
  }

  // 8 corner coordinates + area per box; stride 9 avoids bank conflicts
  __shared__ float rows[kTile][9];
  __shared__ float cols[kTile][9];
  const int tid = ty * kTile + tx;
  if (tid < 2 * kTile) {
    const bool is_row = tid < kTile;
    const int slot = is_row ? tid : tid - kTile;
    const int box = (is_row ? row0 : col0) + slot;
    float* dst = is_row ? rows[slot] : cols[slot];
    if (box < k) {
      const float* src = (is_row ? ca : cb) + ((int64_t)r * k + box) * 8;
#pragma unroll
      for (int c = 0; c < 8; ++c) dst[c] = src[c];
      const float area = mask_area(dst);
      dst[8] = is_row ? area : area / kEnlargeSq;
    }
  }
  __syncthreads();
  if (i >= k) return;

  const float th = thresh[r];
  float b[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) b[c] = cols[tx][c];
  const float area_b = cols[tx][8];
  for (int jj = ty; jj < kTile; jj += kRowsPerPass) {
    const int j = row0 + jj;
    if (j >= k) break;
    float m = 0.0f;
    if (j < i) {
      float a[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) a[c] = rows[jj][c];
      const float area_a = rows[jj][8];
      float inter = clip_edges(a, b, 0.0f);
      inter = clip_edges(b, a, inter);
      inter = fminf(fmaxf(inter, 0.0f), fminf(area_a, area_b));
      const float iou = inter / fmaxf((area_a + area_b) - inter, kEps);
      m = iou > th ? 1.0f : 0.0f;
    }
    o[(int64_t)j * k + i] = m;
  }
}

}  // namespace

// ca, cb (R, K, 4, 2) f32 corners of A and B+; thresh (R,) f32; out
// (R, K, K) f32. All contiguous; R <= 65535 and ceil(K / 32) <= 65535.
// Returns the cudaError_t of the launch.
extern "C" int suppression_mask_f32(const float* ca, const float* cb,
                                    const float* thresh, float* out,
                                    int64_t r, int64_t k, void* stream) {
  if (r == 0 || k == 0) return 0;
  const unsigned int tiles = (unsigned int)((k + kTile - 1) / kTile);
  dim3 grid(tiles, tiles, (unsigned int)r);
  dim3 block(kTile, kRowsPerPass);
  suppression_mask_kernel<<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      ca, cb, thresh, out, (int)k);
  return (int)cudaGetLastError();
}
