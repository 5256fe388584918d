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
// pillarnet_lts_tpu/ops/pallas/iou_kernel.py::convex_intersection_area_pallas.
// That kernel works on (8 x 128) pair tiles and needs two pallas_calls (one
// per side) only because of the Mosaic compiler; here one thread evaluates
// one (t, i, j) pair, both sides, in registers, and the ragged edge is
// masked in the kernel rather than padded. It is built with -fmad=false
// (ops/_kernels.py): products of coordinates near 54 m round at ~2e-4 m^2,
// so FMA contraction alone moved areas by up to 3.7e-4 m^2 from the plain
// version; without it the two agree bit for bit.
//
// What bounds it on the card: it is compute-bound. A pair costs about 600
// flops and 32 divides (16 clip planes per side) on 64 bytes of corners; the
// flagship's NMS runs 6 tasks x 1000 x 1000 = 6 M pairs per frame, and the
// output is 24 MB. A block covers one row quad i and 128 column quads j, so
// the row quad is a broadcast load and the column quads are read coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kEps = 1e-8f;      // iou_kernel.py::_EPS
constexpr float kBig = 1e9f;       // iou_kernel.py::_BIG
constexpr float kScale = 1.00001f; // 1 + iou3d.py::_ENLARGE

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

__global__ void rotated_overlap_kernel(const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       float* __restrict__ out, int64_t ka,
                                       int64_t kb) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= kb) return;
  const int64_t i = blockIdx.y;
  const int64_t t = blockIdx.z;

  float qa[8], qb[8], qp[8];
  const float* pa = a + (t * ka + i) * 8;
  const float* pb = b + (t * kb + j) * 8;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    qa[k] = pa[k];
    qb[k] = pb[k];
  }
  // B+ = B scaled about its corner mean (iou3d.py::_scale_quad)
  const float mx = (((qb[0] + qb[2]) + qb[4]) + qb[6]) / 4.0f;
  const float my = (((qb[1] + qb[3]) + qb[5]) + qb[7]) / 4.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    qp[2 * k] = mx + (qb[2 * k] - mx) * kScale;
    qp[2 * k + 1] = my + (qb[2 * k + 1] - my) * kScale;
  }
  const float area = one_sided(qa, qp) + one_sided(qp, qa);
  const float cap = fminf(shoelace(qa), shoelace(qb));
  out[(t * ka + i) * kb + j] = fminf(fmaxf(area, 0.0f), cap);
}

}  // namespace

// a (T, Ka, 4, 2), b (T, Kb, 4, 2), out (T, Ka, Kb): f32, contiguous.
// Ka and T must each be at most 65535 (grid y and z). Returns the
// cudaError_t of the launch.
extern "C" int rotated_overlap_f32(const float* a, const float* b, float* out,
                                   int64_t t, int64_t ka, int64_t kb,
                                   void* stream) {
  if (t == 0 || ka == 0 || kb == 0) return 0;
  dim3 grid((unsigned int)((kb + kThreads - 1) / kThreads), (unsigned int)ka,
            (unsigned int)t);
  rotated_overlap_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, ka, kb);
  return (int)cudaGetLastError();
}
