// Pillar scatter-max over points sorted by pillar, for Hopper (sm_90a).
//
// Per-pillar element-wise max of point features into a dense NHWC grid, 0 at
// empty pillars, plus a per-pillar occupancy byte: the contract of
// pillarnet_lts_torch/ops/voxelize.py::scatter_max_to_grid in f32.
//
// Replaces the TPU kernel
// pillarnet_lts_tpu/ops/pallas/voxelize_kernel.py::pillar_scatter_max_pallas
// (body `_kernel`). That kernel takes points sorted by pillar id (an XLA
// sort outside the kernel), cuts the grid into row bands that fit VMEM and,
// per band, folds the band's slice of points into the band with one VMEM
// row read-modify-write per point, so HBM sees one write per grid row.
// Hopper has no VMEM to hold a band, and its blocks run in parallel, so the
// same idea becomes ownership of runs instead of bands:
//
//   * the wrapper sorts the pillar ids (torch.sort, stable; dropped points
//     carry id H*W and sort last) and zero-fills the grid and occupancy;
//   * one thread per (sorted point, channel), channel fastest: with C = 32
//     a warp is one point. The thread of a run's first point (the segment
//     head) owns the run: it reduces the run's points for its channel in
//     registers, reading each point's row through the sort permutation, and
//     writes the grid cell once. Every other thread returns after two
//     loads. No atomics, so the result does not depend on the schedule
//     (deterministic); the max keeps the earlier of two equal values, so
//     -0.0 and +0.0 may differ in sign from other routes (they compare
//     equal).
//
// Long runs serialize on their owner: a run of n points is n dependent
// iterations of one warp. Synthetic clouds put tens of points in the
// densest pillars near the sensor; that bound is not addressed here.
//
// What bounds it on the card: bytes. At the Waymo shape (1 x 196,608 points
// x 32 f32 -> 1504^2 x 32) the grid is 290 MB, which the wrapper's zero fill
// writes once (~87 us at 3.35 TB/s); the kernel itself reads 25 MB of
// features plus 1.6 MB of sorted ids and permutation and writes only the
// occupied rows (a few percent of the grid). The sort is a second launch
// sequence (torch.sort's radix sort) of ~1.6 MB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_max_sorted_kernel(
    const float* __restrict__ feats, const int32_t* __restrict__ sorted_ids,
    const int32_t* __restrict__ order, float* __restrict__ grid,
    uint8_t* __restrict__ occ, int64_t n, int64_t c_dim, int64_t hw,
    int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t bp = t / c_dim;  // sorted point index over B*N
  const int64_t c = t - bp * c_dim;
  const int64_t b = bp / n;
  const int64_t p = bp - b * n;
  const int32_t* ids = sorted_ids + b * n;
  const int32_t id = ids[p];
  if (id >= hw) return;                      // dropped points sort last
  if (p > 0 && ids[p - 1] == id) return;     // not the head of its run
  const int32_t* ord = order + b * n;
  const float* f = feats + b * n * c_dim + c;
  float m = f[(int64_t)ord[p] * c_dim];
  for (int64_t q = p + 1; q < n && ids[q] == id; ++q) {
    const float v = f[(int64_t)ord[q] * c_dim];
    m = v > m ? v : m;
  }
  const int64_t pillar = b * hw + id;
  grid[pillar * c_dim + c] = m;
  if (c == 0) occ[pillar] = 1;
}

}  // namespace

// feats (B, N, C) f32 in the points' original order; sorted_ids (B, N) i32,
// ascending per sample, H*W for dropped points; order (B, N) i32, the sort
// permutation (sorted position -> original point). grid (B, H*W, C) f32 and
// occ (B, H*W) bytes, zero-filled by the caller. All contiguous. Returns the
// cudaError_t of the launch.
extern "C" int pillar_scatter_max_sorted_f32(
    const float* feats, const int32_t* sorted_ids, const int32_t* order,
    float* grid, uint8_t* occ, int64_t b, int64_t n, int64_t c_dim,
    int64_t hw, void* stream) {
  const int64_t total = b * n * c_dim;
  if (total == 0) return 0;
  const unsigned int blocks =
      (unsigned int)((total + kThreads - 1) / kThreads);
  scatter_max_sorted_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      feats, sorted_ids, order, grid, occ, n, c_dim, hw, total);
  return (int)cudaGetLastError();
}
