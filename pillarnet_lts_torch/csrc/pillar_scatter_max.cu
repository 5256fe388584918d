// Pillar scatter-max for Hopper (sm_90a).
//
// Per-pillar element-wise max of point features into a dense NHWC grid, 0 at
// empty pillars, plus a per-pillar occupancy byte. Same contract as
// pillarnet_lts_torch/ops/voxelize.py::scatter_max_to_grid: feats (B, N, C)
// f32, or the int8 deploy's codes; a point is dropped when it is not valid
// or its id lies outside [0, H*W).
//
// Replaces the TPU kernel
// pillarnet_lts_tpu/ops/pallas/voxelize_kernel.py::pillar_scatter_max_mxu
// (:411). The TPU has no scatter atomics, so that kernel sorts the points by
// pillar and folds them into the grid with one-hot matmuls on the MXU.
// Hopper has 32-bit atomics in L2, so the reduction uses them; what the
// design has to get right is the grid, not the reduction.
//
// What bounds it on the card: bytes, and nearly all of them are the grid,
// written once at 3.35 TB/s. Byte budget at the flagship shape (1 x 262,144
// points x 32 channels into 1440 x 1440): grid 265.4 MB f32 (66.4 MB int8
// codes), occupancy 2.1 MB, features 33.5 MB f32 (8.4 MB int8), ids and
// valid 1.3 MB; the bound is ~0.090 ms f32, ~0.023 ms int8. Only ~8% of the
// grid's rows are occupied (~20 MB f32), so a zero fill of the grid before
// the scatter, or a decode pass over it after, costs more than the scatter.
// Here every element of the grid is written by exactly one pass, and the
// occupied rows are reduced where they lie:
//
//   1. claim: an int32 map of B*H*W entries (8.3 MB at 1440^2), memset to
//      all-ones (free). Each kept point tries to claim its pillar with an
//      atomicCAS of its point index b*N + n; the one point that wins copies
//      its own row into the pillar's grid row, the start of the pillar's
//      max. Which point wins depends on the schedule; the max does not.
//   2. merge: every other kept point merges its row into the pillar's grid
//      row. f32: an atomicMax on the bits as int for a value with the sign
//      bit clear, an atomicMin on the bits as unsigned for one with it set.
//      Over non-NaN floats that is the float max (negative floats order
//      backwards as unsigned, below every non-negative one as int), on the
//      floats' own bits: no encoding, so no decode pass, one path for signed
//      and nonneg features, exact and independent of the order of the
//      atomics. int8 codes: a compare-and-swap on the per-byte signed max of
//      4-code words (__vmaxs4; there is no 8-bit atomicMax). At the
//      flagship shape ~100 k of 262 k points issue atomics, into the ~20 MB
//      of occupied rows.
//   3. stream (pillar_grid.cuh): one pass over the B*H*W pillars writes
//      zeros over the empty pillars' rows and every occupancy byte, with
//      16-byte streaming stores.
//
// The output is deterministic. Passes 1 and 2 give each point a group of
// threads, one per 16 bytes of its row (C = 32 f32: 8 threads, a warp
// covers 4 points), and index from a 2-D grid (points by blockIdx.x and
// threadIdx.y, the row by threadIdx.x, the sample by blockIdx.y), so there
// is no 64-bit division per element; offsets are 64-bit (B*H*W*C reaches
// 5.3e8 at batch 8). The caller allocates the map as scratch; B*N must stay
// below 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pillar_grid.cuh"

namespace {

using pillar_grid::load_words;
using pillar_grid::Words;

constexpr uint32_t kFree = 0xFFFFFFFFu;  // an unclaimed pillar in the map

struct ClaimedPillars {};  // names this kernel's streaming pass

// The pillar of point g = b*n + p, or -1 when the point is dropped.
__device__ __forceinline__ int64_t pillar_of(const int32_t* __restrict__ ids,
                                             const uint8_t* __restrict__ valid,
                                             int64_t g, int64_t b,
                                             int64_t hw) {
  const int32_t id = ids[g];
  if (!valid[g] || id < 0 || id >= hw) return -1;
  return b * hw + id;
}

// 1. a group of blockDim.x threads per point (a power of 2, so the group
// shares a warp), V words each: block (tx, ty), grid (ceil(n / ty), B). The
// group's first thread claims, the warp shares the outcome, a winner's
// group copies its row.
template <int V>
__global__ void scatter_max_claim_kernel(const uint32_t* __restrict__ feats,
                                         const int32_t* __restrict__ ids,
                                         const uint8_t* __restrict__ valid,
                                         uint32_t* __restrict__ heads,
                                         uint32_t* __restrict__ grid,
                                         int64_t n, int64_t hw,
                                         int row_vecs) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  const int64_t g = blockIdx.y * n + p;
  const int64_t pillar =
      p < n ? pillar_of(ids, valid, g, blockIdx.y, hw) : -1;
  int won = 0;
  if (threadIdx.x == 0 && pillar >= 0) {
    won = atomicCAS(heads + pillar, kFree, (uint32_t)g) == kFree;
  }
  if (!__shfl_sync(0xFFFFFFFFu, won, 0, blockDim.x)) return;
  const int64_t rw = (int64_t)row_vecs * V;
  for (int v = threadIdx.x; v < row_vecs; v += blockDim.x) {
    pillar_grid::store_words<V>(grid + pillar * rw + v * V,
                                load_words<V>(feats + g * rw + v * V));
  }
}

// 2. the same layout as 1.
template <int V, bool kCodes>
__global__ void scatter_max_merge_kernel(const uint32_t* __restrict__ feats,
                                         const int32_t* __restrict__ ids,
                                         const uint8_t* __restrict__ valid,
                                         const uint32_t* __restrict__ heads,
                                         uint32_t* __restrict__ grid,
                                         int64_t n, int64_t hw,
                                         int row_vecs) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (p >= n) return;
  const int64_t g = blockIdx.y * n + p;
  const int64_t pillar = pillar_of(ids, valid, g, blockIdx.y, hw);
  if (pillar < 0 || heads[pillar] == (uint32_t)g) return;
  const int64_t rw = (int64_t)row_vecs * V;
  for (int v = threadIdx.x; v < row_vecs; v += blockDim.x) {
    const Words<V> x = load_words<V>(feats + g * rw + v * V);
    uint32_t* d = grid + pillar * rw + v * V;
    Words<V> cur;  // codes: the row as it stands, one load for V words
    if (kCodes) cur = load_words<V>(d);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const uint32_t mine = x.w[i];
      if (!kCodes) {
        if (mine & 0x80000000u) {
          atomicMin(d + i, mine);
        } else {
          atomicMax(reinterpret_cast<int*>(d + i), (int)mine);
        }
        continue;
      }
      uint32_t old = cur.w[i];
      while (true) {
        const uint32_t merged = __vmaxs4(old, mine);
        if (merged == old) break;
        const uint32_t seen = atomicCAS(d + i, old, merged);
        if (seen == old) break;
        old = seen;
      }
    }
  }
}

template <int V, bool kCodes>
cudaError_t run(const uint32_t* feats, const int32_t* ids,
                const uint8_t* valid, uint32_t* heads, uint32_t* grid,
                uint8_t* occ, int64_t b, int64_t n, int rw, int64_t hw,
                cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(heads, 0xFF, b * hw * sizeof(uint32_t), s);
  if (err != cudaSuccess) return err;
  const int row_vecs = rw / V;
  if (b * n > 0) {
    const dim3 block = pillar_grid::row_block(row_vecs);
    const dim3 blocks((unsigned int)((n + block.y - 1) / block.y),
                      (unsigned int)b);
    scatter_max_claim_kernel<V><<<blocks, block, 0, s>>>(
        feats, ids, valid, heads, grid, n, hw, row_vecs);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scatter_max_merge_kernel<V, kCodes><<<blocks, block, 0, s>>>(
        feats, ids, valid, heads, grid, n, hw, row_vecs);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return pillar_grid::fill_empty<ClaimedPillars>(
      reinterpret_cast<const int32_t*>(heads), grid, occ, b * hw, rw, s);
}

template <bool kCodes>
cudaError_t run_any(const uint32_t* feats, const int32_t* ids,
                    const uint8_t* valid, uint32_t* heads, uint32_t* grid,
                    uint8_t* occ, int64_t b, int64_t n, int rw, int64_t hw,
                    cudaStream_t s) {
  return pillar_grid::vec4_ok(rw, feats, grid, grid)
             ? run<4, kCodes>(feats, ids, valid, heads, grid, occ, b, n, rw,
                              hw, s)
             : run<1, kCodes>(feats, ids, valid, heads, grid, occ, b, n, rw,
                              hw, s);
}

}  // namespace

// feats (B, N, C): f32 (codes = 0) or int8 codes in [0, 127] with C % 4 == 0
// (codes = 1); ids (B, N) i32; valid (B, N) bytes; all contiguous. Scratch:
// heads (B*H*W) 32-bit, any contents. Writes every element of grid (B, H*W,
// C) in the features' dtype and of occ (B, H*W) bytes; neither needs
// initialising. Returns the first non-zero cudaError_t.
extern "C" int pillar_scatter_max(const void* feats, const int32_t* ids,
                                  const uint8_t* valid, void* heads,
                                  void* grid, uint8_t* occ, int64_t b,
                                  int64_t n, int64_t c_dim, int64_t hw,
                                  int codes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rw = (int)(codes ? c_dim / 4 : c_dim);
  const uint32_t* f = static_cast<const uint32_t*>(feats);
  uint32_t* h = static_cast<uint32_t*>(heads);
  uint32_t* g = static_cast<uint32_t*>(grid);
  return (int)(codes ? run_any<true>(f, ids, valid, h, g, occ, b, n, rw, hw,
                                     s)
                     : run_any<false>(f, ids, valid, h, g, occ, b, n, rw, hw,
                                      s));
}
