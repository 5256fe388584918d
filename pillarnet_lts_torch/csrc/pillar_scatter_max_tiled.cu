// Pillar scatter-max over points sorted by pillar, for Hopper (sm_90a).
//
// Per-pillar element-wise max of point features into a dense NHWC grid, 0 at
// empty pillars, plus a per-pillar occupancy byte: the contract of
// pillarnet_lts_torch/ops/voxelize.py::scatter_max_to_grid for f32, bf16 and
// int8 features, each reduced and written in its own dtype (a max of the
// inputs is exact in any of them).
//
// Replaces the TPU kernel
// pillarnet_lts_tpu/ops/pallas/voxelize_kernel.py::pillar_scatter_max_pallas
// (:78, body `_kernel`). That kernel takes points sorted by pillar id (an
// XLA argsort outside the kernel, voxelize_kernel.py:109-111), cuts the grid
// into row bands that fit VMEM and, per band, folds the band's points into
// the band with one VMEM row read-modify-write per point, so HBM sees one
// write per grid row. Hopper has no VMEM to hold a band and its blocks run
// in parallel, so ownership moves from bands to runs of equal ids:
//
//   * keys (scatter_max_sorted_keys_kernel): one thread per point writes
//     b*H*W + id for a kept point, B*H*W (past every pillar) for a dropped
//     one. Keys of different samples never meet, so the wrapper sorts all
//     B*N keys as one array (torch.sort, stable) and runs never cross
//     samples. This kernel, the sort and the passes below are one call.
//   * reduce (scatter_max_sorted_reduce_kernel): the sorted positions are
//     cut into segments of kSeg; a group of threads (one per 16 bytes of
//     the row: 8 for 32 f32 channels) starts at each run head and at each
//     segment boundary inside a run, gathers the points up to the run's or
//     the segment's end through the sort permutation (int64, read as
//     torch.sort returns it) and keeps the max in registers. A run that
//     ends in its head's segment (nearly all) is done: its max goes
//     straight to the pillar's grid row. A longer run's pieces go to
//     rows[position], and its head appends itself to a list of long runs.
//     Each run head marks its pillar in a map of B*H*W int32 (9.0 MB at
//     1504^2, memset to -1). Heads are unique, so the map needs no atomics
//     (the list takes one atomicAdd per long run).
//   * combine (scatter_max_sorted_combine_kernel): a group per long run
//     folds the run's pieces and writes the pillar's grid row.
//   * stream (pillar_grid.cuh): one pass over the B*H*W pillars writes
//     zeros over the empty pillars' rows and every occupancy byte.
//
// Every element of the grid is written by exactly one pass, in the
// features' dtype: no f32 copy, no cast pass. No atomics touch the grid, so
// the result does not depend on the schedule (deterministic).
//
// Why the walks are not in the stream: walking a run inside the pass that
// writes the grid stalls the store stream on each walk's chain of dependent
// loads (keys, permutation, row), and a run of n points became n serial
// gathers by one group of threads (a pillar holding a whole cloud took far
// longer than the plain version). Here a walk is at most kSeg points; a run
// of n points costs ceil(n / kSeg) segment walks in parallel plus a combine
// of that many pieces. Both loops keep kUnroll loads in flight. The max
// keeps the earlier of two equal values, so -0.0 and +0.0 may differ in
// sign from other routes (they compare equal).
//
// What bounds it on the card: bytes, nearly all of them the grid, written
// once at 3.35 TB/s. Byte budget at the Waymo shape (1 x 196,608 points x
// 32 f32 -> 1504^2 x 32): grid 289.6 MB, occupancy 2.3 MB, features 25.2 MB,
// ids and valid 1.0 MB, bound ~0.095 ms; the map (9.0 MB), the keys, sorted
// keys and permutation (~3.1 MB) and the pieces of long runs are scratch
// that should stay in L2. At the
// nuScenes shape (1 x 262,144 x 32 -> 1440^2): grid 265.4 MB, features
// 33.5 MB, map 8.3 MB. The sort (torch's radix sort of B*N int32 keys) is
// the one part that is not this file's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pillar_grid.cuh"

namespace {

using pillar_grid::kThreads;
using pillar_grid::load_words;
using pillar_grid::Words;

constexpr int64_t kSeg = 128;  // sorted positions per segment, a power of 2
constexpr int kUnroll = 4;     // loads in flight in a walk

struct SortedRuns {};  // names this kernel's streaming pass

// one thread per point: grid (ceil(n / kThreads), B)
__global__ void scatter_max_sorted_keys_kernel(
    const int32_t* __restrict__ ids, const uint8_t* __restrict__ valid,
    int32_t* __restrict__ keys, int64_t n, int64_t hw, int32_t dropped) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int64_t g = blockIdx.y * n + p;
  const int32_t id = ids[g];
  keys[g] = (valid[g] && id >= 0 && id < hw) ? (int32_t)(blockIdx.y * hw + id)
                                             : dropped;
}

// per-word max of the three dtypes
struct MaxF32 {
  __device__ __forceinline__ static uint32_t max(uint32_t m, uint32_t x) {
    return __uint_as_float(x) > __uint_as_float(m) ? x : m;
  }
};

struct MaxBF16x2 {
  __device__ __forceinline__ static uint32_t max(uint32_t m, uint32_t x) {
    const uint32_t lo = __uint_as_float(x << 16) > __uint_as_float(m << 16)
                            ? x : m;
    const uint32_t hi = __uint_as_float(x & 0xFFFF0000u) >
                                __uint_as_float(m & 0xFFFF0000u)
                            ? x : m;
    return (hi & 0xFFFF0000u) | (lo & 0x0000FFFFu);
  }
};

struct MaxS8x4 {
  __device__ __forceinline__ static uint32_t max(uint32_t m, uint32_t x) {
    return __vmaxs4(m, x);
  }
};

// m folded with the rows at positions q = first, first + stride, ... while
// q < end and keys[q] == key; row(q) is the row's address. Keys are sorted,
// so the positions in the run are a prefix of each batch of kUnroll: the
// walk ends with the first batch that is not all in.
template <int V, class Op, class RowAt>
__device__ __forceinline__ Words<V> walk_max(Words<V> m,
                                             const int32_t* __restrict__ keys,
                                             int32_t key, int64_t first,
                                             int64_t end, int64_t stride,
                                             const RowAt& row) {
  for (int64_t q = first;; q += kUnroll * stride) {
    bool in[kUnroll];
    const uint32_t* at[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t r = q + j * stride;
      in[j] = r < end && keys[r] == key;
      at[j] = in[j] ? row(r) : nullptr;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (in[j]) {
        const Words<V> x = load_words<V>(at[j]);
#pragma unroll
        for (int i = 0; i < V; ++i) m.w[i] = Op::max(m.w[i], x.w[i]);
      }
    }
    if (!in[kUnroll - 1]) return m;
  }
}

// a group of blockDim.x threads per sorted position, V words each: block
// (tx, ty), grid ceil(total / ty). `count` starts at all-ones, so the
// first long run takes list slot 0.
template <int V, class Op>
__global__ void __launch_bounds__(kThreads, 6)
    scatter_max_sorted_reduce_kernel(const uint32_t* __restrict__ feats,
                                     const int32_t* __restrict__ keys,
                                     const int64_t* __restrict__ perm,
                                     int32_t* __restrict__ heads,
                                     uint32_t* __restrict__ count,
                                     int32_t* __restrict__ list,
                                     uint32_t* __restrict__ rows,
                                     uint32_t* __restrict__ grid,
                                     int64_t total, int32_t dropped,
                                     int row_vecs) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (g >= total) return;
  const int32_t key = keys[g];
  if (key >= dropped) return;
  const bool run_head = g == 0 || keys[g - 1] != key;
  if (!run_head && (g & (kSeg - 1))) return;
  const int64_t end = (g | (kSeg - 1)) + 1;
  const bool whole = run_head && (end >= total || keys[end] != key);
  if (run_head && threadIdx.x == 0) {
    heads[key] = (int32_t)g;
    if (!whole) list[atomicAdd(count, 1u) + 1u] = (int32_t)g;
  }
  const int64_t rw = (int64_t)row_vecs * V;
  uint32_t* out = whole ? grid + key * rw : rows + g * rw;
  for (int v = threadIdx.x; v < row_vecs; v += blockDim.x) {
    const uint32_t* col = feats + v * V;
    const auto row = [=](int64_t q) { return col + perm[q] * rw; };
    const Words<V> m = walk_max<V, Op>(load_words<V>(row(g)), keys, key,
                                       g + 1, end < total ? end : total, 1,
                                       row);
    pillar_grid::store_words<V>(out + v * V, m);
  }
}

// a group per listed long run, striding over the list
template <int V, class Op>
__global__ void scatter_max_sorted_combine_kernel(
    const int32_t* __restrict__ keys, const uint32_t* __restrict__ count,
    const int32_t* __restrict__ list, const uint32_t* __restrict__ rows,
    uint32_t* __restrict__ grid, int64_t total, int row_vecs) {
  const int64_t n_long = (int64_t)(*count + 1u);
  const int64_t rw = (int64_t)row_vecs * V;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
       i < n_long; i += (int64_t)gridDim.x * blockDim.y) {
    const int64_t g = list[i];
    const int32_t key = keys[g];
    for (int v = threadIdx.x; v < row_vecs; v += blockDim.x) {
      const uint32_t* col = rows + v * V;
      const auto row = [=](int64_t q) { return col + q * rw; };
      const Words<V> m = walk_max<V, Op>(load_words<V>(row(g)), keys, key,
                                         (g | (kSeg - 1)) + 1, total, kSeg,
                                         row);
      pillar_grid::store_words<V>(grid + key * rw + v * V, m);
    }
  }
}

template <int V, class Op>
cudaError_t reduce(const uint32_t* feats, const int32_t* keys,
                   const int64_t* perm, int32_t* heads, int32_t* list,
                   uint32_t* rows, uint32_t* grid, int64_t pillars,
                   int64_t total, int rw, cudaStream_t s) {
  const int row_vecs = rw / V;
  const dim3 block = pillar_grid::row_block(row_vecs);
  uint32_t* count = reinterpret_cast<uint32_t*>(heads + pillars);
  scatter_max_sorted_reduce_kernel<V, Op>
      <<<(unsigned int)((total + block.y - 1) / block.y), block, 0, s>>>(
          feats, keys, perm, heads, count, list, rows, grid, total,
          (int32_t)pillars, row_vecs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // at most one long run per segment boundary
  const int64_t most = total / kSeg + 1;
  const int64_t blocks = (most + block.y - 1) / block.y;
  scatter_max_sorted_combine_kernel<V, Op>
      <<<(unsigned int)(blocks < 264 ? blocks : 264), block, 0, s>>>(
          keys, count, list, rows, grid, total, row_vecs);
  return cudaGetLastError();
}

template <class Op>
cudaError_t reduce_any(const uint32_t* feats, const int32_t* keys,
                       const int64_t* perm, int32_t* heads, int32_t* list,
                       uint32_t* rows, uint32_t* grid, int64_t pillars,
                       int64_t total, int rw, cudaStream_t s) {
  return pillar_grid::vec4_ok(rw, feats, rows, grid)
             ? reduce<4, Op>(feats, keys, perm, heads, list, rows, grid,
                             pillars, total, rw, s)
             : reduce<1, Op>(feats, keys, perm, heads, list, rows, grid,
                             pillars, total, rw, s);
}

}  // namespace

// ids (B, N) i32, valid (B, N) bytes -> keys (B, N) i32: b*hw + id for a
// kept point, B*hw for a dropped one (B*hw < 2^31). Returns the launch's
// cudaError_t.
extern "C" int pillar_scatter_max_sorted_keys(const int32_t* ids,
                                              const uint8_t* valid,
                                              int32_t* keys, int64_t b,
                                              int64_t n, int64_t hw,
                                              void* stream) {
  if (b * n == 0) return 0;
  scatter_max_sorted_keys_kernel<<<
      dim3((unsigned int)((n + kThreads - 1) / kThreads), (unsigned int)b),
      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ids, valid, keys, n, hw, (int32_t)(b * hw));
  return (int)cudaGetLastError();
}

// feats (B, N) rows of rw 32-bit words in the points' original order, 4-byte
// aligned: f32 (elem = 0), bf16 pairs (1) or int8 quads (2). keys (B*N) the
// sorted keys, perm (B*N) int64 the sort permutation (sorted position ->
// original point, over the flattened B*N). Scratch, any contents: heads
// (B*H*W + 1) int32 (the map, then the long-run count), list (B*N / 128 +
// 1) int32 and rows (B*N*rw) 32-bit words, 16-byte aligned. Writes every
// element of grid (B, H*W, rw words) in the features' dtype and of occ
// (B, H*W) bytes; neither needs initialising. Returns the first non-zero
// cudaError_t.
extern "C" int pillar_scatter_max_sorted(const void* feats,
                                         const int32_t* keys,
                                         const int64_t* perm, int32_t* heads,
                                         int32_t* list, void* rows,
                                         void* grid, uint8_t* occ, int64_t b,
                                         int64_t n, int64_t rw, int64_t hw,
                                         int elem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t pillars = b * hw, total = b * n;
  cudaError_t err =
      cudaMemsetAsync(heads, 0xFF, (pillars + 1) * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  if (total > 0) {
    const uint32_t* f = static_cast<const uint32_t*>(feats);
    uint32_t* r = static_cast<uint32_t*>(rows);
    uint32_t* g = static_cast<uint32_t*>(grid);
    const int w = (int)rw;
    switch (elem) {
      case 0:
        err = reduce_any<MaxF32>(f, keys, perm, heads, list, r, g, pillars,
                                 total, w, s);
        break;
      case 1:
        err = reduce_any<MaxBF16x2>(f, keys, perm, heads, list, r, g,
                                    pillars, total, w, s);
        break;
      case 2:
        err = reduce_any<MaxS8x4>(f, keys, perm, heads, list, r, g, pillars,
                                  total, w, s);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)pillar_grid::fill_empty<SortedRuns>(heads, grid, occ, pillars,
                                                 (int)rw, s);
}
