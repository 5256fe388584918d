// What the two pillar scatter-max kernels share (pillar_scatter_max.cu, K1,
// and pillar_scatter_max_tiled.cu, K1'): 16-byte row access, the block
// shape of their row passes, and the streaming pass that completes the
// grid.
//
// Both kernels write each occupied pillar's row of the (B, H*W, C) grid
// themselves, where they reduce it, and leave for every pillar one int32
// in a map: kEmpty (-1) for an empty pillar, anything else for an occupied
// one. The streaming pass then visits every pillar once: it writes zeros
// over the rows of the empty pillars and the occupancy byte of every
// pillar. So each element of the grid is written by exactly one of the
// kernel's passes, the grid (265 MB at 1 x 1440^2 x 32 f32) needs no zero
// fill, and the caller allocates it with torch.empty. Only ~8% of the
// flagship grid's rows are occupied, so this pass carries nearly all of
// the call's bytes.
//
//   * block (tx, ty): tx threads share one pillar's row, ty pillars side by
//     side, kPillars such rows of pillars one after another (tx a power of
//     2, at most the row's vectors, looping over longer rows); a thread
//     stores V 32-bit words at a time (V = 4: one 16-byte vector, when the
//     row is a whole number of vectors and the grid is 16-byte aligned;
//     else V = 1). With a 128-byte f32 row each store of a warp fills 4
//     neighbouring rows, 512 contiguous bytes; with a 32-byte int8 row, 16.
//     (kPillars neighbouring pillars per group, with one 16-byte load of
//     their map entries, measured slower on the H100.)
//   * a thread loads the map entries of its kPillars pillars before its
//     first store; the pass reads nothing else.
//   * grid stores are streaming (st.global.cs, evict-first): the grid is
//     much larger than L2 and nothing here reads it again. The occupancy
//     bytes, written by the first thread of each pillar, are plain stores
//     that L2 gathers into whole sectors.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pillar_grid {

constexpr int kThreads = 256;
constexpr int kPillars = 4;  // pillars per thread group
constexpr int32_t kEmpty = -1;

template <int V>
struct Words {
  uint32_t w[V];
};

template <int V>
__device__ __forceinline__ Words<V> load_words(const uint32_t* p);

template <>
__device__ __forceinline__ Words<4> load_words<4>(const uint32_t* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  return {{u.x, u.y, u.z, u.w}};
}

template <>
__device__ __forceinline__ Words<1> load_words<1>(const uint32_t* p) {
  return {{*p}};
}

template <int V>
__device__ __forceinline__ void store_words(uint32_t* p, const Words<V>& x);

template <>
__device__ __forceinline__ void store_words<4>(uint32_t* p,
                                               const Words<4>& x) {
  *reinterpret_cast<uint4*>(p) = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
}

template <>
__device__ __forceinline__ void store_words<1>(uint32_t* p,
                                               const Words<1>& x) {
  *p = x.w[0];
}

template <int V>
__device__ __forceinline__ void store_streaming(uint32_t* p,
                                                const Words<V>& x);

template <>
__device__ __forceinline__ void store_streaming<4>(uint32_t* p,
                                                   const Words<4>& x) {
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(x.w[0], x.w[1], x.w[2],
                                                 x.w[3]));
}

template <>
__device__ __forceinline__ void store_streaming<1>(uint32_t* p,
                                                   const Words<1>& x) {
  __stcs(p, x.w[0]);
}

// true when rows of `row_words` 32-bit words at these pointers can move as
// 16-byte vectors
inline bool vec4_ok(int64_t row_words, const void* a, const void* b,
                    const void* c) {
  return row_words % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

// block shape of a pass over rows of `row_vecs` V-word groups: tx threads
// per row, a power of 2 (so a row's threads share a warp) that loop when
// the row is longer
inline dim3 row_block(int row_vecs) {
  int tx = 1;
  while (tx < 32 && tx * 2 <= row_vecs) tx *= 2;
  return dim3(tx, kThreads / tx);
}

template <int V, class Tag>
__global__ void __launch_bounds__(kThreads)
    pillar_grid_fill_kernel(const int32_t* __restrict__ heads,
                            uint32_t* __restrict__ grid,
                            uint8_t* __restrict__ occ, int64_t pillars,
                            int row_vecs) {
  const int64_t first =
      (int64_t)blockIdx.x * blockDim.y * kPillars + threadIdx.y;
  bool empty[kPillars];
#pragma unroll
  for (int i = 0; i < kPillars; ++i) {
    const int64_t pillar = first + (int64_t)i * blockDim.y;
    empty[i] = pillar < pillars && heads[pillar] == kEmpty;
  }
  Words<V> zero;
#pragma unroll
  for (int k = 0; k < V; ++k) zero.w[k] = 0u;
  for (int v = threadIdx.x; v < row_vecs; v += blockDim.x) {
#pragma unroll
    for (int i = 0; i < kPillars; ++i) {
      const int64_t pillar = first + (int64_t)i * blockDim.y;
      if (empty[i]) {
        store_streaming<V>(grid + (pillar * row_vecs + v) * V, zero);
      }
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kPillars; ++i) {
      const int64_t pillar = first + (int64_t)i * blockDim.y;
      if (pillar < pillars) occ[pillar] = !empty[i];
    }
  }
}

// The streaming pass: zeros over the empty pillars' rows of the (pillars,
// row_words) grid, and the (pillars) occupancy, from the map. Tag, an empty
// type of the calling kernel, only names the instance (a profile then tells
// the two kernels' passes apart).
template <class Tag>
cudaError_t fill_empty(const int32_t* heads, void* grid, uint8_t* occ,
                       int64_t pillars, int row_words, cudaStream_t s) {
  if (pillars == 0) return cudaSuccess;
  const bool vec4 = vec4_ok(row_words, grid, grid, grid);
  const int row_vecs = vec4 ? row_words / 4 : row_words;
  const dim3 block = row_block(row_vecs);
  const int64_t per_block = (int64_t)block.y * kPillars;
  const unsigned int blocks =
      (unsigned int)((pillars + per_block - 1) / per_block);
  uint32_t* g = static_cast<uint32_t*>(grid);
  if (vec4) {
    pillar_grid_fill_kernel<4, Tag>
        <<<blocks, block, 0, s>>>(heads, g, occ, pillars, row_vecs);
  } else {
    pillar_grid_fill_kernel<1, Tag>
        <<<blocks, block, 0, s>>>(heads, g, occ, pillars, row_vecs);
  }
  return cudaGetLastError();
}

}  // namespace pillar_grid
