// Pillar scatter-max for Hopper (sm_90a).
//
// Per-pillar element-wise max of point features into a dense NHWC grid, 0 at
// empty pillars, plus a per-pillar occupancy byte. Same contract as
// pillarnet_lts_torch/ops/voxelize.py::scatter_max_to_grid.
//
// Replaces the TPU kernel
// pillarnet_lts_tpu/ops/pallas/voxelize_kernel.py::pillar_scatter_max_mxu.
// The TPU has no scatter atomics, so that kernel sorts the points by pillar
// and folds them into the grid with one-hot matmuls on the MXU. Hopper has
// native 32-bit atomics in L2, so this kernel goes back to the reference
// design (one atomic max per element, scatter_ops_gpu.cu:13-45):
//
//   * one thread per (point, channel), channel fastest: with C = 32 a warp
//     reads one point's 128 contiguous bytes and its 32 atomics land in one
//     128-byte grid row;
//   * nonneg = 1 (post-ReLU reader features): the grid starts as +0.0 and
//     the kernel does a signed int atomicMax on the float bit pattern. For
//     floats >= +0.0 the int order is the float order, so the result is exact
//     and independent of the order of the atomics (deterministic). A -0.0
//     input has its sign bit set and loses to the initial +0.0; the two
//     compare equal.
//   * nonneg = 0: each float is mapped to an order-preserving uint32
//     (bits ^ 0x80000000 for f >= 0, ~bits otherwise), the scratch grid
//     starts at 0 (below every encoded non-NaN float), the kernel does an
//     unsigned atomicMax, and a second launch decodes in place and writes 0
//     where the pillar is empty.
//   * int8 code mode (`pillar_scatter_max_i8`, the int8 deploy's payload,
//     the TPU kernel's int8 mode at voxelize_kernel.py:554-604): nonneg
//     codes in [0, 127] into an int8 grid, merged 4 channels per 32-bit
//     word with a compare-and-swap on the per-byte max; the grid is a
//     quarter of the f32 grid's bytes.
//
// What bounds it on the card: at the flagship size (1 x 262,144 points x 32
// f32 channels into a 1440 x 1440 x 32 f32 grid) the kernel issues about
// 8.4 M atomics on 34 MB of point features, while the grid is 265 MB. The
// wrapper's zero fill of that grid and its write-back through L2 are the
// bound, not the atomics; the atomics spread over ~2-4% of the grid rows.
// Offsets are 64-bit: B*H*W*C reaches 5.3e8 at batch 8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned int encode_ordered(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u ^ 0x80000000u);
}

__device__ __forceinline__ unsigned int decode_ordered(unsigned int u) {
  return (u & 0x80000000u) ? (u ^ 0x80000000u) : ~u;
}

// Grid offset of thread t's element, or -1 when its point is dropped.
__device__ __forceinline__ int64_t target_offset(
    int64_t t, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ valid, uint8_t* __restrict__ occ, int64_t n,
    int64_t c_dim, int64_t hw) {
  const int64_t p = t / c_dim;  // point index over B*N
  const int64_t c = t - p * c_dim;
  if (!valid[p]) return -1;
  const int64_t id = ids[p];
  if (id < 0 || id >= hw) return -1;
  const int64_t pillar = (p / n) * hw + id;
  if (c == 0) occ[pillar] = 1;
  return pillar * c_dim + c;
}

__global__ void scatter_max_nonneg_kernel(
    const float* __restrict__ feats, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ valid, int* __restrict__ grid,
    uint8_t* __restrict__ occ, int64_t n, int64_t c_dim, int64_t hw,
    int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t off = target_offset(t, ids, valid, occ, n, c_dim, hw);
  if (off < 0) return;
  atomicMax(grid + off, __float_as_int(feats[t]));
}

__global__ void scatter_max_ordered_kernel(
    const float* __restrict__ feats, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ valid, unsigned int* __restrict__ grid,
    uint8_t* __restrict__ occ, int64_t n, int64_t c_dim, int64_t hw,
    int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t off = target_offset(t, ids, valid, occ, n, c_dim, hw);
  if (off < 0) return;
  atomicMax(grid + off, encode_ordered(feats[t]));
}

// int8 code mode: one thread per (point, 4-channel word). There is no 8-bit
// atomicMax, so the thread merges its 4 codes into the grid word with a
// compare-and-swap loop on the per-byte unsigned max (__vmaxu4). Codes are
// nonneg (0..127), so the unsigned byte order is the code order; the grid
// starts at 0, which is also the value of an empty pillar.
__global__ void scatter_max_codes_kernel(
    const uint32_t* __restrict__ feats, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ valid, uint32_t* __restrict__ grid,
    uint8_t* __restrict__ occ, int64_t n, int64_t c_words, int64_t hw,
    int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t off = target_offset(t, ids, valid, occ, n, c_words, hw);
  if (off < 0) return;
  const uint32_t mine = feats[t];
  uint32_t* addr = grid + off;
  uint32_t old = *addr;
  while (true) {
    const uint32_t merged = __vmaxu4(old, mine);
    if (merged == old) break;
    const uint32_t seen = atomicCAS(addr, old, merged);
    if (seen == old) break;
    old = seen;
  }
}

__global__ void decode_ordered_kernel(unsigned int* __restrict__ grid,
                                      const uint8_t* __restrict__ occ,
                                      int64_t c_dim, int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  grid[t] = occ[t / c_dim] ? decode_ordered(grid[t]) : 0u;
}

inline unsigned int blocks_for(int64_t total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

}  // namespace

// feats (B, N, C) f32, ids (B, N) i32, valid (B, N) bytes: all contiguous.
// grid (B, H*W, C) 32-bit words, zero-filled by the caller; occ (B, H*W)
// bytes, zero-filled by the caller. Returns the first non-zero cudaError_t.
extern "C" int pillar_scatter_max_f32(const float* feats, const int32_t* ids,
                                      const uint8_t* valid, void* grid,
                                      uint8_t* occ, int64_t b, int64_t n,
                                      int64_t c_dim, int64_t hw, int nonneg,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = b * n * c_dim;
  if (total > 0) {
    if (nonneg) {
      scatter_max_nonneg_kernel<<<blocks_for(total), kThreads, 0, s>>>(
          feats, ids, valid, static_cast<int*>(grid), occ, n, c_dim, hw,
          total);
    } else {
      scatter_max_ordered_kernel<<<blocks_for(total), kThreads, 0, s>>>(
          feats, ids, valid, static_cast<unsigned int*>(grid), occ, n, c_dim,
          hw, total);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t cells = b * hw * c_dim;
  if (!nonneg && cells > 0) {
    decode_ordered_kernel<<<blocks_for(cells), kThreads, 0, s>>>(
        static_cast<unsigned int*>(grid), occ, c_dim, cells);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// int8 code mode. codes (B, N, C) int8 in [0, 127], ids (B, N) i32, valid
// (B, N) bytes; grid (B, H*W, C) int8 and occ (B, H*W) bytes, zero-filled by
// the caller; C % 4 == 0. Returns the launch's cudaError_t.
extern "C" int pillar_scatter_max_i8(const void* codes, const int32_t* ids,
                                     const uint8_t* valid, void* grid,
                                     uint8_t* occ, int64_t b, int64_t n,
                                     int64_t c_dim, int64_t hw, void* stream) {
  const int64_t c_words = c_dim / 4;
  const int64_t total = b * n * c_words;
  if (total == 0) return 0;
  scatter_max_codes_kernel<<<blocks_for(total), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(codes), ids, valid,
      static_cast<uint32_t*>(grid), occ, n, c_words, hw, total);
  return (int)cudaGetLastError();
}
