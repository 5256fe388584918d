// The whole int8 stride-1 stage (32 channels, n = 3 + 2 * (blocks - 1) SubM
// convs) in one kernel, for Hopper (sm_90a), on the int8 tensor cores.
//
// Contract: pillarnet_lts_torch/ops/int8_stage.py::int8_stage_plain, the
// plain int8 convs chained as
//   conv0:         A = conv(x) * mask
//   mid  (odd i):  B = relu(conv(A)) * mask
//   tail (even i): A = relu(conv(B) + A) * mask      (the last one -> out)
// with each conv's arithmetic exactly that of csrc/int8_conv.cu (quantize
// rint(x * inv_s) clipped to +-127, int32 sums, bf16(acc * dq + shift) with
// two f32 roundings, bf16 residual add, ReLU, mask multiply).
//
// Replaces the TPU kernel
// pillarnet_lts_tpu/ops/pallas/s2d_conv_kernel.py::s2d_stage_int8 (body
// _stage_kernel :287): one read of the stage input and one write of its
// output, with every intermediate activation kept on chip.
//
// Design: one block of 1024 threads (32 warps) per output tile of 20 x 32
// sites (8 x 32 when n is too large for that in shared memory). The block
// loads the tile with a halo of n sites on each side (zeros outside the
// image, mask 0 there) by cp.async into the A buffer (free until conv 0
// writes it), quantizes it with conv 0's scale into a buffer of int8
// codes, and runs the n convs on it: conv i
// reads rows/cols [i, R - i) and writes [i + 1, R - i - 1), so one halo ring
// is used up per conv and the last conv writes exactly the tile. Each conv
// is cut into items of one row x 16 columns, the m16 fragment of
// csrc/int8_conv.cu's micro-tile (mma.sync.m16n8k32 s8, N = 32 output
// channels); a warp skips an item without an active site (it writes its
// zeros), and otherwise does per tap 3 ldmatrix.x4 (A and the two B pairs,
// read from shared memory: 64 registers a thread let 32 warps share the
// SM) and 4 mma; the warps take items from a counter in
// shared memory, so that live items spread over them. The epilogue skips
// the arithmetic of an inactive site (it is 0) and writes the next conv's
// input directly as int8 codes (quant_code of the bf16-rounded output with
// the next conv's scale, as the plain chain quantizes it) into the other of
// two ping-pong code buffers; only A, which the tails also add as the
// residual, is kept in bf16 too. Each conv's packed (9, 32, 32) weights
// arrive by 16-byte cp.async, the next conv's during this one's products.
// Every site of a conv's output region is written (zeros where inactive),
// so no buffer needs clearing, and the padded sites stay exact zeros for the
// next conv, the invariant the per-conv path keeps. Tiles whose output mask
// is all zero write zeros and skip the stage.
//
// Shared memory: two code buffers (32 bytes a site, 16-byte halves swapped
// on every other group of 4 sites), A (64 bytes a site, 16-byte chunks
// XOR-swizzled by site), the mask, the scales and two weight buffers: at
// n = 7, 34 x 46 sites, 221 KB, one block per SM.
//
// What bounds it on the card: the halo recompute (the convs of a 20 x 32
// tile at n = 7 cover 1.9x the tile's sites, in items of 16) and the
// latency of each item's chain of 9 dependent mma and its epilogue, which
// 32 warps only partly hide; the stage reads its input and writes its
// output once instead of 7 times. Measured on an H100 (PERF.md): 16 x 32
// tiles took 10% longer, 8 x 32 tiles 70% longer, and 512 threads with the
// B fragments in registers 15% longer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kC = 32;                 // stage channels
constexpr int kTW = 32;                // output tile width; its height is
constexpr int kMaxTH = 20;             // this, or 8 where it does not fit
constexpr int kWBytes = 9 * kC * kC;   // one conv's packed weights
constexpr int kSmemMax = 232448;       // an H100 block's shared memory

struct Layout {
  int rh, rw, sites;
  int q0, q1, a, ms, dqs, queue, bytes;  // byte offsets; the weights at 0
};

__host__ __device__ inline Layout layout(int n, int th) {
  Layout l;
  l.rh = th + 2 * n;
  l.rw = kTW + 2 * n;
  l.sites = l.rh * l.rw;
  l.q0 = 2 * kWBytes;
  l.q1 = l.q0 + l.sites * kC;
  l.a = l.q1 + l.sites * kC;
  l.ms = l.a + l.sites * kC * 2;
  l.dqs = l.ms + l.sites * 4;  // per conv: dq (32 f32), then shift
  l.queue = l.dqs + n * 2 * kC * 4;  // two item counters
  l.bytes = l.queue + 2 * 4;
  return l;
}

// byte offset of channel `co` of site `s` in a code buffer, and of the
// 16-byte chunk `c` (8 channels) of site `s` in A
__device__ __forceinline__ int code_at(int s, int co) {
  return swz32(s, co >> 4) + (co & 15);
}
__device__ __forceinline__ int a_chunk(int s, int c) {
  return s * 64 + ((c ^ ((s >> 1) & 3)) << 4);
}

__global__ void __launch_bounds__(kThreads, 1) int8_stage_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wp,
    const float* __restrict__ inv_s, const float* __restrict__ dq,
    const float* __restrict__ shift, const __nv_bfloat16* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int H, int W, int n, int th) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(n, th);
  const int RH = L.rh, RW = L.rw;
  unsigned char* abuf = smem + L.a;
  float* ms = reinterpret_cast<float*>(smem + L.ms);
  float* dqs = reinterpret_cast<float*>(smem + L.dqs);
  int* queue = reinterpret_cast<int*>(smem + L.queue);

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * th, ox0 = blockIdx.x * kTW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t img = (int64_t)b * H * W;

  int active = 0;
  for (int i = tid; i < th * kTW; i += kThreads) {
    const int oy = oy0 + i / kTW, ox = ox0 + i % kTW;
    if (oy < H && ox < W &&
        __bfloat162float(mask[img + (int64_t)oy * W + ox]) != 0.f)
      active = 1;
  }
  if (!__syncthreads_or(active)) {
    for (int i = tid; i < th * kTW * (kC / 8); i += kThreads) {
      const int s = i / (kC / 8), part = i % (kC / 8);
      const int oy = oy0 + s / kTW, ox = ox0 + s % kTW;
      if (oy < H && ox < W)
        *reinterpret_cast<uint4*>(out + (img + (int64_t)oy * W + ox) * kC +
                                  part * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  // the haloed tile in bf16 -> A (unused until conv 0 writes it), with
  // conv 0's weights in flight beside it; the mask -> ms, the scales -> dqs
  auto inside = [&](int s, int64_t* at) {  // region site -> image site
    const int y = oy0 - n + s / RW, xx = ox0 - n + s % RW;
    *at = img + (int64_t)y * W + xx;
    return y >= 0 && y < H && xx >= 0 && xx < W;
  };
  for (int i = tid; i < L.sites * 4; i += kThreads) {
    int64_t at;
    if (inside(i >> 2, &at))
      cp_async16(abuf + a_chunk(i >> 2, i & 3), x + at * kC + (i & 3) * 8);
    else  // zero padding outside the image
      *reinterpret_cast<uint4*>(abuf + a_chunk(i >> 2, i & 3)) =
          make_uint4(0, 0, 0, 0);
  }
  stage_weights<kThreads>(smem, wp, kC, kC, kC);  // commits both
  if (tid == 0) queue[0] = 0;
  for (int i = tid; i < n * 2 * kC; i += kThreads)
    dqs[i] = (i / kC) % 2 ? shift[(i / (2 * kC)) * kC + i % kC]
                          : dq[(i / (2 * kC)) * kC + i % kC];
  constexpr int kBatch = 4;  // mask loads in flight per thread
  for (int s0 = tid; s0 < L.sites; s0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      int64_t at;
      const int s = s0 + k * kThreads;
      v[k] = s < L.sites && inside(s, &at) ? __bfloat162float(mask[at]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (s0 + k * kThreads < L.sites) ms[s0 + k * kThreads] = v[k];
  }
  cp_async_wait<0>();
  __syncthreads();
  const float inv0 = inv_s[0];  // conv 0's input codes -> q0
  for (int i = tid; i < L.sites * 4; i += kThreads)
    *reinterpret_cast<uint2*>(smem + L.q0 + code_at(i >> 2, (i & 3) * 8)) =
        quant_8(*reinterpret_cast<const uint4*>(abuf + a_chunk(i >> 2, i & 3)),
                inv0);

  const int g = lane >> 2, t = lane & 3;
  const int m = a_row(lane), a_hf = a_half(lane);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  for (int i = 0; i < n; ++i) {
    const bool tail = i > 0 && i % 2 == 0;  // adds A, writes A
    const bool to_a = i % 2 == 0;           // conv 0 and the tails write A
    const bool last = i == n - 1;           // (a tail: n is odd)
    const unsigned char* qin = smem + (i % 2 ? L.q1 : L.q0);
    unsigned char* qout = smem + (i % 2 ? L.q0 : L.q1);
    cp_async_wait<0>();  // this conv's weights
    __syncthreads();     // ... and the previous conv's outputs are visible
    if (tid == 0) queue[(i + 1) & 1] = 0;  // conv i - 1's counter, for i + 1
    if (!last)  // into the buffer that conv i - 1 read before the barrier
      stage_weights<kThreads>(smem + ((i + 1) & 1) * kWBytes,
                              wp + (int64_t)(i + 1) * kWBytes, kC, kC, kC);
    // this lane's B rows: tap * 32 + 16 p + b_row(lane), all in the swz32
    // layout's same half (the half swap depends on row bit 2 only)
    const unsigned char* wbuf =
        smem + (i & 1) * kWBytes + swz32(b_row(lane), b_half(lane));
    const float inv_next = last ? 0.f : inv_s[i + 1];
    const float* dqi = dqs + i * 2 * kC;  // then shift at + kC

    // items: rows [lo, hi_r) x segments of 16 columns from lo
    const int lo = i + 1, hi_r = RH - i - 1, hi_c = RW - i - 1;
    const int nseg = (hi_c - lo + 15) / 16;
    const int n_items = (hi_r - lo) * nseg;
    for (;;) {  // items from the conv's counter: live ones cost more
      int it = 0;
      if (lane == 0) it = atomicAdd(queue + (i & 1), 1);
      it = __shfl_sync(0xffffffffu, it, 0);
      if (it >= n_items) break;
      const int r = lo + it / nseg, c0 = lo + (it % nseg) * 16;
      const bool live = __any_sync(
          0xffffffffu, lane < 16 && c0 + lane < hi_c &&
                           ms[r * RW + c0 + lane] != 0.f);
      if (!live) {  // zeros: the next conv's codes, and A after conv 0
        const int col = c0 + (lane >> 1);
        if (col < hi_c) {
          const int s = r * RW + col;
          if (!last)
            *reinterpret_cast<uint4*>(qout + swz32(s, lane & 1)) =
                make_uint4(0, 0, 0, 0);
          if (i == 0) {
            *reinterpret_cast<uint4*>(abuf + a_chunk(s, (lane & 1) * 2)) =
                make_uint4(0, 0, 0, 0);
            *reinterpret_cast<uint4*>(abuf + a_chunk(s, (lane & 1) * 2 + 1)) =
                make_uint4(0, 0, 0, 0);
          }
        }
        continue;
      }
      int acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        // columns past the region only feed outputs that are not stored
        const int s = (r - 1 + ky) * RW + min(c0 - 1 + m + kx, RW - 1);
        uint32_t a[4], b[2][4];
        ldmatrix_x4(a, qin + swz32(s, a_hf));
        ldmatrix_x4(b[0], wbuf + tap * kC * 32);
        ldmatrix_x4(b[1], wbuf + (tap * kC + 16) * 32);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[j], a, b[j / 2][2 * (j % 2)], b[j / 2][2 * (j % 2) + 1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c0 + g + 8 * h;
        if (col >= hi_c) continue;
        const int s = r * RW + col;
        const float mv = ms[s];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int co = j * 8 + 2 * t;
          auto* pa = reinterpret_cast<__nv_bfloat162*>(
              abuf + a_chunk(s, co >> 3) + (co & 7) * 2);
          __nv_bfloat162 y = zero;  // an inactive site is 0, and its code
          uint16_t q = 0;
          if (mv != 0.f) {
            y = epilogue2(acc[j][2 * h], acc[j][2 * h + 1],
                          *reinterpret_cast<const float2*>(dqi + co),
                          *reinterpret_cast<const float2*>(dqi + kC + co),
                          tail, tail ? *pa : zero, i > 0,
                          __float2bfloat162_rn(mv));
            q = quant_pair(y, inv_next);
          }
          if (to_a) *pa = y;
          if (!last) *reinterpret_cast<uint16_t*>(qout + code_at(s, co)) = q;
        }
      }
    }
  }

  // the tile's output: the last conv wrote A there
  __syncthreads();
  for (int i = tid; i < th * kTW * (kC / 8); i += kThreads) {
    const int s = i / (kC / 8), part = i % (kC / 8);
    const int oy = oy0 + s / kTW, ox = ox0 + s % kTW;
    if (oy < H && ox < W)
      *reinterpret_cast<uint4*>(out + (img + (int64_t)oy * W + ox) * kC +
                                part * 8) =
          *reinterpret_cast<const uint4*>(
              abuf + a_chunk((n + s / kTW) * RW + n + s % kTW, part));
  }
}

}  // namespace

// x, out (B, H, W, 32) bf16; wp (n, 9, 32, 32) int8, the n HWIO kernels
// packed K-contiguous (ops/quant.py::pack_kernel); inv_s (n,) f32; dq,
// shift (n, 32) f32; mask (B, H, W) bf16 {0, 1}. All on the device and
// contiguous, x, wp and out 16-byte aligned; n odd >= 3. Returns the first
// non-zero cudaError_t.
extern "C" int int8_stage_bf16(const void* x, const void* wp,
                               const float* inv_s, const float* dq,
                               const float* shift, const void* mask, void* out,
                               int b, int h, int w_, int n, void* stream) {
  if (b * h * w_ == 0) return 0;
  int th = kMaxTH;
  if (layout(n, th).bytes > kSmemMax) th = 8;
  const int bytes = layout(n, th).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      int8_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w_ + kTW - 1) / kTW, (h + th - 1) / th, b);
  int8_stage_kernel<<<grid, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wp),
      inv_s, dq, shift, static_cast<const __nv_bfloat16*>(mask),
      static_cast<__nv_bfloat16*>(out), h, w_, n, th);
  return (int)cudaGetLastError();
}
