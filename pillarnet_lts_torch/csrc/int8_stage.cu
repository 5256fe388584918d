// The whole int8 stride-1 stage (32 channels, n = 3 + 2 * (blocks - 1) SubM
// convs) in one kernel, for Hopper (sm_90a).
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
// Design (simple and correct first): one block of 512 threads per output
// tile of 8 x 32 sites. The block loads the tile with a halo of n sites on
// each side (zeros outside the image, mask 0 there) into shared memory as
// bf16, and runs the n convs on it: conv i reads rows/cols [i, R - i) and
// writes [i + 1, R - i - 1), so one halo ring is used up per conv and the
// last conv writes exactly the 8 x 32 tile. Each conv first quantizes its
// source region once into a buffer of int8 words (4 channels per word),
// stages its kernel taps (9 x 8 words x 32 output channels) and lists the
// groups of 4 neighbouring output sites that hold an active site; the
// threads then compute only those groups (4 sites x 8 output channels each,
// with __dp4a, as csrc/int8_conv.cu does). Every other site of the buffers
// stays 0, the value its mask gives it, and zero halo at the image edge
// makes the padded sites exact zeros for the next conv, the invariant the
// per-conv path keeps. Tiles whose output mask is all zero write zeros and
// skip the stage.
//
// Shared memory at n = 7: two bf16 activation buffers of 22 x 46 x 32
// (64.8 KB each), the quantized words (36.4 KB), one conv's taps (9.2 KB)
// and the mask (4 KB): 179 KB, one block per SM.
//
// What bounds it on the card: dp4a issue and the halo recompute (the convs
// of an 8 x 32 tile at n = 7 compute 2.1x the tile's sites); the stage reads
// its input and writes its output once instead of 7 times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kC = 32;                   // stage channels
constexpr int kWords = kC / 4;           // int8 words per site
constexpr int kSiteStride = kWords + 1;  // padded: conflict-free site reads
constexpr int kTH = 8, kTW = 32;         // output tile

size_t smem_bytes(int n) {
  const size_t rh = kTH + 2 * n, rw = kTW + 2 * n, sites = rh * rw;
  const size_t groups = (rh - 2) * ((rw - 2 + 3) / 4);
  return 2 * sites * kC * sizeof(__nv_bfloat16)      // A, B
         + sites * kSiteStride * sizeof(int32_t)      // quantized words
         + 9 * kWords * kC * sizeof(int32_t)          // taps
         + sites * sizeof(float)                      // mask
         + (groups + 1) * sizeof(int);                // active groups
}

__global__ void __launch_bounds__(kThreads) int8_stage_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ inv_s, const float* __restrict__ dq,
    const float* __restrict__ shift, const __nv_bfloat16* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int H, int W, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int RH = kTH + 2 * n, RW = kTW + 2 * n, sites = RH * RW;
  // taps first: 16-byte vector reads need the alignment
  int32_t* ws = reinterpret_cast<int32_t*>(smem);
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(ws + 9 * kWords * kC);
  __nv_bfloat16* buf_b = buf_a + (size_t)sites * kC;
  int32_t* qs = reinterpret_cast<int32_t*>(buf_b + (size_t)sites * kC);
  float* ms = reinterpret_cast<float*>(qs + (size_t)sites * kSiteStride);
  // output groups of 4 sites: rows [1, RH - 1), columns from 1 in fours
  const int gcols = (RW - 2 + 3) / 4, n_groups = (RH - 2) * gcols;
  int* act = reinterpret_cast<int*>(ms + sites);  // this conv's active ones
  int* n_act = act + n_groups;

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kTH, ox0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  const int64_t img = (int64_t)b * H * W;

  int active = 0;
  for (int i = tid; i < kTH * kTW; i += kThreads) {
    const int oy = oy0 + i / kTW, ox = ox0 + i % kTW;
    if (oy < H && ox < W &&
        __bfloat162float(mask[img + (int64_t)oy * W + ox]) != 0.f)
      active = 1;
  }
  if (!__syncthreads_or(active)) {
    for (int i = tid; i < kTH * kTW * (kC / 8); i += kThreads) {
      const int s = i / (kC / 8), part = i % (kC / 8);
      const int oy = oy0 + s / kTW, ox = ox0 + s % kTW;
      if (oy < H && ox < W)
        reinterpret_cast<uint4*>(out + (img + (int64_t)oy * W + ox) * kC)[part] =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }

  // the haloed input tile -> buf_b, the mask -> ms (zeros outside the image)
  for (int i = tid; i < sites * (kC / 8); i += kThreads) {
    const int s = i / (kC / 8), part = i % (kC / 8);
    const int y = oy0 - n + s / RW, xx = ox0 - n + s % RW;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (y >= 0 && y < H && xx >= 0 && xx < W)
      v = reinterpret_cast<const uint4*>(x + (img + (int64_t)y * W + xx) * kC)[part];
    reinterpret_cast<uint4*>(buf_b + (size_t)s * kC)[part] = v;
  }
  for (int s = tid; s < sites; s += kThreads) {
    const int y = oy0 - n + s / RW, xx = ox0 - n + s % RW;
    ms[s] = (y >= 0 && y < H && xx >= 0 && xx < W)
                ? __bfloat162float(mask[img + (int64_t)y * W + xx])
                : 0.f;
  }
  // A is written only at active groups: zero elsewhere, as the mask makes
  for (int t = tid; t < sites * (kC / 8); t += kThreads)
    reinterpret_cast<uint4*>(buf_a)[t] = make_uint4(0, 0, 0, 0);

  for (int i = 0; i < n; ++i) {
    const bool tail = i > 0 && i % 2 == 0;
    const __nv_bfloat16* src = (i % 2 == 1) ? buf_a : buf_b;
    __nv_bfloat16* dst = (i % 2 == 1) ? buf_b : buf_a;
    const int lo = i + 1, hi_r = RH - i - 1, hi_c = RW - i - 1;  // output
    __syncthreads();  // the previous conv's writes and reads are done
    if (tid == 0) *n_act = 0;

    // quantize the source region [i, R - i)^2 once, 4 channels per word
    const float inv = inv_s[i];
    const int qrows = RH - 2 * i, qcols = RW - 2 * i;
    for (int t = tid; t < qrows * qcols * kWords; t += kThreads) {
      const int k = t % kWords, s = t / kWords;
      const int site = (i + s / qcols) * RW + i + s % qcols;
      const uint2 raw =
          *reinterpret_cast<const uint2*>(src + (size_t)site * kC + 4 * k);
      qs[site * kSiteStride + k] = quant_word(raw, inv);
    }
    for (int t = tid; t < 9 * kWords * kC; t += kThreads) {
      const int co = t % kC, k = (t / kC) % kWords, tap = t / (kC * kWords);
      ws[t] = pack_word(w + (((size_t)i * 9 + tap) * kC + 4 * k) * kC + co, kC);
    }
    __syncthreads();
    // the groups of 4 sites with an active site in this conv's output
    for (int g = tid; g < n_groups; g += kThreads) {
      const int r = 1 + g / gcols, c0 = 1 + 4 * (g % gcols);
      if (r < lo || r >= hi_r) continue;
      bool any = false;
      for (int a = 0; a < 4; ++a) {
        const int c = c0 + a;
        any |= c >= lo && c < hi_c && ms[r * RW + c] != 0.f;
      }
      if (any) act[atomicAdd(n_act, 1)] = g;
    }
    __syncthreads();
    if (i == 0) {
      // B held the input; from here on it holds mid outputs, written only
      // at active groups: zero elsewhere, as the mask makes them
      for (int t = tid; t < sites * (kC / 8); t += kThreads)
        reinterpret_cast<uint4*>(buf_b)[t] = make_uint4(0, 0, 0, 0);
    }

    const float* dqi = dq + i * kC;
    const float* shi = shift + i * kC;
    const int n_items = *n_act * 4;
    for (int t = tid; t < n_items; t += kThreads) {
      const int cg = t % 4, g = act[t / 4];
      const int r = 1 + g / gcols, c0 = 1 + 4 * (g % gcols);
      bool valid[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) valid[a] = c0 + a >= lo && c0 + a < hi_c;
      int acc[4][8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[a][j] = 0;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        const int32_t* qrow = qs + ((r - 1 + ky) * RW + c0 - 1 + kx) * kSiteStride;
        const int32_t* wrow = ws + tap * kWords * kC + cg * 8;
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          int av[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            av[a] = valid[a] ? qrow[a * kSiteStride + k] : 0;
          const int4 w0 = *reinterpret_cast<const int4*>(wrow + k * kC);
          const int4 w1 = *reinterpret_cast<const int4*>(wrow + k * kC + 4);
          const int wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[a][j] = __dp4a(av[a], wv[j], acc[a][j]);
        }
      }
      for (int a = 0; a < 4; ++a) {
        if (!valid[a]) continue;
        const int site = r * RW + c0 + a;
        const float m = ms[site];
        __align__(16) __nv_bfloat16 res[8];
        if (tail)
          *reinterpret_cast<uint4*>(res) = *reinterpret_cast<const uint4*>(
              buf_a + (size_t)site * kC + cg * 8);
        __align__(16) __nv_bfloat16 y[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int co = cg * 8 + j;
          const float r = tail ? __bfloat162float(res[j]) : 0.f;
          y[j] = __float2bfloat16_rn(
              epilogue(acc[a][j], dqi[co], shi[co], tail, r, i > 0, m));
        }
        *reinterpret_cast<uint4*>(dst + (size_t)site * kC + cg * 8) =
            *reinterpret_cast<const uint4*>(y);
      }
    }
  }

  // the tile's output: the last conv wrote its active groups into A (zeros
  // elsewhere)
  __syncthreads();
  for (int t = tid; t < kTH * kTW * (kC / 8); t += kThreads) {
    const int s = t / (kC / 8), part = t % (kC / 8);
    const int oy = oy0 + s / kTW, ox = ox0 + s % kTW;
    if (oy < H && ox < W)
      reinterpret_cast<uint4*>(out + (img + (int64_t)oy * W + ox) * kC)[part] =
          reinterpret_cast<const uint4*>(
              buf_a + (size_t)((n + s / kTW) * RW + n + s % kTW) * kC)[part];
  }
}

}  // namespace

// x, out (B, H, W, 32) bf16; w (n, 3, 3, 32, 32) int8 HWIO kernels; inv_s (n,) f32; dq, shift (n, 32) f32; mask (B, H, W) bf16
// {0, 1}. All on the device and contiguous; n odd >= 3. Returns the first
// non-zero cudaError_t.
extern "C" int int8_stage_bf16(const void* x, const void* w,
                               const float* inv_s, const float* dq,
                               const float* shift, const void* mask, void* out,
                               int b, int h, int w_, int n, void* stream) {
  if (b * h * w_ == 0) return 0;
  const size_t bytes = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      int8_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w_ + kTW - 1) / kTW, (h + kTH - 1) / kTH, b);
  int8_stage_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      inv_s, dq, shift, static_cast<const __nv_bfloat16*>(mask),
      static_cast<__nv_bfloat16*>(out), h, w_, n);
  return (int)cudaGetLastError();
}
