// One int8 3x3 conv (padding 1, stride 1 or 2) with the fused eval epilogue,
// for Hopper (sm_90a).
//
// Contract: pillarnet_lts_torch/ops/quant.py::int8_conv_bn_act_plain.
//   x bf16 NHWC -> codes q = clip(rint(x * inv_s), -127, 127) on load,
//   int32 sums over 3x3xCin, then y = bf16(acc * dq + shift) (two f32
//   roundings: built with -fmad=false and written with __fmul_rn/__fadd_rn),
//   + residual (bf16 add), ReLU, times the {0, 1} site mask.
//
// Replaces the TPU kernel
// pillarnet_lts_tpu/ops/pallas/s2d_conv_kernel.py::s2d_subm_conv_int8 (body
// _kernel :50). That kernel exists for the 32-channel stride-1 stage in the
// TPU's space-to-depth lane layout; here the same math runs in plain NHWC and
// also serves every other int8 conv of the deploy path (the strided down
// convs, conv5 and the neck), because PyTorch has no int8 convolution on
// CUDA.
//
// Design (a simple, correct first kernel): one block of 256 threads per
// output tile of 8x16 sites x 64 output channels (16x16 x 32 when Cout is
// not a multiple of 64). Input channels stream through shared memory in
// chunks of 32: the halo'd input patch is quantized once while it is loaded
// (4 channels packed into one 32-bit word) and the chunk's kernel taps are
// staged beside it as words of 4 input channels. Each thread accumulates 4
// neighbouring sites x 8 output channels with __dp4a (4 int8 MACs per
// instruction): per tap and word it reads 4 activation words and two 16-byte
// weight vectors for 32 dp4a. The kernel reads the HWIO int8 kernel as it is
// and packs 4 input channels per word while staging a chunk. Tiles whose
// output mask is all zero write zeros and skip the sums, and so do threads
// whose 4 sites are all masked out (the stride-1 stage of a lidar grid is
// ~90% empty).
//
// What bounds it on the card: dp4a issue rate (no tensor cores yet: mma.sync
// / wgmma with s8 operands and TMA-fed tiles are later work). The flagship's
// int8 convs do ~220 G dp4a per frame before the empty-tile skip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;               // input channels per smem chunk
constexpr int kWords = kChunk / 4;       // 32-bit words per site per chunk
constexpr int kSiteStride = kWords + 1;  // padded: conflict-free site reads
constexpr int kTW = 16;                  // output tile width (sites)

template <int COT, int STRIDE>
struct Tile {
  static constexpr int kCoGroups = COT / 8;              // 8 couts a thread
  static constexpr int kSiteGroups = kThreads / kCoGroups;  // 4 sites a thread
  static constexpr int kTH = kSiteGroups * 4 / kTW;
  static constexpr int kPH = (kTH - 1) * STRIDE + 3;     // input patch
  static constexpr int kPW = (kTW - 1) * STRIDE + 3;
};

template <int COT, int STRIDE>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ inv_s_ptr, const float* __restrict__ dq,
    const float* __restrict__ shift, const __nv_bfloat16* __restrict__ mask,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    int H, int W, int cin, int Ho, int Wo, int cout, int act) {
  using T = Tile<COT, STRIDE>;
  __shared__ int32_t xs[T::kPH * T::kPW * kSiteStride];
  __shared__ __align__(16) int32_t ws[9 * kWords * COT];

  const int n_co_tiles = cout / COT;
  const int b = blockIdx.z / n_co_tiles;
  const int co_base = (blockIdx.z % n_co_tiles) * COT;
  const int oy0 = blockIdx.y * T::kTH, ox0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  const int cg = tid % T::kCoGroups, sg = tid / T::kCoGroups;
  const int ty = sg / (kTW / 4), tx = (sg % (kTW / 4)) * 4;
  const int co0 = co_base + cg * 8;

  if (mask) {
    int active = 0;
    for (int i = tid; i < T::kTH * kTW; i += kThreads) {
      const int oy = oy0 + i / kTW, ox = ox0 + i % kTW;
      if (oy < Ho && ox < Wo &&
          __bfloat162float(mask[((int64_t)b * Ho + oy) * Wo + ox]) != 0.f)
        active = 1;
    }
    if (!__syncthreads_or(active)) {
      for (int i = 0; i < 4; ++i) {
        const int oy = oy0 + ty, ox = ox0 + tx + i;
        if (oy >= Ho || ox >= Wo) continue;
        const int64_t site = ((int64_t)b * Ho + oy) * Wo + ox;
        *reinterpret_cast<uint4*>(out + site * cout + co0) =
            make_uint4(0, 0, 0, 0);
      }
      return;
    }
  }

  // a thread whose 4 sites are all masked out keeps zero sums: its
  // outputs are multiplied by 0 anyway
  bool busy = !mask;
  for (int i = 0; i < 4 && !busy; ++i) {
    const int oy = oy0 + ty, ox = ox0 + tx + i;
    busy = oy < Ho && ox < Wo &&
           __bfloat162float(mask[((int64_t)b * Ho + oy) * Wo + ox]) != 0.f;
  }

  const float inv_s = *inv_s_ptr;
  int acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  const int iy0 = oy0 * STRIDE - 1, ix0 = ox0 * STRIDE - 1;
  for (int c0 = 0; c0 < cin; c0 += kChunk) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < T::kPH * T::kPW * kWords; i += kThreads) {
      const int k = i % kWords, s = i / kWords;
      const int iy = iy0 + s / T::kPW, ix = ix0 + s % T::kPW;
      int32_t word = 0;  // zero padding outside the image
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
        const uint2 raw = *reinterpret_cast<const uint2*>(
            x + (((int64_t)b * H + iy) * W + ix) * cin + c0 + 4 * k);
        word = quant_word(raw, inv_s);
      }
      xs[s * kSiteStride + k] = word;
    }
    for (int i = tid; i < 9 * kWords * COT; i += kThreads) {
      const int co = i % COT, r = i / COT;
      const int k = r % kWords, tap = r / kWords;
      const int8_t* src = w + ((int64_t)tap * cin + c0 + 4 * k) * cout +
                          co_base + co;
      ws[i] = pack_word(src, cout);
    }
    __syncthreads();
    if (!busy) continue;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const int32_t* xrow =
          xs + ((ty * STRIDE + ky) * T::kPW + tx * STRIDE + kx) * kSiteStride;
      const int32_t* wrow = ws + tap * kWords * COT + cg * 8;
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        int a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xrow[i * STRIDE * kSiteStride + k];
        const int4 w0 = *reinterpret_cast<const int4*>(wrow + k * COT);
        const int4 w1 = *reinterpret_cast<const int4*>(wrow + k * COT + 4);
        const int wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(a[i], wv[j], acc[i][j]);
      }
    }
  }

  for (int i = 0; i < 4; ++i) {
    const int oy = oy0 + ty, ox = ox0 + tx + i;
    if (oy >= Ho || ox >= Wo) continue;
    const int64_t site = ((int64_t)b * Ho + oy) * Wo + ox;
    const float m = mask ? __bfloat162float(mask[site]) : 1.f;
    __align__(16) __nv_bfloat16 y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = co0 + j;
      const float r = res ? __bfloat162float(res[site * cout + co]) : 0.f;
      y[j] = __float2bfloat16_rn(
          epilogue(acc[i][j], dq[co], shift[co], res != nullptr, r, act, m));
    }
    *reinterpret_cast<uint4*>(out + site * cout + co0) =
        *reinterpret_cast<const uint4*>(y);
  }
}

template <int COT, int STRIDE>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* w, const float* inv_s,
                   const float* dq, const float* shift,
                   const __nv_bfloat16* mask, const __nv_bfloat16* res,
                   __nv_bfloat16* out, int b, int h, int w_, int cin, int ho,
                   int wo, int cout, int act, cudaStream_t s) {
  using T = Tile<COT, STRIDE>;
  const dim3 grid((wo + kTW - 1) / kTW, (ho + T::kTH - 1) / T::kTH,
                  b * (cout / COT));
  int8_conv_kernel<COT, STRIDE><<<grid, kThreads, 0, s>>>(
      x, w, inv_s, dq, shift, mask, res, out, h, w_, cin, ho, wo, cout, act);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin) bf16; w (3, 3, Cin, Cout) int8; inv_s one f32 on the
// device; dq, shift (Cout,) f32; mask
// (B, Ho, Wo) bf16 or null; res (B, Ho, Wo, Cout) bf16 or null; out
// (B, Ho, Wo, Cout) bf16. All contiguous; Cin % 32 == 0, Cout % 32 == 0.
// Returns the launch's cudaError_t.
extern "C" int int8_conv_bf16(const void* x, const void* w,
                              const float* inv_s, const float* dq,
                              const float* shift, const void* mask,
                              const void* res, void* out, int b, int h, int w_,
                              int cin, int ho, int wo, int cout, int stride,
                              int act, void* stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wi = static_cast<const int8_t*>(w);
  const auto* mb = static_cast<const __nv_bfloat16*>(mask);
  const auto* rb = static_cast<const __nv_bfloat16*>(res);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b * ho * wo == 0) return 0;
  const bool wide = cout % 64 == 0;
  cudaError_t err;
  if (stride == 1) {
    err = wide ? launch<64, 1>(xb, wi, inv_s, dq, shift, mb, rb, ob, b, h, w_,
                               cin, ho, wo, cout, act, s)
               : launch<32, 1>(xb, wi, inv_s, dq, shift, mb, rb, ob, b, h, w_,
                               cin, ho, wo, cout, act, s);
  } else if (stride == 2) {
    err = wide ? launch<64, 2>(xb, wi, inv_s, dq, shift, mb, rb, ob, b, h, w_,
                               cin, ho, wo, cout, act, s)
               : launch<32, 2>(xb, wi, inv_s, dq, shift, mb, rb, ob, b, h, w_,
                               cin, ho, wo, cout, act, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
