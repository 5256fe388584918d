// One int8 3x3 conv (padding 1, stride 1 or 2) with the fused eval epilogue,
// for Hopper (sm_90a), on the int8 tensor cores.
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
// Design: an implicit GEMM on mma.sync.m16n8k32 (s8 x s8 -> s32). One block
// of 256 threads (8 warps) per output tile of 8 rows x 16 columns x COT
// output channels (64, or 32 when Cout is not a multiple of 64). M is the
// tile's 128 sites, one m16 fragment per output row and warp; N is COT; K is
// 9 taps x Cin in chunks of 32 input channels. Per chunk:
//   - the tile's haloed input patch is quantized while it is loaded into a
//     site-major int8 patch in shared memory, 48 bytes a site (32 codes and
//     16 of padding, so that ldmatrix's 8 rows of 8 consecutive sites hit 8
//     distinct bank groups); at stride 2 a patch row holds its even columns
//     first and its odd ones after, so a tap's 16 sites stay consecutive;
//   - the chunk's weights come from the (9, Cout, Cin) int8 pack, whose
//     K-contiguous rows are the B operand's "col" order, by 16-byte cp.async
//     into one of two buffers (int8_common.cuh::stage_weights);
//   - per tap a warp does one ldmatrix.x4 for A, COT / 16 for B and COT / 8
//     mma. The next chunk's weights (cp.async) and activations (register
//     loads) are in flight during this chunk's mma.
// A warp whose output row has no active site skips its mma (its outputs are
// multiplied by 0); a tile whose output mask is all zero writes zeros and
// stops. The int32 sums then go through the epilogue (int8_common.cuh::
// epilogue2, on pairs of output channels): the residual of the tile's
// active sites arrives in shared memory by 16-byte cp.async issued before
// the K loop, each thread finishes its accumulators in place there (an
// inactive site is written as 0 without the arithmetic or its residual),
// and the bf16 tile leaves as 16-byte stores.
//
// What bounds it on the card: at the masked convs the bytes. The function
// needs x only under the active sites' 3x3 windows, but a live tile reads
// its whole haloed patch, so at the sparse 1440^2 stage the kernel reads
// most of x (chip_smoke.py phase 6 prints each shape's bound and share of
// live tiles); at the dense 256-channel convs the issue rate of mma.sync,
// which reaches only part of the int8 peak that wgmma with TMA would (later
// work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps, one output row each
constexpr int kTH = 8, kTW = 16;  // output tile (sites)
constexpr int kChunk = 32;        // input channels per K chunk
constexpr int kXStride = 48;      // patch bytes per site

template <int COT, int STRIDE>
struct Tile {
  static constexpr int kPH = (kTH - 1) * STRIDE + 3;  // input patch
  static constexpr int kPW = (kTW - 1) * STRIDE + 3;
  static constexpr int kEven = (kPW + 1) / 2;  // stride 2: even columns
  static constexpr int kXBytes = kPH * kPW * kXStride;
  static constexpr int kWBytes = 9 * COT * kChunk;  // one chunk's weights
  // 16-byte input loads per thread and chunk
  static constexpr int kLoads = (kPH * kPW * 4 + kThreads - 1) / kThreads;
  static constexpr int kNF = COT / 8;          // n8 fragments
  static constexpr int kOStride = COT * 2 + 16;  // epilogue bytes per site
  static constexpr int kMask = 2 * kWBytes + kXBytes;  // float mask[128]
  static constexpr int kEo = kMask + kTH * kTW * 4;    // epilogue tile
  static constexpr int kSmem = kEo + kTH * kTW * kOStride;
  // blocks an SM: at stride 1 the input prefetch takes 12 registers, and 32
  // output channels half the accumulators; stride 2 (36 registers of input)
  // spills below 128 registers a thread
  static constexpr int kMinBlocks = STRIDE == 2 ? 2 : COT == 32 ? 4 : 3;
};

// the patch column that input column `c` of the tile's patch is kept at
template <int STRIDE, int EVEN>
__device__ __forceinline__ int patch_col(int c) {
  return STRIDE == 1 ? c : (c & 1) ? EVEN + (c >> 1) : c >> 1;
}

template <int COT, int STRIDE>
__global__ void __launch_bounds__(kThreads, Tile<COT, STRIDE>::kMinBlocks)
int8_conv_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wp,
    const float* __restrict__ inv_s_ptr, const float* __restrict__ dq,
    const float* __restrict__ shift, const __nv_bfloat16* __restrict__ mask,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    int H, int W, int cin, int Ho, int Wo, int cout, int act) {
  using T = Tile<COT, STRIDE>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem + 2 * T::kWBytes;  // after the two weight buffers
  float* ms = reinterpret_cast<float*>(smem + T::kMask);
  unsigned char* eo = smem + T::kEo;  // the residual, then the output tile

  const int n_co_tiles = cout / COT;
  const int b = blockIdx.z / n_co_tiles;
  const int co_base = (blockIdx.z % n_co_tiles) * COT;
  const int oy0 = blockIdx.y * kTH, ox0 = blockIdx.x * kTW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto out_site = [&](int s) -> int64_t {  // tile site -> output site
    const int oy = oy0 + s / kTW, ox = ox0 + s % kTW;  // (-1 outside)
    return oy < Ho && ox < Wo ? ((int64_t)b * Ho + oy) * Wo + ox : -1;
  };

  // the tile's output mask (0 outside the image, 1 without a mask)
  bool live = false;
  if (tid < kTH * kTW) {
    const int64_t site = out_site(tid);
    float m = 0.f;
    if (site >= 0) m = mask ? __bfloat162float(mask[site]) : 1.f;
    ms[tid] = m;
    live = m != 0.f;
  }
  if (!__syncthreads_or(live)) {
    for (int i = tid; i < kTH * kTW * (COT / 8); i += kThreads) {
      const int64_t site = out_site(i / (COT / 8));
      const uint4 zero = make_uint4(0, 0, 0, 0);
      if (site >= 0)
        *reinterpret_cast<uint4*>(out + site * cout + co_base +
                                  (i % (COT / 8)) * 8) = zero;
    }
    return;
  }
  const bool row_live =
      __any_sync(0xffffffffu, lane < kTW && ms[warp * kTW + lane] != 0.f);
  if (res) {  // the residual at the active sites, in flight during the K loop
    for (int i = tid; i < kTH * kTW * (COT / 8); i += kThreads) {
      const int s = i / (COT / 8), part = i % (COT / 8);
      const int64_t site = out_site(s);
      if (site >= 0 && ms[s] != 0.f)
        cp_async16(eo + s * T::kOStride + part * 16,
                   res + site * cout + co_base + part * 8);
    }
    cp_async_commit();
  }

  const float inv_s = *inv_s_ptr;
  const int iy0 = oy0 * STRIDE - 1, ix0 = ox0 * STRIDE - 1;
  uint4 pre[T::kLoads];
  auto load_x = [&](int c0) {  // 16-byte loads of one chunk into registers
#pragma unroll
    for (int k = 0; k < T::kLoads; ++k) {
      const int i = tid + k * kThreads, s = i >> 2;
      const int iy = iy0 + s / T::kPW, ix = ix0 + s % T::kPW;
      pre[k] = make_uint4(0, 0, 0, 0);  // zero padding outside the image
      if (i < T::kPH * T::kPW * 4 && iy >= 0 && iy < H && ix >= 0 && ix < W)
        pre[k] = __ldg(reinterpret_cast<const uint4*>(
            x + (((int64_t)b * H + iy) * W + ix) * cin + c0 + (i & 3) * 8));
    }
  };
  auto store_x = [&]() {  // ... quantized into the patch
#pragma unroll
    for (int k = 0; k < T::kLoads; ++k) {
      const int i = tid + k * kThreads, s = i >> 2;
      if (i < T::kPH * T::kPW * 4) {
        const int py = s / T::kPW, px = s % T::kPW;
        *reinterpret_cast<uint2*>(
            xs + (py * T::kPW + patch_col<STRIDE, T::kEven>(px)) * kXStride +
            (i & 3) * 8) = quant_8(pre[k], inv_s);
      }
    }
  };
  const int8_t* wtile = wp + (int64_t)co_base * cin;

  int acc[T::kNF][4];
#pragma unroll
  for (int j = 0; j < T::kNF; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  // A rows of this lane: output column m of the warp's row, patch row base
  const int m = a_row(lane);
  const int a_off = a_half(lane) * 16;
  const int b_co = b_row(lane), b_hf = b_half(lane);

  const int n_chunks = cin / kChunk;
  load_x(0);
  stage_weights<kThreads>(smem, wtile, COT, cin, cout);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // every warp is done with the previous chunk
    store_x();
    if (c + 1 < n_chunks) {
      stage_weights<kThreads>(smem + ((c + 1) & 1) * T::kWBytes,
                              wtile + (c + 1) * kChunk, COT, cin, cout);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the patch and this chunk's weights are visible
    if (c + 1 < n_chunks) load_x((c + 1) * kChunk);
    if (!row_live) continue;
    const unsigned char* wbuf = smem + (c & 1) * T::kWBytes;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const int col = STRIDE == 1 ? m + kx
                                  : (kx == 1 ? T::kEven + m : m + (kx >> 1));
      uint32_t a[4];
      ldmatrix_x4(a, xs + ((warp * STRIDE + ky) * T::kPW + col) * kXStride +
                         a_off);
#pragma unroll
      for (int p = 0; p < COT / 16; ++p) {
        uint32_t bf[4];
        ldmatrix_x4(bf, wbuf + swz32(tap * COT + p * 16 + b_co, b_hf));
        mma_s8(acc[2 * p], a, bf[0], bf[1]);
        mma_s8(acc[2 * p + 1], a, bf[2], bf[3]);
      }
    }
  }

  if (res) {  // the residual tile has landed (every group is waited for)
    __syncthreads();
  }
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int j = 0; j < T::kNF; ++j) {
    const int co = j * 8 + 2 * t;  // within the tile's COT
    const float2 d = make_float2(__ldg(dq + co_base + co),
                                 __ldg(dq + co_base + co + 1));
    const float2 sh = make_float2(__ldg(shift + co_base + co),
                                  __ldg(shift + co_base + co + 1));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = warp * kTW + g + 8 * h;
      const float mv = ms[s];
      auto* p =
          reinterpret_cast<__nv_bfloat162*>(eo + s * T::kOStride + co * 2);
      // an inactive site is 0, the mask's product
      *p = mv == 0.f ? zero
                     : epilogue2(acc[j][2 * h], acc[j][2 * h + 1], d, sh,
                                 res != nullptr, res ? *p : zero, act,
                                 __float2bfloat162_rn(mv));
    }
  }
  __syncthreads();
  for (int i = tid; i < kTH * kTW * (COT / 8); i += kThreads) {
    const int s = i / (COT / 8), part = i % (COT / 8);
    const int64_t site = out_site(s);
    if (site >= 0)
      *reinterpret_cast<uint4*>(out + site * cout + co_base + part * 8) =
          *reinterpret_cast<const uint4*>(eo + s * T::kOStride + part * 16);
  }
}

template <int COT, int STRIDE>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* wp,
                   const float* inv_s, const float* dq, const float* shift,
                   const __nv_bfloat16* mask, const __nv_bfloat16* res,
                   __nv_bfloat16* out, int b, int h, int w_, int cin, int ho,
                   int wo, int cout, int act, cudaStream_t s) {
  using T = Tile<COT, STRIDE>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_conv_kernel<COT, STRIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((wo + kTW - 1) / kTW, (ho + kTH - 1) / kTH,
                  b * (cout / COT));
  int8_conv_kernel<COT, STRIDE><<<grid, kThreads, T::kSmem, s>>>(
      x, wp, inv_s, dq, shift, mask, res, out, h, w_, cin, ho, wo, cout, act);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin) bf16; wp (9, Cout, Cin) int8, the HWIO kernel packed
// K-contiguous (ops/quant.py::pack_kernel); inv_s one f32 on the device;
// dq, shift (Cout,) f32; mask (B, Ho, Wo) bf16 or null; res
// (B, Ho, Wo, Cout) bf16 or null; out (B, Ho, Wo, Cout) bf16. All
// contiguous, x, wp, res and out 16-byte aligned; Cin % 32 == 0,
// Cout % 32 == 0. Returns the launch's cudaError_t.
extern "C" int int8_conv_bf16(const void* x, const void* wp,
                              const float* inv_s, const float* dq,
                              const float* shift, const void* mask,
                              const void* res, void* out, int b, int h, int w_,
                              int cin, int ho, int wo, int cout, int stride,
                              int act, void* stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wi = static_cast<const int8_t*>(wp);
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
