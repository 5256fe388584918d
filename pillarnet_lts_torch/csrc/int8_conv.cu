// One int8 3x3 conv (padding 1, stride 1 or 2) with the fused eval epilogue,
// for Hopper (sm_90a), on the int8 tensor cores.
//
// Contract: pillarnet_lts_torch/ops/quant.py::int8_conv_bn_act_plain, for
// activations of type T, bf16 (int8_conv_bf16) or f32 (int8_conv_f32).
//   x NHWC -> codes q = clip(rint(x * inv_s), -127, 127) on load (an f32
//   x is quantized itself, never a bf16 copy of it), int32 sums over
//   3x3xCin, then y = acc * dq + shift (two f32 roundings: built with
//   -fmad=false and written with __fmul_rn/__fadd_rn), rounded to T, + the
//   residual, ReLU, times the {0, 1} site mask, each in T (for f32 no
//   rounding to bf16 anywhere).
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
// The activations arrive as 16-byte loads: 8 bf16 or 4 f32 channels
// (Act<T>). A bf16 load is held raw and quantized when it is stored to the
// patch; an f32 chunk is twice the bytes (at stride 2, 18 loads a thread),
// so an f32 load is quantized as it lands and only its 4 codes (one
// register, not four) wait for the store. Only the loads and the epilogue
// differ: the codes in shared memory and the mma core are the same for both.
// A warp whose output row has no active site skips its mma (its outputs are
// multiplied by 0); a tile whose output mask is all zero writes zeros and
// stops. The int32 sums then go through the epilogue (int8_common.cuh::
// epilogue2 / epilogue2_f32, on pairs of output channels): the residual of
// the tile's active sites arrives in shared memory by 16-byte cp.async
// issued before the K loop, each thread finishes its accumulators in place
// there (an inactive site is written as 0 without the arithmetic or its
// residual), and the tile of T leaves as 16-byte stores.
//
// What bounds it on the card: at the masked convs the bytes. The function
// needs x only under the active sites' 3x3 windows, but a live tile reads
// its whole haloed patch, so at the sparse 1440^2 stage the kernel reads
// most of x (chip_smoke.py phase 6 prints each shape's bound and share of
// live tiles); at the dense 256-channel convs the issue rate of mma.sync,
// which reaches only part of the int8 peak that wgmma with TMA would (later
// work). The f32 variant moves twice the activation bytes of the bf16 one
// at the same shapes, and its output tile takes twice the shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps, one output row each
constexpr int kTH = 8, kTW = 16;  // output tile (sites)
constexpr int kChunk = 32;        // input channels per K chunk
constexpr int kXStride = 48;      // patch bytes per site

// How activations of type T load: kVec channels a 16-byte load. A bf16
// load is held raw (Pre) and quantized when stored; an f32 load is
// quantized on arrival, so Pre holds its 4 codes.
template <typename T>
struct Act;

template <>
struct Act<__nv_bfloat16> {
  static constexpr int kVec = 8;
  using Pre = uint4;
  using Codes = uint2;
  static __device__ __forceinline__ Pre zero() {
    return make_uint4(0, 0, 0, 0);
  }
  static __device__ __forceinline__ Pre load(const __nv_bfloat16* p, float) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Codes codes(Pre raw, float inv_s) {
    return quant_8(raw, inv_s);
  }
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};

template <>
struct Act<float> {
  static constexpr int kVec = 4;
  using Pre = uint32_t;
  using Codes = uint32_t;
  static __device__ __forceinline__ Pre zero() { return 0u; }
  static __device__ __forceinline__ Pre load(const float* p, float inv_s) {
    return quant_f4(__ldg(reinterpret_cast<const float4*>(p)), inv_s);
  }
  static __device__ __forceinline__ Codes codes(Pre q, float) { return q; }
  static __device__ __forceinline__ float to_float(float v) { return v; }
};

template <typename T, int COT, int STRIDE>
struct Tile {
  static constexpr int kPH = (kTH - 1) * STRIDE + 3;  // input patch
  static constexpr int kPW = (kTW - 1) * STRIDE + 3;
  static constexpr int kEven = (kPW + 1) / 2;  // stride 2: even columns
  static constexpr int kXBytes = kPH * kPW * kXStride;
  static constexpr int kWBytes = 9 * COT * kChunk;  // one chunk's weights
  // 16-byte input loads per site and chunk, and per thread and chunk
  static constexpr int kParts = kChunk / Act<T>::kVec;
  static constexpr int kLoads =
      (kPH * kPW * kParts + kThreads - 1) / kThreads;
  static constexpr int kOParts = COT / Act<T>::kVec;  // 16-byte output parts
  static constexpr int kNF = COT / 8;          // n8 fragments
  static constexpr int kOStride = COT * (int)sizeof(T) + 16;  // epilogue
  static constexpr int kMask = 2 * kWBytes + kXBytes;  // float mask[128]
  static constexpr int kEo = kMask + kTH * kTW * 4;    // epilogue tile
  static constexpr int kSmem = kEo + kTH * kTW * kOStride;
  // blocks an SM: at stride 1 the bf16 input prefetch takes 12 registers,
  // and 32 output channels half the accumulators; stride 2 (36 registers of
  // bf16 input, 18 of f32 codes) spills below 128 registers a thread. The
  // f32 output tile at 64 channels leaves shared memory for 2 blocks.
  static constexpr int kMinBlocks =
      STRIDE == 2 ? 2 : COT == 32 ? 4 : sizeof(T) == 4 ? 2 : 3;
};

// the patch column that input column `c` of the tile's patch is kept at
template <int STRIDE, int EVEN>
__device__ __forceinline__ int patch_col(int c) {
  return STRIDE == 1 ? c : (c & 1) ? EVEN + (c >> 1) : c >> 1;
}

template <typename T, int COT, int STRIDE>
__global__ void __launch_bounds__(kThreads, Tile<T, COT, STRIDE>::kMinBlocks)
int8_conv_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wp,
    const float* __restrict__ inv_s_ptr, const float* __restrict__ dq,
    const float* __restrict__ shift, const T* __restrict__ mask,
    const T* __restrict__ res, T* __restrict__ out,
    int H, int W, int cin, int Ho, int Wo, int cout, int act) {
  using Tl = Tile<T, COT, STRIDE>;
  using A = Act<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem + 2 * Tl::kWBytes;  // after the two weight buffers
  float* ms = reinterpret_cast<float*>(smem + Tl::kMask);
  unsigned char* eo = smem + Tl::kEo;  // the residual, then the output tile

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
    if (site >= 0) m = mask ? A::to_float(mask[site]) : 1.f;
    ms[tid] = m;
    live = m != 0.f;
  }
  if (!__syncthreads_or(live)) {
    for (int i = tid; i < kTH * kTW * Tl::kOParts; i += kThreads) {
      const int64_t site = out_site(i / Tl::kOParts);
      const uint4 zero = make_uint4(0, 0, 0, 0);
      if (site >= 0)
        *reinterpret_cast<uint4*>(out + site * cout + co_base +
                                  (i % Tl::kOParts) * A::kVec) = zero;
    }
    return;
  }
  const bool row_live =
      __any_sync(0xffffffffu, lane < kTW && ms[warp * kTW + lane] != 0.f);
  if (res) {  // the residual at the active sites, in flight during the K loop
    for (int i = tid; i < kTH * kTW * Tl::kOParts; i += kThreads) {
      const int s = i / Tl::kOParts, part = i % Tl::kOParts;
      const int64_t site = out_site(s);
      if (site >= 0 && ms[s] != 0.f)
        cp_async16(eo + s * Tl::kOStride + part * 16,
                   res + site * cout + co_base + part * A::kVec);
    }
    cp_async_commit();
  }

  const float inv_s = *inv_s_ptr;
  const int iy0 = oy0 * STRIDE - 1, ix0 = ox0 * STRIDE - 1;
  typename A::Pre pre[Tl::kLoads];
  auto load_x = [&](int c0) {  // 16-byte loads of one chunk into registers
#pragma unroll
    for (int k = 0; k < Tl::kLoads; ++k) {
      const int i = tid + k * kThreads, s = i / Tl::kParts;
      const int part = i % Tl::kParts;
      const int iy = iy0 + s / Tl::kPW, ix = ix0 + s % Tl::kPW;
      pre[k] = A::zero();  // zero padding outside the image
      if (i < Tl::kPH * Tl::kPW * Tl::kParts && iy >= 0 && iy < H &&
          ix >= 0 && ix < W)
        pre[k] = A::load(x + (((int64_t)b * H + iy) * W + ix) * cin + c0 +
                             part * A::kVec,
                         inv_s);
    }
  };
  auto store_x = [&]() {  // ... quantized into the patch
#pragma unroll
    for (int k = 0; k < Tl::kLoads; ++k) {
      const int i = tid + k * kThreads, s = i / Tl::kParts;
      const int part = i % Tl::kParts;
      if (i < Tl::kPH * Tl::kPW * Tl::kParts) {
        const int py = s / Tl::kPW, px = s % Tl::kPW;
        *reinterpret_cast<typename A::Codes*>(
            xs + (py * Tl::kPW + patch_col<STRIDE, Tl::kEven>(px)) * kXStride +
            part * A::kVec) = A::codes(pre[k], inv_s);
      }
    }
  };
  const int8_t* wtile = wp + (int64_t)co_base * cin;

  int acc[Tl::kNF][4];
#pragma unroll
  for (int j = 0; j < Tl::kNF; ++j)
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
      stage_weights<kThreads>(smem + ((c + 1) & 1) * Tl::kWBytes,
                              wtile + (c + 1) * kChunk, COT, cin, cout);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the patch and this chunk's weights are visible
    if (c + 1 < n_chunks) load_x((c + 1) * kChunk);
    if (!row_live) continue;
    const unsigned char* wbuf = smem + (c & 1) * Tl::kWBytes;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const int col = STRIDE == 1 ? m + kx
                                  : (kx == 1 ? Tl::kEven + m : m + (kx >> 1));
      uint32_t a[4];
      ldmatrix_x4(a, xs + ((warp * STRIDE + ky) * Tl::kPW + col) * kXStride +
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
#pragma unroll
  for (int j = 0; j < Tl::kNF; ++j) {
    const int co = j * 8 + 2 * t;  // within the tile's COT
    const float2 d = make_float2(__ldg(dq + co_base + co),
                                 __ldg(dq + co_base + co + 1));
    const float2 sh = make_float2(__ldg(shift + co_base + co),
                                  __ldg(shift + co_base + co + 1));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = warp * kTW + g + 8 * h;
      const float mv = ms[s];
      unsigned char* p = eo + s * Tl::kOStride + co * (int)sizeof(T);
      // an inactive site is 0, the mask's product
      if constexpr (sizeof(T) == 2) {
        const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
        auto* q = reinterpret_cast<__nv_bfloat162*>(p);
        *q = mv == 0.f ? zero
                       : epilogue2(acc[j][2 * h], acc[j][2 * h + 1], d, sh,
                                   res != nullptr, res ? *q : zero, act,
                                   __float2bfloat162_rn(mv));
      } else {
        const float2 zero = make_float2(0.f, 0.f);
        auto* q = reinterpret_cast<float2*>(p);
        *q = mv == 0.f ? zero
                       : epilogue2_f32(acc[j][2 * h], acc[j][2 * h + 1], d,
                                       sh, res != nullptr, res ? *q : zero,
                                       act, mv);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kTH * kTW * Tl::kOParts; i += kThreads) {
    const int s = i / Tl::kOParts, part = i % Tl::kOParts;
    const int64_t site = out_site(s);
    if (site >= 0)
      *reinterpret_cast<uint4*>(out + site * cout + co_base +
                                part * A::kVec) =
          *reinterpret_cast<const uint4*>(eo + s * Tl::kOStride + part * 16);
  }
}

template <typename T, int COT, int STRIDE>
cudaError_t launch(const T* x, const int8_t* wp, const float* inv_s,
                   const float* dq, const float* shift, const T* mask,
                   const T* res, T* out, int b, int h, int w_, int cin,
                   int ho, int wo, int cout, int act, cudaStream_t s) {
  using Tl = Tile<T, COT, STRIDE>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_conv_kernel<T, COT, STRIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((wo + kTW - 1) / kTW, (ho + kTH - 1) / kTH,
                  b * (cout / COT));
  int8_conv_kernel<T, COT, STRIDE><<<grid, kThreads, Tl::kSmem, s>>>(
      x, wp, inv_s, dq, shift, mask, res, out, h, w_, cin, ho, wo, cout, act);
  return cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* wp, const float* inv_s, const float* dq,
        const float* shift, const void* mask, const void* res, void* out,
        int b, int h, int w_, int cin, int ho, int wo, int cout, int stride,
        int act, void* stream) {
  const auto* xt = static_cast<const T*>(x);
  const auto* wi = static_cast<const int8_t*>(wp);
  const auto* mt = static_cast<const T*>(mask);
  const auto* rt = static_cast<const T*>(res);
  auto* ot = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b * ho * wo == 0) return 0;
  const bool wide = cout % 64 == 0;
  cudaError_t err;
  if (stride == 1) {
    err = wide ? launch<T, 64, 1>(xt, wi, inv_s, dq, shift, mt, rt, ot, b, h,
                                  w_, cin, ho, wo, cout, act, s)
               : launch<T, 32, 1>(xt, wi, inv_s, dq, shift, mt, rt, ot, b, h,
                                  w_, cin, ho, wo, cout, act, s);
  } else if (stride == 2) {
    err = wide ? launch<T, 64, 2>(xt, wi, inv_s, dq, shift, mt, rt, ot, b, h,
                                  w_, cin, ho, wo, cout, act, s)
               : launch<T, 32, 2>(xt, wi, inv_s, dq, shift, mt, rt, ot, b, h,
                                  w_, cin, ho, wo, cout, act, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

// x (B, H, W, Cin) of T; wp (9, Cout, Cin) int8, the HWIO kernel packed
// K-contiguous (ops/quant.py::pack_kernel); inv_s one f32 on the device;
// dq, shift (Cout,) f32; mask (B, Ho, Wo) of T or null; res
// (B, Ho, Wo, Cout) of T or null; out (B, Ho, Wo, Cout) of T. All
// contiguous, x, wp, res and out 16-byte aligned; Cin % 32 == 0,
// Cout % 32 == 0. T is bf16 (int8_conv_bf16) or f32 (int8_conv_f32).
// Returns the launch's cudaError_t.
extern "C" int int8_conv_bf16(const void* x, const void* wp,
                              const float* inv_s, const float* dq,
                              const float* shift, const void* mask,
                              const void* res, void* out, int b, int h, int w_,
                              int cin, int ho, int wo, int cout, int stride,
                              int act, void* stream) {
  return run<__nv_bfloat16>(x, wp, inv_s, dq, shift, mask, res, out, b, h,
                            w_, cin, ho, wo, cout, stride, act, stream);
}

extern "C" int int8_conv_f32(const void* x, const void* wp,
                             const float* inv_s, const float* dq,
                             const float* shift, const void* mask,
                             const void* res, void* out, int b, int h, int w_,
                             int cin, int ho, int wo, int cout, int stride,
                             int act, void* stream) {
  return run<float>(x, wp, inv_s, dq, shift, mask, res, out, b, h, w_, cin,
                    ho, wo, cout, stride, act, stream);
}
