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
// The per-input-channel variant (PC, int8_conv_pc_bf16 / int8_conv_pc_f32)
// takes a (Cin,) vector of inverse scales and quantizes channel c with its
// own: q_c = clip(rint(x_c * inv_s[c]), -127, 127) (the plain version's
// `quantize` broadcasting a vector). It serves the int8 CenterHead's wide
// SepHead conv, whose activation scale the JAX package takes per input
// channel (center_head.py:145-172). The vector is copied into shared memory
// when a block starts, and each 16-byte unit is quantized with its channels'
// scales from there. Everything else is the per-tensor kernel.
//
// Replaces the TPU kernel
// pillarnet_lts_tpu/ops/pallas/s2d_conv_kernel.py::s2d_subm_conv_int8 (body
// _kernel :50). That kernel exists for the 32-channel stride-1 stage in the
// TPU's space-to-depth lane layout; here the same math runs in plain NHWC and
// also serves every other int8 conv of the deploy path (the strided down
// convs, conv5 and the neck), because PyTorch has no int8 convolution on
// CUDA.
//
// Design: a persistent, warp-specialised implicit GEMM on wgmma (s8 x s8 ->
// s32, both operands in shared memory), int8_conv_kernel_ws. It replaces a
// kernel with one block per 8 x 16 output tile and per 64 output channels
// on mma.sync.m16n8k32, which read and quantized a tile's input patch once
// for every 64 output channels (the channel tiles were the outermost grid
// dimension, so L2 had dropped the patch before the next one came),
// overlapped nothing inside a block at Cin = 32 (one K chunk: load, sync,
// multiply, store in turn), reached only part of the int8 peak, and took
// every dead tile through its prologue.
//
//   - Work: a tile is TR output rows x 64 columns; a work item is a tile and
//     a block of NT output channels, the blocks of one tile adjacent items.
//     One block an SM walks the items i, i + grid, ...: a tile's input
//     patch is read from device memory and quantized once for all the
//     output channels (a second block of channels finds it in L2).
//   - Loader warpgroup (setmaxnreg down): it keeps the output masks of its
//     next items in flight (one decode an item) and ORs a tile's sites; a
//     dead tile (mask all zero, or outside the image) it writes as zeros
//     with 16-byte stores and never passes on. For a live tile it keeps a
//     ring of 1-4 raw stages loading by TMA, each the haloed patch of one
//     32-channel K chunk ((TR + 2) x 66 sites at stride 1, 5 x 129 at stride
//     2; TMA fills the part outside the image with zeros), and the weights:
//     resident for the whole launch (all of 9 x Cin x Cout, where it fits
//     beside two raw stages) or through a ring of weight stages (3 taps x NT
//     channels x 32 of K each, by TMA from the (9, Cout, Cin) pack).
//   - Quantizer warpgroup (up to NT 128): the oldest raw stage -> a ring of
//     2-4 A stages: the int8 codes in two planes of 16-byte site rows (K
//     bytes 0-15 and 16-31; at stride 2 a row keeps its even columns first,
//     so a tap's 64 sites stay consecutive), with the tile's mask. At NT 256
//     (two 128-register accumulators leave no room for it) the consumers
//     quantize into a double buffer themselves.
//   - Two consumer warpgroups (setmaxnreg up), consumer wg on the tile's
//     rows wg, wg + 2, ...: per row and tap one wgmma.m64nNTk32, A a
//     descriptor into the codes at the tap's shift (any site can start an
//     operand of this layout, so one quantized patch serves all 9 taps and
//     every row) and B the weights; one group per 3 taps, a chunk's codes
//     released once its groups are done. Full and empty mbarriers pace every
//     ring, so the loads and the quantization of the next chunks overlap
//     the tensor cores, also at Cin = 32 where K is one chunk.
//   - Epilogue from the accumulators, row by row: each thread finishes its
//     pairs of output channels with int8_common.cuh::epilogue2 /
//     epilogue2_f32 (the residual of the active sites of the next rows in
//     flight; an inactive site is written as 0 without the arithmetic) into
//     a staging slice of 64 bytes a site, which leaves as 16-byte stores of
//     whole site rows.
//   The tile configuration of a call comes from what it shows (make_plan):
//   NT is the largest of 256 (bf16 at stride 1) / 128 / 64 / 32 that
//   divides Cout; TR (tile_rows) is 8 at NT <= 64 in bf16 at stride 1 (the
//   masked stages' narrow convs: 4 rows a consumer, the haloed patch 10 / 8
//   of the tile's rows where 2-row tiles read 4 / 2, and an item's fixed
//   costs spread over 4 times the sites), 4 at NT 128 or f32 NT 32, else 2
//   (the registers of a row's accumulator, NT / 2, and the raw stage's size
//   decide); the rings are as deep as shared memory allows after the
//   resident weights, the per-channel scales and f32's twice larger raw
//   stages. Every call of the four variants fits (Cin <= 4096 with
//   per-channel scales). The int32 sums are exact in any order and the
//   epilogue is the same code as before, so the output is byte-identical to
//   the replaced kernel's.
//
// What bounds it on the card: at the masked convs (conv1-conv3 of the
// flagship) the bytes: the whole output is written (dead tiles as zeros) and
// a live tile reads its whole haloed patch; at the dense 256-channel convs
// (conv4, conv5, the neck) the int8 operations, where a block's 128 sites
// take each weight byte once from L2 (a 128 x NT tile: 32 bytes of weights
// a clock and SM at the int8 peak, near what L2 delivers). The f32 variant
// moves twice the activation bytes of the bf16 one at the same shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "int8_common.cuh"
#include "int8_wgmma.cuh"

namespace {

constexpr int kChunk = 32;        // input channels a K step (wgmma's k32)
constexpr int kTW = 64;           // output columns a tile: wgmma's M
constexpr int kMaxRS = 4;         // raw patch stages
constexpr int kMaxWS = 12;        // weight stages of the ring
constexpr int kSmemMax = 232448;  // shared memory of an H100 block
constexpr int kMaxAS = 4;         // quantized patch stages (a ring)
constexpr int kFront = 1024;      // the mbarriers, at the front
constexpr int kTail = 1024;       // unused, after the last stage
constexpr int kMaxCinPC = 4096;   // the per-channel scales in shared memory
constexpr int kMaxCoutDq = 1024;  // dq and shift in shared memory up to this

// Activations of type T: kVec channels a 16-byte unit, quantized from
// shared memory (codes16, codes16_pc: with a scale per channel).
template <typename T>
struct Act;

template <>
struct Act<__nv_bfloat16> {
  static constexpr int kVec = 8;
  using Pair = __nv_bfloat162;
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ uint2 codes16(uint4 raw, float inv_s) {
    return quant_8(raw, inv_s);
  }
  static __device__ __forceinline__ uint2 codes16_pc(uint4 raw,
                                                     const float* s) {
    return quant_8v(raw, s);
  }
};

template <>
struct Act<float> {
  static constexpr int kVec = 4;
  using Pair = float2;
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float4 floats(uint4 r) {
    return make_float4(__uint_as_float(r.x), __uint_as_float(r.y),
                       __uint_as_float(r.z), __uint_as_float(r.w));
  }
  static __device__ __forceinline__ uint32_t codes16(uint4 raw, float inv_s) {
    return quant_f4(floats(raw), inv_s);
  }
  static __device__ __forceinline__ uint32_t codes16_pc(uint4 raw,
                                                        const float* s) {
    return quant_f4v(floats(raw), s);
  }
};

// Output rows a tile, from the activation bytes `es`, the stride and NT: a
// consumer keeps a row's accumulator in NT / 2 registers, and the raw stage
// holds (rows + 2) x 66 sites of 32 channels.
__host__ __device__ constexpr int tile_rows(int es, int s, int nt) {
  return s == 2         ? 2
         : es == 4      ? (nt <= 32 ? 4 : 2)
         : nt <= 64     ? 8
         : nt == 128    ? 4
                        : 2;
}

// the patch column that input column `c` of a tile's patch is kept at: at
// stride 2 the even columns first, then the odd ones
template <int S, int EVEN>
__device__ __forceinline__ int patch_col(int c) {
  return S == 1 ? c : (c & 1) ? EVEN + (c >> 1) : c >> 1;
}

// What travels with a chunk: the tile's output mask (first chunk of an
// item; 0 outside the image) and the work item (-1: no more work).
template <int TR>
struct Hdr {
  float mask[TR * kTW];
  int item;
  int pad[3];
};

__host__ __device__ constexpr int align128(int v) { return (v + 127) & ~127; }
__host__ __device__ constexpr int hdr_bytes(int tr) {
  return tr * kTW * 4 + 16;
}
// a tile's input patch at stride s: rows and columns
__host__ __device__ constexpr int patch_rows(int tr, int s) {
  return (tr - 1) * s + 3;
}
__host__ __device__ constexpr int patch_cols(int s) {
  return (kTW - 1) * s + 3;
}
// a raw stage: the TMA box (the patch at 32 channels of `es` bytes), then
// the header
__host__ __device__ constexpr int raw_box(int es, int tr, int s) {
  return patch_rows(tr, s) * patch_cols(s) * kChunk * es;
}
__host__ __device__ constexpr int raw_stage(int es, int tr, int s) {
  return align128(raw_box(es, tr, s) + hdr_bytes(tr));
}
// an A buffer: the patch's int8 codes in two planes (K bytes 0-15, 16-31)
// of 16-byte site rows
__host__ __device__ constexpr int a_plane(int tr, int s) {
  return patch_rows(tr, s) * patch_cols(s) * 16;
}
__host__ __device__ constexpr int a_codes(int tr, int s) {
  return align128(2 * a_plane(tr, s));
}
// a weight stage: two planes of 3 taps x nt output channels
__host__ __device__ constexpr int w_plane(int nt) { return 3 * nt * 16; }
__host__ __device__ constexpr int w_stage(int nt) { return 2 * w_plane(nt); }
// the epilogue's staging: a consumer's 64 sites x 64 bytes (+16: banks)
constexpr int kEpiPitch = 64 + 16;
constexpr int kEpi = kTW * kEpiPitch;
// an A stage of the ring between a quantizer and the consumers: the codes,
// then the header
__host__ __device__ constexpr int a_stage(int tr, int s) {
  return a_codes(tr, s) + align128(hdr_bytes(tr));
}
// a warpgroup apart quantizes the patches into a ring of A stages up to 128
// output channels a work item; at 256 (two 128-register accumulators) the
// consumers quantize into a double buffer themselves
__host__ __device__ constexpr bool quantizer(int nt) { return nt <= 128; }

// The tile configuration of one call, from what it shows: activation bytes
// `es`, per-channel scales, the channels and the stride. nt: output
// channels of a work item (wgmma's N); rs, as, ws: raw, quantized (the
// ring, with a quantizer) and weight stages; resident: the whole packed
// kernel stays in shared memory (no weight ring); nt 0: nothing fits (not
// met for Cin <= 4096).
struct Plan {
  int nt, rs, as, ws, resident, smem;
};

inline Plan make_plan(int es, bool pc, int cin, int cout, int stride) {
  const int all_w = 9 * cin * cout;
  const int max_nt = es == 2 && stride == 1 ? 256 : 128;
  for (int nt = max_nt; nt >= 32; nt /= 2) {
    if (cout % nt) continue;
    const bool q = quantizer(nt);
    const int tr = tile_rows(es, stride, nt);
    const int raw = raw_stage(es, tr, stride);
    const int ast = q ? a_stage(tr, stride) : 0;
    const int fixed = kFront + (cout <= kMaxCoutDq ? align128(8 * cout) : 0) +
                      (pc ? align128(4 * cin) : 0) + 2 * kEpi +
                      (q ? 0 : 2 * a_codes(tr, stride)) + 128 + kTail;
    // resident where two raw stages fit beside the whole kernel
    Plan p{nt, 1, 2, 2, all_w + 2 * raw + 2 * ast + fixed <= kSmemMax, 0};
    auto bytes = [&](const Plan& t) {
      return fixed + t.rs * raw + t.as * ast +
             (t.resident ? all_w : t.ws * w_stage(nt));
    };
    if (bytes(p) > kSmemMax) continue;
    // grow the rings while they fit: a second raw stage first, then
    // weight stages, quantized stages and more raw stages
    const int grow[][3] = {{2, 2, 2}, {2, 2, 3}, {2, 3, 3}, {2, 3, 6},
                           {3, 3, 6}, {3, 4, 9}, {4, 4, 12}};
    for (const auto& g : grow) {
      Plan t = p;
      t.rs = g[0];
      t.as = g[1];
      t.ws = t.resident ? 0 : g[2];
      if (bytes(t) <= kSmemMax) p = t;
    }
    if (p.resident) p.ws = 0;
    if (!q) p.as = 0;
    p.smem = bytes(p);
    return p;
  }
  return {0, 0, 0, 0, 0, 0};
}

// the descriptor of an operand of planes `plane` bytes apart (no swizzle:
// LBO the next plane along K, SBO the next 8 rows)
__device__ __forceinline__ uint64_t operand(const void* p, int plane) {
  return wgmma_desc(p, plane, 128);
}

template <typename T, int S, int NT>
__global__ void __launch_bounds__(quantizer(NT) ? 512 : 384, 1)
    int8_conv_kernel_ws(const __grid_constant__ CUtensorMap tmx,
                        const __grid_constant__ CUtensorMap tmw,
                        const float* __restrict__ inv_s_ptr,
                        const float* __restrict__ dq,
                        const float* __restrict__ shift,
                        const T* __restrict__ mask, const T* __restrict__ res,
                        T* __restrict__ out, int B, int Ho, int Wo, int cin,
                        int cout, int act, int pc, int n_rs, int n_as,
                        int n_ws, int resident) {
  using A = Act<T>;
  using Pair = typename A::Pair;
  // warpgroups: the two consumers, the quantizer (up to NT 128), the loader
  constexpr bool kQ = quantizer(NT);
  constexpr int kThreads = kQ ? 512 : 384;
  constexpr int kLoader = kThreads - 128;  // the loader's first thread
  // setmaxnreg: the loader (and the quantizer) give registers to the
  // consumers, within the block's allocation at launch (512 threads at 128,
  // 384 at 168)
  constexpr int kLoaderRegs = kQ ? 40 : 56, kQuantRegs = 64;
  constexpr int kConsumerRegs = kQ ? 200 : 224;
  static_assert(128 * kLoaderRegs + (kQ ? 128 * kQuantRegs : 0) +
                        256 * kConsumerRegs <=
                    kThreads * (kQ ? 128 : 168),
                "setmaxnreg beyond the block's registers");
  constexpr int TR = tile_rows((int)sizeof(T), S, NT);
  constexpr int kRows = TR / 2;  // output rows a consumer: wg, wg + 2, ...
  constexpr int kSites = TR * kTW / 128;  // sites a loader thread
  constexpr int kLook = 8 / TR;  // work items whose masks are in flight
  // rows whose residual is in flight: two where their registers fit
  constexpr int kRR = kRows > 1 && NT * (int)sizeof(T) <= 128 ? 2 : 1;
  using H = Hdr<TR>;
  constexpr int kPH = patch_rows(TR, S), kPW = patch_cols(S);
  constexpr int kEven = (kPW + 1) / 2;
  constexpr int kBox = raw_box((int)sizeof(T), TR, S);
  constexpr int kRaw = raw_stage((int)sizeof(T), TR, S);
  constexpr int kAPlane = a_plane(TR, S), kACodes = a_codes(TR, S);
  constexpr int kAStage = a_stage(TR, S);
  constexpr int kWPlane = w_plane(NT), kWStage = w_stage(NT);
  constexpr int kOParts = NT * (int)sizeof(T) / 16;  // 16-byte output parts
  constexpr int kSC = 64 / (int)sizeof(T);  // channels an epilogue slice
  constexpr int kParts = kChunk / A::kVec;  // 16-byte units a site
  extern __shared__ __align__(128) unsigned char ws_smem[];
  unsigned char* sm = ws_smem + ((128 - (smem_u32(ws_smem) & 127)) & 127);
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* raw_empty = raw_full + kMaxRS;
  uint64_t* a_full = raw_empty + kMaxRS;
  uint64_t* a_empty = a_full + kMaxAS;
  uint64_t* w_full = a_empty + kMaxAS;
  uint64_t* w_empty = w_full + kMaxWS;
  const bool dq_smem = cout <= kMaxCoutDq;
  float* sdq = reinterpret_cast<float*>(sm + kFront);
  float* ssh = sdq + cout;
  float* sv = reinterpret_cast<float*>(  // PC: the scales
      sm + kFront + (dq_smem ? align128(8 * cout) : 0));
  unsigned char* ebase = reinterpret_cast<unsigned char*>(sv) +
                         (pc ? align128(4 * cin) : 0);
  unsigned char* abase = ebase + 2 * kEpi;  // A ring, or double buffer
  unsigned char* wbase = abase + (kQ ? n_as * kAStage : 2 * kACodes);
  unsigned char* rbase = wbase + (resident ? 9 * cin * cout : n_ws * kWStage);

  const int tid = threadIdx.x;
  const int n_chunks = cin / kChunk, n_nb = cout / NT;
  const int n_tr = (Ho + TR - 1) / TR, n_tc = (Wo + kTW - 1) / kTW;
  const int n_items = B * n_tr * n_tc * n_nb;
  // work item -> (b, tile row, tile column, block of NT output channels);
  // the blocks of one tile are adjacent items
  auto decode = [&](int item, int& b, int& tr, int& tc, int& nb) {
    nb = item % n_nb;
    int t = item / n_nb;
    tc = t % n_tc;
    t /= n_tc;
    tr = t % n_tr;
    b = t / n_tr;
  };
  // The raw stage at `raw` (chunk c) -> int8 codes in `ab`, by `n` threads
  // from `first`: two planes of 16-byte site rows, at stride 2 the even
  // columns of a row first.
  auto quantize = [&](const unsigned char* raw_stage_p, unsigned char* ab,
                      int c, int first, int n) {
    const float inv_s = pc ? 0.f : *inv_s_ptr;
    const T* raw = reinterpret_cast<const T*>(raw_stage_p);
    constexpr int kUnits = kPH * kPW * kParts;
#pragma unroll 2
    for (int u = tid - first; u < kUnits; u += n) {
      const int r = u / (kPW * kParts), rem = u % (kPW * kParts);
      const int px = rem / kParts, ch = (rem % kParts) * A::kVec;
      const uint4 v = *reinterpret_cast<const uint4*>(
          raw + (r * kPW + px) * kChunk + ch);
      unsigned char* dst = ab + (ch >> 4) * kAPlane +
                           (r * kPW + patch_col<S, kEven>(px)) * 16 +
                           (ch & 15);
      const float* s = sv + c * kChunk + ch;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<uint2*>(dst) =
            pc ? A::codes16_pc(v, s) : A::codes16(v, inv_s);
      else
        *reinterpret_cast<uint32_t*>(dst) =
            pc ? A::codes16_pc(v, s) : A::codes16(v, inv_s);
    }
    fence_proxy_async();  // the codes, visible to wgmma
  };

  if (dq_smem) {
    for (int i = tid; i < cout; i += kThreads) {
      sdq[i] = dq[i];
      ssh[i] = shift[i];
    }
  }
  if (pc) {
    for (int i = tid; i < cin; i += kThreads) sv[i] = inv_s_ptr[i];
  }
  if (tid == 0) {
    for (int i = 0; i < kMaxRS; ++i) {
      mbar_init(raw_full + i, 128);  // every loader thread arrives
      // the quantizer's first thread, or one thread a consumer warpgroup
      mbar_init(raw_empty + i, kQ ? 1 : 2);
    }
    for (int i = 0; i < kMaxAS; ++i) {
      mbar_init(a_full + i, 128);  // every quantizer thread arrives
      mbar_init(a_empty + i, 2);
    }
    for (int i = 0; i < kMaxWS; ++i) {
      mbar_init(w_full + i, 1);
      mbar_init(w_empty + i, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kLoader) {
    // ---- loader warpgroup: masks, dead tiles, TMA loads ----
    regs_dec<kLoaderRegs>();
    const int p = tid - kLoader;  // its sites of a tile: p, p + 128, ...
    const int G = gridDim.x;
    // the output mask at this thread's sites of an item (one decode an item)
    auto masks_of = [&](int item, float (&mm)[kSites]) {
      int b = 0, tr = 0, tc = 0, nb = 0;
      if (item < n_items) decode(item, b, tr, tc, nb);
#pragma unroll
      for (int j = 0; j < kSites; ++j) {
        const int s = p + 128 * j;
        const int oy = tr * TR + s / kTW, ox = tc * kTW + s % kTW;
        mm[j] = item >= n_items || oy >= Ho || ox >= Wo ? 0.f
                : mask ? A::to_float(mask[((int64_t)b * Ho + oy) * Wo + ox])
                       : 1.f;
      }
    };
    // one weight stage (taps 3 ky.. of chunk c, output channels nb NT..):
    // two TMA boxes of the (9, Cout, Cin) pack, K bytes 0-15 and 16-31
    auto load_weights = [&](unsigned char* dst, uint64_t* bar, int nb, int c,
                            int ky) {
      tma_load_3d(dst, &tmw, bar, c * kChunk, nb * NT, 3 * ky);
      tma_load_3d(dst + kWPlane, &tmw, bar, c * kChunk + 16, nb * NT,
                  3 * ky);
    };
    if (resident && p == 0) {  // the whole packed kernel, once
      mbar_arrive_tx(w_full, 9 * cin * cout);
      for (int nb = 0; nb < n_nb; ++nb)
        for (int c = 0; c < n_chunks; ++c)
          for (int ky = 0; ky < 3; ++ky)
            load_weights(wbase + ((nb * n_chunks + c) * 3 + ky) * kWStage,
                         w_full, nb, c, ky);
    }
    // The masks of this block's items come kLook at a time, a batch ahead:
    // `next` is loaded while `cur`'s items are worked through, so no mask
    // load waits on its latency (a register that a load is still filling
    // stalls whatever reads it, a move included).
    float cur[kLook][kSites], next[kLook][kSites];
#pragma unroll
    for (int k = 0; k < kLook; ++k) masks_of(blockIdx.x + k * G, cur[k]);
    int rs = 0, ws = 0, k = -1;
    uint32_t rph = 0, wph = 0;
    for (int item = blockIdx.x; item < n_items; item += G) {
      if (++k == kLook) {
        k = 0;
#pragma unroll
        for (int i = 0; i < kLook; ++i)
#pragma unroll
          for (int j = 0; j < kSites; ++j) cur[i][j] = next[i][j];
      }
      if (k == 0) {
#pragma unroll
        for (int i = 0; i < kLook; ++i)
          masks_of(item + (kLook + i) * G, next[i]);
      }
      float m[kSites];
      bool any = false;
#pragma unroll
      for (int j = 0; j < kSites; ++j) {
        m[j] = cur[0][j];
#pragma unroll
        for (int i = 1; i < kLook; ++i) m[j] = k == i ? cur[i][j] : m[j];
        any |= m[j] != 0.f;
      }
      int b, tr, tc, nb;
      decode(item, b, tr, tc, nb);
      if (!bar_or(1, 128, any)) {  // dead: zeros, wide stores
        for (int i = p; i < TR * kTW * kOParts; i += 128) {
          const int s = i / kOParts, part = i % kOParts;
          const int oy = tr * TR + s / kTW, ox = tc * kTW + s % kTW;
          if (oy < Ho && ox < Wo)
            *reinterpret_cast<uint4*>(
                out + (((int64_t)b * Ho + oy) * Wo + ox) * cout + nb * NT +
                part * (16 / (int)sizeof(T))) = make_uint4(0, 0, 0, 0);
        }
        continue;
      }
      for (int c = 0; c < n_chunks; ++c) {
        mbar_wait(raw_empty + rs, rph ^ 1);
        unsigned char* st = rbase + rs * kRaw;
        if (c == 0) {
          H* h = reinterpret_cast<H*>(st + kBox);
#pragma unroll
          for (int j = 0; j < kSites; ++j) h->mask[p + 128 * j] = m[j];
          if (p == 0) h->item = item;
        }
        // the haloed patch at this chunk's 32 channels, site-major: one TMA
        // box (zeros outside the image)
        if (p == 0) {
          mbar_arrive_tx(raw_full + rs, kBox);
          tma_load_4d(st, &tmx, raw_full + rs, c * kChunk,
                      tc * kTW * S - 1, tr * TR * S - 1, b);
        } else {
          mbar_arrive(raw_full + rs);
        }
        if (++rs == n_rs) {
          rs = 0;
          rph ^= 1;
        }
        if (resident) continue;
        for (int ky = 0; ky < 3; ++ky) {  // this chunk's weights
          mbar_wait(w_empty + ws, wph ^ 1);
          if (p == 0) {
            mbar_arrive_tx(w_full + ws, kWStage);
            load_weights(wbase + ws * kWStage, w_full + ws, nb, c, ky);
          }
          if (++ws == n_ws) {
            ws = 0;
            wph ^= 1;
          }
        }
      }
    }
    mbar_wait(raw_empty + rs, rph ^ 1);  // no more work
    if (p == 0) reinterpret_cast<H*>(rbase + rs * kRaw + kBox)->item = -1;
    mbar_arrive(raw_full + rs);
  } else if (kQ && tid >= 256) {
    // ---- quantizer warpgroup: raw stages -> the A ring ----
    if constexpr (kQ) {
      regs_dec<kQuantRegs>();
      const int p = tid - 256;
      int rs = 0, as = 0, c = 0;
      uint32_t rph = 0, aph = 0;
      while (true) {
        mbar_wait(raw_full + rs, rph);
        const unsigned char* st = rbase + rs * kRaw;
        const H* h = reinterpret_cast<const H*>(st + kBox);
        mbar_wait(a_empty + as, aph ^ 1);
        unsigned char* ab = abase + as * kAStage;
        H* ah = reinterpret_cast<H*>(ab + kACodes);
        // the header travels with an item's first chunk
        const int item = c == 0 ? h->item : 0;
        if (c == 0) {
#pragma unroll
          for (int j = 0; j < kSites; ++j)
            ah->mask[p + 128 * j] = h->mask[p + 128 * j];
          if (p == 0) ah->item = item;
        }
        if (item >= 0) quantize(st, ab, c, 256, 128);
        mbar_arrive(a_full + as);
        if (item < 0) break;
        bar_sync(3, 128);  // every quantizer thread is done with the stage
        if (p == 0) mbar_arrive(raw_empty + rs);
        if (++rs == n_rs) {
          rs = 0;
          rph ^= 1;
        }
        if (++as == n_as) {
          as = 0;
          aph ^= 1;
        }
        if (++c == n_chunks) c = 0;
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma and the epilogue (and, without a
    // quantizer, the quantization into their double buffer) ----
    regs_inc<kConsumerRegs>();
    const int wg = tid >> 7, t = tid & 127, w4 = t >> 5, lane = t & 31;
    const int g = lane >> 2, q = lane & 3;
    unsigned char* stage_out = ebase + wg * kEpi;  // this warpgroup's staging
    const float* dqp = dq_smem ? sdq : dq;
    const float* shp = dq_smem ? ssh : shift;
    // the residual of this thread's pairs, for kRR rows
    Pair rr[kRR][2][NT / 8];
    int rs = 0, ws = 0, abuf = 0;  // abuf: the A stage or buffer
    uint32_t rph = 0, wph = 0, aph = 0;
    int acc[kRows][NT / 2];
    if (resident) mbar_wait(w_full, 0);
    while (true) {
      // the next item's header: in its first A stage (quantizer), or in
      // its first raw stage
      const H* h;
      if constexpr (kQ) {
        mbar_wait(a_full + abuf, aph);
        h = reinterpret_cast<const H*>(abase + abuf * kAStage + kACodes);
      } else {
        mbar_wait(raw_full + rs, rph);
        h = reinterpret_cast<const H*>(rbase + rs * kRaw + kBox);
      }
      const int item = h->item;
      if (item < 0) break;
      int b, tr, tc, nb;
      decode(item, b, tr, tc, nb);
      // row wg + 2 i of the tile, sites 16 w4 + g and + 8 of it
      float mv[kRows][2];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          mv[i][hh] = h->mask[(wg + 2 * i) * kTW + 16 * w4 + g + 8 * hh];
      auto site = [&](int i, int hh) -> int64_t {
        const int oy = tr * TR + wg + 2 * i;
        const int ox = tc * kTW + 16 * w4 + g + 8 * hh;
        return oy < Ho && ox < Wo ? ((int64_t)b * Ho + oy) * Wo + ox : -1;
      };
      // the residual of row i's active sites, in flight while the K loop
      // (or the rows before it) runs (at NT 256 from the last chunk on:
      // registers)
      auto load_residual = [&](int i) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int64_t st = site(i, hh);
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) {
            Pair z;
            if constexpr (sizeof(T) == 2)
              z = __float2bfloat162_rn(0.f);
            else
              z = make_float2(0.f, 0.f);
            if (res != nullptr && st >= 0 && mv[i][hh] != 0.f)
              z = *reinterpret_cast<const Pair*>(res + st * cout + nb * NT +
                                                 8 * j + 2 * q);
            rr[i % kRR][hh][j] = z;
          }
        }
      };
      if constexpr (NT <= 128) {
#pragma unroll
        for (int i = 0; i < kRR; ++i) load_residual(i);
      }
      int prev_ws = -1, prev_a = -1;
      for (int c = 0; c < n_chunks; ++c) {
        const unsigned char* ab;
        if constexpr (kQ) {
          if (c > 0) mbar_wait(a_full + abuf, aph);
          ab = abase + abuf * kAStage;
        } else {
          if (c > 0) mbar_wait(raw_full + rs, rph);
          // both warpgroups' groups that read this buffer two chunks ago
          // are done: then both quantize the patch into it, once
          wgmma_wait<3>();
          bar_sync(2, 256);
          quantize(rbase + rs * kRaw, abase + abuf * kACodes, c, 0, 256);
          bar_sync(2, 256);
          if (t == 0) mbar_arrive(raw_empty + rs);
          if (++rs == n_rs) {
            rs = 0;
            rph ^= 1;
          }
          ab = abase + abuf * kACodes;
        }
        for (int ky = 0; ky < 3; ++ky) {
          const unsigned char* wb;
          if (resident) {
            wb = wbase + ((nb * n_chunks + c) * 3 + ky) * kWStage;
          } else {
            mbar_wait(w_full + ws, wph);
            wb = wbase + ws * kWStage;
          }
          wgmma_fence();
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            // output row wg + 2 i starts at patch row (wg + 2 i) * S
            const unsigned char* arow = ab + (wg + 2 * i) * S * kPW * 16;
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
              const int col = S == 1 ? kx : kx == 1 ? kEven : kx >> 1;
              wgmma_s8(acc[i],
                       operand(arow + (ky * kPW + col) * 16, kAPlane),
                       operand(wb + kx * NT * 16, kWPlane),
                       (c | ky | kx) != 0);
            }
          }
          wgmma_commit();
          if (!resident) {  // release the weight stage before this one
            wgmma_wait<1>();
            if (prev_ws >= 0 && t == 0) mbar_arrive(w_empty + prev_ws);
            prev_ws = ws;
            if (++ws == n_ws) {
              ws = 0;
              wph ^= 1;
            }
          }
        }
        if (NT > 128 && c == n_chunks - 1) load_residual(0);
        if constexpr (kQ) {
          // release the previous chunk's A stage once its groups are done
          wgmma_wait<3>();
          if (prev_a >= 0 && t == 0) mbar_arrive(a_empty + prev_a);
          prev_a = abuf;
          if (++abuf == n_as) {
            abuf = 0;
            aph ^= 1;
          }
        } else {
          abuf ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc_fence(acc[i]);
      if (t == 0) {
        if (kQ) mbar_arrive(a_empty + prev_a);
        if (!resident) mbar_arrive(w_empty + prev_ws);
      }

      // The epilogue, row by row and kSC channels at a time: each thread's
      // pairs into this warpgroup's staging, then 16-byte stores of whole
      // 64-byte site rows; row i + 2's residual is loaded once row i's is
      // used.
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int oy = tr * TR + wg + 2 * i;
#pragma unroll
        for (int k = 0; k < NT / kSC; ++k) {
#pragma unroll
          for (int jj = 0; jj < kSC / 8; ++jj) {
            const int j = k * (kSC / 8) + jj, co = nb * NT + 8 * j + 2 * q;
            const float2 d = make_float2(dqp[co], dqp[co + 1]);
            const float2 sh = make_float2(shp[co], shp[co + 1]);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              Pair v;
              // an inactive site is 0, the mask's product
              if constexpr (sizeof(T) == 2) {
                v = mv[i][hh] == 0.f
                        ? __float2bfloat162_rn(0.f)
                        : epilogue2(acc[i][4 * j + 2 * hh],
                                    acc[i][4 * j + 2 * hh + 1], d, sh,
                                    res != nullptr, rr[i % kRR][hh][j], act,
                                    __float2bfloat162_rn(mv[i][hh]));
              } else {
                v = mv[i][hh] == 0.f
                        ? make_float2(0.f, 0.f)
                        : epilogue2_f32(acc[i][4 * j + 2 * hh],
                                        acc[i][4 * j + 2 * hh + 1], d, sh,
                                        res != nullptr, rr[i % kRR][hh][j],
                                        act, mv[i][hh]);
              }
              *reinterpret_cast<Pair*>(
                  stage_out + (16 * w4 + g + 8 * hh) * kEpiPitch +
                  (8 * jj + 2 * q) * (int)sizeof(T)) = v;
            }
          }
          if (NT <= 128 && k == NT / kSC - 1 && i + kRR < kRows)
            load_residual(i + kRR);
          bar_sync(4 + wg, 128);
#pragma unroll
          for (int u = t; u < kTW * 4; u += 128) {
            const int m = u >> 2, part = u & 3;
            const int ox = tc * kTW + m;
            if (oy < Ho && ox < Wo)
              *reinterpret_cast<uint4*>(
                  out + (((int64_t)b * Ho + oy) * Wo + ox) * cout + nb * NT +
                  k * kSC + part * (16 / (int)sizeof(T))) =
                  *reinterpret_cast<const uint4*>(stage_out + m * kEpiPitch +
                                                  part * 16);
          }
          bar_sync(4 + wg, 128);
        }
      }
    }
  }
}

// the multiprocessors of the current device (cached per device)
inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < 64 && counts[dev] > 0) return counts[dev];
  int n = 1;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) counts[dev] = n;
  return n;
}

template <typename T, int S, int NT>
cudaError_t launch(const Plan& pl, const T* x, const int8_t* wp,
                   const float* inv_s, const float* dq, const float* shift,
                   const T* mask, const T* res, T* out, int b, int h, int w_,
                   int cin, int ho, int wo, int cout, int act, bool pc,
                   cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_conv_kernel_ws<T, S, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return attr;
  constexpr cuuint64_t es = sizeof(T);
  const cuuint64_t xdims[4] = {(cuuint64_t)cin, (cuuint64_t)w_,
                               (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t xstrides[3] = {cin * es, (cuuint64_t)w_ * cin * es,
                                  (cuuint64_t)h * w_ * cin * es};
  constexpr int TR = tile_rows((int)sizeof(T), S, NT);
  const cuuint32_t xbox[4] = {kChunk, (cuuint32_t)patch_cols(S),
                              (cuuint32_t)patch_rows(TR, S), 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)cin, (cuuint64_t)cout, 9};
  const cuuint64_t wstrides[2] = {(cuuint64_t)cin, (cuuint64_t)cout * cin};
  const cuuint32_t wbox[3] = {16, (cuuint32_t)NT, 3};
  CUtensorMap tmx, tmw;
  if (!make_tensor_map(&tmx,
                       sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                       4, x, xdims, xstrides, xbox) ||
      !make_tensor_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, wp, wdims,
                       wstrides, wbox))
    return cudaErrorInvalidValue;
  const int items = b * ((ho + TR - 1) / TR) * ((wo + kTW - 1) / kTW) *
                    (cout / NT);
  const int grid = std::min(items, sm_count());
  int8_conv_kernel_ws<T, S, NT>
      <<<grid, quantizer(NT) ? 512 : 384, pl.smem, s>>>(
          tmx, tmw, inv_s, dq, shift, mask, res, out, b, ho, wo, cin, cout,
          act, pc ? 1 : 0, pl.rs, pl.as, pl.ws, pl.resident);
  return cudaGetLastError();
}

template <typename T, bool PC>
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
  if ((stride != 1 && stride != 2) || (PC && cin > kMaxCinPC))
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan((int)sizeof(T), PC, cin, cout, stride);
#define K4(S, NT)                                                         \
  launch<T, S, NT>(pl, xt, wi, inv_s, dq, shift, mt, rt, ot, b, h, w_, cin, \
                   ho, wo, cout, act, PC, s)
  cudaError_t err = cudaErrorInvalidValue;  // nt 0: nothing fits
  if (stride == 1) {
    switch (pl.nt) {
      case 32: err = K4(1, 32); break;
      case 64: err = K4(1, 64); break;
      case 128: err = K4(1, 128); break;
      case 256:
        if constexpr (sizeof(T) == 2) err = K4(1, 256);
        break;
    }
  } else {
    switch (pl.nt) {
      case 32: err = K4(2, 32); break;
      case 64: err = K4(2, 64); break;
      case 128: err = K4(2, 128); break;
    }
  }
#undef K4
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
  return run<__nv_bfloat16, false>(x, wp, inv_s, dq, shift, mask, res, out,
                                   b, h, w_, cin, ho, wo, cout, stride, act,
                                   stream);
}

extern "C" int int8_conv_f32(const void* x, const void* wp,
                             const float* inv_s, const float* dq,
                             const float* shift, const void* mask,
                             const void* res, void* out, int b, int h, int w_,
                             int cin, int ho, int wo, int cout, int stride,
                             int act, void* stream) {
  return run<float, false>(x, wp, inv_s, dq, shift, mask, res, out, b, h, w_,
                           cin, ho, wo, cout, stride, act, stream);
}

// The per-input-channel variant (int8_conv_pc_bf16, int8_conv_pc_f32): the
// same arguments, but inv_s is a (Cin,) f32 vector on the device, 16-byte
// aligned, Cin <= 4096; channel c is quantized as
// clip(rint(x_c * inv_s[c]), -127, 127).
extern "C" int int8_conv_pc_bf16(const void* x, const void* wp,
                                 const float* inv_s, const float* dq,
                                 const float* shift, const void* mask,
                                 const void* res, void* out, int b, int h,
                                 int w_, int cin, int ho, int wo, int cout,
                                 int stride, int act, void* stream) {
  return run<__nv_bfloat16, true>(x, wp, inv_s, dq, shift, mask, res, out,
                                  b, h, w_, cin, ho, wo, cout, stride, act,
                                  stream);
}

extern "C" int int8_conv_pc_f32(const void* x, const void* wp,
                                const float* inv_s, const float* dq,
                                const float* shift, const void* mask,
                                const void* res, void* out, int b, int h,
                                int w_, int cin, int ho, int wo, int cout,
                                int stride, int act, void* stream) {
  return run<float, true>(x, wp, inv_s, dq, shift, mask, res, out, b, h, w_,
                          cin, ho, wo, cout, stride, act, stream);
}
