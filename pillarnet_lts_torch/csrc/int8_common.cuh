// Device helpers shared by the int8 conv kernels (int8_conv.cu,
// int8_stage.cu): quantize on load (bf16 or f32 activations), the epilogue
// of ops/quant.py::int8_conv_bn_act_plain on a pair of output channels (bf16
// or f32), and K5's int8 tensor-core micro-tile (ldmatrix,
// mma.sync.m16n8k32 s8 -> s32, cp.async). The f32 products and sums are written with __fmul_rn /
// __fadd_rn (and the sources build with -fmad=false) so that they round as
// the plain version does.
//
// Operand layouts of mma.m16n8k32 s8 (thread = 4 * g + t in its warp):
//   A (16 sites x 32 channels, row-major): a0 = row g, channels 4t..4t+3;
//     a1 = row g + 8; a2, a3 the same rows at channels 16 + 4t...
//   B (32 channels x 8 output channels, "col": K-contiguous per output
//     channel): b0 = output channel g, channels 4t..4t+3; b1 = 16 + 4t...
//   C (16 x 8 int32): c0, c1 = row g, columns 2t, 2t + 1; c2, c3 = row g + 8.
// One ldmatrix.x4 gives a whole A fragment from 16 rows of 32 bytes, or the
// B fragments of two n8 tiles from 16 output channels' 32 bytes; the lane
// address helpers below say which row and 16-byte half each lane points at.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// clip(rint(v * inv_s), -127, 127): the conversion rounds half to even and
// saturates, so clipping the integer gives what clipping the float does
__device__ __forceinline__ int quant_code(float v, float inv_s) {
  return min(max(__float2int_rn(__fmul_rn(v, inv_s)), -127), 127);
}

// 4 bf16 (one 8-byte load) -> 4 int8 codes in one word, channel 0 lowest
__device__ __forceinline__ int32_t quant_word(uint2 raw, float inv_s) {
  const int q0 = quant_code(__uint_as_float(raw.x << 16), inv_s);
  const int q1 = quant_code(__uint_as_float(raw.x & 0xffff0000u), inv_s);
  const int q2 = quant_code(__uint_as_float(raw.y << 16), inv_s);
  const int q3 = quant_code(__uint_as_float(raw.y & 0xffff0000u), inv_s);
  return (int32_t)((q0 & 0xff) | ((q1 & 0xff) << 8) | ((q2 & 0xff) << 16) |
                   ((uint32_t)(q3 & 0xff) << 24));
}

// 8 bf16 (one 16-byte load) -> 8 int8 codes, channel 0 lowest
__device__ __forceinline__ uint2 quant_8(uint4 raw, float inv_s) {
  return make_uint2(quant_word(make_uint2(raw.x, raw.y), inv_s),
                    quant_word(make_uint2(raw.z, raw.w), inv_s));
}

// quant_word with a scale per channel: 4 bf16 and their 4 inverse scales
__device__ __forceinline__ int32_t quant_word_v(uint2 raw, float4 s) {
  const int q0 = quant_code(__uint_as_float(raw.x << 16), s.x);
  const int q1 = quant_code(__uint_as_float(raw.x & 0xffff0000u), s.y);
  const int q2 = quant_code(__uint_as_float(raw.y << 16), s.z);
  const int q3 = quant_code(__uint_as_float(raw.y & 0xffff0000u), s.w);
  return (int32_t)((q0 & 0xff) | ((q1 & 0xff) << 8) | ((q2 & 0xff) << 16) |
                   ((uint32_t)(q3 & 0xff) << 24));
}

// quant_8 with a scale per channel: s points at the 8 channels' inverse
// scales (16-byte aligned)
__device__ __forceinline__ uint2 quant_8v(uint4 raw, const float* s) {
  return make_uint2(
      quant_word_v(make_uint2(raw.x, raw.y),
                   *reinterpret_cast<const float4*>(s)),
      quant_word_v(make_uint2(raw.z, raw.w),
                   *reinterpret_cast<const float4*>(s + 4)));
}

// Two neighbouring output channels of one site, in the plain version's
// order: bf16(acc * dq + shift) with two f32 roundings each, + the residual
// pair `r` (if `has_res`), ReLU (if `act`), times the site mask `m`. The
// last three run on the bf16 pair, each one correctly rounded bf16
// operation, which is what the plain version's f32 operation and bf16
// rounding give: the f32 sum of two bf16 values is exact unless their
// exponents are 16 or more apart, and then both roundings return the larger
// one; max with 0 and a product with a {0, 1} mask are exact.
__device__ __forceinline__ __nv_bfloat162 epilogue2(
    int acc0, int acc1, float2 dq, float2 shift, bool has_res,
    __nv_bfloat162 r, bool act, __nv_bfloat162 m) {
  __nv_bfloat162 v =
      __floats2bfloat162_rn(__fadd_rn(__fmul_rn((float)acc0, dq.x), shift.x),
                            __fadd_rn(__fmul_rn((float)acc1, dq.y), shift.y));
  if (has_res) v = __hadd2(v, r);
  if (act) v = __hmax2(v, __float2bfloat162_rn(0.f));
  return __hmul2(v, m);
}

// 4 f32 (one 16-byte load) -> 4 int8 codes in one word, channel 0 lowest;
// each value is quantized itself, never a bf16 copy of it
__device__ __forceinline__ uint32_t quant_f4(float4 v, float inv_s) {
  return (uint32_t)((quant_code(v.x, inv_s) & 0xff) |
                    ((quant_code(v.y, inv_s) & 0xff) << 8) |
                    ((quant_code(v.z, inv_s) & 0xff) << 16) |
                    ((uint32_t)(quant_code(v.w, inv_s) & 0xff) << 24));
}

// quant_f4 with a scale per channel: s points at the 4 channels' inverse
// scales (16-byte aligned)
__device__ __forceinline__ uint32_t quant_f4v(float4 v, const float* s) {
  const float4 i = *reinterpret_cast<const float4*>(s);
  return (uint32_t)((quant_code(v.x, i.x) & 0xff) |
                    ((quant_code(v.y, i.y) & 0xff) << 8) |
                    ((quant_code(v.z, i.z) & 0xff) << 16) |
                    ((uint32_t)(quant_code(v.w, i.w) & 0xff) << 24));
}

// epilogue2 for f32 activations: acc * dq + shift, + the residual pair `r`
// (if `has_res`), ReLU (if `act`), times the site mask `m`, each an f32
// operation rounded on its own, as the plain version computes in f32
__device__ __forceinline__ float2 epilogue2_f32(int acc0, int acc1,
                                                float2 dq, float2 shift,
                                                bool has_res, float2 r,
                                                bool act, float m) {
  float2 v = make_float2(__fadd_rn(__fmul_rn((float)acc0, dq.x), shift.x),
                         __fadd_rn(__fmul_rn((float)acc1, dq.y), shift.y));
  if (has_res) v = make_float2(__fadd_rn(v.x, r.x), __fadd_rn(v.y, r.y));
  if (act) v = make_float2(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));
  return make_float2(__fmul_rn(v.x, m), __fmul_rn(v.y, m));
}

// the int8 codes of a bf16 pair, channel 0 in the low byte
__device__ __forceinline__ uint16_t quant_pair(__nv_bfloat162 v,
                                               float inv_s) {
  return (uint16_t)((quant_code(__low2float(v), inv_s) & 0xff) |
                    ((quant_code(__high2float(v), inv_s) & 0xff) << 8));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += A (16 x 32 s8) * B (32 x 8 s8), int32 (wraps; the sums here stay
// below 9 * 512 * 127^2 < 2^31)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ldmatrix.x4 lane roles for an A fragment: the lane points at row
// a_row(lane) of the 16 and at byte 16 * a_half(lane) of its 32
__device__ __forceinline__ int a_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int a_half(int lane) { return lane >> 4; }

// ... and for the B fragments of n8 tiles 2p, 2p + 1: output channel
// 16 p + b_row(lane), byte 16 * b_half(lane); registers 0, 1 are tile 2p's
// b0, b1 and registers 2, 3 tile 2p + 1's
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_half(int lane) { return (lane >> 3) & 1; }

// Rows of 32 int8 in shared memory with their two 16-byte halves swapped
// on every other group of 4 rows: the 8 rows that one ldmatrix phase reads
// (8 consecutive rows, one half) then fall in 8 distinct bank groups.
__device__ __forceinline__ int swz32(int row, int half) {
  return row * 32 + ((half ^ ((row >> 2) & 1)) << 4);
}

// Stage one (9, cot, 32) block of a (.., 9, Cout, Cin) packed kernel into
// `dst` (rows tap * cot + co, swz32 layout) with 16-byte cp.async copies:
// `src` points at output channel co_base, input channel c0 of tap 0;
// rows of one tap are `cin` bytes apart, taps `cout * cin`.
template <int THREADS>
__device__ __forceinline__ void stage_weights(unsigned char* dst,
                                              const int8_t* src, int cot,
                                              int cin, int cout) {
  for (int i = threadIdx.x; i < 9 * cot * 2; i += THREADS) {
    const int half = i & 1, row = i >> 1;
    const int tap = row / cot, co = row % cot;
    cp_async16(dst + swz32(row, half),
               src + ((int64_t)tap * cout + co) * cin + half * 16);
  }
  cp_async_commit();
}

}  // namespace
