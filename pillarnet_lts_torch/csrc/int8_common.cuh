// Device helpers shared by the int8 conv kernels (int8_conv.cu,
// int8_stage.cu): quantize on load, pack int8 words for __dp4a, and the
// per-element epilogue of ops/quant.py::int8_conv_bn_act_plain. The f32
// products and sums are written with __fmul_rn / __fadd_rn (and the sources
// build with -fmad=false) so that they round as the plain version does.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int quant_code(float v, float inv_s) {
  float q = rintf(__fmul_rn(v, inv_s));  // round half to even
  q = fminf(fmaxf(q, -127.f), 127.f);
  return (int)q;
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

// 4 int8 taps of consecutive input channels (`stride` bytes apart in the
// HWIO kernel) -> one word, channel 0 lowest
__device__ __forceinline__ int32_t pack_word(const int8_t* p, int stride) {
  return (int32_t)((uint8_t)p[0] | ((uint32_t)(uint8_t)p[stride] << 8) |
                   ((uint32_t)(uint8_t)p[2 * stride] << 16) |
                   ((uint32_t)(uint8_t)p[3 * stride] << 24));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One output element, in the plain version's order: bf16(acc * dq + shift)
// with two f32 roundings, + the residual `r` (bf16 add, if `has_res`), ReLU
// (if `act`), times the {0, 1} site mask `m` (exact).
__device__ __forceinline__ float epilogue(int acc, float dq, float shift,
                                          bool has_res, float r, bool act,
                                          float m) {
  float v = bf16_round(__fadd_rn(__fmul_rn((float)acc, dq), shift));
  if (has_res) v = bf16_round(v + r);
  if (act) v = fmaxf(v, 0.f);
  return v * m;
}

}  // namespace
