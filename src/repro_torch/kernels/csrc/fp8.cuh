// e4m3 widening helpers shared by wgrad.cu, act_quant.cu and
// grouped_gemm.cu.  Every e4m3 value is an f16 value (and an f32 and a
// bf16 value), so each widening here is exact, NaN included:
// cvt.rn.f16x2.e4m3x2 widens two in one instruction.
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace repro {

// two e4m3 (the low 16 bits of v, low byte first) -> f16x2
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t v) {
  uint32_t r;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(r) : "h"((unsigned short)v));
  return r;
}

// two e4m3 (the low 16 bits of v, low byte first) -> two f32
__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t v) {
  const uint32_t h = e4m3x2_to_f16x2(v);
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
}

}  // namespace repro
