// Tensor-core and fp8 helpers shared by wgrad.cu and act_quant.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace repro {

// one e4m3 byte -> f32, exact (e4m3 is a subset of fp16)
__device__ __forceinline__ float e4m3_to_float(uint32_t byte) {
  const __half_raw h = __nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(byte), __NV_E4M3);
  return __half2float(__half(h));
}

// 4 e4m3 bytes -> 4 bf16 (exact), as two packed bf16x2 words
__device__ __forceinline__ uint2 e4m3x4_to_bf16x4(uint32_t v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(e4m3_to_float(v & 0xffu),
                                            e4m3_to_float((v >> 8) & 0xffu));
  __nv_bfloat162 hi = __floats2bfloat162_rn(e4m3_to_float((v >> 16) & 0xffu),
                                            e4m3_to_float(v >> 24));
  return make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                    *reinterpret_cast<uint32_t*>(&hi));
}

// d += a * b on a 16x8x16 tile: bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace repro
