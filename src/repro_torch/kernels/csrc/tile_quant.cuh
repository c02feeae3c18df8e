// 1x128 tile quantizer shared by quant.cu, act_quant.cu and
// grouped_gemm.cu.
//
// A tile's scale is amax * f32(1/448) (1 for an all-zero tile), and every
// value is divided by it (IEEE divide, never a reciprocal multiply) and
// rounded to e4m3 with saturation.  This is exactly the arithmetic of the
// plain PyTorch quantizer, so the payload and the scales are bitwise
// equal to it.  quantize_tile_warp: one warp owns one tile, each lane
// holding 4 consecutive values, and the amax is a warp-shuffle max;
// grouped_gemm.cu applies tile_scale and quantize_value to a tile spread
// over 4 lanes of a wgmma fragment.  Build without --use_fast_math.
#pragma once

#include <cuda_fp8.h>
#include <stdint.h>

namespace repro {

constexpr int kQuantBlock = 128;
constexpr float kFp8MaxRecip = 1.0f / 448.0f;   // rounded to f32

// the scale of a tile whose largest magnitude is amax
__device__ __forceinline__ float tile_scale(float amax) {
  return amax > 0.0f ? __fmul_rn(amax, kFp8MaxRecip) : 1.0f;
}

// one value's e4m3 payload byte under its tile's scale
__device__ __forceinline__ uint32_t quantize_value(float v, float scale) {
  return __nv_cvt_float_to_fp8(__fdiv_rn(v, scale), __NV_SATFINITE, __NV_E4M3);
}

// v[0..3] are this lane's values of the tile; q points at the tile's 128
// payload bytes, s at its scale.
__device__ __forceinline__ void quantize_tile_warp(const float v[4], int lane,
                                                   uint8_t* q, float* s) {
  float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                     fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = tile_scale(amax);
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) packed |= quantize_value(v[i], scale) << (8 * i);
  reinterpret_cast<uint32_t*>(q)[lane] = packed;
  if (lane == 0) *s = scale;
}

}  // namespace repro
