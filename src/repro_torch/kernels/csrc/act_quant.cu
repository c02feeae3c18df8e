// Fused activation -> 1x128 per-tile fp8 quantization.
//
// Replaces: src/repro/kernels/epilogue_kernel.py::act_quantize_pallas, both
// of its input modes.  g, u [M, K] (K % 128 == 0) -> h = silu(g) * u (or
// tanh-gelu(g)) in f32 -> q [M, K] e4m3, s [M, K/128].  The operands are
// bf16 or f32, or (the fused-producer mode) e4m3 with 1x128 scales
// s_g, s_u [M, K/128], dequantized on load as float(q) * s, the
// reference's _dequant_rows.
//
// Bound on the card: bytes.  With bf16 inputs it reads 2 x 2 B and writes
// 1 B per element plus 4 B per 128 elements; with e4m3 inputs it reads
// 2 x 1 B per element plus 2 x 4 B per 128 elements.  An exp or a tanh
// per element is far below the compute roof.  Design: the same
// one-warp-per-tile quantizer as quant.cu, preceded by the activation in
// registers, so h never touches device memory.  A warp's input tile and
// its output tile are the same 1x128 tile, so an fp8 operand's tile needs
// its one scale.  silu is written g * sigmoid(g) and gelu in its tanh
// form, the forms of the plain PyTorch version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"
#include "tile_quant.cuh"

namespace {

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

// 4 e4m3 bytes, dequantized with their tile's scale
__device__ __forceinline__ void load4(const uint8_t* p, float v[4], float scale) {
  const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = __fmul_rn(repro::e4m3_to_float((t >> (8 * i)) & 0xffu), scale);
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, float v[4], float) {
  load4(p, v);
}

__device__ __forceinline__ float silu(float g) {
  const float sig = 1.0f / (1.0f + expf(-g));
  return g * sig;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;   // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.0f + tanhf(inner));
}

// T: float, __nv_bfloat16, or uint8_t for e4m3 operands with scales
// sg, su (unused otherwise)
template <typename T, int ACT>
__global__ void __launch_bounds__(256)
act_quantize_kernel(const T* __restrict__ g, const T* __restrict__ u,
                    const float* __restrict__ sg,
                    const float* __restrict__ su, uint8_t* __restrict__ q,
                    float* __restrict__ s, long long tiles, int K) {
  constexpr bool kFp8 = sizeof(T) == 1;
  const int lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (tile >= tiles) return;
  const int kb = K / repro::kQuantBlock;
  const long long row = tile / kb;
  const int col = (int)(tile % kb) * repro::kQuantBlock;
  const long long off = row * K + col + 4 * lane;
  float gv[4], h[4];
  load4(g + off, gv, kFp8 ? sg[tile] : 1.0f);
  if (ACT == 0) {
    float uv[4];
    load4(u + off, uv, kFp8 ? su[tile] : 1.0f);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = silu(gv[i]) * uv[i];
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = gelu_tanh(gv[i]);
  }
  repro::quantize_tile_warp(h, lane, q + row * K + col, s + tile);
}

template <typename T>
int launch(const void* g, const void* u, const void* sg, const void* su,
           void* q, void* s, int M, int K, int act, cudaStream_t stream) {
  const long long tiles = (long long)M * (K / repro::kQuantBlock);
  const int warps_per_block = 8;
  const unsigned blocks = (unsigned)((tiles + warps_per_block - 1) / warps_per_block);
  if (act == 0) {
    act_quantize_kernel<T, 0><<<blocks, 32 * warps_per_block, 0, stream>>>(
        (const T*)g, (const T*)u, (const float*)sg, (const float*)su,
        (uint8_t*)q, (float*)s, tiles, K);
  } else {
    act_quantize_kernel<T, 1><<<blocks, 32 * warps_per_block, 0, stream>>>(
        (const T*)g, nullptr, (const float*)sg, nullptr, (uint8_t*)q,
        (float*)s, tiles, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// act: 0 = silu_mul (u required), 1 = gelu (u unused).
// in_kind: 0 for f32 inputs, 1 for bf16, 2 for e4m3 with 1x128 scales
// sg (and su for silu_mul); the scales are unused otherwise.
extern "C" int act_quantize(const void* g, const void* u, const void* sg,
                            const void* su, void* q, void* s, int M, int K,
                            int act, int in_kind, void* stream) {
  if (act != 0 && act != 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  switch (in_kind) {
    case 0:
      return launch<float>(g, u, sg, su, q, s, M, K, act, st);
    case 1:
      return launch<__nv_bfloat16>(g, u, sg, su, q, s, M, K, act, st);
    case 2:
      return launch<uint8_t>(g, u, sg, su, q, s, M, K, act, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
