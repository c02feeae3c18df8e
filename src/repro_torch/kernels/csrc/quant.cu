// 1x128 per-tile fp8 activation quantizer.
//
// Replaces: src/repro/kernels/quant_kernel.py::quantize_tilewise_pallas.
// x [M, K] f32 (K % 128 == 0) -> q [M, K] e4m3 and s [M, K/128] f32.
//
// Bound on the card: bytes.  It reads 4 B and writes 1 B per element plus
// 4 B per 128 elements, and does a handful of operations per byte, far
// below the H100's ~295 operations per byte.  Design: one warp per 1x128
// tile, 16-byte loads (4 floats a lane, neighbouring lanes on neighbouring
// addresses), one 4-byte payload store a lane, no shared memory and no
// synchronisation, so the pass streams at memory speed.
#include <cuda_runtime.h>

#include "tile_quant.cuh"
#include "resources.cuh"

namespace {

__global__ void __launch_bounds__(256)
quantize_tilewise_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
                         float* __restrict__ s, long long tiles, int K) {
  const int lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (tile >= tiles) return;
  const int kb = K / repro::kQuantBlock;
  const long long row = tile / kb;
  const int col = (int)(tile % kb) * repro::kQuantBlock;
  const float4 v4 = reinterpret_cast<const float4*>(x + row * K + col)[lane];
  const float v[4] = {v4.x, v4.y, v4.z, v4.w};
  repro::quantize_tile_warp(v, lane, q + row * K + col, s + tile);
}

}  // namespace

extern "C" int quantize_tilewise_f32(const void* x, void* q, void* s, int M,
                                     int K, void* stream) {
  const long long tiles = (long long)M * (K / repro::kQuantBlock);
  const int warps_per_block = 8;
  const long long blocks = (tiles + warps_per_block - 1) / warps_per_block;
  quantize_tilewise_kernel<<<(unsigned)blocks, 32 * warps_per_block, 0,
                             (cudaStream_t)stream>>>(
      (const float*)x, (uint8_t*)q, (float*)s, tiles, K);
  return (int)cudaGetLastError();
}

// The resources of the kernel (resources.cuh); a, b and c are unused.
extern "C" int kernel_resources(int, int, int, int* out) {
  return repro::query_resources(quantize_tilewise_kernel, 256, 0, out);
}
