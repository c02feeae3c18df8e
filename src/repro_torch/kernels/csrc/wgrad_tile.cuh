// The schedule and the epilogue shared by the two ragged-contraction
// (wgrad) kernels, B4 (wgrad_bf16.cu) and B6 (wgrad.cu): the persistent
// walk over output tiles, the dw tile staged in the output dtype and
// stored by TMA, dw's tensor map and the persistent launch.  sm_90a only.
//
// An output tile is (N tile, K tile, group): 128 x 128 of dw[g], summed by
// one CTA over the group's rows [offsets[g], offsets[g+1]) in chunks of
// kRows, starting at offsets[g].  Tile t of the walk has its N tile
// fastest, so the SMs work on one group's x and dy rows together, from L2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace wgrad {

using namespace hopper;

constexpr int kTile = 128;   // the tile's K and N extent
constexpr int kRows = 64;    // contracted rows per ring stage

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// tile t of the (N tile, K tile, group) order: its group, rows and chunks
struct Tile {
  int n0, k0, g, start, end, chunks;
  __device__ __forceinline__ Tile(int t, int n_tiles, int k_tiles,
                                  const int* offsets, int M) {
    n0 = (t % n_tiles) * kTile;
    k0 = (t / n_tiles % k_tiles) * kTile;
    g = t / (n_tiles * k_tiles);
    start = min(offsets[g], M);
    end = min(offsets[g + 1], M);
    chunks = end > start ? (end - start + kRows - 1) / kRows : 0;
  }
};

// The epilogue of the two consumer warpgroups (threads 0..255; named
// barrier 1): wait until the previous tile's store has read the staged
// tile, stage this one's f32 sum rounded to OutT (boxes of 128 bytes x
// 128 rows, 128B-swizzled; a thread holds rows r and r + 8, columns
// 8j + 2(lane%4) + {0, 1} of the wgmma fragment), then store it by TMA
// at (n0, row0) of the [G * K, N] dw without waiting: the store drains
// while the next tile's products run.
template <typename OutT>
__device__ __forceinline__ void store_tile(const float (&acc)[64], int r,
                                           int tid, uint8_t* staged,
                                           const CUtensorMap* out, int n0,
                                           int row0) {
  constexpr int kCols = 128 / (int)sizeof(OutT);   // columns of a staged box
  const int lane = tid & 31;
  if (tid == 0) tma_store_wait_read<0>();
  bar_sync(1, 256);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    uint8_t* box = staged + (col / kCols) * (kTile * 128);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2(reinterpret_cast<OutT*>(
                 box + sw128_offset(r + 8 * h, (col % kCols) * sizeof(OutT))),
             acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  fence_proxy_async();
  bar_sync(1, 256);
  if (tid == 0) {
    for (int b = 0; b < kTile / kCols; ++b)
      tma_store_2d(out, staged + b * (kTile * 128), n0 + b * kCols, row0);
    tma_store_commit();
  }
}

// dw [G * K, N] in f32 or bf16 as a map of 128-byte x 128-row boxes in the
// 128-byte swizzle
inline CUresult encode_dw(CUtensorMap* map, void* dw, int K, int N, int G,
                          int out_f32) {
  const int esize = out_f32 ? 4 : 2;
  const uint64_t dims[2] = {(uint64_t)N, (uint64_t)G * K};
  const uint64_t strides[1] = {(uint64_t)N * esize};
  const uint32_t box[2] = {(uint32_t)(128 / esize), kTile};
  return encode(map,
                out_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, dw, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Launch kKernel persistent over `tiles` tiles: one CTA an SM (at most
// one a tile) of `threads` threads and `smem` bytes of dynamic shared
// memory.  Returns a cudaError_t.
template <auto kKernel, typename... Args>
int launch_persistent(int threads, int smem, int tiles, cudaStream_t stream,
                      const Args&... args) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      sms = 0;
      return (int)e;
    }
  }
  kKernel<<<min(tiles, sms), threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace wgrad
