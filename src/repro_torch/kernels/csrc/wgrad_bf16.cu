// B4, the bf16 ragged-contraction (wgrad) grouped GEMM, on Hopper's own
// machinery: TMA loads into an mbarrier ring kept full by a producer warp,
// wgmma consumers reading both operands where they lie, dw written by TMA
// in the output dtype.
//
// Replaces src/repro/kernels/wgrad_kernel.py::gmm_pallas_wgrad (B4).
//   dw[g] = x[rows of g]^T @ dy[rows of g], f32 accumulation
// x [M, K], dy [M, N] bf16 row-major; rows [offsets[g], offsets[g+1])
// belong to group g.  Rows at or beyond offsets[G] never enter, NaN
// included; a group with no rows gets exact zeros.  dw [G, K, N] is
// written in f32 or bf16: the f32 sum, then one round-to-nearest, as the
// reference's out_dtype cast of its f32 accumulator.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at the
// training path's gate/up shape (16384 rows over 60 groups, K 2048,
// N 1408) 94.5 GFLOP (~0.096 ms) against 113 MB of operands and a dw of
// 346 MB in bf16 (0.137 ms) or 692 MB in f32 (0.240 ms): writing dw.
// Each operand row is read by every output tile of its group (K / 128
// tiles read a dy row, N / 128 an x row), so the SMs load ~1.5 GB from
// L2 at that shape while HBM sees each byte about once.  On an H100 the
// ring's loads and the dw stores take most of the time, and overlap only
// in part; the products add little.  A 128 x 256 tile (fewer L2 bytes), a
// second staging buffer and stores through the load / store units were
// each no faster.
//
// Design.  Each output tile (N tile, K tile, group) is summed by one CTA
// over the tile's whole contraction, in a fixed row order, with no
// atomics, so two launches are bitwise equal and dw is written once (the
// walk, the epilogue and the launch are wgrad_tile.cuh's, shared with B6).
// Persistent CTAs, one an SM, walk the tiles in a fixed stride (N tile
// fastest, so the SMs work on one group's x and dy rows together, from
// L2):
//   - a producer warp (its first thread) keeps a 4-stage TMA ring of
//     64 contracted rows x (128 K of x + 128 N of dy), each operand as two
//     64-column boxes in the 128-byte swizzle, starting at offsets[g]
//     (TMA takes any row coordinate and zero-fills rows >= M); it runs
//     ahead into the CTA's next tile while the consumers store this one;
//   - two consumer warpgroups, one per 64 rows of K, each run wgmma
//     m64n128k16 on both operands as they lie: A = x^T is M-major (K is
//     x's contiguous axis) and B = dy is N-major, so both transpose bits
//     are set and nothing is transposed in memory; one chunk's products
//     stay in flight while the next chunk's are issued;
//   - the last chunk of a group holds rows past offsets[g+1] (the next
//     group's, or the tail's, NaN possible): after its full barrier the
//     consumers zero those rows of both operands (one alone is not
//     enough: 0 * NaN is NaN), fence them to the async proxy and
//     synchronise before the product; producer and consumers count the
//     chunks from the same offsets;
//   - the epilogue stages the f32 accumulator, rounded to the output
//     dtype, in a buffer of its own (128-byte swizzled) and stores it by
//     TMA without waiting: the store drains while the next tile's
//     products run, and only the next epilogue waits for it to have read
//     the buffer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
#include "wgrad_tile.cuh"
#include "resources.cuh"

namespace {

using namespace hopper;
using wgrad::kRows;
using wgrad::kTile;
using wgrad::Tile;

constexpr int kStages = 4;
constexpr int kBoxBytes = kRows * 128;       // 64 rows x 64 bf16: 8 KB
constexpr int kStageBytes = 4 * kBoxBytes;   // x: 2 boxes, dy: 2 boxes
constexpr int kThreads = 2 * 128 + 32;       // 2 consumer warpgroups + producer

// ring, staged output tile, barriers (1024-byte aligned for the swizzle)
template <typename OutT>
constexpr int smem_bytes() {
  return 1024 + kStages * kStageBytes + kTile * kTile * (int)sizeof(OutT) +
         2 * kStages * 8;
}

struct Maps {
  CUtensorMap x;     // [M, K] bf16: box 64 K x 64 rows, 128B swizzle
  CUtensorMap dy;    // [M, N] bf16: box 64 N x 64 rows, 128B swizzle
  CUtensorMap out;   // [G * K, N] f32 or bf16: box 128 bytes x 128 rows, 128B swizzle
};

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_bf16_kernel(const __grid_constant__ Maps maps,
                  const int* __restrict__ offsets, int M, int K, int N,
                  int G) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* staged = ring + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      staged + kTile * kTile * sizeof(OutT));
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int n_tiles = N / kTile, k_tiles = K / kTile;
  const int tiles = n_tiles * k_tiles * G;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps kStages chunks of both operands in
    // flight, across the CTA's tiles
    if (tid == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl(t, n_tiles, k_tiles, offsets, M);
        for (int i = 0; i < tl.chunks; ++i, ++it) {
          const int s = it % kStages, row = tl.start + i * kRows;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          uint8_t* st = ring + s * kStageBytes;
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_2d(st, &maps.x, &full[s], tl.k0, row);
          tma_load_2d(st + kBoxBytes, &maps.x, &full[s], tl.k0 + 64, row);
          tma_load_2d(st + 2 * kBoxBytes, &maps.dy, &full[s], tl.n0, row);
          tma_load_2d(st + 3 * kBoxBytes, &maps.dy, &full[s], tl.n0 + 64,
                      row);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a K tile; a
  // thread holds rows r and r + 8 of it, columns 8j + 2(lane%4) + {0, 1}
  const int r = wg * 64 + ((tid / 32) & 3) * 16 + (lane >> 2);
  float acc[64];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl(t, n_tiles, k_tiles, offsets, M);
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
    for (int i = 0; i < tl.chunks; ++i, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      uint8_t* st = ring + s * kStageBytes;
      const int valid = tl.end - (tl.start + i * kRows);
      if (valid < kRows) {
        // rows [valid, 64) are not this group's: zero them in all four boxes
        const int per_box = (kRows - valid) * 8;        // 16-byte words
        for (int e = tid; e < 4 * per_box; e += 256) {
          const int box = e / per_box, w = e % per_box;
          *reinterpret_cast<uint4*>(st + box * kBoxBytes + valid * 128 +
                                    w * 16) = make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();
        bar_sync(1, 256);
      }
      const uint32_t a_addr = smem_u32(st + wg * kBoxBytes);
      const uint32_t b_addr = smem_u32(st + 2 * kBoxBytes);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks) {
        // 16 contracted rows are 2 KB on in either operand; dy's second
        // 64 columns one box on
        wgmma_m64n128k16<1, 1>(
            acc, sw128_desc(a_addr + ks * 2048, kBoxBytes, 1024),
            sw128_desc(b_addr + ks * 2048, kBoxBytes, 1024), 1);
      }
      wgmma_commit();
      // the previous chunk's products are done: release its stage
      wgmma_wait<1>();
      fence_regs(acc);
      if (i > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (tl.chunks > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);

    wgrad::store_tile<OutT>(acc, r, tid, staged, &maps.out, tl.n0,
                            tl.g * K + tl.k0);
  }
  if (tid == 0) tma_store_wait_all();
}

}  // namespace

// One launch covers every group: one persistent CTA an SM (at most one a
// tile).  K and N are multiples of 128; offsets [G + 1] int32; dw [G, K, N], f32 when out_f32
// else bf16.  Returns a cudaError_t, or 1000 + the CUresult of a failed
// tensor-map encoding.
extern "C" int wgrad_bf16(const void* x, const void* dy, const void* offsets,
                          void* dw, int M, int K, int N, int G, int out_f32,
                          void* stream) {
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  CUresult r = encode_rows_sw128(&maps.x, x, M, K, kRows);
  if (r == CUDA_SUCCESS) r = encode_rows_sw128(&maps.dy, dy, M, N, kRows);
  if (r == CUDA_SUCCESS) r = wgrad::encode_dw(&maps.out, dw, K, N, G, out_f32);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  const int tiles = (N / kTile) * (K / kTile) * G;
  auto st = (cudaStream_t)stream;
  auto offs = (const int*)offsets;
  if (out_f32)
    return wgrad::launch_persistent<wgrad_bf16_kernel<float>>(
        kThreads, smem_bytes<float>(), tiles, st, maps, offs, M, K, N, G);
  return wgrad::launch_persistent<wgrad_bf16_kernel<__nv_bfloat16>>(
      kThreads, smem_bytes<__nv_bfloat16>(), tiles, st, maps, offs, M, K, N,
      G);
}


// The resources of one variant (resources.cuh): b = 1 for an f32 dw; a
// and c are unused.
extern "C" int kernel_resources(int, int out_f32, int, int* out) {
  if (out_f32)
    return repro::query_resources(wgrad_bf16_kernel<float>, kThreads,
                                  smem_bytes<float>(), out);
  return repro::query_resources(wgrad_bf16_kernel<__nv_bfloat16>, kThreads,
                                smem_bytes<__nv_bfloat16>(), out);
}
