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
// Design.  Each 128 x 128 sub-tile (N tile, K tile, group) is summed by
// one CTA over the tile's whole contraction, in a fixed row order, with no
// atomics, so two launches are bitwise equal and dw is written once (the
// walk, the clusters, the epilogue and the launch are wgrad_tile.cuh's,
// shared with B6).  Persistent CTAs, one an SM, walk the tiles in a fixed
// stride (N tile fastest, so the SMs work on one group's x and dy rows
// together, from L2).  The JAX package's wider geometries (block_n 256,
// n_span = k_span 2 and 4) put a super-tile on a thread-block cluster of
// 1 x 2, 2 x 2 or 4 x 4 CTAs (span 4 as one non-portable 16-CTA cluster:
// an H100 holds 7 at once), one a sub-tile, bitwise span 1; span 1 at
// block_n 128 runs an instance of its own with no cluster term:
//   - a producer warp (its first thread) keeps a 4-stage TMA ring of
//     64 contracted rows x (128 K of x + 128 N of dy), each operand as two
//     64-column boxes in the 128-byte swizzle, starting at offsets[g]
//     (TMA takes any row coordinate and zero-fills rows >= M); it runs
//     ahead into the CTA's next tile while the consumers store this one;
//     in a cluster it loads 64 / cn rows of x's boxes and multicasts them
//     to its cluster row (the CTAs of its K sub-tile) and 64 / ck rows of
//     dy's to its column, and waits, before reusing a stage, until every
//     CTA of its row and column has released it;
//   - two consumer warpgroups, one per 64 rows of K, each run wgmma
//     m64n128k16 on both operands as they lie: A = x^T is M-major (K is
//     x's contiguous axis) and B = dy is N-major, so both transpose bits
//     are set and nothing is transposed in memory; one chunk's products
//     stay in flight while the next chunk's are issued;
//   - the last chunk of a group holds rows past offsets[g+1] (the next
//     group's, or the tail's, NaN possible): after its full barrier the
//     consumers zero those rows of both operands in their CTA's copy of
//     the stage (one alone is not
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
using wgrad::Cluster;
using wgrad::Geom;
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
  CUtensorMap x;     // [M, K] bf16: box 64 K x 64 / cn rows, 128B swizzle
  CUtensorMap dy;    // [M, N] bf16: box 64 N x 64 / ck rows, 128B swizzle
  CUtensorMap out;   // [G * K, N] f32 or bf16: box 128 bytes x 128 rows, 128B swizzle
};

// kCluster: the instance of the cluster geometries; the other runs span 1
// at block_n 128 with every cluster term a constant
template <typename OutT, bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_bf16_kernel(const __grid_constant__ Maps maps,
                  const int* __restrict__ offsets, int M, int K, int N,
                  int G, const Geom walk) {
  const Geom geo = kCluster ? walk : wgrad::single(K, N, G);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* staged = ring + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      staged + kTile * kTile * sizeof(OutT));
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const Cluster cl(geo);
  const int first = wgrad::first_unit(geo), stride = wgrad::unit_stride(geo);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      // every consumer warp of every CTA this CTA's loads land in
      mbar_init(&empty[s], 8 * cl.peers());
    }
    mbar_init_fence();
  }
  if (geo.ctas() > 1)
    cluster_sync();
  else
    __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps kStages chunks of both operands in
    // flight, across the CTA's tiles; its slice of x's rows goes to its
    // cluster row, its slice of dy's to its column
    if (tid == 256) {
      const int hx = kRows / cl.cn, hd = kRows / cl.ck;
      const uint16_t rows = cl.row_mask(), cols = cl.col_mask();
      int it = 0;
      for (int u = first; u < geo.units; u += stride) {
        const Tile tl(u, geo, cl, offsets, M);
        for (int i = 0; i < tl.chunks; ++i, ++it) {
          const int s = it % kStages, row = tl.start + i * kRows;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          uint8_t* st = ring + s * kStageBytes;
          mbar_expect_tx(&full[s], kStageBytes);
          const int xr = cl.nn * hx, dr = cl.kk * hd;
          cl.load(st + xr * 128, &maps.x, &full[s], tl.k0, row + xr, rows);
          cl.load(st + kBoxBytes + xr * 128, &maps.x, &full[s], tl.k0 + 64,
                  row + xr, rows);
          cl.load(st + 2 * kBoxBytes + dr * 128, &maps.dy, &full[s], tl.n0,
                  row + dr, cols);
          cl.load(st + 3 * kBoxBytes + dr * 128, &maps.dy, &full[s],
                  tl.n0 + 64, row + dr, cols);
        }
      }
    }
    wgrad::leave_cluster<kCluster>();
    return;
  }
  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a K tile; a
  // thread holds rows r and r + 8 of it, columns 8j + 2(lane%4) + {0, 1}
  const int r = wg * 64 + ((tid / 32) & 3) * 16 + (lane >> 2);
  float acc[64];
  int it = 0;
  for (int u = first; u < geo.units; u += stride) {
    const Tile tl(u, geo, cl, offsets, M);
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
    for (int i = 0; i < tl.chunks; ++i, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      uint8_t* st = ring + s * kStageBytes;
      const int valid = tl.end - (tl.start + i * kRows);
      if (valid < kRows) {
        // rows [valid, 64) are not this group's: zero them in all four
        // boxes of this CTA's copy
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
      if (i > 0) cl.release(&empty[(it - 1) % kStages], lane);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (tl.chunks > 0) cl.release(&empty[(it - 1) % kStages], lane);

    wgrad::store_tile<OutT>(acc, r, tid, staged, &maps.out, tl.n0,
                            tl.g * K + tl.k0);
  }
  if (tid == 0) tma_store_wait_all();
  wgrad::leave_cluster<kCluster>();
}

}  // namespace

// launch the instance of geo's form
template <typename OutT, typename... Args>
int run(const Geom& geo, cudaStream_t st, const Args&... args) {
  if (geo.ctas() > 1)
    return wgrad::launch<wgrad_bf16_kernel<OutT, true>>(
        geo, kThreads, smem_bytes<OutT>(), st, args..., geo);
  return wgrad::launch<wgrad_bf16_kernel<OutT, false>>(
      geo, kThreads, smem_bytes<OutT>(), st, args..., geo);
}

// One launch covers every group.  K and N are multiples of the geometry's
// super-tile (k_span x 128, n_span x block_n); offsets [G + 1] int32; dw
// [G, K, N], f32 when out_f32 else bf16.  Returns a cudaError_t
// (cudaErrorInvalidValue for a geometry outside the pool), or 1000 + the
// CUresult of a failed tensor-map encoding.
extern "C" int wgrad_bf16(const void* x, const void* dy, const void* offsets,
                          void* dw, int M, int K, int N, int G, int out_f32,
                          int block_n, int n_span, int k_span, void* stream) {
  const Geom geo = wgrad::geometry(block_n, n_span, k_span, K, N, G);
  if (geo.ck == 0) return (int)cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  CUresult r = encode_rows_sw128(&maps.x, x, M, K, kRows / geo.cn);
  if (r == CUDA_SUCCESS)
    r = encode_rows_sw128(&maps.dy, dy, M, N, kRows / geo.ck);
  if (r == CUDA_SUCCESS) r = wgrad::encode_dw(&maps.out, dw, K, N, G, out_f32);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  auto st = (cudaStream_t)stream;
  auto offs = (const int*)offsets;
  if (out_f32)
    return run<float>(geo, st, maps, offs, M, K, N, G);
  return run<__nv_bfloat16>(geo, st, maps, offs, M, K, N, G);
}


// the resources of the instance that runs clusters of `ctas` CTAs
template <typename OutT>
int resources_of(int ctas, int* out) {
  if (ctas > 1)
    return wgrad::cluster_resources<wgrad_bf16_kernel<OutT, true>>(
        kThreads, smem_bytes<OutT>(), ctas, out);
  return wgrad::cluster_resources<wgrad_bf16_kernel<OutT, false>>(
      kThreads, smem_bytes<OutT>(), ctas, out);
}

// The resources of one variant (resources.cuh, wgrad_tile.cuh): b = 1 for
// an f32 dw; clusters of a x c CTAs (0 counts as 1).
extern "C" int kernel_resources(int ck, int out_f32, int cn, int* out) {
  const int ctas = (ck > 0 ? ck : 1) * (cn > 0 ? cn : 1);
  return out_f32 ? resources_of<float>(ctas, out)
                 : resources_of<__nv_bfloat16>(ctas, out);
}
