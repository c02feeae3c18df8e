// B5, the padding-free bf16 grouped GEMM, on Hopper's own machinery: TMA
// loads into a multi-stage mbarrier ring kept full by a producer warp,
// wgmma consumers, and TMA stores of the owned rows only, through a pool
// of power-of-two store descriptors (the paper's mechanism).
//
// Replaces src/repro/kernels/grouped_gemm_kernel.py::gmm_pallas_bf16 (B5).
//   y[rows of g] = x[rows of g] @ w[g]; rows in [sum(sizes), M) -> zeros
// x [M, K] bf16 row-major; w [G, K, N] bf16 in either layout: N-contiguous
// (the forward's weight as it lies) or K-contiguous (the dgrad's w^T, the
// forward weight's own storage [G, N, K]); out [M, N] bf16 or f32.  Rows
// [offsets[g], offsets[g+1]) of x belong to group g.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16):
//   - prefill (1024 rows, ~19 owned rows per visited expert): 5.8 GFLOP
//     against ~300 MB of visited weights, so bytes (~0.09 ms);
//   - decode (16 rows): the visited weights alone, bytes;
//   - training (16384 rows): 94.5 GFLOP against ~413 MB, balanced
//     (~0.1 ms either way).
// What the design does about it:
//   - the weights stream through a 4-stage TMA ring (one producer thread,
//     up to 128 KB in flight per SM), so HBM keeps streaming while the
//     tensor cores run; nothing passes through registers and the K loop
//     has no __syncthreads;
//   - wgmma m64n128k16 reads both operands from 128-byte-swizzled shared
//     memory (no bank conflicts), B in either major-ness (the transpose
//     bit for the N-contiguous forward weight), so the dgrad reads w^T
//     where it lies instead of a transposed copy of every expert weight;
//   - a visit loads and multiplies only the 64-row slabs holding its
//     owned rows, from its first owned row on: a prefill visit owning 19
//     rows runs one warpgroup on one 64-row A box, not 128 rows;
//   - the accumulator is staged in shared memory and only the owned rows
//     are stored, by TMA, as pieces of 2^i rows (37 = 32 + 4 + 1) through
//     log2(block_m) + 1 descriptors of box heights 1, 2, ..., block_m;
//     rows >= total are zero-filled the same way by their tile's first
//     visit.  Owned row sets of different visits are disjoint, so CTAs
//     never race, and the output is never read back.
//
// Schedule.  One CTA per (128-column N tile, visit t of the TilePlan): the
// CTA reads its visit's group and M tile from the plan itself.  A visit
// that repeats the previous (group, tile), or owns no row, loads and
// multiplies nothing; producer and consumers take that decision from the
// same values.  Warpgroups 0..NC-1 are the consumers, one per 64-row
// slab (a slab with no owned row sits out); one warp after them is the
// producer, whose first thread issues the TMA loads.  block_m 128 runs two
// consumer warpgroups, block_m 16 (decode) one, on a 64-row box whose
// rows past the tile are computed and never stored; decode is bound by
// the weight bytes, so that costs nothing that shows.  Registers: the
// consumers' two 64-float accumulators take 149 a thread, with no spill,
// in every instance.  A producer warp rather than a warpgroup is what
// allows it at block_m 16: 160-thread CTAs fit two an SM at up to 200 a
// thread, where a producer warpgroup would cap them at 128 and spill in
// the K loop.  block_m 128 runs 288 threads, one CTA an SM (set by its
// shared memory anyway).
//
// Numerics.  Per 128-K block (two 64-K stages) one f32 partial on the
// tensor cores, added into the f32 accumulator with __fadd_rn: the
// two-level sum of the reference's oracle gmm_bf16_xla_exact.
//
// Shared memory (dynamic, 1024-byte aligned for the 128-byte swizzle):
// kStages x [NC A slabs of 64 rows x 64 K | B 64 K x 128 N], then the
// staged output tile [block_m][128] of the output type (rows of 256 or
// 512 bytes, so every store piece starts 128-byte aligned), then the full
// and empty barriers of the ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
#include "resources.cuh"

namespace {

using namespace hopper;

constexpr int kBN = 128;                       // N tile
constexpr int kBK = 64;                        // K per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kSlab = 64;                      // rows of one wgmma and one A box
constexpr int kSlabBytes = kSlab * kBK * 2;    // 8 KB
constexpr int kBBytes = kBK * kBN * 2;         // 16 KB
constexpr int kPool = 8;                       // store descriptors for block_m 128

struct Maps {
  CUtensorMap a;              // x [M, K]: box 64 K x 64 rows, 128B swizzle
  CUtensorMap b;              // w, 3-D: box 64 N x 64 K x 1 (N-contiguous)
                              // or 64 K x 128 N x 1 (K-contiguous), 128B swizzle
  CUtensorMap store[kPool];   // out [M, N]: box 128 x 2^i rows, no swizzle
};

template <int BM, int NC, typename OutT>
constexpr int smem_bytes() {
  return 1024 + kStages * (NC * kSlabBytes + kBBytes) +
         BM * kBN * (int)sizeof(OutT) + 2 * kStages * 8;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// TMA-store `count` (<= BM) staged rows from staged row `srow` to output
// row `grow`, as one piece per set bit of `count`, largest first
template <int BM, typename OutT>
__device__ __forceinline__ void store_rows(const Maps& maps, const OutT* staged,
                                           int srow, int grow, int count,
                                           int n0) {
  constexpr int kLog = BM == 128 ? 7 : 4;
#pragma unroll
  for (int b = kLog; b >= 0; --b) {
    if (count & (1 << b)) {
      tma_store_2d(&maps.store[b], staged + (size_t)srow * kBN, n0, grow);
      srow += 1 << b;
      grow += 1 << b;
    }
  }
}

// BM: the plan's M tile (16 or 128); NC: consumer warpgroups (one per
// 64-row slab); K_MAJOR_B: B is K-contiguous in global memory.
template <int BM, int NC, typename OutT, bool K_MAJOR_B>
__global__ void __launch_bounds__(128 * NC + 32, NC == 1 ? 2 : 1)
gmm_bf16_tma_kernel(const __grid_constant__ Maps maps,
                    const int* __restrict__ group_offsets,
                    const int* __restrict__ group_ids,
                    const int* __restrict__ m_tile_ids, int M, int K, int G) {
  static_assert(BM <= NC * kSlab, "a tile's owned rows must fit the slabs");
  constexpr int kStageBytes = NC * kSlabBytes + kBBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = smem;
  OutT* staged = reinterpret_cast<OutT*>(smem + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kStages * kStageBytes + BM * kBN * sizeof(OutT));
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int n0 = blockIdx.x * kBN;
  const int t = blockIdx.y;
  const int g = group_ids[t];
  const int tile = m_tile_ids[t];
  const int start = group_offsets[g], end = group_offsets[g + 1];
  const int total = group_offsets[G];
  const int row0 = tile * BM;
  const bool dup = t > 0 && group_ids[t - 1] == g && m_tile_ids[t - 1] == tile;
  const bool first = t == 0 || m_tile_ids[t - 1] != tile;
  const int own_lo = max(start, row0);
  const int n_own = dup ? 0 : max(min(min(end, row0 + BM), M) - own_lo, 0);
  const int z_lo = max(total, row0);
  const int n_zero = first ? max(min(row0 + BM, M) - z_lo, 0) : 0;
  if (n_own == 0 && n_zero == 0) return;
  const int n_act = (n_own + kSlab - 1) / kSlab;   // slabs with owned rows
  const int chunks = n_own ? K / kBK : 0;           // ring stages to run

  if (tid == 0 && chunks) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * n_act);              // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {
    // producer: one thread keeps kStages stages of A slabs and B in flight
    if (tid == 128 * NC) {
      for (int i = 0; i < chunks; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* st = ring + s * kStageBytes;
        uint8_t* bs = st + NC * kSlabBytes;
        mbar_expect_tx(&full[s], n_act * kSlabBytes + kBBytes);
        for (int j = 0; j < n_act; ++j)
          tma_load_2d(st + j * kSlabBytes, &maps.a, &full[s], i * kBK,
                      own_lo + j * kSlab);
        if (K_MAJOR_B) {
          tma_load_3d(bs, &maps.b, &full[s], i * kBK, n0, g);
        } else {
          tma_load_3d(bs, &maps.b, &full[s], n0, i * kBK, g);
          tma_load_3d(bs + kBBytes / 2, &maps.b, &full[s], n0 + 64, i * kBK, g);
        }
      }
    }
  } else {
    const int c = wg;                     // this warpgroup's 64-row slab
    float acc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
    if (c < n_act) {
      float part[64];
      for (int kb = 0; kb < chunks / 2; ++kb) {
        // one 128-K block: two stages into `part`, then acc += part
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 2 * kb + h, s = i % kStages;
          mbar_wait(&full[s], (i / kStages) & 1);
          const uint32_t a_addr = smem_u32(ring + s * kStageBytes + c * kSlabBytes);
          const uint32_t b_addr = smem_u32(ring + s * kStageBytes + NC * kSlabBytes);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kBK / 16; ++ks) {
            // A: K-major, 16 K = 32 bytes along the swizzled row
            const uint64_t da = sw128_desc(a_addr + ks * 32, 16, 1024);
            // B: K-major as A, or N-major: 16 K rows = 2 KB, the second
            // 64 columns 8 KB on
            const uint64_t db = K_MAJOR_B
                                    ? sw128_desc(b_addr + ks * 32, 16, 1024)
                                    : sw128_desc(b_addr + ks * 2048, 8192, 1024);
            wgmma_m64n128k16<0, K_MAJOR_B ? 0 : 1>(part, da, db, (h | ks) != 0);
          }
          wgmma_commit();
        }
        wgmma_wait<0>();
        if (lane == 0) {
          mbar_arrive(&empty[(2 * kb) % kStages]);
          mbar_arrive(&empty[(2 * kb + 1) % kStages]);
        }
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[j] = __fadd_rn(acc[j], part[j]);
      }
      // stage this slab's owned rows: a warp holds 16 rows, a thread rows
      // lane/4 and lane/4 + 8 of them, columns 8j + 2(lane%4) + {0, 1}
      const int wrow = c * kSlab + ((tid / 32) & 3) * 16;
      if (wrow < n_own) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wrow + (lane >> 2) + 8 * h;
          if (r < n_own) {
#pragma unroll
            for (int j = 0; j < 16; ++j)
              store2(staged + r * kBN + 8 * j + 2 * (lane & 3),
                     acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
    // rows >= total of this tile, staged after the owned rows, as zeros
    uint4* zeros = reinterpret_cast<uint4*>(staged + n_own * kBN);
    const int zwords = n_zero * kBN * (int)sizeof(OutT) / 16;
    for (int e = tid; e < zwords; e += NC * 128) zeros[e] = make_uint4(0, 0, 0, 0);
    // make the staged tile visible to TMA, then one thread stores
    fence_proxy_async();
    bar_sync(1, NC * 128);
    if (tid == 0) {
      store_rows<BM>(maps, staged, 0, own_lo, n_own, n0);
      store_rows<BM>(maps, staged, n_own, z_lo, n_zero, n0);
      tma_store_commit();
      tma_store_wait_read<0>();
    }
  }
}

template <int BM, int NC, typename OutT, bool K_MAJOR_B>
int launch(const Maps& maps, dim3 grid, cudaStream_t stream, const void* go,
           const void* gi, const void* mi, int M, int K, int G) {
  auto kernel = gmm_bf16_tma_kernel<BM, NC, OutT, K_MAJOR_B>;
  constexpr int smem = smem_bytes<BM, NC, OutT>();
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  kernel<<<grid, 128 * NC + 32, smem, stream>>>(
      maps, (const int*)go, (const int*)gi, (const int*)mi, M, K, G);
  return (int)cudaGetLastError();
}

template <int BM, int NC, typename OutT>
int launch_layout(int k_major_b, const Maps& maps, dim3 grid,
                  cudaStream_t stream, const void* go, const void* gi,
                  const void* mi, int M, int K, int G) {
  if (k_major_b)
    return launch<BM, NC, OutT, true>(maps, grid, stream, go, gi, mi, M, K, G);
  return launch<BM, NC, OutT, false>(maps, grid, stream, go, gi, mi, M, K, G);
}

}  // namespace

// B5.  a [M, K] bf16 row-major; b [Gw, K, N] bf16, N-contiguous
// (k_major_b 0) or K-contiguous (k_major_b 1: storage [Gw, N, K]); the
// plan's G = num_groups <= Gw groups; out [M, N], f32 when out_f32 else
// bf16.  One launch covers the whole plan: grid (N / 128, T visits).
// Returns a cudaError_t, or 1000 + the CUresult of a failed tensor-map
// encoding.
extern "C" int gmm_bf16(const void* a, const void* b, const void* group_offsets,
                        const void* group_ids, const void* m_tile_ids, void* out,
                        int M, int K, int N, int G, int Gw, int T, int block_m,
                        int out_f32, int k_major_b, void* stream) {
  if (block_m != 16 && block_m != 128) return (int)cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  CUresult r;
  {
    const uint64_t dims[2] = {(uint64_t)K, (uint64_t)M};
    const uint64_t strides[1] = {(uint64_t)K * 2};
    const uint32_t box[2] = {kBK, kSlab};
    r = encode(&maps.a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, dims, strides,
               box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (r != CUDA_SUCCESS) return 1000 + (int)r;
  }
  if (k_major_b) {
    const uint64_t dims[3] = {(uint64_t)K, (uint64_t)N, (uint64_t)Gw};
    const uint64_t strides[2] = {(uint64_t)K * 2, (uint64_t)K * N * 2};
    const uint32_t box[3] = {kBK, kBN, 1};
    r = encode(&maps.b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, b, dims, strides,
               box, CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    const uint64_t dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)Gw};
    const uint64_t strides[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
    const uint32_t box[3] = {64, kBK, 1};
    r = encode(&maps.b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, b, dims, strides,
               box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  // the store pool: box heights 1, 2, 4, ..., block_m
  const int esize = out_f32 ? 4 : 2;
  for (int i = 0; (1 << i) <= block_m; ++i) {
    const uint64_t dims[2] = {(uint64_t)N, (uint64_t)M};
    const uint64_t strides[1] = {(uint64_t)N * esize};
    const uint32_t box[2] = {kBN, (uint32_t)(1 << i)};
    r = encode(&maps.store[i],
               out_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               2, out, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (r != CUDA_SUCCESS) return 1000 + (int)r;
  }
  const dim3 grid(N / kBN, T);
  auto st = (cudaStream_t)stream;
  if (block_m == 16) {
    if (out_f32)
      return launch_layout<16, 1, float>(k_major_b, maps, grid, st,
                                         group_offsets, group_ids, m_tile_ids,
                                         M, K, G);
    return launch_layout<16, 1, __nv_bfloat16>(k_major_b, maps, grid, st,
                                               group_offsets, group_ids,
                                               m_tile_ids, M, K, G);
  }
  if (out_f32)
    return launch_layout<128, 2, float>(k_major_b, maps, grid, st,
                                        group_offsets, group_ids, m_tile_ids,
                                        M, K, G);
  return launch_layout<128, 2, __nv_bfloat16>(k_major_b, maps, grid, st,
                                              group_offsets, group_ids,
                                              m_tile_ids, M, K, G);
}


// The resources of one variant (resources.cuh): a = block_m (16 or 128),
// b = 1 for an f32 output, c = 1 for a K-contiguous w.
namespace {

template <int BM, int NC, typename OutT>
int query_bf16(int k_major_b, int* out) {
  constexpr int smem = smem_bytes<BM, NC, OutT>();
  if (k_major_b)
    return repro::query_resources(gmm_bf16_tma_kernel<BM, NC, OutT, true>,
                                  128 * NC + 32, smem, out);
  return repro::query_resources(gmm_bf16_tma_kernel<BM, NC, OutT, false>,
                                128 * NC + 32, smem, out);
}

}  // namespace

extern "C" int kernel_resources(int block_m, int out_f32, int k_major_b,
                                int* out) {
  if (block_m == 16)
    return out_f32 ? query_bf16<16, 1, float>(k_major_b, out)
                   : query_bf16<16, 1, __nv_bfloat16>(k_major_b, out);
  if (block_m == 128)
    return out_f32 ? query_bf16<128, 2, float>(k_major_b, out)
                   : query_bf16<128, 2, __nv_bfloat16>(k_major_b, out);
  return (int)cudaErrorInvalidValue;
}
