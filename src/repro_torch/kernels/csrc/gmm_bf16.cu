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
//     a pool of descriptors of box heights 1, 2, ..., min(block_m, 128)
//     (a store is no taller than the staged piece); rows >= total are
//     zero-filled the same way by their tile's first visit.  Owned row
//     sets of different visits are disjoint, so CTAs never race, and the
//     output is never read back.
//
// Schedule.  One CTA per (block_n-wide N tile, visit t of the TilePlan):
// the CTA reads its visit's group and M tile from the plan itself, and
// walks the tile as the pieces of tile_geom.cuh (sub-tiles of at most
// 128 rows at block_m 256 and 512, 128-column halves at block_n 256),
// the ring running on across them.  A piece whose visit repeats the
// previous (group, tile), or owns no row, loads and multiplies nothing;
// producer and consumers take that decision from the same values.
// Warpgroups 0..NC-1 are the consumers, one per 64-row slab (a slab with
// no owned row sits out, its warps' ring arrivals made for them by the
// active ones); one warp after them is the producer, whose first thread
// issues the TMA loads.  The tall instance (block_m 64 to 512) runs two
// consumer warpgroups, the decode instance (block_m 8 and 16) one, on a
// 64-row box whose rows past the tile are computed and never stored;
// decode is bound by the weight bytes, so that costs nothing that shows.
// Registers: the consumers' two 64-float accumulators take 165-166 a
// thread, with no spill, in every instance.  A producer warp rather than
// a warpgroup is what allows it in the decode instance: 160-thread CTAs
// fit two an SM at up to 200 a thread, where a producer warpgroup would
// cap them at 128 and spill in the K loop.  The tall instance runs 288
// threads, one CTA an SM (set by its shared memory anyway).
//
// Numerics.  Per 128-K block (two 64-K stages) one f32 partial on the
// tensor cores, added into the f32 accumulator with __fadd_rn: the
// two-level sum of the reference's oracle gmm_bf16_xla_exact.
//
// Shared memory (dynamic, 1024-byte aligned for the 128-byte swizzle):
// kStages x [NC A slabs of 64 rows x 64 K | B 64 K x 128 N], then the
// staged output piece [16 or 128][128] of the output type (rows of 256 or
// 512 bytes, so every store piece starts 128-byte aligned), then the full
// and empty barriers of the ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
#include "resources.cuh"
#include "tile_geom.cuh"

namespace {

using namespace hopper;

constexpr int kBN = 128;                       // N tile
constexpr int kBK = 64;                        // K per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kSlab = 64;                      // rows of one wgmma and one A box
constexpr int kSlabBytes = kSlab * kBK * 2;    // 8 KB
constexpr int kBBytes = kBK * kBN * 2;         // 16 KB
constexpr int kPool = 8;                       // store descriptors, heights 1..128

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

// TMA-store `count` (<= BM, the instance's piece height) staged rows from
// staged row `srow` to output row `grow`, as one piece per set bit of
// `count`, largest first
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

using repro::Geom;
using repro::Piece;

// BM: the instance, the most rows of a piece (16: block_m 8 and 16; 128:
// block_m 64 to 512); NC: consumer warpgroups (one per 64-row slab);
// K_MAJOR_B: B is K-contiguous in global memory; q: the launch's tile
// geometry (tile_geom.cuh).
template <int BM, int NC, typename OutT, bool K_MAJOR_B>
__global__ void __launch_bounds__(128 * NC + 32, NC == 1 ? 2 : 1)
gmm_bf16_tma_kernel(const __grid_constant__ Maps maps, const Geom q,
                    const int* __restrict__ group_offsets,
                    const int* __restrict__ group_ids,
                    const int* __restrict__ m_tile_ids, int M, int K, int G) {
  static_assert(BM <= NC * kSlab, "a piece's owned rows must fit the slabs");
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
  const int nt = blockIdx.x, t = blockIdx.y;
  auto piece = [&](int p) {
    return repro::make_piece(q, t, p, nt, group_offsets, group_ids,
                             m_tile_ids, M, G);
  };
  // a one-piece tile with nothing to own or zero-fill ends here
  const Piece first = piece(0);
  if (q.pieces == 1 && first.n_own == 0 && first.n_zero == 0) return;

  if (tid == 0 && (first.n_own || q.pieces > 1)) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);                 // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {
    // producer: one thread keeps kStages stages of A slabs and B in
    // flight, across the CTA's pieces
    if (tid == 128 * NC) {
      int it = 0;
      for (int p = 0; p < q.pieces; ++p) {
        const Piece I = p ? piece(p) : first;
        const int chunks = I.n_own ? K / kBK : 0;
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          uint8_t* st = ring + s * kStageBytes;
          uint8_t* bs = st + NC * kSlabBytes;
          mbar_expect_tx(&full[s], I.n_act * kSlabBytes + kBBytes);
          for (int j = 0; j < I.n_act; ++j)
            tma_load_2d(st + j * kSlabBytes, &maps.a, &full[s], c * kBK,
                        I.own_lo + j * kSlab);
          if (K_MAJOR_B) {
            tma_load_3d(bs, &maps.b, &full[s], c * kBK, I.n0, I.g);
          } else {
            tma_load_3d(bs, &maps.b, &full[s], I.n0, c * kBK, I.g);
            tma_load_3d(bs + kBBytes / 2, &maps.b, &full[s], I.n0 + 64,
                        c * kBK, I.g);
          }
        }
      }
    }
    return;
  }
  const int c = wg;                       // this warpgroup's 64-row slab
  int it = 0;
  auto run = [&](const Piece& I, bool last) {
    if (I.n_own == 0 && I.n_zero == 0) return;
    const int chunks = I.n_own ? K / kBK : 0;       // ring stages to run
    float acc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
    if (c < I.n_act) {
      // a warp's arrival stands for its twin's in a warpgroup sitting out
      const uint32_t arrivals = NC / I.n_act;
      float part[64];
      for (int kb = 0; kb < chunks / 2; ++kb) {
        // one 128-K block: two stages into `part`, then acc += part
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = it + 2 * kb + h, s = i % kStages;
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
          mbar_arrive(&empty[(it + 2 * kb) % kStages], arrivals);
          mbar_arrive(&empty[(it + 2 * kb + 1) % kStages], arrivals);
        }
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[j] = __fadd_rn(acc[j], part[j]);
      }
      // stage this slab's owned rows: a warp holds 16 rows, a thread rows
      // lane/4 and lane/4 + 8 of them, columns 8j + 2(lane%4) + {0, 1}
      const int wrow = c * kSlab + ((tid / 32) & 3) * 16;
      if (wrow < I.n_own) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wrow + (lane >> 2) + 8 * h;
          if (r < I.n_own) {
#pragma unroll
            for (int j = 0; j < 16; ++j)
              store2(staged + r * kBN + 8 * j + 2 * (lane & 3),
                     acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
    it += chunks;
    // rows >= total of this piece, staged after the owned rows, as zeros
    uint4* zeros = reinterpret_cast<uint4*>(staged + I.n_own * kBN);
    const int zwords = I.n_zero * kBN * (int)sizeof(OutT) / 16;
    for (int e = tid; e < zwords; e += NC * 128) zeros[e] = make_uint4(0, 0, 0, 0);
    // make the staged piece visible to TMA, then one thread stores
    fence_proxy_async();
    bar_sync(1, NC * 128);
    if (tid == 0) {
      store_rows<BM>(maps, staged, 0, I.own_lo, I.n_own, I.n0);
      store_rows<BM>(maps, staged, I.n_own, I.z_lo, I.n_zero, I.n0);
      tma_store_commit();
      tma_store_wait_read<0>();
    }
    // the stage has been read: the next piece may stage over it
    if (!last) bar_sync(1, NC * 128);
  };
  run(first, q.pieces == 1);
  for (int p = 1; p < q.pieces; ++p) run(piece(p), p + 1 == q.pieces);
}

template <int BM, int NC, typename OutT, bool K_MAJOR_B>
int launch(const Maps& maps, const Geom& q, dim3 grid, cudaStream_t stream,
           const void* go, const void* gi, const void* mi, int M, int K,
           int G) {
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
      maps, q, (const int*)go, (const int*)gi, (const int*)mi, M, K, G);
  return (int)cudaGetLastError();
}

template <int BM, int NC, typename OutT>
int launch_layout(int k_major_b, const Maps& maps, const Geom& q, dim3 grid,
                  cudaStream_t stream, const void* go, const void* gi,
                  const void* mi, int M, int K, int G) {
  if (k_major_b)
    return launch<BM, NC, OutT, true>(maps, q, grid, stream, go, gi, mi, M, K,
                                      G);
  return launch<BM, NC, OutT, false>(maps, q, grid, stream, go, gi, mi, M, K,
                                     G);
}

}  // namespace

// B5.  a [M, K] bf16 row-major; b [Gw, K, N] bf16, N-contiguous
// (k_major_b 0) or K-contiguous (k_major_b 1: storage [Gw, N, K]); the
// plan's G = num_groups <= Gw groups; out [M, N], f32 when out_f32 else
// bf16.  block_m is 8, 16, 64, 128, 256 or 512, block_n 128 or 256 and
// divides N.  One launch covers the whole plan: grid (N / block_n, T
// visits).  Returns a cudaError_t, or 1000 + the CUresult of a failed
// tensor-map encoding.
extern "C" int gmm_bf16(const void* a, const void* b, const void* group_offsets,
                        const void* group_ids, const void* m_tile_ids, void* out,
                        int M, int K, int N, int G, int Gw, int T, int block_m,
                        int block_n, int out_f32, int k_major_b, void* stream) {
  Geom q;
  if (!repro::make_geom(block_m, block_n, N, &q)) return (int)cudaErrorInvalidValue;
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
  // the store pool: box heights 1, 2, 4, ..., the piece's rows
  const int esize = out_f32 ? 4 : 2;
  for (int i = 0; (1 << i) <= q.rows; ++i) {
    const uint64_t dims[2] = {(uint64_t)N, (uint64_t)M};
    const uint64_t strides[1] = {(uint64_t)N * esize};
    const uint32_t box[2] = {kBN, (uint32_t)(1 << i)};
    r = encode(&maps.store[i],
               out_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               2, out, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (r != CUDA_SUCCESS) return 1000 + (int)r;
  }
  const dim3 grid(N / block_n, T);
  auto st = (cudaStream_t)stream;
  if (repro::small_instance(block_m)) {
    if (out_f32)
      return launch_layout<16, 1, float>(k_major_b, maps, q, grid, st,
                                         group_offsets, group_ids, m_tile_ids,
                                         M, K, G);
    return launch_layout<16, 1, __nv_bfloat16>(k_major_b, maps, q, grid, st,
                                               group_offsets, group_ids,
                                               m_tile_ids, M, K, G);
  }
  if (out_f32)
    return launch_layout<128, 2, float>(k_major_b, maps, q, grid, st,
                                        group_offsets, group_ids, m_tile_ids,
                                        M, K, G);
  return launch_layout<128, 2, __nv_bfloat16>(k_major_b, maps, q, grid, st,
                                              group_offsets, group_ids,
                                              m_tile_ids, M, K, G);
}


// The resources of one variant (resources.cuh): a = block_m (8, 16, 64,
// 128, 256 or 512: its instance's), b = 1 for an f32 output, c = 1 for a
// K-contiguous w.
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
  Geom q;
  if (!repro::make_geom(block_m, 128, 128, &q)) return (int)cudaErrorInvalidValue;
  if (repro::small_instance(block_m))
    return out_f32 ? query_bf16<16, 1, float>(k_major_b, out)
                   : query_bf16<16, 1, __nv_bfloat16>(k_major_b, out);
  return out_f32 ? query_bf16<128, 2, float>(k_major_b, out)
                 : query_bf16<128, 2, __nv_bfloat16>(k_major_b, out);
}
