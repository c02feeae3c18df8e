// B6, the ragged-contraction (wgrad) grouped GEMM on e4m3 operands with
// their 1x128 scales, on B4's Hopper schedule: TMA loads of the e4m3
// tiles into an mbarrier ring, two warpgroups widening and scaling them
// into bf16 in shared memory, two wgmma warpgroups, dw written by TMA in
// the output dtype.
//
// Replaces src/repro/kernels/wgrad_kernel.py::gmm_pallas_wgrad_fp8 (B6).
//   dw[g] = sum over rows m of g of (q_x[m,:] s_x[m, kb])^T (q_dy[m,:] s_dy[m, nb])
// x [M, K], dy [M, N] e4m3 row-major, s_x [M, K/128], s_dy [M, N/128] f32;
// rows [offsets[g], offsets[g+1]) belong to group g.  Rows at or beyond
// offsets[G] never enter, NaN included; a group with no rows gets exact
// zeros.  dw [G, K, N] is written in f32 or bf16: the f32 sum, then one
// round-to-nearest, as the reference's out_dtype cast of its f32
// accumulator.
//
// What bounds it on an H100 (3.35 TB/s, 1979 TFLOP/s on e4m3 operands):
// at the training path's gate/up shape (16384 rows over 60 groups, K 2048,
// N 1408) 94.5 GFLOP against 58 MB of operands and scales and a dw of
// 346 MB in bf16 (0.121 ms) or 692 MB in f32 (0.224 ms): writing dw.  The
// design has a ceiling of its own above the bf16 bound: the scaled dy
// enters as a bf16 hi + lo pair, two bf16 products a step, 189 GFLOP at
// 989 TFLOP/s = 0.191 ms.  On the card it runs at ~3x that ceiling
// (PERF.md): the widening and the products each take most of the time
// alone and overlap only in part; shared memory carries the TMA writes,
// the widening's reads and writes (64 KB a stage) and wgmma's reads.
//
// Design.  B4's schedule, clusters and epilogue (wgrad_tile.cuh): each
// 128 x 128 sub-tile (N tile, K tile, group) is summed by one CTA over the
// tile's whole contraction, in a fixed row order, with no atomics, so two
// launches are bitwise equal and dw is written once; persistent CTAs, one
// an SM, walk the tiles in a fixed stride.  At block_n 256 and at span 2
// and 4 a super-tile runs on a 1 x 2, 2 x 2 or 4 x 4 cluster (span 4 as
// one 16-CTA cluster), bitwise span 1: the first widening thread of each
// CTA loads its slice of the stage's e4m3 rows (64 / cn of x's, 64 / ck
// of dy's) and multicasts it to its cluster row (x) and column (dy); the
// widening warps release a stage to every CTA of their row and column;
// each CTA widens and scales its own copy.
//   - The first widening thread keeps a 4-stage TMA ring of 64 contracted
//     rows x (128 K of x + 128 N of dy), each one e4m3 box of 128 bytes a
//     row in the 128-byte swizzle, starting at offsets[g], 3 chunks ahead
//     of the widening and across the CTA's tiles.
//   - The scale of a contracted row m varies along the contraction, so it
//     cannot be applied after the product: two widening warpgroups (their
//     registers handed to the consumers by setmaxnreg) widen each stage
//     into three bf16 tiles, in the swizzled layout B4's wgmma reads from
//     its TMA ring: x exactly (e4m3 -> f16 -> f32 -> bf16), and dy as
//     v = (q * s_dy) * s_x in f32 split into hi = bf16(v) and
//     lo = bf16(v - hi), about 16 bits of v where one bf16 would keep 8.
//     Rows at or past offsets[g+1] (the next group's rows, or the tail's,
//     NaN possible) become 0 in all three tiles.  A quarter warp widens one
//     row's 128 bytes, reading and writing 8 distinct 16-byte bank groups.
//     The stage goes back to the ring as soon as it is widened.
//   - The scales are plain loads from L2, one chunk ahead: at N = 1408
//     (and the down projection's K = 1408) s_dy and s_x are [M, 11] f32, a
//     44-byte row stride, which TMA cannot describe.
//   - The widened tiles are double-buffered and handed over by mbarriers:
//     the next chunk (in the ring's order, across tiles) widens while this
//     chunk's products run.
//   - Two consumer warpgroups, one per 64 rows of K, run wgmma m64n128k16
//     on bf16 (A = x^T M-major, B = dy N-major, both transpose bits set),
//     the hi and the lo product each k16 step into one f32 accumulator;
//     one chunk's products stay in flight while the next chunk's issue.
//   - The epilogue stages the accumulator, rounded to the output dtype, in
//     a buffer of its own and stores it by TMA without waiting.
// Shared memory: ring 64 KB, widened tiles 2 x 48 KB, staged dw 32 KB
// (bf16) or 64 KB (f32): 197,728 or 230,496 bytes, one CTA an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "fp8.cuh"
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

constexpr int kBoxBytes = kRows * 128;        // 64 rows x 128 bytes: 8 KB
constexpr int kStageBytes = 2 * kBoxBytes;    // e4m3 x box, e4m3 dy box
constexpr int kWideBytes = 6 * kBoxBytes;     // bf16 x, dy hi, dy lo: 2 boxes each
constexpr int kThreads = 4 * 128;             // 2 consumer + 2 widening warpgroups
constexpr int kStages = 4;

// ring, two widened buffers, staged output tile, barriers (1024-byte
// aligned for the swizzle)
template <typename OutT>
constexpr int smem_bytes() {
  return 1024 + kStages * kStageBytes + 2 * kWideBytes +
         kTile * kTile * (int)sizeof(OutT) + (2 * kStages + 4) * 8;
}

struct Maps {
  CUtensorMap x;     // [M, K] e4m3: box 128 K x 64 / cn rows, 128B swizzle
  CUtensorMap dy;    // [M, N] e4m3: box 128 N x 64 / ck rows, 128B swizzle
  CUtensorMap out;   // [G * K, N] f32 or bf16: box 128 bytes x 128 rows, 128B swizzle
};

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Widen 16-byte chunk c (values 16c..16c+15) of row r of the e4m3 stage
// into the buffer wb: x to bf16, dy to (q * s_dy) * s_x as bf16 hi and lo
// (zeros where !valid).  Value 16c + e lands in 64-column box c / 4, bytes
// 32(c % 4) + 2e of the row: 16-byte chunks 2(c % 4) and 2(c % 4) + 1.  A
// quarter warp holds one row's c = 0..7; c >= 4 writes its second chunk
// first, so each write hits 8 distinct bank groups.
__device__ __forceinline__ void widen_chunk(const uint8_t* st, uint8_t* wb,
                                            int r, int c, bool valid,
                                            float s_dy, float s_x) {
  // computed for every row (a row past the group holds the next group's
  // bytes, TMA's zeros or the tail's NaN) and zeroed after, with no branch,
  // so the compiler interleaves a thread's rows
  const uint4 vx = *reinterpret_cast<const uint4*>(st + sw128_offset(r, 16 * c));
  const uint4 vd = *reinterpret_cast<const uint4*>(st + kBoxBytes +
                                                   sw128_offset(r, 16 * c));
  const uint32_t wx[4] = {vx.x, vx.y, vx.z, vx.w};
  const uint32_t wd[4] = {vd.x, vd.y, vd.z, vd.w};
  const uint32_t keep = valid ? 0xffffffffu : 0u;
  uint32_t xo[8], hi[8], lo[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 fx = repro::e4m3x2_to_float2(wx[j / 2] >> (16 * (j & 1)));
    xo[j] = bf16x2(fx.x, fx.y) & keep;
    const float2 fd = repro::e4m3x2_to_float2(wd[j / 2] >> (16 * (j & 1)));
    const float v0 = __fmul_rn(__fmul_rn(fd.x, s_dy), s_x);
    const float v1 = __fmul_rn(__fmul_rn(fd.y, s_dy), s_x);
    const uint32_t h = bf16x2(v0, v1);
    hi[j] = h & keep;
    lo[j] = bf16x2(__fsub_rn(v0, __uint_as_float(h << 16)),
                   __fsub_rn(v1, __uint_as_float(h & 0xffff0000u))) & keep;
  }
  const uint4 t[3][2] = {
      {make_uint4(xo[0], xo[1], xo[2], xo[3]), make_uint4(xo[4], xo[5], xo[6], xo[7])},
      {make_uint4(hi[0], hi[1], hi[2], hi[3]), make_uint4(hi[4], hi[5], hi[6], hi[7])},
      {make_uint4(lo[0], lo[1], lo[2], lo[3]), make_uint4(lo[4], lo[5], lo[6], lo[7])}};
  const bool swap = c >= 4;
  uint8_t* box = wb + (c >> 2) * kBoxBytes;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int off = sw128_offset(r, 32 * (c & 3) + 16 * (h ^ swap));
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint4*>(box + 2 * p * kBoxBytes + off) =
          (h ^ swap) ? t[p][1] : t[p][0];
  }
}

// The chunks of the CTA's units in the order the ring takes them: chunk
// i of unit u (tile), the q-th of the walk, units with no rows skipped
// (the walk's geometry and the CTA's place in its cluster are passed to
// each step: the kernel's parameters and registers, never copied)
struct Cursor {
  const int* offsets;
  int M, u, i, q;   // q: chunks passed
  Tile tile;
  __device__ __forceinline__ Cursor(const int* offsets, int M,
                                    const Geom& geo, const Cluster& cl)
      : offsets(offsets), M(M), u(wgrad::first_unit(geo)), i(0), q(0),
        tile(u, geo, cl, offsets, M) {
    settle(geo, cl);
  }
  __device__ __forceinline__ bool done(const Geom& geo) const {
    return u >= geo.units;
  }
  __device__ __forceinline__ void settle(const Geom& geo, const Cluster& cl) {
    while (i == tile.chunks) {
      u += wgrad::unit_stride(geo);
      if (u >= geo.units) return;
      tile = Tile(u, geo, cl, offsets, M);
      i = 0;
    }
  }
  __device__ __forceinline__ void next(const Geom& geo, const Cluster& cl) {
    if (done(geo)) return;
    ++i;
    ++q;
    settle(geo, cl);
  }
  __device__ __forceinline__ int row0() const { return tile.start + i * kRows; }
  __device__ __forceinline__ int valid() const {
    return min(tile.end - row0(), kRows);
  }
};

// a widening thread's rows of a chunk: rq and rq + 32
constexpr int kRowsPerThread = 2;

// a widening thread's scales of its rows of a chunk
struct Scales {
  float x[kRowsPerThread], dy[kRowsPerThread];
};

// the scales of a widening thread's rows of chunk `cur` (0 past its rows)
__device__ __forceinline__ void load_scales(const Cursor& cur,
                                            const Geom& geo,
                                            const float* __restrict__ sx,
                                            const float* __restrict__ sdy,
                                            int K, int N, int rq,
                                            Scales& out) {
  const int valid = cur.done(geo) ? 0 : cur.valid();
  const int row0 = cur.done(geo) ? 0 : cur.row0();
  const int kb = cur.tile.k0 / kTile, nb = cur.tile.n0 / kTile;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = rq + 32 * j;
    out.x[j] = out.dy[j] = 0.0f;
    if (r < valid) {
      out.x[j] = sx[(size_t)(row0 + r) * (K / kTile) + kb];
      out.dy[j] = sdy[(size_t)(row0 + r) * (N / kTile) + nb];
    }
  }
}

// kCluster: the instance of the cluster geometries; the other runs span 1
// at block_n 128 with every cluster term a constant
template <typename OutT, bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_fp8_kernel(const __grid_constant__ Maps maps,
                 const float* __restrict__ sx, const float* __restrict__ sdy,
                 const int* __restrict__ offsets, int M, int K, int N, int G,
                 const Geom walk) {
  const Geom geo = kCluster ? walk : wgrad::single(K, N, G);
  // aligned to 1024 bytes for the swizzle by pointer arithmetic, so the
  // compiler keeps shared-memory (32-bit) addressing
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* wide = ring + kStages * kStageBytes;
  uint8_t* staged = wide + 2 * kWideBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      staged + kTile * kTile * sizeof(OutT));
  uint64_t* empty = full + kStages;
  uint64_t* wfull = empty + kStages;          // a widened buffer is ready
  uint64_t* wempty = wfull + 2;               // its products are done

  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const Cluster cl(geo);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      // every widening warp of every CTA this CTA's loads land in
      mbar_init(&empty[s], 8 * cl.peers());
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&wfull[b], 8);                // every widening warp
      mbar_init(&wempty[b], 8);               // every consumer warp
    }
    mbar_init_fence();
  }
  if (geo.ctas() > 1)
    cluster_sync();
  else
    __syncthreads();

  if (wg >= 2) {
    // the widening warpgroups, their registers handed to the consumers;
    // their first thread also keeps the TMA ring kStages - 1 chunks ahead:
    // its slice of x's rows to its cluster row, of dy's to its column
    setmaxnreg_dec<96>();
    const int wt = tid - 256, c = wt & 7, rq = wt >> 3;
    const int xr = cl.nn * (kRows / cl.cn), dr = cl.kk * (kRows / cl.ck);
    const uint16_t rows = cl.row_mask(), cols = cl.col_mask();
    Cursor load(offsets, M, geo, cl);
    auto issue = [&]() {
      if (wt != 0 || load.done(geo)) return;
      const int s = load.q % kStages;
      mbar_wait(&empty[s], ((load.q / kStages) & 1) ^ 1);
      uint8_t* st = ring + s * kStageBytes;
      mbar_expect_tx(&full[s], kStageBytes);
      cl.load(st + xr * 128, &maps.x, &full[s], load.tile.k0,
              load.row0() + xr, rows);
      cl.load(st + kBoxBytes + dr * 128, &maps.dy, &full[s], load.tile.n0,
              load.row0() + dr, cols);
      load.next(geo, cl);
    };
    for (int q = 0; q < kStages - 1; ++q) issue();
    Cursor cur(offsets, M, geo, cl);
    Scales sc;
    load_scales(cur, geo, sx, sdy, K, N, rq, sc);
    while (!cur.done(geo)) {
      issue();
      // the next chunk's scales, in flight while this chunk widens
      Cursor nxt = cur;
      nxt.next(geo, cl);
      Scales sn;
      load_scales(nxt, geo, sx, sdy, K, N, rq, sn);
      const int s = cur.q % kStages, b = cur.q & 1, valid = cur.valid();
      mbar_wait(&full[s], (cur.q / kStages) & 1);
      mbar_wait(&wempty[b], ((cur.q >> 1) & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        widen_chunk(ring + s * kStageBytes, wide + b * kWideBytes,
                    rq + 32 * i, c, rq + 32 * i < valid, sc.dy[i], sc.x[i]);
      fence_proxy_async();
      __syncwarp();
      cl.release(&empty[s], lane);
      if (lane == 0) mbar_arrive(&wfull[b]);
      sc = sn;
      cur = nxt;
    }
    wgrad::leave_cluster<kCluster>();
    return;
  }
  setmaxnreg_inc<160>();

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a K tile; a
  // thread holds rows r and r + 8 of it, columns 8j + 2(lane%4) + {0, 1}
  const int r = wg * 64 + ((tid / 32) & 3) * 16 + (lane >> 2);
  float acc[64];
  int it = 0;
  const int stride = wgrad::unit_stride(geo);
  for (int u = wgrad::first_unit(geo); u < geo.units; u += stride) {
    const Tile tl(u, geo, cl, offsets, M);
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
    for (int i = 0; i < tl.chunks; ++i, ++it) {
      const int b = it & 1;
      mbar_wait(&wfull[b], (it >> 1) & 1);
      uint8_t* wb = wide + b * kWideBytes;
      const uint32_t a_addr = smem_u32(wb + wg * kBoxBytes);
      const uint32_t hi_addr = smem_u32(wb + 2 * kBoxBytes);
      const uint32_t lo_addr = smem_u32(wb + 4 * kBoxBytes);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks) {
        // 16 contracted rows are 2 KB on in every tile; the second 64
        // columns of hi and lo one box on
        const uint64_t a = sw128_desc(a_addr + ks * 2048, kBoxBytes, 1024);
        wgmma_m64n128k16<1, 1>(
            acc, a, sw128_desc(hi_addr + ks * 2048, kBoxBytes, 1024), 1);
        wgmma_m64n128k16<1, 1>(
            acc, a, sw128_desc(lo_addr + ks * 2048, kBoxBytes, 1024), 1);
      }
      wgmma_commit();
      // the previous chunk's products are done: release its buffer
      wgmma_wait<1>();
      fence_regs(acc);
      if (i > 0 && lane == 0) mbar_arrive(&wempty[(it - 1) & 1]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (tl.chunks > 0 && lane == 0) mbar_arrive(&wempty[(it - 1) & 1]);
    wgrad::store_tile<OutT>(acc, r, tid, staged, &maps.out, tl.n0,
                            tl.g * K + tl.k0);
  }
  if (tid == 0) tma_store_wait_all();
  wgrad::leave_cluster<kCluster>();
}

// an [rows, cols] e4m3 matrix as a 2-D map of 128-column x `box_rows`
// boxes in the 128-byte swizzle
CUresult encode_e4m3_rows(CUtensorMap* map, const void* base, uint64_t rows,
                          uint64_t cols, uint32_t box_rows) {
  const uint64_t dims[2] = {cols, rows};
  const uint64_t strides[1] = {cols};
  const uint32_t box[2] = {128, box_rows};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides,
                box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// launch the instance of geo's form
template <typename OutT, typename... Args>
int run(const Geom& geo, cudaStream_t st, const Args&... args) {
  if (geo.ctas() > 1)
    return wgrad::launch<wgrad_fp8_kernel<OutT, true>>(
        geo, kThreads, smem_bytes<OutT>(), st, args..., geo);
  return wgrad::launch<wgrad_fp8_kernel<OutT, false>>(
      geo, kThreads, smem_bytes<OutT>(), st, args..., geo);
}

// One launch covers every group.  K and N are multiples of the geometry's
// super-tile (k_span x 128, n_span x block_n); offsets [G + 1] int32; dw
// [G, K, N], f32 when out_f32 else bf16.  Returns a cudaError_t
// (cudaErrorInvalidValue for a geometry outside the pool), or 1000 + the
// CUresult of a failed tensor-map encoding.
extern "C" int wgrad_fp8(const void* x, const void* sx, const void* dy,
                         const void* sdy, const void* offsets, void* dw, int M,
                         int K, int N, int G, int out_f32, int block_n,
                         int n_span, int k_span, void* stream) {
  const Geom geo = wgrad::geometry(block_n, n_span, k_span, K, N, G);
  if (geo.ck == 0) return (int)cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  CUresult r = encode_e4m3_rows(&maps.x, x, M, K, kRows / geo.cn);
  if (r == CUDA_SUCCESS) r = encode_e4m3_rows(&maps.dy, dy, M, N, kRows / geo.ck);
  if (r == CUDA_SUCCESS) r = wgrad::encode_dw(&maps.out, dw, K, N, G, out_f32);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  auto st = (cudaStream_t)stream;
  auto s_x = (const float*)sx;
  auto s_dy = (const float*)sdy;
  auto offs = (const int*)offsets;
  if (out_f32)
    return run<float>(geo, st, maps, s_x, s_dy, offs, M, K, N, G);
  return run<__nv_bfloat16>(geo, st, maps, s_x, s_dy, offs, M, K, N, G);
}

// the resources of the instance that runs clusters of `ctas` CTAs
template <typename OutT>
int resources_of(int ctas, int* out) {
  if (ctas > 1)
    return wgrad::cluster_resources<wgrad_fp8_kernel<OutT, true>>(
        kThreads, smem_bytes<OutT>(), ctas, out);
  return wgrad::cluster_resources<wgrad_fp8_kernel<OutT, false>>(
      kThreads, smem_bytes<OutT>(), ctas, out);
}

// The resources of one variant (resources.cuh, wgrad_tile.cuh): b = 1 for
// an f32 dw; clusters of a x c CTAs (0 counts as 1).
extern "C" int kernel_resources(int ck, int out_f32, int cn, int* out) {
  const int ctas = (ck > 0 ? ck : 1) * (cn > 0 ? cn : 1);
  return out_f32 ? resources_of<float>(ctas, out)
                 : resources_of<__nv_bfloat16>(ctas, out);
}
