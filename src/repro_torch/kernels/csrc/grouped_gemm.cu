// Padding-free fp8 grouped GEMM (the paper's kernel), simple version.
//
// Replaces: src/repro/kernels/grouped_gemm_kernel.py::gmm_pallas.
// A [M, K] e4m3 with 1x128 scales s_a [M, K/128]; B [G, K, N] e4m3 with
// 128x128 scales s_b [G, K/128, N/128]; rows [offsets[g], offsets[g+1])
// of A belong to group g.  out [M, N] (bf16 or f32): the owned rows get
// A_g @ B_g, rows >= sum(sizes) get zeros.
//
// Bound on the card: at prefill shapes (1024 rows, K/N 2048/1408) the
// work is ~6 GFLOP against ~155 MB, almost all of it the visited experts'
// weights, so reading B bounds it (~46 us at 3.35 TB/s); at decode
// (16 rows) even more so.  This version stages fp8 tiles through shared
// memory as bf16 (e4m3 -> bf16 is exact) and multiplies with mma.sync
// m16n8k16 (bf16 in, f32 accumulate).  wgmma on fp8 operands, TMA and
// warp specialisation come in a later version.
//
// Design.  One CTA per (N tile of 128 columns, visit t of the TilePlan);
// the CTA reads its visit's group and M tile from the plan itself.  It
// loops over K in 128-blocks: per block, the f32 dot of the 128 K
// columns (tensor cores), then acc = acc + (part * s_a[row, kb]) *
// s_b[g, kb, nb], the order of the reference oracle.  The Pallas kernel's
// masked read-modify-write relies on visits of one tile running one after
// another; here those visits run in parallel CTAs, so each CTA writes
// only the rows its group owns and zero-fills the rows >= total, never
// reading the output back.  Owned row sets of different visits are
// disjoint and zero-filled rows are owned by no one, so the stores never
// race.  A visit that repeats the previous (group, tile), or whose tile
// holds no row of its group, skips the K loop and only zero-fills.  Rows
// >= M of a partial last tile are never stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using repro::e4m3x4_to_bf16x4;
using repro::mma_bf16;

constexpr int kThreads = 256;   // 8 warps
constexpr int kBN = 128;        // N tile = one 128-wide scale block of B
constexpr int kKC = 64;         // K columns staged in shared memory at a time
constexpr int kPad = 8;         // bf16 padding of a shared row (bank spread)

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Warps tile the CTA's BM x 128 output as WARPS_M x WARPS_N; a warp owns
// a (BM / WARPS_M) x (128 / WARPS_N) block of m16n8 fragments.
template <int BM, typename OutT>
__global__ void __launch_bounds__(kThreads)
gmm_fp8_kernel(const uint8_t* __restrict__ a, const float* __restrict__ sa,
               const uint8_t* __restrict__ b, const float* __restrict__ sb,
               const int* __restrict__ group_offsets,
               const int* __restrict__ group_ids,
               const int* __restrict__ m_tile_ids, OutT* __restrict__ out,
               int M, int K, int N, int G) {
  constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = kBN / WARPS_N;
  constexpr int MI = WM / 16, NI = WN / 8;
  __shared__ __align__(16) __nv_bfloat16 As[BM][kKC + kPad];
  __shared__ __align__(16) __nv_bfloat16 Bs[kKC][kBN + kPad];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;          // mma group / thread-in-group
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int nb = blockIdx.x, n0 = nb * kBN;
  const int t = blockIdx.y;
  const int g = group_ids[t];
  const int tile = m_tile_ids[t];
  const int start = group_offsets[g], end = group_offsets[g + 1];
  const int total = group_offsets[G];
  const int row0 = tile * BM;
  const int KB = K / 128, NB = N / kBN;
  const bool dup = t > 0 && group_ids[t - 1] == g && m_tile_ids[t - 1] == tile;
  const int own_lo = max(start, row0);
  const int own_hi = min(min(end, row0 + BM), M);
  const bool work = !dup && own_lo < own_hi;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  if (work) {
    const uint8_t* bg = b + (size_t)g * K * N;
    for (int kb = 0; kb < KB; ++kb) {
      float part[MI][NI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[i][j][c] = 0.0f;

      for (int kc = 0; kc < 128; kc += kKC) {
        const int k0 = kb * 128 + kc;
        // A: BM rows x 64 bytes, as 4-byte words (16 a row)
        for (int e = tid; e < BM * (kKC / 4); e += kThreads) {
          const int r = e / (kKC / 4), w = e % (kKC / 4);
          const int row = row0 + r;
          uint32_t v = 0;
          if (row < M)
            v = *reinterpret_cast<const uint32_t*>(a + (size_t)row * K + k0 + 4 * w);
          *reinterpret_cast<uint2*>(&As[r][4 * w]) = e4m3x4_to_bf16x4(v);
        }
        // B: 64 rows x 128 bytes, as 4-byte words (32 a row)
        for (int e = tid; e < kKC * (kBN / 4); e += kThreads) {
          const int kk = e / (kBN / 4), w = e % (kBN / 4);
          const uint32_t v = *reinterpret_cast<const uint32_t*>(
              bg + (size_t)(k0 + kk) * N + n0 + 4 * w);
          *reinterpret_cast<uint2*>(&Bs[kk][4 * w]) = e4m3x4_to_bf16x4(v);
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < kKC; ks += 16) {
          uint32_t af[MI][4], bf[NI][2];
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const int r = wm * WM + i * 16 + gq;
            const int c = ks + 2 * tq;
            af[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][c]);
            af[i][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c]);
            af[i][2] = *reinterpret_cast<const uint32_t*>(&As[r][c + 8]);
            af[i][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c + 8]);
          }
#pragma unroll
          for (int j = 0; j < NI; ++j) {
            const int n = wn * WN + j * 8 + gq;
            const int k = ks + 2 * tq;
            bf[j][0] = pack2(Bs[k][n], Bs[k + 1][n]);
            bf[j][1] = pack2(Bs[k + 8][n], Bs[k + 9][n]);
          }
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NI; ++j) mma_bf16(part[i][j], af[i], bf[j]);
        }
        __syncthreads();
      }
      // fine-grained rescale, in the oracle's order: (part * s_a) * s_b
      const float sbv = sb[((size_t)g * KB + kb) * NB + nb];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + wm * WM + i * 16 + gq + 8 * h;
          const float sav = row < M ? sa[(size_t)row * KB + kb] : 0.0f;
#pragma unroll
          for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              acc[i][j][2 * h + c] = __fadd_rn(
                  acc[i][j][2 * h + c],
                  __fmul_rn(__fmul_rn(part[i][j][2 * h + c], sav), sbv));
        }
      }
    }
  }

  // store: owned rows get the product, rows >= total get zeros, every
  // other row belongs to another visit and is left alone
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm * WM + i * 16 + gq + 8 * h;
      if (row >= M) continue;
      const bool owned = work && row >= start && row < end;
      if (!owned && row < total) continue;
      OutT* orow = out + (size_t)row * N + n0 + wn * WN + 2 * tq;
#pragma unroll
      for (int j = 0; j < NI; ++j)
        store2(orow + j * 8, owned ? acc[i][j][2 * h] : 0.0f,
               owned ? acc[i][j][2 * h + 1] : 0.0f);
    }
  }
}

// block_m 16 (decode) and 128 (prefill) are instantiated; others are refused.
template <typename OutT>
int launch(int block_m, dim3 grid, cudaStream_t stream, const uint8_t* a,
           const float* sa, const uint8_t* b, const float* sb, const int* go,
           const int* gi, const int* mi, OutT* out, int M, int K, int N, int G) {
  switch (block_m) {
    case 16:
      gmm_fp8_kernel<16, OutT><<<grid, kThreads, 0, stream>>>(a, sa, b, sb, go, gi, mi, out, M, K, N, G);
      break;
    case 128:
      gmm_fp8_kernel<128, OutT><<<grid, kThreads, 0, stream>>>(a, sa, b, sb, go, gi, mi, out, M, K, N, G);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One launch covers the whole plan: grid (N / 128, T visits).
// out_f32: 1 for an f32 output, 0 for bf16.
extern "C" int gmm_fp8(const void* a, const void* sa, const void* b,
                       const void* sb, const void* group_offsets,
                       const void* group_ids, const void* m_tile_ids, void* out,
                       int M, int K, int N, int G, int T, int block_m,
                       int out_f32, void* stream) {
  const dim3 grid(N / kBN, T);
  if (out_f32)
    return launch<float>(block_m, grid, (cudaStream_t)stream, (const uint8_t*)a,
                         (const float*)sa, (const uint8_t*)b, (const float*)sb,
                         (const int*)group_offsets, (const int*)group_ids,
                         (const int*)m_tile_ids, (float*)out, M, K, N, G);
  return launch<__nv_bfloat16>(block_m, grid, (cudaStream_t)stream,
                               (const uint8_t*)a, (const float*)sa,
                               (const uint8_t*)b, (const float*)sb,
                               (const int*)group_offsets, (const int*)group_ids,
                               (const int*)m_tile_ids, (__nv_bfloat16*)out, M,
                               K, N, G);
}
