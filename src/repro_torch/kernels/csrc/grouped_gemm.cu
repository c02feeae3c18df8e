// Padding-free fp8 grouped GEMMs over the TilePlan, simple versions: the
// fp8 GEMM (the paper's kernel) and its quantizing-store twin.  (The bf16
// twin, B5, is its own kernel on TMA and wgmma: gmm_bf16.cu.)
//
// Replaces, in src/repro/kernels/grouped_gemm_kernel.py:
//   gmm_pallas        (B2)  fp8 A, B -> bf16/f32 out          gmm_fp8
//   gmm_pallas_quant  (B7)  fp8 A, B -> e4m3 out + 1x128 s    gmm_fp8_quant
// A [M, K] e4m3 with 1x128 scales s_a [M, K/128]; B [G, K, N] e4m3 with
// 128x128 scales s_b [G, K/128, N/128]; rows [offsets[g], offsets[g+1])
// of A belong to group g.  The owned rows get A_g @ B_g, rows >=
// sum(sizes) get zeros (B7: payload 0, scale 1).
//
// Bound on the card: at prefill shapes (1024 rows, K/N 2048/1408) the
// work is ~6 GFLOP against ~155 MB, almost all of it the visited experts'
// weights, so reading B bounds it (~46 us at 3.35 TB/s); at decode (16
// rows) even more so.  This version stages tiles through shared memory as
// bf16 (e4m3 -> bf16 is exact) and multiplies with mma.sync m16n8k16
// (bf16 in, f32 accumulate).  wgmma takes an fp8 B only K-major, so its
// redesign needs a transposed quantized weight (ROADMAP B2).
//
// Design.  One CTA per (N tile of 128 columns, visit t of the TilePlan);
// the CTA reads its visit's group and M tile from the plan itself.  It
// loops over K in 128-blocks: per block, the f32 dot of the 128 K
// columns (tensor cores), then acc = acc + (part * s_a[row, kb]) *
// s_b[g, kb, nb] (the order of the reference oracle).  The two kernels
// are one template: the epilogue picks the store and the main loop is
// shared, so B7's accumulator is bit for bit B2's.  The
// Pallas kernels' masked read-modify-write relies on visits of one tile
// running one after another; here those visits run in parallel CTAs, so
// each CTA writes only the rows its group owns and zero-fills the rows >=
// total, never reading the output back.  Owned row sets of different
// visits are disjoint and zero-filled rows are owned by no one, so the
// stores never race.  A visit that repeats the previous (group, tile), or
// whose tile holds no row of its group, skips the K loop and only
// zero-fills.  Rows >= M of a partial last tile are never stored.
//
// B7's store.  The accumulator is rounded through the intermediate dtype
// (bf16: what B2 would store) and staged in shared memory, because a
// row's 128 columns are spread over WARPS_N warps x 4 lanes of the mma
// layout; then one warp per row runs B1's tile quantizer
// (tile_quant.cuh), so the payload and the scales are bitwise those of
// B1 applied to B2's output.  The stage reuses the operand tiles' shared
// memory, WM rows (one warp row of the CTA) at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "tile_quant.cuh"

namespace {

using repro::e4m3x4_to_bf16x4;
using repro::mma_bf16;

constexpr int kThreads = 256;   // 8 warps
constexpr int kBN = 128;        // N tile = one 128-wide scale block of B
constexpr int kKC = 64;         // K columns staged in shared memory at a time
constexpr int kPad = 8;         // bf16 padding of a shared row (bank spread)
constexpr int kStagePad = 4;    // f32 padding of a staged output row

enum Epilogue { kStore = 0, kQuant = 1 };

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the value a store of type T would keep, back in f32
__device__ __forceinline__ float round_through(float x, float*) { return x; }
__device__ __forceinline__ float round_through(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Warps tile the CTA's BM x 128 output as WARPS_M x WARPS_N; a warp owns
// a (BM / WARPS_M) x (128 / WARPS_N) block of m16n8 fragments.  A and B
// are e4m3 with scales.
//   EPI == kStore: out [M, N] of OutT receives the product;
//   EPI == kQuant: q [M, N] e4m3 and s [M, N/128] receive the 1x128
//   quantization of the product rounded through OutT (out unused).
template <int BM, int EPI, typename OutT>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const void* __restrict__ a_, const float* __restrict__ sa,
           const void* __restrict__ b_, const float* __restrict__ sb,
           const int* __restrict__ group_offsets,
           const int* __restrict__ group_ids,
           const int* __restrict__ m_tile_ids, OutT* __restrict__ out,
           uint8_t* __restrict__ q, float* __restrict__ s, int M, int K,
           int N, int G) {
  constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = kBN / WARPS_N;
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int kAsBytes = BM * (kKC + kPad) * 2;
  constexpr int kTileBytes = kAsBytes + kKC * (kBN + kPad) * 2;
  constexpr int kStageBytes = EPI == kQuant ? WM * (kBN + kStagePad) * 4 : 0;
  __shared__ __align__(16) unsigned char smem[kTileBytes > kStageBytes
                                                  ? kTileBytes : kStageBytes];
  auto As = reinterpret_cast<__nv_bfloat16(*)[kKC + kPad]>(smem);
  auto Bs = reinterpret_cast<__nv_bfloat16(*)[kBN + kPad]>(smem + kAsBytes);

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
        const uint8_t* a = static_cast<const uint8_t*>(a_);
        const uint8_t* bg = static_cast<const uint8_t*>(b_) + (size_t)g * K * N;
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

  if constexpr (EPI == kStore) {
    // owned rows get the product, rows >= total get zeros, every other
    // row belongs to another visit and is left alone
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
  } else {
    // quantizing store, one warp row (WM rows) of the tile at a time: the
    // warps of that row stage their rounded fragments, then each warp
    // quantizes whole rows.  Owned rows get B1's payload and scale, rows
    // >= total payload 0 and scale 1, other rows are left alone.
    auto stage = reinterpret_cast<float(*)[kBN + kStagePad]>(smem);
#pragma unroll 1
    for (int p = 0; p < WARPS_M; ++p) {
      __syncthreads();            // the K loop or the previous pass is done
      if (wm == p) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < NI; ++j) {
              const int r = i * 16 + gq + 8 * h;
              const int c = wn * WN + j * 8 + 2 * tq;
              *reinterpret_cast<float2*>(&stage[r][c]) = make_float2(
                  round_through(acc[i][j][2 * h], (OutT*)nullptr),
                  round_through(acc[i][j][2 * h + 1], (OutT*)nullptr));
            }
      }
      __syncthreads();
      for (int r = warp; r < WM; r += kThreads / 32) {
        const int row = row0 + p * WM + r;
        if (row >= M) break;
        const bool owned = work && row >= start && row < end;
        if (!owned && row < total) continue;
        uint8_t* qrow = q + (size_t)row * N + n0;
        float* srow = s + (size_t)row * NB + nb;
        if (owned) {
          const float4 v4 = reinterpret_cast<const float4*>(&stage[r][0])[lane];
          const float v[4] = {v4.x, v4.y, v4.z, v4.w};
          repro::quantize_tile_warp(v, lane, qrow, srow);
        } else {
          reinterpret_cast<uint32_t*>(qrow)[lane] = 0u;
          if (lane == 0) *srow = 1.0f;
        }
      }
    }
  }
}

// block_m 16 (decode) and 128 (prefill) are instantiated; others are refused.
template <int EPI, typename OutT>
int launch(int block_m, int N, int T, cudaStream_t stream, const void* a,
           const void* sa, const void* b, const void* sb, const void* go,
           const void* gi, const void* mi, void* out, void* q, void* s, int M,
           int K, int G) {
  const dim3 grid(N / kBN, T);
  void (*kernel)(const void*, const float*, const void*, const float*,
                 const int*, const int*, const int*, OutT*, uint8_t*, float*,
                 int, int, int, int);
  switch (block_m) {
    case 16:
      kernel = gmm_kernel<16, EPI, OutT>;
      break;
    case 128:
      kernel = gmm_kernel<128, EPI, OutT>;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  kernel<<<grid, kThreads, 0, stream>>>(
      a, (const float*)sa, b, (const float*)sb, (const int*)go,
      (const int*)gi, (const int*)mi, (OutT*)out, (uint8_t*)q, (float*)s, M,
      K, N, G);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch covers the whole plan: grid (N / 128, T visits).

// B2.  out_f32: 1 for an f32 output, 0 for bf16.
extern "C" int gmm_fp8(const void* a, const void* sa, const void* b,
                       const void* sb, const void* group_offsets,
                       const void* group_ids, const void* m_tile_ids, void* out,
                       int M, int K, int N, int G, int T, int block_m,
                       int out_f32, void* stream) {
  auto st = (cudaStream_t)stream;
  if (out_f32)
    return launch<kStore, float>(block_m, N, T, st, a, sa, b, sb,
                                 group_offsets, group_ids, m_tile_ids,
                                 out, nullptr, nullptr, M, K, G);
  return launch<kStore, __nv_bfloat16>(block_m, N, T, st, a, sa, b, sb,
                                       group_offsets, group_ids,
                                       m_tile_ids, out, nullptr,
                                       nullptr, M, K, G);
}

// B7.  q [M, N] e4m3, s [M, N/128] f32; round_f32: 1 to quantize the f32
// accumulator as it is, 0 to round it through bf16 first.
extern "C" int gmm_fp8_quant(const void* a, const void* sa, const void* b,
                             const void* sb, const void* group_offsets,
                             const void* group_ids, const void* m_tile_ids,
                             void* q, void* s, int M, int K, int N, int G,
                             int T, int block_m, int round_f32, void* stream) {
  auto st = (cudaStream_t)stream;
  if (round_f32)
    return launch<kQuant, float>(block_m, N, T, st, a, sa, b, sb,
                                 group_offsets, group_ids, m_tile_ids,
                                 nullptr, q, s, M, K, G);
  return launch<kQuant, __nv_bfloat16>(block_m, N, T, st, a, sa, b, sb,
                                       group_offsets, group_ids,
                                       m_tile_ids, nullptr, q, s, M, K,
                                       G);
}
