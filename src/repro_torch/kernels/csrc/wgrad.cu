// Ragged-contraction (wgrad) grouped GEMM on e4m3 operands:
// dw[g] = x[rows of g]^T @ dy[rows of g], each row dequantized by its 1x128
// scales.
//
// Replaces: src/repro/kernels/wgrad_kernel.py::gmm_pallas_wgrad_fp8 (B6:
// e4m3 operands with their 1x128 scales; the bf16 B4 is wgrad_bf16.cu).
// x [M, K], dy [M, N]; rows [offsets[g], offsets[g+1]) belong to group g
// and are contracted into dw[g] [K, N] f32.  Rows at or beyond offsets[G]
// never enter; a group with no rows gets zeros.
//
// Bound on the card: at the training path's shapes (16384 rows over 60
// groups, K/N 2048/1408) the work is 94.5 GFLOP against ~760 MB, most of
// it the f32 output, so writing dw bounds it (~0.21 ms at 3.35 TB/s,
// against ~0.1 ms of bf16 tensor-core time).  This version stages the
// operands synchronously through shared memory and multiplies with
// mma.sync m16n8k16 (bf16 in, f32 accumulate); wgmma, TMA and a pipelined
// load come in a later version.
//
// Design.  The Pallas kernel accumulates a group's visits one after
// another into one resident output block; CTAs run in parallel and in no
// order, so here one CTA owns one output tile (group g, 128 rows of K,
// 128 columns of N) and itself loops over its group's rows, 32 at a time,
// starting at offsets[g]: no atomics, no two CTAs on one output, so the
// result is deterministic and written once.  Rows of the last chunk past
// offsets[g+1] are replaced by zeros with a select before the product
// (they may hold NaN, and 0 * NaN poisons a sum); rows before offsets[g]
// are never read.  Both operands are staged row-major ([m][k], [m][n]) and
// ldmatrix.trans hands the tensor cores their transposes.
//
// The e4m3 payload of x is exact in bf16.  Each contracted row m has
// one scale pair sx[m, kb] * sdy[m, nb] for the CTA's tile; it varies
// along the contraction, so it is folded into the dy operand in f32,
// which then enters the product as a bf16 hi + lo pair (two products):
// about 16 bits of the f32 value instead of one bf16 rounding's 8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using repro::e4m3_to_float;
using repro::mma_bf16;

constexpr int kThreads = 256;   // 8 warps: 2 along K x 4 along N
constexpr int kTile = 128;      // the CTA's K and N extent (a 1x128 scale block)
constexpr int kMC = 32;         // contracted rows staged per step
constexpr int kLd = kTile + 8;  // bf16 pitch of a staged row: 272 B, conflict-free ldmatrix

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// e4m3 operands: one 16-byte vector (16 values) of x and of dy per thread.
// x -> bf16 (exact); dy -> (q * sdy) * sx in f32 -> bf16 hi and lo.
__device__ __forceinline__ void stage_fp8(
    const uint8_t* __restrict__ x, const float* __restrict__ sx,
    const uint8_t* __restrict__ dy, const float* __restrict__ sdy,
    int m0, int end, int K, int N, int k0, int n0,
    __nv_bfloat16 (*Xs)[kLd], __nv_bfloat16 (*Dh)[kLd], __nv_bfloat16 (*Dl)[kLd]) {
  const int r = threadIdx.x >> 3, c = (threadIdx.x & 7) * 16;
  const int row = m0 + r;
  uint32_t xo[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t hi[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t lo[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (row < end) {
    const uint4 vx = *reinterpret_cast<const uint4*>(x + (size_t)row * K + k0 + c);
    const uint4 vd = *reinterpret_cast<const uint4*>(dy + (size_t)row * N + n0 + c);
    const float s_x = sx[(size_t)row * (K / kTile) + k0 / kTile];
    const float s_dy = sdy[(size_t)row * (N / kTile) + n0 / kTile];
    const uint32_t wx[4] = {vx.x, vx.y, vx.z, vx.w};
    const uint32_t wd[4] = {vd.x, vd.y, vd.z, vd.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint2 xb = repro::e4m3x4_to_bf16x4(wx[w]);
      xo[2 * w] = xb.x;
      xo[2 * w + 1] = xb.y;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float v[2], h[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const uint32_t byte = (wd[w] >> (8 * (2 * p + t))) & 0xffu;
          v[t] = __fmul_rn(__fmul_rn(e4m3_to_float(byte), s_dy), s_x);
        }
        const __nv_bfloat162 vh = __floats2bfloat162_rn(v[0], v[1]);
        h[0] = __low2float(vh);
        h[1] = __high2float(vh);
        hi[2 * w + p] = bf16x2_bits(vh);
        lo[2 * w + p] = bf16x2_bits(
            __floats2bfloat162_rn(__fsub_rn(v[0], h[0]), __fsub_rn(v[1], h[1])));
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    *reinterpret_cast<uint4*>(&Xs[r][c + 8 * h]) =
        make_uint4(xo[4 * h], xo[4 * h + 1], xo[4 * h + 2], xo[4 * h + 3]);
    *reinterpret_cast<uint4*>(&Dh[r][c + 8 * h]) =
        make_uint4(hi[4 * h], hi[4 * h + 1], hi[4 * h + 2], hi[4 * h + 3]);
    *reinterpret_cast<uint4*>(&Dl[r][c + 8 * h]) =
        make_uint4(lo[4 * h], lo[4 * h + 1], lo[4 * h + 2], lo[4 * h + 3]);
  }
}

// grid (N / 128, K / 128, G).  A warp owns 64 rows of K x 32 columns of
// N: 4 x 4 m16n8 accumulator fragments.  The MMA's A operand is x^T
// (rows k, contraction m), its B operand dy (contraction m, columns n).
__global__ void __launch_bounds__(kThreads)
wgrad_fp8_kernel(const uint8_t* __restrict__ x, const float* __restrict__ sx,
                 const uint8_t* __restrict__ dy, const float* __restrict__ sdy,
                 const int* __restrict__ offsets, float* __restrict__ dw,
                 int M, int K, int N) {
  constexpr int kParts = 2;              // dy as a bf16 hi + lo pair
  __shared__ __align__(16) __nv_bfloat16 Xs[kMC][kLd];
  __shared__ __align__(16) __nv_bfloat16 Ds[kParts][kMC][kLd];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;        // mma group / thread-in-group
  const int q = lane >> 3, r8 = lane & 7;         // ldmatrix matrix / row
  const int wk = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int n0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile, g = blockIdx.z;
  const int start = min(offsets[g], M), end = min(offsets[g + 1], M);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  for (int m0 = start; m0 < end; m0 += kMC) {
    stage_fp8(x, sx, dy, sdy, m0, end, K, N, k0, n0, Xs, Ds[0], Ds[1]);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kMC; ks += 16) {
      // A fragments: matrix q covers k rows +8*(q&1), contraction rows +8*(q>>1)
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4_trans(af[i], &Xs[ks + (q >> 1) * 8 + r8][wk + i * 16 + (q & 1) * 8]);
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        // B fragments of two n8 blocks per ldmatrix: matrix q covers
        // contraction rows +8*(q&1), columns +8*(q>>1)
        uint32_t bfr[4][2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t t[4];
          ldsm_x4_trans(t, &Ds[p][ks + (q & 1) * 8 + r8][wn + jj * 16 + (q >> 1) * 8]);
          bfr[2 * jj][0] = t[0];
          bfr[2 * jj][1] = t[1];
          bfr[2 * jj + 1][0] = t[2];
          bfr[2 * jj + 1][1] = t[3];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
      }
    }
    __syncthreads();
  }

  // every CTA writes its whole tile once: an empty group's tile is zeros
  float* out = dw + ((size_t)g * K + k0) * N + n0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = wk + i * 16 + gq + 8 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(out + (size_t)kr * N + wn + j * 8 + 2 * tq) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
}

}  // namespace

// One launch covers every group: grid (N / 128, K / 128, G).  K and N
// are multiples of 128; offsets [G + 1] int32; dw [G, K, N] f32.
extern "C" int wgrad_fp8(const void* x, const void* sx, const void* dy,
                         const void* sdy, const void* offsets, void* dw, int M,
                         int K, int N, int G, void* stream) {
  const dim3 grid(N / kTile, K / kTile, G);
  wgrad_fp8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const float*)sx, (const uint8_t*)dy,
      (const float*)sdy, (const int*)offsets, (float*)dw, M, K, N);
  return (int)cudaGetLastError();
}
