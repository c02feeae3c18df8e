// Causal GQA flash attention, forward, bf16 in and out.
//
// Replaces: src/repro/kernels/flash_attention_kernel.py:75 flash_attention
// (the Pallas kernel _flash_kernel).
// q [B, Hq, S, D], k/v [B, Hkv, S, D] -> o [B, Hq, S, D]; q-head h reads
// kv-head h / (Hq / Hkv).  D in {64, 128}, S % 64 == 0.
//
// Arithmetic, as the reference's: s = (q . k) * D^-0.5 in f32, -1e30 on
// the masked entries of the diagonal tile, an online softmax whose running
// max m, denominator l and accumulator acc stay in f32 registers across
// the k tiles, k tiles wholly above the diagonal skipped, then
// acc / max(l, 1e-20) rounded to bf16.  P . V takes p as a bf16 hi + lo
// pair (p - hi rounded to bf16 again), two mma.sync per tile, so p enters
// the product to ~2^-16 relative instead of plain bf16's 2^-9; l sums the
// f32 p.
//
// Design (simple first): one CTA per (64-row q tile, b * Hq + h), 4 warps
// of 16 q rows each.  The q tile is staged once through shared memory into
// mma A fragments held in registers; each k/v tile is staged synchronously
// into shared memory (rows padded by 16 bytes, so the fragment loads hit
// distinct banks) and both products run on mma.sync m16n8k16 bf16 -> f32.
// Row max and sum are reduced over the lane quad that shares a row.  Heavy
// (late) q tiles are launched first.
//
// Bound on the card: at the model's shapes (S 512, D 128) the bytes of q,
// k, v and o (~10 us at 3.35 TB/s) exceed the causal FLOPs (~4.3 us at
// 989 TFLOP/s); at longer S the FLOPs bound.  Left on the table: wgmma
// (mma.sync tops out well below the tensor cores' peak), TMA with an
// mbarrier ring so loads overlap the products (here every tile load is a
// full stop), warp specialisation, and the hi + lo pair's second P . V
// product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kBlock = 64;     // q rows and k rows of a tile
constexpr int kThreads = 128;  // 4 warps x 16 q rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 values (lower index in the low half) as one mma operand word
__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return (uint32_t)(*reinterpret_cast<uint16_t*>(&lo)) |
         ((uint32_t)(*reinterpret_cast<uint16_t*>(&hi)) << 16);
}

// p split into bf16 hi + lo: hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16x2(a - __low2float(h), b - __high2float(h));
}

// a 64 x D tile of bf16 rows (row stride D in global memory) into shared
// memory (row stride D + 8), 16 bytes a thread per step
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src) {
  constexpr int kChunksPerRow = D / 8;
  for (int c = threadIdx.x; c < kBlock * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow, col = (c % kChunksPerRow) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + col) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + col);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int S,
                       int causal, float scale) {
  constexpr int kStride = D + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kBlock * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlock * kStride];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;  // mma fragment row / column pair
  const int bh = blockIdx.x;                  // b * Hq + h
  const int qt = gridDim.y - 1 - blockIdx.y;  // q tile, the heaviest first
  const int b = bh / Hq, h = bh % Hq;
  const size_t kv_off = (size_t)(b * Hkv + h / (Hq / Hkv)) * S * D;
  const size_t q_off = ((size_t)bh * S + (size_t)qt * kBlock) * D;

  // the warp's 16 q rows as mma A fragments, staged through ks
  stage_tile<D>(ks, q + q_off);
  __syncthreads();
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* r0 = ks + (warp * 16 + grp) * kStride + tig * 2;
    const __nv_bfloat16* r1 = r0 + 8 * kStride;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(r0 + kk * 16);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(r1 + kk * 16);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + kk * 16 + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + kk * 16 + 8);
    }
  }
  __syncthreads();

  // this thread's two rows: grp and grp + 8 of the warp's 16
  const int row0 = qt * kBlock + warp * 16 + grp;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int n_kt = causal ? qt + 1 : S / kBlock;
  for (int j = 0; j < n_kt; ++j) {
    stage_tile<D>(ks, k + kv_off + (size_t)j * kBlock * D);
    stage_tile<D>(vs, v + kv_off + (size_t)j * kBlock * D);
    __syncthreads();

    // s = q k^T over the tile's 64 keys: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = ks + (nt * 8 + grp) * kStride + tig * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t bk[2] = {
            *reinterpret_cast<const uint32_t*>(kr + kk * 16),
            *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8)};
        repro::mma_bf16(s[nt], qa[kk], bk);
      }
    }
    const bool diag = causal && j == qt;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (diag) {
          const int col = j * kBlock + nt * 8 + tig * 2 + (e & 1);
          if (col > row0 + (e >> 1) * 8) x = kNegInf;
        }
        s[nt][e] = x;
      }
    }

    // online softmax: new row max, rescale, p and its row sum
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      const float alpha = expf(m[i] - mx[i]);
      l[i] = l[i] * alpha + rs[i];
      m[i] = mx[i];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * i] *= alpha;
        acc[dt][2 * i + 1] *= alpha;
      }
    }

    // acc += p v: 4 k-steps of 16 keys; the A fragment of keys
    // 16kk..16kk+15 is the C fragments of n-tiles 2kk and 2kk+1
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      // B fragment: v[key 16kk + 2tig (+1) (+8)][col 8dt + grp]
      const __nv_bfloat16* vr = vs + (kk * 16 + tig * 2) * kStride + grp;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* c = vr + dt * 8;
        const uint32_t bv[2] = {pack_raw(c[0], c[kStride]),
                                pack_raw(c[8 * kStride], c[9 * kStride])};
        repro::mma_bf16(acc[dt], ph, bv);
        repro::mma_bf16(acc[dt], pl, bv);
      }
    }
    __syncthreads();  // the next tile overwrites ks and vs
  }

  const float d0 = fmaxf(l[0], 1e-20f), d1 = fmaxf(l[1], 1e-20f);
  __nv_bfloat16* o0 = o + q_off + (size_t)(warp * 16 + grp) * D + tig * 2;
  __nv_bfloat16* o1 = o0 + 8 * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(o0 + dt * 8) =
        pack_bf16x2(acc[dt][0] / d0, acc[dt][1] / d0);
    *reinterpret_cast<uint32_t*>(o1 + dt * 8) =
        pack_bf16x2(acc[dt][2] / d1, acc[dt][3] / d1);
  }
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int Hq,
                                    int Hkv, int S, int D, int causal,
                                    float scale, void* stream) {
  const dim3 grid((unsigned)(B * Hq), (unsigned)(S / kBlock));
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* qp = (const __nv_bfloat16*)q;
  const auto* kp = (const __nv_bfloat16*)k;
  const auto* vp = (const __nv_bfloat16*)v;
  auto* op = (__nv_bfloat16*)o;
  if (D == 128) {
    flash_attention_kernel<128><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, Hq, Hkv, S, causal, scale);
  } else if (D == 64) {
    flash_attention_kernel<64><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, Hq, Hkv, S, causal, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
