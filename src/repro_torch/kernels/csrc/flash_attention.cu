// Causal GQA flash attention, forward, bf16 in and out, on Hopper's own
// machinery: TMA loads into mbarrier rings kept full by a producer warp,
// both products on wgmma, the output stored by TMA.
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
// acc / max(l, 1e-20) rounded to bf16.  exp(x - m) is taken as
// exp2(x log2(e) - m log2(e)) (ex2.approx, ~2^-22 relative).  P . V takes
// p as a bf16 hi + lo pair (p - hi rounded to bf16 again), two products
// per 16 keys, so p enters the product to ~2^-16 relative instead of plain
// bf16's 2^-9; l sums the f32 p.
//
// Bound on the card: at the model's shapes (S 512, D 128) the bytes of q,
// k, v and o (~10 us at 3.35 TB/s for batch 4 x 16 heads) exceed the
// causal FLOPs (~4.3 us at 989 TFLOP/s); at longer S the FLOPs bound.  A
// work item is short (1 to 8 k tiles at S 512), so what costs is the
// serial chain load -> Q K^T -> softmax -> P V of each tile and the
// start and end of each item.
//
// Design.  A work item is a (64-row q tile, b * Hq + h), the heaviest
// (latest) q tiles first.  Persistent CTAs, as many as fit (two an SM at
// D 128, three at D 64), take items in a fixed snake order.  Warpgroup 0 is the
// consumer, one warp after it the producer, whose first thread loads each
// item's q tile and keeps rings of k and v tiles in flight (2 stages
// each), with separate full and empty barriers for q, k and v: the next
// item's q and first tiles load while this item finishes, Q K^T starts
// while v still arrives, and a k slot is refilled once its Q K^T is done.
// Tensor maps view q, k, v and o as 2-D [B * H * S, D] row arrays; a 64-row
// tile of D 128 is two 64-column boxes in the 128-byte swizzle.
//   - S = Q K^T: wgmma m64n64k16, both operands from shared memory, both
//     K-major (q and k rows are D-contiguous), D / 16 steps.
//   - the online softmax runs on the accumulator fragment: a thread holds
//     rows warp * 16 + lane / 4 and that + 8, columns 8 j + 2 (lane % 4)
//     + {0, 1}, so a row's max and sum reduce over the lane quad.
//   - O += P V: wgmma m64nDk16 with A from registers (the accumulator
//     fragments of 16 keys are the A fragment of one k-step, so p never
//     passes through shared memory), B the v tile, D-contiguous, so
//     N-major (transpose bit 1); one product for hi, one for lo.
//   - the output is staged in a buffer of its own in the same swizzled
//     layout and stored by TMA without waiting: the next item's epilogue
//     waits for the store to have read it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
#include "resources.cuh"

namespace {

using namespace hopper;

constexpr int kBlock = 64;                  // q rows of an item; keys of a tile
constexpr int kBoxBytes = kBlock * 128;     // 64 rows x 64 bf16 columns: 8 KB
constexpr int kThreads = 128 + 32;          // consumer warpgroup + producer warp
constexpr int kStages = 2;                  // of the k ring and of the v ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kBoxes = D / 64;                // boxes of a tile
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kCtas = D == 128 ? 2 : 3;       // per SM
  // q tile, o tile, the k ring, the v ring, then the barriers
  static constexpr int kSmem =
      1024 + kTileBytes * (2 + 2 * kStages) + 8 * (2 + 4 * kStages);
};

struct Maps {
  CUtensorMap q, k, v, o;   // [rows, D] bf16: box 64 columns x 64 rows, 128B swizzle
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// p split into bf16 hi + lo: hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16x2(a - __low2float(h), b - __high2float(h));
}

// s = q k^T over a tile's 64 keys: wgmma m64n64k16, both operands
// K-major; a 16-wide D step is 32 bytes along a swizzled row, a 64-wide
// one the next box
template <int D>
__device__ __forceinline__ void qk_product(float (&sc)[32], uint32_t q_addr,
                                           uint32_t k_addr) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks >> 2) * kBoxBytes + (ks & 3) * 32;
    wgmma_m64n64k16<0, 0>(sc, sw128_desc(q_addr + off, 16, 1024),
                          sw128_desc(k_addr + off, 16, 1024), ks != 0);
  }
}

// acc += p v over a tile's 64 keys, p as bf16 hi and lo A fragments
// (words 4kk..4kk+3 for keys 16kk..16kk+15); v N-major: 16 key rows are
// 2 KB on, the second 64 columns one box on
template <int D>
__device__ __forceinline__ void pv_product(float (&acc)[D / 2],
                                           const uint32_t (&ph)[16],
                                           const uint32_t (&pl)[16],
                                           uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = sw128_desc(v_addr + kk * 2048, kBoxBytes, 1024);
    const uint32_t h[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                           ph[4 * kk + 3]};
    const uint32_t o[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                           pl[4 * kk + 3]};
    if constexpr (D == 128) {
      wgmma_m64n128k16_rs<1>(acc, h, db, 1);
      wgmma_m64n128k16_rs<1>(acc, o, db, 1);  // the lo product
    } else {
      wgmma_m64n64k16_rs<1>(acc, h, db, 1);
      wgmma_m64n64k16_rs<1>(acc, o, db, 1);  // the lo product
    }
  }
}

// scale, causal mask (diagonal tile), online softmax of one tile's scores
// in place: sc becomes p; m and l advance; alpha rescales the old acc.
// A thread holds rows r_lo and r_lo + 8, columns 8 jn + 2 (lane % 4) +
// {0, 1}: a row's max and sum reduce over the lane quad.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool diag, int lane, int r_lo,
                                             float scale) {
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * jn + e] * scale;
      if (diag) {
        const int col = jn * 8 + 2 * (lane & 3) + (e & 1);
        if (col > r_lo + (e >> 1) * 8) x = kNegInf;
      }
      sc[4 * jn + e] = x;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * jn], sc[4 * jn + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  const float mb[2] = {mx[0] * kLog2e, mx[1] * kLog2e};
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * jn + e] = exp2f(fmaf(sc[4 * jn + e], kLog2e, -mb[e >> 1]));
      rs[e >> 1] += sc[4 * jn + e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    alpha[i] = exp2f((m[i] - mx[i]) * kLog2e);
    l[i] = l[i] * alpha[i] + rs[i];
    m[i] = mx[i];
  }
}

// the CTA's item of round r: a snake over the heaviest-first order (the
// stride runs backwards on odd rounds), so heavy and light items pair up
__device__ __forceinline__ int item_of(int r) {
  const int g = gridDim.x, c = blockIdx.x;
  return r * g + ((r & 1) ? g - 1 - c : c);
}

// work item i: q tile qt (the heaviest first) of head bh = b * Hq + h
struct Item {
  int bh, qt, q_row, kv_row, n_kt;
  __device__ __forceinline__ Item(int i, int BH, int n_qt, int Hq, int Hkv,
                                  int S, int causal) {
    bh = i % BH;
    qt = n_qt - 1 - i / BH;
    q_row = bh * S + qt * kBlock;
    kv_row = (bh / Hq * Hkv + bh % Hq / (Hq / Hkv)) * S;
    n_kt = causal ? qt + 1 : n_qt;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kCtas)
flash_attention_kernel(const __grid_constant__ Maps maps, int BH, int Hq,
                       int Hkv, int S, int causal, float scale) {
  using C = Cfg<D>;
  constexpr int kTile = C::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                 // the item's q tile
  uint8_t* os = qs + kTile;           // the staged o tile
  uint8_t* kring = os + kTile;
  uint8_t* vring = kring + kStages * kTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vring + kStages * kTile);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  const int tid = threadIdx.x;
  const int n_qt = S / kBlock, items = BH * n_qt;

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4);                    // one arrival per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 4);
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128) {
    // producer: each item's q tile, then its k and v tiles through the
    // rings; j counts tiles over all of this CTA's items
    if (tid == 128) {
      int j = 0, n = 0;
      for (int i = item_of(0); i < items; i = item_of(++n)) {
        const Item it(i, BH, n_qt, Hq, Hkv, S, causal);
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, kTile);
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load_2d(qs + c * kBoxBytes, &maps.q, q_full, 64 * c, it.q_row);
        for (int t = 0; t < it.n_kt; ++t, ++j) {
          const int s = j % kStages;
          const uint32_t par = ((j / kStages) & 1) ^ 1;
          const int row = it.kv_row + t * kBlock;
          mbar_wait(&k_empty[s], par);
          mbar_expect_tx(&k_full[s], kTile);
          for (int c = 0; c < C::kBoxes; ++c)
            tma_load_2d(kring + s * kTile + c * kBoxBytes, &maps.k, &k_full[s],
                        64 * c, row);
          mbar_wait(&v_empty[s], par);
          mbar_expect_tx(&v_full[s], kTile);
          for (int c = 0; c < C::kBoxes; ++c)
            tma_load_2d(vring + s * kTile + c * kBoxBytes, &maps.v, &v_full[s],
                        64 * c, row);
        }
      }
    }
    return;
  }

  // consumer warpgroup: this thread's rows r_lo and r_lo + 8 of a q tile
  const int warp = tid >> 5, lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);
  const uint32_t q_addr = smem_u32(qs);
  float acc[D / 2];                   // m64nD accumulator: acc[4 jd + e]
  float sc[32];                       // m64n64 scores: sc[4 jn + e]
  uint32_t ph[16], pl[16];            // p as bf16 hi / lo A fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  int j = 0, n = 0;
  for (int i = item_of(0); i < items; i = item_of(++n)) {
    const Item it(i, BH, n_qt, Hq, Hkv, S, causal);
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    float alpha[2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    mbar_wait(q_full, n & 1);
    for (int t = 0; t < it.n_kt; ++t, ++j) {
      const int s = j % kStages;
      const uint32_t par = (j / kStages) & 1;
      mbar_wait(&k_full[s], par);
      wgmma_fence();
      qk_product<D>(sc, q_addr, smem_u32(kring + s * kTile));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) {
        mbar_arrive(&k_empty[s]);
        if (t == it.n_kt - 1) mbar_arrive(q_empty);   // q is read
      }
      softmax_tile(sc, m, l, alpha, causal && t == it.qt, lane, r_lo, scale);
      // acc carries max m(t-1): rescale to m(t), then p(t) joins at m(t)
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * jd + e] *= alpha[e >> 1];
      }
      // the A fragment of k-step kk (keys 16kk..16kk+15) is the score
      // fragments of columns 16kk.. (jn = 2kk) and 16kk+8.. (2kk+1)
#pragma unroll
      for (int w = 0; w < 16; ++w)
        split_pair(sc[2 * w], sc[2 * w + 1], ph[w], pl[w]);
      mbar_wait(&v_full[s], par);
      wgmma_fence();
      pv_product<D>(acc, ph, pl, smem_u32(vring + s * kTile));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      if (lane == 0) mbar_arrive(&v_empty[s]);
    }

    // o = acc / max(l, 1e-20) in bf16, staged once the previous item's
    // store has read the buffer, then stored by TMA without waiting
    if (tid == 0)
      tma_store_wait_read<0>();
    bar_sync(1, 128);
    const float dn[2] = {fmaxf(l[0], 1e-20f), fmaxf(l[1], 1e-20f)};
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const int col = jd * 8 + 2 * (lane & 3);
      uint8_t* box = os + (col >> 6) * kBoxBytes;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(box + sw128_offset(r_lo + 8 * h,
                                                        (col & 63) * 2)) =
            pack_bf16x2(acc[4 * jd + 2 * h] / dn[h],
                        acc[4 * jd + 2 * h + 1] / dn[h]);
    }
    fence_proxy_async();
    bar_sync(1, 128);
    if (tid == 0) {
      for (int c = 0; c < C::kBoxes; ++c)
        tma_store_2d(&maps.o, os + c * kBoxBytes, 64 * c, it.q_row);
      tma_store_commit();
    }
  }
  if (tid == 0) tma_store_wait_all();
}

template <int D>
int launch(const Maps& maps, cudaStream_t stream, int BH, int Hq, int Hkv,
           int S, int causal, float scale) {
  auto kernel = flash_attention_kernel<D>;
  static int ctas = 0;                        // resident CTAs on the card
  if (ctas == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::kSmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, Cfg<D>::kSmem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    ctas = sms * per_sm;
  }
  const int items = BH * (S / kBlock);
  kernel<<<min(items, ctas), kThreads, Cfg<D>::kSmem, stream>>>(
      maps, BH, Hq, Hkv, S, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t, or 1000 + the CUresult of a failed tensor-map
// encoding.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int Hq,
                                    int Hkv, int S, int D, int causal,
                                    float scale, void* stream) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t q_rows = (uint64_t)B * Hq * S, kv_rows = (uint64_t)B * Hkv * S;
  const void* bases[4] = {q, k, v, o};
  CUtensorMap* dst[4] = {&maps.q, &maps.k, &maps.v, &maps.o};
  for (int i = 0; i < 4; ++i) {
    const CUresult r = encode_rows_sw128(dst[i], bases[i],
                                         i == 1 || i == 2 ? kv_rows : q_rows,
                                         (uint64_t)D, kBlock);
    if (r != CUDA_SUCCESS) return 1000 + (int)r;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == 128) return launch<128>(maps, st, B * Hq, Hq, Hkv, S, causal, scale);
  return launch<64>(maps, st, B * Hq, Hq, Hkv, S, causal, scale);
}


// The resources of one variant (resources.cuh): a = the head dim (64 or
// 128); b and c are unused.
extern "C" int kernel_resources(int d, int, int, int* out) {
  if (d == 128)
    return repro::query_resources(flash_attention_kernel<128>, kThreads,
                                  Cfg<128>::kSmem, out);
  if (d == 64)
    return repro::query_resources(flash_attention_kernel<64>, kThreads,
                                  Cfg<64>::kSmem, out);
  return (int)cudaErrorInvalidValue;
}
