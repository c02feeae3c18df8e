// B2 and B7, the padding-free fp8 grouped GEMMs over the TilePlan, on
// Hopper's own machinery: persistent CTAs, TMA loads of the e4m3 tiles
// into a deep mbarrier ring kept full by a producer thread, the tiles
// widened to f16 on their way into wgmma, and TMA stores of the owned rows
// only, through a pool of power-of-two store descriptors (the paper's
// mechanism).  The bf16 twin, B5, is gmm_bf16.cu.
//
// Replaces, in src/repro/kernels/grouped_gemm_kernel.py:
//   gmm_pallas        (B2)  fp8 A, B -> bf16/f32 out          gmm_fp8
//   gmm_pallas_quant  (B7)  fp8 A, B -> e4m3 out + 1x128 s    gmm_fp8_quant
// A [M, K] e4m3 with 1x128 scales s_a [M, K/128]; B [G, K, N] e4m3
// (N-contiguous, as the weights lie) with 128x128 scales
// s_b [G, K/128, N/128]; rows [offsets[g], offsets[g+1]) of A belong to
// group g.  The owned rows get A_g @ B_g, rows >= sum(sizes) get zeros
// (B7: payload 0, scale 1).
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s f16/bf16):
//   - prefill (1024 rows, ~19 owned rows per visited expert, K/N
//     2048/1408): 5.8 GFLOP against ~155 MB, almost all of it the visited
//     experts' weights, so bytes (~46 us);
//   - decode (16 rows): the visited weights alone, bytes;
//   - training (16384 rows): 94.5 GFLOP against ~230 MB, so the f16
//     products (~96 us) above the bytes (~69 us).
// What the design does about it:
//   - wgmma takes a B operand from shared memory in fp8 only K-major, and
//     the weights are N-contiguous; fp8 wgmma also adds its products in
//     fewer bits than f32 inside a 128-K block.  So the e4m3 tiles are
//     widened to f16 (exact: every e4m3 value is an f16 value, and
//     cvt.rn.f16x2.e4m3x2 widens two in one instruction, NaN included)
//     and multiplied on f16 wgmma with f32 sums, as B5 multiplies bf16:
//     B into a double-buffered, 128-byte-swizzled f16 tile (read with the
//     transpose bit), A straight from its e4m3 TMA tile into registers
//     (the RS form), so A costs no shared-memory writes or rereads;
//   - the CTAs are persistent (one an SM, walking the (visit, N tile)
//     items N tile fastest), so the ring streams across items with no
//     launch, barrier set-up or first-load latency per item; its 5
//     (tall instance) or 8 (decode instance) stages of 128-K blocks keep
//     ~120-150 KB of loads in flight per SM;
//   - the widening of block kb + 1 runs while the wgmma of block kb is in
//     flight, with one named barrier over the consumers a block; the
//     scales are loaded two blocks ahead;
//   - an item loads and multiplies only the 64-row slabs holding its
//     owned rows, from its first owned row on;
//   - the accumulator is staged in shared memory (over the f16 tiles,
//     free between pieces) and only the owned rows are stored, by TMA, as
//     pieces of 2^i rows (37 = 32 + 4 + 1) through a pool of descriptors
//     of box heights 1, 2, ..., min(block_m, 128): 4 at block_m 8, 5 at
//     16, 7 at 64 and 8 from 128 on (a store is no taller than the
//     128-row stage); rows >= total are zero-filled the same way by their
//     tile's first visit.  Owned row sets of different visits are
//     disjoint, so CTAs never race, and the output is never read back.
//
// Schedule.  An item is (visit t of the TilePlan, block_n-wide N tile),
// walked as the pieces of tile_geom.cuh: sub-tiles of at most 128 rows
// (block_m 256 and 512) by 128-column halves (block_n 256), each a
// 128-column product and store as below.  A piece whose visit
// repeats the previous (group, tile), or owns no row, loads and
// multiplies nothing; producer and consumers take that decision from the
// same values and count the ring's blocks alike.  Two consumer
// warpgroups split the piece's output: a piece whose owned rows span two
// 64-row slabs gives each one slab (m64n128); a piece with one slab
// (every decode piece, most prefill pieces, every piece at block_m 64)
// gives each 64 of its columns (m64n64), so both are busy and each runs
// half the chain.  At block_m 8 and 16 (the decode instance) the slab is
// an A box of block_m rows; the wgmma rows past it are zeros, computed
// and never stored.  A third warpgroup is the producer; its first thread
// issues the loads, and it hands its registers to the consumers
// (setmaxnreg: 40 against 232 a thread), who hold the accumulator, the
// block's partial and its A fragments with no spill.
//
// Where the time goes on the card (PERF.md): the consumers, not HBM; the
// producer mostly waits for free stages.  Per 128-K block they widen B,
// wait for their products, take the next A fragments and rescale, and
// the rescale and the widening cost the most; shared memory carries the
// TMA writes, the widening and wgmma's reads of B.  fp8 wgmma on a K-major
// weight (ROADMAP B) would halve the widened bytes and the products.
//
// The A fragments come from the e4m3 tile as one 32-bit word (4 K values)
// per row and 16-K step, so a thread's f16x2 words hold K 4t..4t+1 and
// 4t+2..4t+3 where wgmma expects 2t..2t+1 and 2t+8..2t+9: the widening of
// B writes K row 4t + v of each 16-row group to f16 row
// 2t + (v & 1) + 8 (v >> 1), the same permutation, so every product pairs
// the right K.
//
// Numerics.  Per 128-K block (one ring stage) one f32 partial on the
// tensor cores, then acc = acc + (part * s_a[row, kb]) * s_b[g, kb, nb]
// with __fmul_rn / __fadd_rn: the order of the reference's oracle.  B2
// and B7 are one template and share the main loop, so B7's accumulator
// is bit for bit B2's.
//
// B7's store.  The accumulator is rounded through the intermediate dtype
// (bf16: what B2 would store); a row's columns sit in 4 lanes of a
// fragment (of each warpgroup when they split the columns, whose halves
// meet in shared memory), which take its amax by two shuffles and
// quantize their values with B1's arithmetic (tile_quant.cuh), so the
// payload and the scales are bitwise those of B1 applied to B2's output.
// The payload is staged and leaves through an e4m3 store pool of the same
// heights; the scales, s [M, N/128] (a row stride of 44 bytes at
// N = 1408, which TMA cannot take), by plain stores.
//
// Shared memory (dynamic, 1024-byte aligned for the 128-byte swizzle):
// the ring, kStages x [NS A boxes of 128 K x (64 or 16) rows | B 128 K x
// 128 N], all e4m3 (at block_m 8 the A box fills half its 16-row slot);
// two f16 B tiles of 128 K x 128 N, also the output stage; the full and
// empty barriers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "fp8.cuh"
#include "hopper.cuh"
#include "tile_quant.cuh"
#include "resources.cuh"
#include "tile_geom.cuh"

namespace {

using namespace hopper;

constexpr int kBN = 128;                       // N tile: one scale block of B
constexpr int kBK = 128;                       // K per stage: one scale block
constexpr int kSlab = 64;                      // rows of one wgmma
constexpr int kBBytes = kBK * kBN;             // e4m3 B tile, 16 KB
constexpr int kWideBytes = kBK * kBN * 2;      // f16 B tile, 32 KB
constexpr int kPool = 8;                       // store descriptors, heights 1..128
constexpr int kConsumers = 256;                // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;     // and the producer warpgroup

enum Epilogue { kStore = 0, kQuant = 1 };

struct Maps {
  CUtensorMap a;              // A [M, K] e4m3: box 128 K x (64 or 16) rows, 128B swizzle
  CUtensorMap b;              // B [G, K, N] e4m3: box 128 N x 128 K x 1, 128B swizzle
  CUtensorMap store[kPool];   // out [M, N] (B2) or q [M, N] (B7): box 128 x 2^i rows
};

// BM: the instance, the most rows of a piece (16 or 128)
template <int BM>
struct Shape {
  static constexpr int NS = BM == 128 ? 2 : 1;        // 64-row slabs of a tile
  static constexpr int kARows = BM < kSlab ? BM : kSlab;
  static constexpr int kABytes = kARows * kBK;        // one A box
  static constexpr int kStages = BM == 128 ? 5 : 8;
  static constexpr int kStageBytes = NS * kABytes + kBBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kRingBytes + 2 * kWideBytes + 2 * kStages * 8;
  // B2's stage (f32 at most), or B7's payload then its rows' half amaxes
  static_assert(BM * kBN * 4 <= 2 * kWideBytes, "B2's stage must fit");
  static_assert(BM * kBN + BM * 8 <= 2 * kWideBytes, "B7's stage must fit");
  static_assert(kSmem <= 232448, "one CTA's shared memory");
};

using repro::Geom;
using repro::Piece;

// Calls f(piece) on each piece of the CTA's items (items stride by the
// grid), an item's pieces in turn.  The tall instance walks them with one
// counter, u = item x 2^shift + piece: its consumers' registers are
// spoken for by the main loop, and two counters cost them a spill.  The
// decode instance walks a loop an item, which measured faster there (its
// CTAs step over mostly empty items).
template <int BM, typename F>
__device__ __forceinline__ void walk_pieces(const Geom& q, int items, int NT,
                                            const int* go, const int* gi,
                                            const int* mi, int M, int G,
                                            F&& f) {
  if constexpr (BM == repro::kPieceRowsMax) {
    const int sh = q.shift;
    for (int u = blockIdx.x << sh; u < items << sh;) {
      const int w = u >> sh;
      f(repro::make_piece(q, w / NT, u - (w << sh), w % NT, go, gi, mi, M, G));
      u = ((u + 1) & ((1 << sh) - 1)) ? u + 1 : (w + gridDim.x) << sh;
    }
  } else {
    for (int w = blockIdx.x; w < items; w += gridDim.x)
      for (int p = 0; p < q.pieces; ++p)
        f(repro::make_piece(q, w / NT, p, w % NT, go, gi, mi, M, G));
  }
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

using repro::e4m3x2_to_f16x2;

// m64nWNk16 on f16, A from registers, B N-major from shared memory
template <int WN>
__device__ __forceinline__ void wgmma_f16(float (&d)[WN / 2], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  if constexpr (WN == 128)
    wgmma_m64n128k16_rs_f16<1>(d, a, db, scale_d);
  else
    wgmma_m64n64k16_rs_f16<1>(d, a, db, scale_d);
}

// Widen 16-byte chunk `e` (of 1024) of the e4m3 B tile (128 K rows of 128
// N bytes, as TMA's 128-byte swizzle lays them) to f16 in the N-major
// layout wgmma reads: K row k goes to f16 row (k & ~15) + the A
// fragments' permutation of k & 15, values 16c..16c+15 to bytes
// [32(c%4), 32(c%4) + 32) of that row in the 64-column tile c/4; the two
// column tiles are 8 KB apart, the two 64-K halves 16 KB apart.  A
// quarter warp takes K rows 2p and 2p + 1 (f16 rows of one even / odd
// pair), chunks 0-3 of one and 4-7 of the other, so its 16-byte reads and
// writes each hit 8 distinct bank groups.
__device__ __forceinline__ void widen_b_chunk(const uint8_t* src, uint8_t* dst,
                                              int e) {
  const int w = e & 15, j = w & 7;
  const int k = 2 * (e >> 4) + (j >> 2);
  const int c16 = (j & 3) + 4 * ((j >> 2) ^ (w >> 3));
  const uint4 v = *reinterpret_cast<const uint4*>(src + sw128_offset(k, 16 * c16));
  const uint4 lo = make_uint4(e4m3x2_to_f16x2(v.x), e4m3x2_to_f16x2(v.x >> 16),
                              e4m3x2_to_f16x2(v.y), e4m3x2_to_f16x2(v.y >> 16));
  const uint4 hi = make_uint4(e4m3x2_to_f16x2(v.z), e4m3x2_to_f16x2(v.z >> 16),
                              e4m3x2_to_f16x2(v.w), e4m3x2_to_f16x2(v.w >> 16));
  const int q = k & 15;
  const int row = (k & 48) + 2 * (q >> 2) + (q & 1) + 8 * ((q >> 1) & 1);
  uint8_t* d = dst + (k >> 6) * 16384 + (c16 >> 2) * 8192;
  const int b = 32 * (c16 & 3);
  *reinterpret_cast<uint4*>(d + sw128_offset(row, b)) = lo;
  *reinterpret_cast<uint4*>(d + sw128_offset(row, b + 16)) = hi;
}

// A fragments of one 128-K block for the thread's rows r0 and r0 + 8 of
// the slab's e4m3 box: af[ks] = {row r0: K 16ks + 4t + {0, 1}, row r0 + 8:
// the same, row r0: K 16ks + 4t + {2, 3}, row r0 + 8: the same}, t = lane
// % 4.  Rows past a box of fewer than 64 rows (a_rows: 8 or 16) are zeros.
template <int BM>
__device__ __forceinline__ void load_a(const uint8_t* abox, uint32_t (&af)[8][4],
                                       int r0, int t, int a_rows) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    if (BM < kSlab && r0 >= a_rows) {
      af[ks][0] = af[ks][1] = af[ks][2] = af[ks][3] = 0u;
      continue;
    }
    const int off = (((ks ^ r0) & 7) << 4) + 4 * t;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(abox + r0 * 128 + off);
    const uint32_t w1 =
        BM < kSlab && r0 + 8 >= a_rows
            ? 0u
            : *reinterpret_cast<const uint32_t*>(abox + (r0 + 8) * 128 + off);
    af[ks][0] = e4m3x2_to_f16x2(w0);
    af[ks][1] = e4m3x2_to_f16x2(w1);
    af[ks][2] = e4m3x2_to_f16x2(w0 >> 16);
    af[ks][3] = e4m3x2_to_f16x2(w1 >> 16);
  }
}

// TMA-store `count` (<= BM, the instance's piece height) staged rows of
// `row_bytes` from staged row `srow` to output row `grow`, as one piece
// per set bit of `count`, largest first
template <int BM>
__device__ __forceinline__ void store_rows(const Maps& maps, const uint8_t* staged,
                                           int row_bytes, int srow, int grow,
                                           int count, int n0) {
  constexpr int kLog = BM == 128 ? 7 : 4;
#pragma unroll
  for (int b = kLog; b >= 0; --b) {
    if (count & (1 << b)) {
      tma_store_2d(&maps.store[b], staged + (size_t)srow * row_bytes, n0, grow);
      srow += 1 << b;
      grow += 1 << b;
    }
  }
}

// One piece's products and store.  The two consumer warpgroups split its
// output as WN says: WN 128 (a piece with two slabs of owned rows), one
// 64-row slab each on m64n128; WN 64 (one slab, or none), 64 columns each
// of the first slab on m64n64, so both are busy and each runs half the
// chain.  `it` counts the ring's blocks; a_rows: rows of an A box.
template <int BM, int EPI, typename OutT, int WN>
__device__ __forceinline__ void consume(const Maps& maps, const Piece& I, int& it,
                                        uint8_t* ring, uint8_t* wide,
                                        uint64_t* full, uint64_t* empty,
                                        const float* __restrict__ sa,
                                        const float* __restrict__ sb,
                                        float* __restrict__ s, int M, int KB,
                                        int NB, int a_rows) {
  using S = Shape<BM>;
  constexpr int NS = S::NS;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  // this warpgroup's slab and first column of the N tile
  const int slab = WN == 128 ? wg : 0;
  const int col0 = WN == 128 ? 0 : 64 * wg;
  // a thread's rows of the slab: r0 and r0 + 8; its columns
  // col0 + 8j + 2t + {0, 1}
  const int r0 = ((tid >> 5) & 3) * 16 + (lane >> 2), t4 = lane & 3;
  const int row_lo = slab * kSlab + r0;      // its first row of the tile
  const bool active = slab < I.n_act;
  const int nb = I.n0 / kBN;
  float acc[WN / 2];
#pragma unroll
  for (int j = 0; j < WN / 2; ++j) acc[j] = 0.0f;

  if (I.n_own) {
    // this block's A fragments
    uint32_t af[8][4];
    // block kb's scales {s_a of the thread's two rows, s_b}, loaded two
    // blocks ahead into sc[kb % 2]: the loads meet a memory system busy
    // with the weights' stream
    float sc[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
    const int arow = I.own_lo + row_lo;
    auto scales = [&](int kb, float (&v)[3]) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[h] = arow + 8 * h < M ? sa[(size_t)(arow + 8 * h) * KB + kb] : 0.0f;
      v[2] = sb[((size_t)I.g * KB + kb) * NB + nb];
    };
    // block i's stage: widen its B into f16 tile i % 2 (every consumer
    // thread), then take this slab's A fragments (active warpgroups) and
    // release the stage to the producer
    auto widen = [&](int i) {
      const int st = i % S::kStages;
      mbar_wait(&full[st], (i / S::kStages) & 1);
      const uint8_t* bt = ring + st * S::kStageBytes + NS * S::kABytes;
      uint8_t* wb = wide + (i & 1) * kWideBytes;
#pragma unroll
      for (int k = 0; k < 1024 / kConsumers; ++k)
        widen_b_chunk(bt, wb, tid + k * kConsumers);
    };
    auto release = [&](int i) {
      const int st = i % S::kStages;
      if (active)
        load_a<BM>(ring + st * S::kStageBytes + slab * S::kABytes, af, r0, t4,
                   a_rows);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };
    widen(it);
    release(it);
    if (active) {
      scales(0, sc[0]);
      if (KB > 1) scales(1, sc[1]);
    }
    fence_proxy_async();
    bar_sync(1, kConsumers);
    float part[WN / 2];
    auto step = [&](int kb, float (&v)[3]) {
      const int cur = it + kb;
      if (active) {
        // B: N-major, 16 K rows = 2 KB, the second 64 columns 8 KB on,
        // the second 64 K 16 KB on
        const uint32_t b_addr =
            smem_u32(wide + (cur & 1) * kWideBytes) + (col0 / 64) * 8192;
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const uint64_t db = sw128_desc(
              b_addr + (ks >> 2) * 16384 + (ks & 3) * 2048, 8192, 1024);
          wgmma_f16<WN>(part, af[ks], db, ks != 0);
        }
        wgmma_commit();
      }
      // the next block's B widens under this block's products; its A
      // fragments replace this block's once those are done
      const bool more = kb + 1 < KB;
      if (more) widen(cur + 1);
      if (active) {
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) fence_regs(af[ks]);
      }
      if (more) release(cur + 1);
      if (active) {
        // fine-grained rescale, in the oracle's order: (part * s_a) * s_b
#pragma unroll
        for (int j = 0; j < WN / 2; ++j)
          acc[j] = __fadd_rn(acc[j],
                             __fmul_rn(__fmul_rn(part[j], v[(j >> 1) & 1]), v[2]));
        if (kb + 2 < KB) scales(kb + 2, v);
      }
      // block kb + 1's f16 B is complete and block kb's products have
      // read theirs (the next widening overwrites it)
      fence_proxy_async();
      bar_sync(1, kConsumers);
    };
    for (int kb = 0; kb < KB; kb += 2) {
      step(kb, sc[0]);
      if (kb + 1 < KB) step(kb + 1, sc[1]);
    }
    it += KB;
  }

  // the f16 tiles are free until the next piece's first widening
  if constexpr (EPI == kStore) {
    OutT* staged = reinterpret_cast<OutT*>(wide);
    if (active) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row_lo + 8 * h;
        if (r < I.n_own) {
#pragma unroll
          for (int j = 0; j < WN / 8; ++j)
            store2(staged + r * kBN + col0 + 8 * j + 2 * t4, acc[4 * j + 2 * h],
                   acc[4 * j + 2 * h + 1]);
        }
      }
    }
    // rows >= total of this tile, staged after the owned rows, as zeros
    uint4* zeros = reinterpret_cast<uint4*>(staged + I.n_own * kBN);
    const int zwords = I.n_zero * kBN * (int)sizeof(OutT) / 16;
    for (int e = tid; e < zwords; e += kConsumers) zeros[e] = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
    bar_sync(1, kConsumers);
    if (tid == 0) {
      const uint8_t* st = reinterpret_cast<const uint8_t*>(staged);
      constexpr int rb = kBN * (int)sizeof(OutT);
      store_rows<BM>(maps, st, rb, 0, I.own_lo, I.n_own, I.n0);
      store_rows<BM>(maps, st, rb, I.n_own, I.z_lo, I.n_zero, I.n0);
      tma_store_commit();
      tma_store_wait_read<0>();
    }
  } else {
    // a row's values: WN / 4 in each of the 4 lanes sharing lane / 4, of
    // one warpgroup (WN 128) or of both (WN 64: their halves' amaxes meet
    // in shared memory)
    uint8_t* stageq = wide;
    float* amax2 = reinterpret_cast<float*>(wide + BM * kBN);   // [BM][2]
    float amax[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < WN / 4; ++j)
        amax[h] = fmaxf(amax[h], fabsf(round_through(
                                     acc[4 * (j >> 1) + 2 * h + (j & 1)],
                                     (OutT*)nullptr)));
      amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
      amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 2));
    }
    if constexpr (WN == 64) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r0 + 8 * h < I.n_own && t4 == 0) amax2[(r0 + 8 * h) * 2 + wg] = amax[h];
      bar_sync(1, kConsumers);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r0 + 8 * h < I.n_own)
          amax[h] = fmaxf(amax2[(r0 + 8 * h) * 2], amax2[(r0 + 8 * h) * 2 + 1]);
    }
    if (active) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row_lo + 8 * h;
        if (r < I.n_own) {
          const float scale = repro::tile_scale(amax[h]);
#pragma unroll
          for (int j = 0; j < WN / 8; ++j) {
            const uint32_t q0 = repro::quantize_value(
                round_through(acc[4 * j + 2 * h], (OutT*)nullptr), scale);
            const uint32_t q1 = repro::quantize_value(
                round_through(acc[4 * j + 2 * h + 1], (OutT*)nullptr), scale);
            *reinterpret_cast<uint16_t*>(stageq + r * kBN + col0 + 8 * j + 2 * t4) =
                (uint16_t)(q0 | (q1 << 8));
          }
          if (col0 == 0 && t4 == 0) s[(size_t)(I.own_lo + r) * NB + nb] = scale;
        }
      }
    }
    // rows >= total: payload 0 (staged after the owned rows), scale 1
    uint4* zeros = reinterpret_cast<uint4*>(stageq + I.n_own * kBN);
    for (int e = tid; e < I.n_zero * kBN / 16; e += kConsumers)
      zeros[e] = make_uint4(0, 0, 0, 0);
    for (int e = tid; e < I.n_zero; e += kConsumers)
      s[(size_t)(I.z_lo + e) * NB + nb] = 1.0f;
    fence_proxy_async();
    bar_sync(1, kConsumers);
    if (tid == 0) {
      store_rows<BM>(maps, stageq, kBN, 0, I.own_lo, I.n_own, I.n0);
      store_rows<BM>(maps, stageq, kBN, I.n_own, I.z_lo, I.n_zero, I.n0);
      tma_store_commit();
      tma_store_wait_read<0>();
    }
  }
  // the stage has been read: the next piece may widen over it
  bar_sync(1, kConsumers);
}

// BM: the instance (16: block_m 8 and 16; 128: block_m 64 to 512); q:
// the launch's tile geometry (tile_geom.cuh).
//   EPI == kStore: the pool stores the product as OutT (s unused);
//   EPI == kQuant: the pool stores the e4m3 payload of the product rounded
//   through OutT, and s [M, N/128] receives its 1x128 scales.
template <int BM, int EPI, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
gmm_fp8_tma_kernel(const __grid_constant__ Maps maps, const Geom q,
                   const float* __restrict__ sa, const float* __restrict__ sb,
                   const int* __restrict__ group_offsets,
                   const int* __restrict__ group_ids,
                   const int* __restrict__ m_tile_ids, float* __restrict__ s,
                   int M, int K, int N, int G, int T) {
  using S = Shape<BM>;
  constexpr int NS = S::NS;
  static_assert(BM <= NS * kSlab, "a piece's owned rows must fit the slabs");
  static_assert(BM == repro::kSmallRows || BM == repro::kPieceRowsMax,
                "the two instances");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = smem;
  uint8_t* wide = smem + S::kRingBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(wide + 2 * kWideBytes);
  uint64_t* empty = full + S::kStages;

  const int tid = threadIdx.x;
  const int KB = K / kBK, NB = N / kBN, NT = N / q.block_n;
  const int items = T * NT;
  const int a_rows = q.block_m < kSlab ? q.block_m : kSlab;   // one A box
  const int a_bytes = a_rows * kBK;

  if (tid == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers / 32);       // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer: one thread keeps kStages 128-K blocks of A slabs and B in
    // flight, across the CTA's items; the warpgroup hands its registers
    // to the consumers
    setmaxnreg_dec<40>();
    if (tid == kConsumers) {
      int it = 0;
      walk_pieces<BM>(q, items, NT, group_offsets, group_ids, m_tile_ids, M,
                      G, [&](const Piece& I) {
        if (I.n_own == 0) return;
        for (int i = 0; i < KB; ++i, ++it) {
          const int st = it % S::kStages;
          mbar_wait(&empty[st], ((it / S::kStages) & 1) ^ 1);
          uint8_t* stage = ring + st * S::kStageBytes;
          mbar_expect_tx(&full[st], I.n_act * a_bytes + kBBytes);
          for (int j = 0; j < I.n_act; ++j)
            tma_load_2d(stage + j * S::kABytes, &maps.a, &full[st], i * kBK,
                        I.own_lo + j * kSlab);
          tma_load_3d(stage + NS * S::kABytes, &maps.b, &full[st], I.n0,
                      i * kBK, I.g);
        }
      });
    }
    return;
  }
  setmaxnreg_inc<232>();

  int it = 0;
  walk_pieces<BM>(q, items, NT, group_offsets, group_ids, m_tile_ids, M, G,
                  [&](const Piece& I) {
    if (I.n_own == 0 && I.n_zero == 0) return;
    if constexpr (BM == 128) {
      if (I.n_act == 2) {
        consume<BM, EPI, OutT, 128>(maps, I, it, ring, wide, full, empty, sa,
                                    sb, s, M, KB, NB, a_rows);
        return;
      }
    }
    consume<BM, EPI, OutT, 64>(maps, I, it, ring, wide, full, empty, sa, sb, s,
                               M, KB, NB, a_rows);
  });
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <int BM, int EPI, typename OutT>
int launch(const Maps& maps, const Geom& q, int T, int N, cudaStream_t stream,
           const void* sa, const void* sb, const void* go, const void* gi,
           const void* mi, void* s, int M, int K, int G) {
  auto kernel = gmm_fp8_tma_kernel<BM, EPI, OutT>;
  constexpr int smem = Shape<BM>::kSmem;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorNoDevice;
  const int items = T * (N / q.block_n);
  kernel<<<items < sms ? items : sms, kThreads, smem, stream>>>(
      maps, q, (const float*)sa, (const float*)sb, (const int*)go, (const int*)gi,
      (const int*)mi, (float*)s, M, K, N, G, T);
  return (int)cudaGetLastError();
}

template <int EPI, typename OutT>
int launch_bm(const Geom& q, const Maps& maps, int T, int N,
              cudaStream_t stream, const void* sa, const void* sb,
              const void* go, const void* gi, const void* mi, void* s, int M,
              int K, int G) {
  if (repro::small_instance(q.block_m))
    return launch<16, EPI, OutT>(maps, q, T, N, stream, sa, sb, go, gi, mi, s,
                                 M, K, G);
  return launch<128, EPI, OutT>(maps, q, T, N, stream, sa, sb, go, gi, mi, s,
                                M, K, G);
}

// The operand maps and the store pool (box heights 1, 2, 4, ..., the
// piece's rows) over `out` [M, N] of `dt` (`esize` bytes an element);
// returns 0 or 1000 + the CUresult of a failed encoding.
int encode_maps(Maps* maps, const void* a, const void* b, void* out,
                CUtensorMapDataType dt, int esize, int M, int K, int N, int G,
                const Geom& q) {
  memset(maps, 0, sizeof(*maps));
  CUresult r;
  {
    const uint64_t dims[2] = {(uint64_t)K, (uint64_t)M};
    const uint64_t strides[1] = {(uint64_t)K};
    const uint32_t box[2] = {kBK,
                             (uint32_t)(q.block_m < kSlab ? q.block_m : kSlab)};
    r = encode(&maps->a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a, dims, strides,
               box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (r != CUDA_SUCCESS) return 1000 + (int)r;
  }
  {
    const uint64_t dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)G};
    const uint64_t strides[2] = {(uint64_t)N, (uint64_t)K * N};
    const uint32_t box[3] = {kBN, kBK, 1};
    r = encode(&maps->b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, b, dims, strides,
               box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (r != CUDA_SUCCESS) return 1000 + (int)r;
  }
  for (int i = 0; (1 << i) <= q.rows; ++i) {
    const uint64_t dims[2] = {(uint64_t)N, (uint64_t)M};
    const uint64_t strides[1] = {(uint64_t)N * esize};
    const uint32_t box[2] = {kBN, (uint32_t)(1 << i)};
    r = encode(&maps->store[i], dt, 2, out, dims, strides, box,
               CU_TENSOR_MAP_SWIZZLE_NONE);
    if (r != CUDA_SUCCESS) return 1000 + (int)r;
  }
  return 0;
}

}  // namespace

// One launch covers the whole plan: persistent CTAs, at most one an SM,
// over its T visits x N / block_n tiles.  Every pointer is 16-byte
// aligned and contiguous; block_m is 8, 16, 64, 128, 256 or 512, block_n
// 128 or 256 and divides N.  Each returns a cudaError_t, or 1000 + the
// CUresult of a failed tensor-map encoding.

// B2.  out [M, N], f32 when out_f32 else bf16.
extern "C" int gmm_fp8(const void* a, const void* sa, const void* b,
                       const void* sb, const void* group_offsets,
                       const void* group_ids, const void* m_tile_ids, void* out,
                       int M, int K, int N, int G, int T, int block_m,
                       int block_n, int out_f32, void* stream) {
  Geom q;
  if (!repro::make_geom(block_m, block_n, N, &q)) return (int)cudaErrorInvalidValue;
  Maps maps;
  const int e = encode_maps(&maps, a, b, out,
                            out_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            out_f32 ? 4 : 2, M, K, N, G, q);
  if (e) return e;
  auto st = (cudaStream_t)stream;
  if (out_f32)
    return launch_bm<kStore, float>(q, maps, T, N, st, sa, sb, group_offsets,
                                    group_ids, m_tile_ids, nullptr, M, K, G);
  return launch_bm<kStore, __nv_bfloat16>(q, maps, T, N, st, sa, sb,
                                          group_offsets, group_ids, m_tile_ids,
                                          nullptr, M, K, G);
}

// B7.  q [M, N] e4m3, s [M, N/128] f32; round_f32: 1 to quantize the f32
// accumulator as it is, 0 to round it through bf16 first.
extern "C" int gmm_fp8_quant(const void* a, const void* sa, const void* b,
                             const void* sb, const void* group_offsets,
                             const void* group_ids, const void* m_tile_ids,
                             void* q, void* s, int M, int K, int N, int G,
                             int T, int block_m, int block_n, int round_f32,
                             void* stream) {
  Geom g;
  if (!repro::make_geom(block_m, block_n, N, &g)) return (int)cudaErrorInvalidValue;
  Maps maps;
  const int e = encode_maps(&maps, a, b, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                            M, K, N, G, g);
  if (e) return e;
  auto st = (cudaStream_t)stream;
  if (round_f32)
    return launch_bm<kQuant, float>(g, maps, T, N, st, sa, sb, group_offsets,
                                    group_ids, m_tile_ids, s, M, K, G);
  return launch_bm<kQuant, __nv_bfloat16>(g, maps, T, N, st, sa, sb,
                                          group_offsets, group_ids, m_tile_ids,
                                          s, M, K, G);
}

// The resources of one variant (resources.cuh): a = block_m (8, 16, 64,
// 128, 256 or 512: its instance's), b = 1 for an f32 output (B2) or
// rounding (B7), c = 1 for B7.
extern "C" int kernel_resources(int block_m, int out_f32, int quant, int* out) {
  Geom g;
  if (!repro::make_geom(block_m, 128, 128, &g)) return (int)cudaErrorInvalidValue;
  const bool small = repro::small_instance(block_m);
  const int smem = small ? Shape<16>::kSmem : Shape<128>::kSmem;
  auto q = [&](auto kernel) {
    return repro::query_resources(kernel, kThreads, smem, out);
  };
  if (small) {
    if (quant) return out_f32 ? q(gmm_fp8_tma_kernel<16, kQuant, float>)
                              : q(gmm_fp8_tma_kernel<16, kQuant, __nv_bfloat16>);
    return out_f32 ? q(gmm_fp8_tma_kernel<16, kStore, float>)
                   : q(gmm_fp8_tma_kernel<16, kStore, __nv_bfloat16>);
  }
  if (quant) return out_f32 ? q(gmm_fp8_tma_kernel<128, kQuant, float>)
                            : q(gmm_fp8_tma_kernel<128, kQuant, __nv_bfloat16>);
  return out_f32 ? q(gmm_fp8_tma_kernel<128, kStore, float>)
                 : q(gmm_fp8_tma_kernel<128, kStore, __nv_bfloat16>);
}
