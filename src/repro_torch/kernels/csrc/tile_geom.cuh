// The tile geometry of one grouped-GEMM launch (B2 and B7 in
// grouped_gemm.cu, B5 in gmm_bf16.cu) and the pieces a visit's tile is
// walked in.
//
// A launch takes the plan's tile, block_m rows by block_n columns, as
// runtime arguments: block_m in {8, 16, 64, 128, 256, 512} (the JAX
// package's CONFIG_POOL), block_n 128 or 256.  Each kernel has two
// instances, keyed by the most rows one piece may hold: 16 (block_m 8
// and 16, decode) and 128 (block_m 64 and up).  A visit's tile is walked
// as pieces of at most that many rows (block_m 256: 2 sub-tiles, 512: 4)
// by 128-column halves (block_n 256: 2), sub-tile outer; each piece runs
// the kernel's main loop and stores its own rows through the store pool,
// whose tallest box is the piece's height (a piece is all the stage
// holds).  The plan's visit semantics hold piece by piece:
//   - a visit owns rows [max(start, row0), min(end, row0 + block_m, M))
//     of its tile; a piece, those of its sub-tile;
//   - a visit repeating the previous (group, tile) owns nothing;
//   - a tile's rows >= sum(sizes) are zero-filled by its first visit;
// so owned row sets stay disjoint and no two CTAs write one row.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kPieceCols = 128;       // columns of a piece: one scale block
constexpr int kPieceRowsMax = 128;    // rows of a piece in the tall instance
constexpr int kSmallRows = 16;        // ... and in the decode instance
constexpr int kSlabRows = 64;         // rows of one wgmma

struct Geom {
  int block_m, block_n;
  int rows;     // rows of a piece: block_m, at most the instance's
  int halves;   // 128-column halves of a tile: block_n / 128
  int pieces;   // pieces of a tile: block_m / rows x halves, 1 to 8
  int shift;    // log2(pieces)
};

// The geometry of a (block_m, block_n) tile over N columns; false where
// no kernel is built for it.
inline bool make_geom(int block_m, int block_n, int N, Geom* q) {
  const bool bm_ok = block_m == 8 || block_m == 16 || block_m == 64 ||
                     block_m == 128 || block_m == 256 || block_m == 512;
  if (!bm_ok || (block_n != 128 && block_n != 256) || N % block_n) return false;
  q->block_m = block_m;
  q->block_n = block_n;
  q->rows = block_m < kPieceRowsMax ? block_m : kPieceRowsMax;
  q->halves = block_n / kPieceCols;
  q->pieces = block_m / q->rows * q->halves;
  q->shift = 0;
  while ((1 << q->shift) < q->pieces) ++q->shift;
  return true;
}

// Whether a launch at block_m takes the decode instance (16-row pieces).
inline bool small_instance(int block_m) { return block_m <= kSmallRows; }

// One piece: group g's rows of a sub-tile on 128 columns from n0.  Its
// owned rows [own_lo, own_lo + n_own) (n_act 64-row slabs of them), and
// the rows >= total it zero-fills, [z_lo, z_lo + n_zero).
struct Piece {
  int g, n0, own_lo, n_own, z_lo, n_zero, n_act;
};

// Piece p of visit t on the tile's N tile nt.
__device__ __forceinline__ Piece make_piece(const Geom& q, int t, int p, int nt,
                                            const int* offsets,
                                            const int* group_ids,
                                            const int* m_tile_ids, int M,
                                            int G) {
  Piece it;
  const int h = q.halves - 1;                     // 0 or 1
  const int sub = p >> h;
  it.n0 = nt * q.block_n + (p & h) * kPieceCols;
  it.g = group_ids[t];
  const int tile = m_tile_ids[t];
  const int start = offsets[it.g], end = offsets[it.g + 1];
  const int total = offsets[G];
  const int row0 = tile * q.block_m + sub * q.rows;
  const int row1 = row0 + q.rows;
  const bool dup =
      t > 0 && group_ids[t - 1] == it.g && m_tile_ids[t - 1] == tile;
  const bool first = t == 0 || m_tile_ids[t - 1] != tile;
  it.own_lo = max(start, row0);
  it.n_own = dup ? 0 : max(min(min(end, row1), M) - it.own_lo, 0);
  it.z_lo = max(total, row0);
  it.n_zero = first ? max(min(row1, M) - it.z_lo, 0) : 0;
  it.n_act = (it.n_own + kSlabRows - 1) / kSlabRows;
  return it;
}

}  // namespace repro
