// The schedule and the epilogue shared by the two ragged-contraction
// (wgrad) kernels, B4 (wgrad_bf16.cu) and B6 (wgrad.cu): the persistent
// walk over output tiles, the thread-block cluster that shares operand
// stages across a super-tile, the dw tile staged in the output dtype and
// stored by TMA, dw's tensor map and the launch.  sm_90a only.
//
// A sub-tile is 128 x 128 of dw[g], summed by one CTA over the group's
// rows [offsets[g], offsets[g+1]) in chunks of kRows, starting at
// offsets[g].  A geometry (block_n, n_span, k_span) of the JAX package's
// pool makes a super-tile of k_span x (n_span * block_n / 128) sub-tiles;
// it runs on a cluster of as many CTAs, one a sub-tile (Geom):
//   span 1, block_n 128: (1, 1), no cluster: each CTA loads its own stage,
//     in an instance of its own where every cluster term is a constant;
//   span 1, block_n 256: (1, 2);  span 2: (2, 2);
//   span 4: (4, 4), 16 CTAs, a non-portable cluster size: the H100 holds 7
//     such clusters at once at B6's 230,496 bytes a CTA
//     (cudaOccupancyMaxActiveClusters), so it runs as one cluster (four
//     passes of a (2, 2) cluster, the form for a card that held none,
//     are not built).
// The CTAs of cluster row kk share a K sub-tile, so they share x's boxes;
// those of column nn share dy's.  Each CTA of a row loads 1 / cn of the
// row's x rows and multicasts them to the row, each CTA of a column 1 / ck
// of dy's to the column, so every x and dy byte of a stage leaves L2 once
// a cluster.  A CTA's full barrier expects its whole stage; its empty
// barrier counts the releases of every CTA of its row and column (the
// CTAs its loads land in), so no load overwrites a stage a peer still
// reads.  Each sub-tile's sum is exactly span 1's (the same chunks, the
// same products, in the same order): any geometry is bitwise span 1.
// Clusters are persistent: cluster c walks the super-tiles c, c +
// clusters, ... (N fastest, then K, then the group), so every CTA of a
// cluster walks the same groups and chunks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "resources.cuh"

namespace wgrad {

using namespace hopper;

constexpr int kTile = 128;   // the tile's K and N extent
constexpr int kRows = 64;    // contracted rows per ring stage

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A launch's walk, computed on the host and read by the kernel from its
// parameters: the cluster (ck x cn CTAs, one a sub-tile of the
// super-tile), the super-tiles of one group's dw along N and K, and the
// units of the launch (a unit: one super-tile)
struct Geom {
  int ck, cn, ns, ks, units;
  __host__ __device__ int ctas() const { return ck * cn; }
};

// the walk of span 1 at block_n 128, no cluster, over dw [G, K, N]: the
// form the kernels' single-CTA instances take, every cluster term a
// constant and the tile counts computed from the shape in the kernel
__host__ __device__ __forceinline__ Geom single(int K, int N, int G) {
  return {1, 1, N / kTile, K / kTile, (N / kTile) * (K / kTile) * G};
}

// the walk of a pool geometry (block_n 128 or 256 at span 1, or n_span =
// k_span in {2, 4} at block_n 128) over dw [G, K, N], K and N multiples of
// its super-tile; ck = 0 for any other geometry
inline Geom geometry(int block_n, int n_span, int k_span, int K, int N,
                     int G) {
  Geom g{0, 0, 0, 0, 0};
  if (n_span == 1 && k_span == 1 && (block_n == 128 || block_n == 256))
    g = {1, block_n / kTile};
  else if (block_n == kTile && n_span == k_span &&
           (n_span == 2 || n_span == 4))
    g = {k_span, n_span};
  if (g.ck == 0) return g;
  g.ns = N / (kTile * g.cn);
  g.ks = K / (kTile * g.ck);
  g.units = g.ns * g.ks * G;
  return g;
}

// one CTA's place in its cluster: its sub-tile (kk, nn), rank kk * cn + nn
struct Cluster {
  int ck, cn, kk, nn, rank;
  __device__ __forceinline__ explicit Cluster(const Geom& geo)
      : ck(geo.ck), cn(geo.cn) {
    rank = geo.ctas() > 1 ? (int)cluster_rank() : 0;
    kk = rank / cn;
    nn = rank % cn;
  }
  // the CTAs that x's (row) and dy's (column) loads of this CTA land in
  __device__ __forceinline__ uint16_t row_mask() const {
    return (uint16_t)(((1u << cn) - 1) << (kk * cn));
  }
  __device__ __forceinline__ uint16_t col_mask() const {
    uint32_t m = 0;
    for (int j = 0; j < ck; ++j) m |= 1u << (j * cn + nn);
    return (uint16_t)m;
  }
  // CTAs whose loads land in this CTA (its row and column, itself once):
  // the arrivals of one stage's release, a warp each
  __device__ __forceinline__ int peers() const { return cn + ck - 1; }
  // a warp's release of a stage it has consumed: lane i arrives on the
  // stage's empty barrier in the i-th CTA of this CTA's row, then column
  __device__ __forceinline__ void release(uint64_t* empty, int lane) const {
    if (ck * cn == 1) {
      if (lane == 0) mbar_arrive(empty);
      return;
    }
    if (lane >= peers()) return;
    int peer;
    if (lane < cn) {
      peer = kk * cn + lane;
    } else {
      const int j = lane - cn;
      peer = (j < kk ? j : j + 1) * cn + nn;
    }
    mbar_arrive_cluster(empty, (uint32_t)peer);
  }
  // load a box slice into this CTA, or multicast it to the CTAs of `mask`
  __device__ __forceinline__ void load(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1,
                                       uint16_t mask) const {
    if (mask == (uint16_t)(1u << rank))
      tma_load_2d(dst, map, bar, c0, c1);
    else
      tma_load_2d_multicast(dst, map, bar, c0, c1, mask);
  }
};

// The end of a warp's part of the kernel: in a cluster, no CTA leaves
// while a peer may still arrive on its barriers (every thread of the
// cluster arrives, then waits)
template <bool kCluster>
__device__ __forceinline__ void leave_cluster() {
  if (kCluster) {
    __syncwarp();
    cluster_sync();
  }
}

// this CTA's cluster's first unit, and the units between two of its
__device__ __forceinline__ int first_unit(const Geom& geo) {
  return blockIdx.x / geo.ctas();
}
__device__ __forceinline__ int unit_stride(const Geom& geo) {
  return gridDim.x / geo.ctas();
}

// unit (super-tile) u of the walk for one CTA: its sub-tile's group,
// rows and chunks
struct Tile {
  int n0, k0, g, start, end, chunks;
  __device__ __forceinline__ Tile(int u, const Geom& geo, const Cluster& cl,
                                  const int* offsets, int M) {
    n0 = ((u % geo.ns) * geo.cn + cl.nn) * kTile;
    k0 = ((u / geo.ns % geo.ks) * geo.ck + cl.kk) * kTile;
    g = u / (geo.ns * geo.ks);
    start = min(offsets[g], M);
    end = min(offsets[g + 1], M);
    chunks = end > start ? (end - start + kRows - 1) / kRows : 0;
  }
};

// The epilogue of the two consumer warpgroups (threads 0..255; named
// barrier 1): wait until the previous tile's store has read the staged
// tile, stage this one's f32 sum rounded to OutT (boxes of 128 bytes x
// 128 rows, 128B-swizzled; a thread holds rows r and r + 8, columns
// 8j + 2(lane%4) + {0, 1} of the wgmma fragment), then store it by TMA
// at (n0, row0) of the [G * K, N] dw without waiting: the store drains
// while the next tile's products run.
template <typename OutT>
__device__ __forceinline__ void store_tile(const float (&acc)[64], int r,
                                           int tid, uint8_t* staged,
                                           const CUtensorMap* out, int n0,
                                           int row0) {
  constexpr int kCols = 128 / (int)sizeof(OutT);   // columns of a staged box
  const int lane = tid & 31;
  if (tid == 0) tma_store_wait_read<0>();
  bar_sync(1, 256);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    uint8_t* box = staged + (col / kCols) * (kTile * 128);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2(reinterpret_cast<OutT*>(
                 box + sw128_offset(r + 8 * h, (col % kCols) * sizeof(OutT))),
             acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  fence_proxy_async();
  bar_sync(1, 256);
  if (tid == 0) {
    for (int b = 0; b < kTile / kCols; ++b)
      tma_store_2d(out, staged + b * (kTile * 128), n0 + b * kCols, row0);
    tma_store_commit();
  }
}

// dw [G * K, N] in f32 or bf16 as a map of 128-byte x 128-row boxes in the
// 128-byte swizzle
inline CUresult encode_dw(CUtensorMap* map, void* dw, int K, int N, int G,
                          int out_f32) {
  const int esize = out_f32 ? 4 : 2;
  const uint64_t dims[2] = {(uint64_t)N, (uint64_t)G * K};
  const uint64_t strides[1] = {(uint64_t)N * esize};
  const uint32_t box[2] = {(uint32_t)(128 / esize), kTile};
  return encode(map,
                out_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, dw, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Set kKernel's attributes once: `smem` bytes of dynamic shared memory
// and, for a cluster instance, clusters past the portable 8 CTAs.
// Returns a cudaError_t.
template <auto kKernel>
int prepare(int smem, bool clusters) {
  static int done = 0;
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && clusters)
    e = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = e == cudaSuccess;
  return (int)e;
}

// a launch configuration of clusters of `ctas` CTAs along x
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int grid, int threads, int smem, int ctas,
                cudaStream_t stream) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// How many clusters of `ctas` CTAs of kKernel (`threads`, `smem`) the card
// holds at once, into *n; for one CTA, the SMs (one CTA an SM).  Returns a
// cudaError_t.
template <auto kKernel>
int max_clusters(int threads, int smem, int ctas, int* n) {
  int e = prepare<kKernel>(smem, ctas > 1);
  if (e != 0) return e;
  if (ctas == 1) {
    int dev = 0;
    e = (int)cudaGetDevice(&dev);
    if (e == 0)
      e = (int)cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
    return e;
  }
  ClusterLaunch l(ctas, threads, smem, ctas, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(n, kKernel, &l.cfg);
}

// Launch kKernel over the walk of `geo`: persistent clusters, at most one
// a unit and as many as the card holds at once (one CTA an SM), each of
// `threads` threads and `smem` bytes of dynamic shared memory; span 1 at
// block_n 128 as a plain launch.  Returns a cudaError_t
// (cudaErrorInvalidConfiguration where the card holds no such cluster).
template <auto kKernel, typename... Args>
int launch(const Geom& geo, int threads, int smem, cudaStream_t stream,
           const Args&... args) {
  static int held[17] = {};   // clusters the card holds, by CTAs a cluster
  const int ctas = geo.ctas();
  if (held[ctas] == 0) {
    const int e = max_clusters<kKernel>(threads, smem, ctas, &held[ctas]);
    if (e != 0) {
      held[ctas] = 0;
      return e;
    }
    if (held[ctas] == 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int grid = min(geo.units, held[ctas]) * ctas;
  if (ctas == 1) {
    kKernel<<<grid, threads, smem, stream>>>(args...);
    return (int)cudaGetLastError();
  }
  ClusterLaunch l(grid, threads, smem, ctas, stream);
  const cudaError_t e = cudaLaunchKernelEx(&l.cfg, kKernel, args...);
  return e == cudaSuccess ? (int)cudaGetLastError() : (int)e;
}

// The resources of one variant (resources.cuh) at clusters of `ctas` CTAs:
// out[6] the cluster's CTAs, out[7] the clusters the card holds at once.
template <auto kKernel>
int cluster_resources(int threads, int smem, int ctas, int* out) {
  int e = repro::query_resources(kKernel, threads, smem, out);
  if (e == 0) e = max_clusters<kKernel>(threads, smem, ctas, &out[7]);
  out[6] = ctas;
  return e;
}

}  // namespace wgrad
