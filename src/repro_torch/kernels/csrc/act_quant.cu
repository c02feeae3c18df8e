// Fused activation -> 1x128 per-tile fp8 quantization.
//
// Replaces: src/repro/kernels/epilogue_kernel.py::act_quantize_pallas, both
// of its input modes.  g, u [M, K] (K % 128 == 0) -> h = silu(g) * u (or
// tanh-gelu(g)) in f32 -> q [M, K] e4m3, s [M, K/128].  The operands are
// bf16 or f32, or (the fused-producer mode) e4m3 with 1x128 scales
// s_g, s_u [M, K/128], dequantized on load as float(q) * s, the
// reference's _dequant_rows.
//
// Bound on the card: bytes.  With bf16 inputs it reads 2 x 2 B and writes
// 1 B per element plus 4 B per 128 elements; with e4m3 inputs it reads
// 2 x 1 B per element plus 2 x 4 B per 128 elements.  At the serving
// path's shapes the whole call is a few MB, and what the card shows
// (PERF.md) is the launch floor, one load round trip, and the exact
// arithmetic: expf, an IEEE reciprocal and the quantizer's IEEE divide
// are long dependent chains, so a lane that holds more values runs
// longer chains (16-byte loads of 8 bf16 or 16 e4m3 a lane were slower
// at those shapes).
//
// Design: a warp owns a 1x128 tile, 4 values a lane (16, 8 or 4 bytes a
// load), its amax a warp shuffle, as quant.cu; the grid holds as many
// blocks as the card keeps resident (no more than the tiles need) and
// each warp strides over the tiles, loading its next tile's operands (and
// scales) before the current tile's arithmetic, so a load is in flight
// while a chain runs.  silu is written g * sigmoid(g) and gelu in its
// tanh form, the forms of the plain PyTorch version, and the quantizer
// is tile_quant.cuh's, so the fp8-input mode is bitwise its plain
// version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fp8.cuh"
#include "tile_quant.cuh"
#include "resources.cuh"

namespace {

constexpr int kThreads = 256;

// 4 values of T: a load of 16, 8 or 4 bytes
template <typename T> struct Quad;
template <> struct Quad<float> { using type = uint4; };
template <> struct Quad<__nv_bfloat16> { using type = uint2; };
template <> struct Quad<uint8_t> { using type = uint32_t; };

// the 4 values as f32: f32, bf16, or e4m3 times the tile's scale
__device__ __forceinline__ void widen(uint4 w, const float*, float (&v)[4],
                                      float) {
  v[0] = __uint_as_float(w.x); v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z); v[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void widen(uint2 w, const __nv_bfloat16*,
                                      float (&v)[4], float) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ void widen(uint32_t w, const uint8_t*,
                                      float (&v)[4], float scale) {
  const float2 lo = repro::e4m3x2_to_float2(w);
  const float2 hi = repro::e4m3x2_to_float2(w >> 16);
  v[0] = __fmul_rn(lo.x, scale); v[1] = __fmul_rn(lo.y, scale);
  v[2] = __fmul_rn(hi.x, scale); v[3] = __fmul_rn(hi.y, scale);
}

__device__ __forceinline__ float silu(float g) {
  const float sig = 1.0f / (1.0f + expf(-g));
  return g * sig;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;   // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.0f + tanhf(inner));
}

// T: float, __nv_bfloat16, or uint8_t for e4m3 operands with scales
// sg, su (unused otherwise).  Tile t is elements [128 t, 128 t + 128) of
// the row-major [M, K]; warp w of the grid takes tiles w, w + warps, ...
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
act_quantize_kernel(const T* __restrict__ g, const T* __restrict__ u,
                    const float* __restrict__ sg,
                    const float* __restrict__ su, uint8_t* __restrict__ q,
                    float* __restrict__ s, long long tiles) {
  using Raw = typename Quad<T>::type;
  constexpr bool kFp8 = sizeof(T) == 1;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);

  // a tile's operands: this lane's 4 values of g and u and their scales
  struct Ops {
    Raw g, u;
    float sg, su;
  };
  auto fetch = [&](long long tile) {
    Ops o;
    o.g = o.u = Raw{};
    o.sg = o.su = 1.0f;
    if (tile < tiles) {
      const long long off = tile * repro::kQuantBlock + 4 * lane;
      o.g = __ldg(reinterpret_cast<const Raw*>(g + off));
      if (ACT == 0) o.u = __ldg(reinterpret_cast<const Raw*>(u + off));
      if (kFp8) {
        o.sg = sg[tile];
        if (ACT == 0) o.su = su[tile];
      }
    }
    return o;
  };

  long long tile = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  Ops cur = fetch(tile);
  for (; tile < tiles; tile += warps) {
    const Ops nxt = fetch(tile + warps);     // in flight during this tile
    float h[4];
    widen(cur.g, g, h, cur.sg);
    if (ACT == 0) {
      float uv[4];
      widen(cur.u, u, uv, cur.su);
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = silu(h[j]) * uv[j];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = gelu_tanh(h[j]);
    }
    repro::quantize_tile_warp(h, lane, q + tile * repro::kQuantBlock,
                              s + tile);
    cur = nxt;
  }
}

template <typename T, int ACT>
int launch(const void* g, const void* u, const void* sg, const void* su,
           void* q, void* s, int M, int K, cudaStream_t stream) {
  auto kernel = act_quantize_kernel<T, ACT>;
  // blocks the card keeps resident at once, found on first use
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    resident = sms * per_sm;
  }
  const long long tiles = (long long)M * (K / repro::kQuantBlock);
  const long long want = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  kernel<<<(int)(want < resident ? want : resident), kThreads, 0, stream>>>(
      (const T*)g, (const T*)u, (const float*)sg, (const float*)su,
      (uint8_t*)q, (float*)s, tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_act(const void* g, const void* u, const void* sg, const void* su,
               void* q, void* s, int M, int K, int act, cudaStream_t stream) {
  if (act == 0) return launch<T, 0>(g, u, sg, su, q, s, M, K, stream);
  return launch<T, 1>(g, nullptr, sg, nullptr, q, s, M, K, stream);
}

}  // namespace

// act: 0 = silu_mul (u required), 1 = gelu (u unused).
// in_kind: 0 for f32 inputs, 1 for bf16, 2 for e4m3 with 1x128 scales
// sg (and su for silu_mul); the scales are unused otherwise.  Every
// operand 16-byte aligned.
extern "C" int act_quantize(const void* g, const void* u, const void* sg,
                            const void* su, void* q, void* s, int M, int K,
                            int act, int in_kind, void* stream) {
  if (act != 0 && act != 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  switch (in_kind) {
    case 0:
      return launch_act<float>(g, u, sg, su, q, s, M, K, act, st);
    case 1:
      return launch_act<__nv_bfloat16>(g, u, sg, su, q, s, M, K, act, st);
    case 2:
      return launch_act<uint8_t>(g, u, sg, su, q, s, M, K, act, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The resources of one variant (resources.cuh): a = in_kind (0 f32, 1
// bf16, 2 e4m3), b = act (0 silu_mul, 1 gelu); c is unused.
namespace {

template <typename T>
int query_act(int act, int* out) {
  if (act == 0)
    return repro::query_resources(act_quantize_kernel<T, 0>, kThreads, 0, out);
  return repro::query_resources(act_quantize_kernel<T, 1>, kThreads, 0, out);
}

}  // namespace

extern "C" int kernel_resources(int in_kind, int act, int, int* out) {
  switch (in_kind) {
    case 0:
      return query_act<float>(act, out);
    case 1:
      return query_act<__nv_bfloat16>(act, out);
    case 2:
      return query_act<uint8_t>(act, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
