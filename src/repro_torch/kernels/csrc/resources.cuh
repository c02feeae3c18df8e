// The resource query every kernel library exports as
//
//   extern "C" int kernel_resources(int a, int b, int c, int* out);
//
// for one of its built variants (a, b, c pick it; each library says how).
// It reports what the card holds for that variant as the library's launch
// runs it, for kernels/resources.py's static model to be held against:
//   out[0] registers a thread (cudaFuncGetAttributes' numRegs),
//   out[1] the largest dynamic shared memory a launch may ask
//          (maxDynamicSharedSizeBytes, after the launch's own attribute),
//   out[2] the dynamic shared memory the launch asks,
//   out[3] threads a CTA at the launch,
//   out[4] static shared memory,
//   out[5] CTAs an SM holds at that launch (the occupancy calculator),
//   out[6] CTAs a thread-block cluster of the launch (1: no cluster),
//   out[7] clusters the card holds at once (for one CTA: out[5] x SMs).
// Returns a cudaError_t.  Launches nothing.
#pragma once

#include <cuda_runtime.h>

namespace repro {

template <typename Kernel>
int query_resources(Kernel* kernel, int threads, int smem, int* out) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t e = cudaSuccess;
  if (smem > 0)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = attr.maxDynamicSharedSizeBytes;
  out[2] = smem;
  out[3] = threads;
  out[4] = (int)attr.sharedSizeBytes;
  out[5] = per_sm;
  out[6] = 1;
  out[7] = per_sm * sms;
  return 0;
}

}  // namespace repro
