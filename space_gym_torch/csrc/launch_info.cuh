// Launching an env kernel whose one parameter is a struct, on the card or
// (host/ stand-ins) emulated on the CPU; and what a launch of one kernel
// instantiation looks like on the current device, for chip_smoke.py.
#pragma once

#include <cuda_runtime.h>

// Registers, local memory (stack frame and spills) per thread,
// resident blocks per SM, SMs, the grid, threads a block, dynamic shared
// memory, lane tiles.
template <class KERNEL>
static int sg_kernel_info(KERNEL k, int grid, int threads, int smem, int tiles, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  int bps = 0, dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, k, threads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int v[8] = {fa.numRegs, (int)fa.localSizeBytes, bps, sms, grid, threads, smem, tiles};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}


// Launches k(args) on `grid` blocks of `threads`; returns the launch's error.
template <class ARGS>
static int sg_launch(void (*k)(ARGS), int grid, int threads, size_t smem, cudaStream_t s,
                     ARGS& args) {
  void* params[] = {&args};
#ifdef __CUDACC__
  const cudaError_t e = cudaLaunchKernel((const void*)k, dim3(grid), dim3(threads), params, smem, s);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
#else
  (void)s;
  return launch_emul(k, dim3(grid), dim3(threads), params, smem);
#endif
}

// The blocks of `threads` threads and `smem` bytes of dynamic shared memory
// of kernel k that the current device holds at once; `known_dev` and
// `per_sm` cache the occupancy query of one instantiation per device.
template <class ARGS>
static int sg_resident_blocks(void (*k)(ARGS), int threads, int smem, int& known_dev,
                              int& per_sm, int* out) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != known_dev) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads, smem);
    if (e == cudaSuccess) known_dev = dev;
  }
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && per_sm * sms <= 0) e = cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  return (int)e;
}
