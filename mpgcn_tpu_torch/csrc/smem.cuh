// Host helpers about a block's dynamic shared memory, about how many
// blocks of a kernel the current device holds at once, and about the
// alignment that 16-byte copies need. Every source that needs them
// includes this one copy, so a source may include any set of the headers.

#pragma once

#include <cuda_runtime.h>

namespace {

// True when a kernel needing smem bytes of dynamic shared memory fits a
// block of the current device (48 KB always does, without asking it).
inline cudaError_t smem_fits(size_t smem, bool* fits) {
  *fits = true;
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *fits = err == cudaSuccess && smem <= (size_t)optin;
  return err;
}

// Lets `kernel` launch with smem bytes of dynamic shared memory.
inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The most blocks of `kernel` (block threads, dynamic shared memory smem)
// that the current device holds at once: the largest grid a cooperative
// launch of it takes.
inline cudaError_t max_coresident(const void* kernel, int threads,
                                  size_t smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  *out = per_sm * sms;
  return err;
}

// True when p may be read or written in 16-byte copies (null counts as
// aligned: it is never read).
inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace
