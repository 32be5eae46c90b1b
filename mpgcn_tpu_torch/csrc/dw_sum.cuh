// The fixed-order sum of per-block dW partials that the two backward kernels
// (lstm_train.cu's BPTT and bdgcn_pair_bwd.cu's dW product) run after a
// grid-wide barrier, inside the launch that wrote the partials.

#pragma once

#include <cuda_runtime.h>

namespace {

// Block b of nb sums entries [b share, (b + 1) share) of the P partials
// (P, n) over p = 0, 1, ..., P-1 in order: the adds of dw_reduce_plain, so
// the sum is bit-equal to it and from run to run. The partials were written
// by other blocks before the barrier, so they are read past L1. All the
// block's threads load a piece of its share, rows of partials at a time,
// into buf (cap floats of shared memory the block no longer needs), so the
// loads are in flight together; then one thread per entry adds its column
// in order. Every thread of the block must call it.
__device__ __forceinline__ void sum_partials(const float* part, float* out,
                                             int P, int n, int b, int nb,
                                             int tid, int nthreads,
                                             float* buf, int cap) {
  const int share = (n + nb - 1) / nb;
  const int i1 = min(n, (b + 1) * share);
  const int width = min(nthreads, cap);
  for (int e0 = b * share; e0 < i1; e0 += width) {
    const int w = min(width, i1 - e0);
    const int rows = cap / w;
    float s = 0.0f;
    for (int p0 = 0; p0 < P; p0 += rows) {
      const int nr = min(rows, P - p0);
      __syncthreads();  // buf's last readers are done
      for (int q = tid; q < nr * w; q += nthreads) {
        const int r = q / w;
        buf[q] = __ldcg(part + (size_t)(p0 + r) * n + e0 + q - r * w);
      }
      __syncthreads();
      if (tid < w) {
        int r = 0;
        if (p0 == 0) {
          s = buf[tid];
          r = 1;
        }
        // eight loads in flight together, added in order
        for (; r + 8 <= nr; r += 8) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = buf[(r + u) * w + tid];
#pragma unroll
          for (int u = 0; u < 8; ++u) s += v[u];
        }
        for (; r < nr; ++r) s += buf[r * w + tid];
      }
    }
    if (tid < w) out[e0 + tid] = s;
  }
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

}  // namespace
