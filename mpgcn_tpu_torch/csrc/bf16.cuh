// The storage types of the kernels' bf16 entries. Each LSTM and K-BDGCN
// kernel that has a bf16 entry keeps its f32 arithmetic and takes a
// storage type S (float or __nv_bfloat16) for the tensors it reads and
// writes in device memory: a load of S is widened to f32 exactly (ldf),
// a store rounds to nearest even (stf), and round_to<S> gives the f32
// value a store of S would keep. With S = float every helper is the
// identity, so the f32 entries compile to the code they had before.
//
// widen_bf16_kernel and round_bf16_kernel move whole tensors between the
// two types: the bf16 entries that run on the split-TF32 engine of
// bdgcn_gemm.cuh (whose staging reads f32 operands) widen their bf16
// operands into f32 scratch first and round the products that are stored
// in bf16 afterwards. A bf16 value splits into TF32 with a zero remainder
// (8 mantissa bits of TF32's 10), so the engine's products of widened
// operands are those of the bf16 values.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

template <class S>
constexpr bool kIsBf16 = sizeof(S) == 2;

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) { return tof(*p); }
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v as a store of S keeps it: v itself for float, v rounded to the
// nearest bf16 (ties to even; Inf and NaN stay what they are) for bf16.
template <class S>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (kIsBf16<S>)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

// dst[i] = src[i] widened, i < n.
__global__ void widen_bf16_kernel(const bf16* __restrict__ src,
                                  float* __restrict__ dst, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    dst[i] = __bfloat162float(src[i]);
}

// dst[i] = src[i] rounded to bf16, i < n; dst of type D (bf16, or float
// for a value kept rounded in f32 storage, in place where dst == src).
template <class D>
__global__ void round_bf16_kernel(const float* src, D* dst, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    stf(dst + i, round_to<bf16>(src[i]));
}

constexpr int kCvtThreads = 256;

inline int cvt_blocks(long long n) {
  const long long b = (n + kCvtThreads - 1) / kCvtThreads;
  return (int)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

inline cudaError_t widen_bf16(const void* src, float* dst, long long n,
                              cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  widen_bf16_kernel<<<cvt_blocks(n), kCvtThreads, 0, s>>>(
      static_cast<const bf16*>(src), dst, n);
  return cudaGetLastError();
}

template <class D>
inline cudaError_t round_bf16(const float* src, D* dst, long long n,
                              cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  round_bf16_kernel<D><<<cvt_blocks(n), kCvtThreads, 0, s>>>(src, dst, n);
  return cudaGetLastError();
}

}  // namespace
