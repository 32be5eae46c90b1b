// The LSTM forward for hidden widths whose w_hh^T does not fit a block's
// shared memory, shared by lstm_infer.cu (h_T only, or every h_t) and
// lstm_train.cu (hs and cs).
//
// The resident kernels of those files stage w_hh^T (H x 4H, 16 H^2 bytes)
// in shared memory once per block; past H ~ 116 it no longer fits the
// 227 KB a block may take. Here w_hh^T stays in device memory and is read
// through the read-only cache at every step: thread (x, y) takes hidden
// units j = x, x + bx, ... (bx = min(H, 256)), so any H works, and for
// each j its four gate columns j, H+j, 2H+j, 3H+j of kRowsPerThread rows.
// Neighbouring threads read neighbouring columns, so the loads coalesce;
// each w_hh^T value read serves the tile's rows. h_{t-1} of the tile is
// double-buffered in shared memory and c lives there too (a thread owns
// its (row, j) entries of c, so c needs no barrier); one barrier per step.
// Shared memory is 3 x tile_rows x H floats (48 KB at H = 1,024), so H up
// to 4,842 fits: past the H that the JAX kernels' 96 MB VMEM limit takes.
// Gate math is f32 with expf and tanhf, as in the resident kernels. The
// gate inputs come from x_proj or, for the inference modes, from x, w_ih
// and b in the fused form of lstm_fwd.cuh (kFused; proj_in below).

#pragma once

#include <cuda_runtime.h>

#include "smem.cuh"

namespace {

constexpr int kRowsPerThread = 4;
constexpr int kThreadsTarget = 256;

enum LstmFwdMode { kFwdLast = 0, kFwdCollect = 1, kFwdTrain = 2 };

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// A gate input of the fused form: x (F features) . w (F weights) + b, the
// products summed in f order and b added last. At F = 1 it rounds as a
// K = 1 product and a bias add do: __fadd_rn(__fmul_rn(x, w), b).
__device__ __forceinline__ float proj_in(const float* x, const float* w,
                                         float b, int F) {
  float p = __fmul_rn(x[0], w[0]);
  for (int f = 1; f < F; ++f) p = __fmaf_rn(x[f], w[f], p);
  return __fadd_rn(p, b);
}

// Thread rows of a block at hidden width H, max(1, 256 / H), each of
// kRowsPerThread sequence rows: the resident kernels' blocks are (H, by),
// the wide ones' (min(H, 256), by), so a tile holds the same rows in both.
inline int rows_y_for(int H) {
  return kThreadsTarget / H > 0 ? kThreadsTarget / H : 1;
}

inline int wide_bx(int H) { return H < kThreadsTarget ? H : kThreadsTarget; }

inline size_t wide_fwd_smem_bytes(int H) {
  return (size_t)3 * rows_y_for(H) * kRowsPerThread * H * sizeof(float);
}

// kFwdLast writes h_T to out0 (R, H); kFwdCollect every h_t to out0
// (T, R, H); kFwdTrain every h_t to out0 and every c_t to out1 (T, R, H).
// kFused reads x (R, T, F), w_ih (4H, F) and b (4H) instead of x_proj.
template <int kMode, bool kFused>
__global__ void lstm_fwd_wide_kernel(const float* __restrict__ xp,
                                     const float* __restrict__ whhT,
                                     float* __restrict__ out0,
                                     float* __restrict__ out1, int T, int R,
                                     int H, const float* __restrict__ x,
                                     const float* __restrict__ wih,
                                     const float* __restrict__ b, int F) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int bx = blockDim.x;
  const int tile_rows = blockDim.y * kRowsPerThread;
  float* hbuf = smem;                     // 2 x (tile_rows, H)
  float* cbuf = hbuf + 2 * tile_rows * H;  // (tile_rows, H)

  const int tid = threadIdx.y * bx + threadIdx.x;
  const int nthreads = bx * blockDim.y;
  for (int i = tid; i < 3 * tile_rows * H; i += nthreads) smem[i] = 0.0f;
  const int lr0 = threadIdx.y * kRowsPerThread;
  const int row0 = blockIdx.x * tile_rows + lr0;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* hcur = hbuf + (t & 1) * tile_rows * H;
    float* hnxt = hbuf + ((t + 1) & 1) * tile_rows * H;
    const float* xt = xp + (size_t)t * R * G;
    for (int j = threadIdx.x; j < H; j += bx) {
      float acc[kRowsPerThread][4];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int r = row0 + q;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if constexpr (kFused)
            acc[q][g] = r < R ? proj_in(x + ((size_t)r * T + t) * F,
                                        wih + (size_t)(g * H + j) * F,
                                        b[g * H + j], F)
                              : 0.0f;
          else
            acc[q][g] = r < R ? xt[(size_t)r * G + g * H + j] : 0.0f;
        }
      }
      for (int k = 0; k < H; ++k) {
        const float* wk = whhT + (size_t)k * G + j;
        const float w0 = __ldg(wk), w1 = __ldg(wk + H),
                    w2 = __ldg(wk + 2 * H), w3 = __ldg(wk + 3 * H);
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q) {
          const float hk = hcur[(lr0 + q) * H + k];
          acc[q][0] = fmaf(hk, w0, acc[q][0]);
          acc[q][1] = fmaf(hk, w1, acc[q][1]);
          acc[q][2] = fmaf(hk, w2, acc[q][2]);
          acc[q][3] = fmaf(hk, w3, acc[q][3]);
        }
      }
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const float ig = sigmoidf(acc[q][0]);
        const float fg = sigmoidf(acc[q][1]);
        const float gg = tanhf(acc[q][2]);
        const float og = sigmoidf(acc[q][3]);
        float* cq = cbuf + (lr0 + q) * H + j;
        const float c = fg * *cq + ig * gg;
        *cq = c;
        const float h = og * tanhf(c);
        hnxt[(lr0 + q) * H + j] = h;
        const int r = row0 + q;
        if (r < R) {
          const size_t o = ((size_t)t * R + r) * H + j;
          if (kMode == kFwdLast) {
            if (t == T - 1) out0[(size_t)r * H + j] = h;
          } else {
            out0[o] = h;
            if (kMode == kFwdTrain) out1[o] = c;
          }
        }
      }
    }
    __syncthreads();
  }
}

// Launch the wide forward, on x_proj or (kFused, the inference modes) from
// x, w_ih and b with F features; refused (cudaErrorInvalidValue) only when
// even its 3 x tile_rows x H floats exceed a block's shared memory.
template <int kMode, bool kFused>
cudaError_t launch_fwd_wide(const float* xp, const float* x, const float* wih,
                            const float* b, int F, const float* whhT,
                            float* out0, float* out1, int T, int R, int H,
                            cudaStream_t stream) {
  const size_t smem = wide_fwd_smem_bytes(H);
  bool fits = false;
  cudaError_t err = smem_fits(smem, &fits);
  if (err != cudaSuccess) return err;
  if (!fits) return cudaErrorInvalidValue;
  auto kernel = lstm_fwd_wide_kernel<kMode, kFused>;
  err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const int bx = wide_bx(H), by = rows_y_for(H);
  const int tile_rows = by * kRowsPerThread;
  const dim3 grid((R + tile_rows - 1) / tile_rows);
  kernel<<<grid, dim3(bx, by), smem, stream>>>(xp, whhT, out0, out1, T, R,
                                               H, x, wih, b, F);
  return cudaGetLastError();
}

}  // namespace
