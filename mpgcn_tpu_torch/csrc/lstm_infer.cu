// K-LSTM: inference forward of one LSTM layer with zero initial state.
//
// Replaces the TPU kernels of mpgcn_tpu/nn/pallas_lstm.py reached from
// _fused_layer_infer: _make_last_kernel (collect=False, writes h_T only)
// and _lstm_infer_kernel (collect=True, streams h_t for every t).
//
//   x_proj (T, R, 4H) f32, time-major: x_t @ W_ih^T + b_ih + b_hh
//   w_hh_T (H, 4H)    f32: the recurrent weight, transposed
//   out    (R, H)     h_T            (lstm_infer_last_f32)
//          (T, R, H)  h_t for all t  (lstm_infer_collect_f32)
//   gates = x_proj_t + h_{t-1} @ w_hh_T, torch order i, f, g, o;
//   c_t = f * c_{t-1} + i * g;  h_t = o * tanh(c_t).
//
// What bounds it on the H100: at the serve shape (R = 17,672 OD-pair
// sequences at bucket 8, T = 7, H = 32) it must read 63.3 MB of x_proj
// and write 2.3 MB (19.6 us at 3.35 TB/s) for 1.01 GFLOP (15.1 us at
// 67 TFLOP/s f32): memory-bound, so the design reads x_proj once and keeps
// everything else on chip.
//
// Design: the TPU kernel runs time as a sequential grid axis whose carry
// persists in VMEM scratch; here the whole time loop runs inside one block
// and blocks run in parallel over row tiles. Each block stages w_hh_T in
// shared memory once (16 KB at H = 32). Thread (j, y) owns hidden unit j of
// kRowsPerThread rows, so its four gate columns j, H+j, 2H+j, 3H+j -- and
// the cell state c -- stay in registers. h_{t-1} of the block's rows lives
// in shared memory, double-buffered between t-1 and t, so one barrier per
// step suffices. The next step's x_proj is loaded before this step's
// recurrent product, so the load latency overlaps the arithmetic. Loads
// are coalesced (neighbouring threads read neighbouring gate columns).
// Time is never padded: the loop runs exactly T steps; the row tail is
// masked with a bound check. Gate math is f32 with expf and tanhf.
//
// Widths: this resident kernel runs wherever w_hh^T and the h buffers fit
// a block's shared memory (H <= 118 on the H100), the reference H = 32
// among them, so its code and its times there stay as they were. Wider H
// takes lstm_fwd_wide_kernel of lstm_wide.cuh (w_hh^T read through the
// read-only cache each step; any H): a second kernel chosen per call from
// H and the device's shared-memory limit, not a branch inside this one,
// so the resident kernel's registers and schedule do not change.

#include <cuda_runtime.h>

#include "lstm_wide.cuh"

namespace {

template <bool kCollect>
__global__ void lstm_infer_kernel(const float* __restrict__ xp,
                                  const float* __restrict__ whhT,
                                  float* __restrict__ out, int T, int R,
                                  int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int tile_rows = blockDim.y * kRowsPerThread;
  float* w = smem;               // (H, 4H)
  float* hbuf = w + H * G;       // 2 x (tile_rows, H)

  const int j = threadIdx.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < H * G; i += nthreads) w[i] = whhT[i];
  for (int i = tid; i < 2 * tile_rows * H; i += nthreads) hbuf[i] = 0.0f;

  const int lr0 = threadIdx.y * kRowsPerThread;  // first local row
  const int row0 = blockIdx.x * tile_rows + lr0;  // first global row
  float c[kRowsPerThread];
  float x_next[kRowsPerThread][4];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    c[q] = 0.0f;
    const int r = row0 + q;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      x_next[q][g] = r < R ? xp[(size_t)r * G + g * H + j] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float acc[kRowsPerThread][4];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[q][g] = x_next[q][g];
    if (t + 1 < T) {
      const float* xt = xp + (size_t)(t + 1) * R * G;
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int r = row0 + q;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          x_next[q][g] = r < R ? xt[(size_t)r * G + g * H + j] : 0.0f;
      }
    }
    const float* hcur = hbuf + (t & 1) * tile_rows * H;
    float* hnxt = hbuf + ((t + 1) & 1) * tile_rows * H;
    for (int k = 0; k < H; ++k) {
      const float* wk = w + k * G + j;
      const float w0 = wk[0], w1 = wk[H], w2 = wk[2 * H], w3 = wk[3 * H];
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
      c[q] = fg * c[q] + ig * gg;
      const float h = og * tanhf(c[q]);
      hnxt[(lr0 + q) * H + j] = h;
      const int r = row0 + q;
      if (r < R) {
        if (kCollect)
          out[((size_t)t * R + r) * H + j] = h;
        else if (t == T - 1)
          out[(size_t)r * H + j] = h;
      }
    }
    __syncthreads();
  }
}

template <bool kCollect>
int launch(const void* xp, const void* whhT, void* out, int T, int R, int H,
           void* stream) {
  if (T < 1 || R < 1 || H < 1) return cudaErrorInvalidValue;
  const int rows_y = rows_y_for(H);
  const int tile_rows = rows_y * kRowsPerThread;
  const size_t smem = (size_t)(H * 4 * H + 2 * tile_rows * H) * sizeof(float);
  bool resident = false;
  cudaError_t err = smem_fits(smem, &resident);
  if (err != cudaSuccess) return err;
  if (!resident)
    return launch_fwd_wide<kCollect ? kFwdCollect : kFwdLast>(
        xp, whhT, out, nullptr, T, R, H, static_cast<cudaStream_t>(stream));
  auto kernel = lstm_infer_kernel<kCollect>;
  err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 block(H, rows_y);
  const dim3 grid((R + tile_rows - 1) / tile_rows);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(whhT),
      static_cast<float*>(out), T, R, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lstm_infer_last_f32(const void* xp, const void* whhT,
                                   void* out, int T, int R, int H,
                                   void* stream) {
  return launch<false>(xp, whhT, out, T, R, H, stream);
}

extern "C" int lstm_infer_collect_f32(const void* xp, const void* whhT,
                                      void* out, int T, int R, int H,
                                      void* stream) {
  return launch<true>(xp, whhT, out, T, R, H, stream);
}
