// K-LSTM-train: the training forward and the reverse-time BPTT of one LSTM
// layer with zero initial state, plus the fixed-order sum of per-block dW
// partials that both backward kernels (this BPTT and bdgcn_pair_bwd.cu) use.
//
// Replaces the TPU kernels of mpgcn_tpu/nn/pallas_lstm.py on the training
// path: _lstm_fwd_kernel (launched by _fused_layer_fwd_impl; stores hs and
// cs as the VJP residuals) and _lstm_bwd_kernel (launched by
// _fused_layer_bwd_pallas).
//
//   lstm_train_fwd_f32   x_proj (T, R, 4H), w_hh_T (H, 4H) -> hs, cs (T, R, H)
//   lstm_train_bwd_f32   x_proj, w_hh_T, hs, cs, dhs, dcs (T, R, H; a null
//                        dhs or dcs means zero) -> dx_proj (T, R, 4H) and
//                        per-block partials of dW_hh^T (P, H, 4H)
//   dw_reduce_f32        partials (P, n) -> out (n), summed over p in order
//
//   gates = x_proj_t + h_{t-1} @ w_hh_T, torch order i, f, g, o;
//   c_t = f * c_{t-1} + i * g;  h_t = o * tanh(c_t).
//
// What bounds it on the H100: at the training shape (R = 8,836 OD-pair
// sequences, batch 4 at N = 47, T = 7, H = 32) the forward must read 31.7 MB
// of x_proj and write 15.8 MB of hs and cs (14.2 us at 3.35 TB/s) for
// 0.51 GFLOP (7.6 us at 67 TFLOP/s f32); the backward reads x_proj, hs, cs
// and dhs and writes dx_proj, about 87 MB (26.0 us), for 1.52 GFLOP
// (22.7 us). Both are memory-bound, so each reads its inputs once and keeps
// the carries on chip.
//
// Design of the forward: the inference kernel of lstm_infer.cu plus the
// cs store. One block runs the whole time loop for a tile of rows; thread
// (j, y) owns hidden unit j of kRowsPerThread rows, so its four gate
// columns and c stay in registers; h_{t-1} is double-buffered in shared
// memory; w_hh_T is staged once.
//
// Design of the backward: the TPU kernel walks time chunks in reverse as a
// sequential grid axis and adds dW_hh^T into one resident block across the
// whole grid. Hopper blocks run in parallel and in no order, so here each
// block walks t = T-1..0 inside its own loop for each row tile it takes
// (a grid of a few blocks per SM strides over the tiles), and sums dW_hh^T
// into its own shared-memory block. Each block writes that sum once as a
// partial; dw_reduce_f32 then adds the partials in a fixed order. No
// float atomics: two runs give bit-equal dW. Per step the block stages
// h_{t-1} (read from hs at t-1, zero at t = 0 -- no shifted copies),
// recomputes the gates from x_proj + h_{t-1} w_hh_T exactly as _cell_bwd
// does, writes dgates = dx_proj_t and keeps them in shared memory for
// dh_{t-1} = dgates W_hh and the dW_hh^T update. dh and dc are carried in
// f32 registers. w_hh_T rows are padded by one float so the dh product
// reads it without bank conflicts.

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerThread = 4;
constexpr int kThreadsTarget = 256;
constexpr int kMaxHidden = 64;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

int rows_y_for(int H) {
  return kThreadsTarget / H > 0 ? kThreadsTarget / H : 1;
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

__global__ void lstm_train_fwd_kernel(const float* __restrict__ xp,
                                      const float* __restrict__ whhT,
                                      float* __restrict__ hs,
                                      float* __restrict__ cs, int T, int R,
                                      int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int tile_rows = blockDim.y * kRowsPerThread;
  float* w = smem;          // (H, 4H)
  float* hbuf = w + H * G;  // 2 x (tile_rows, H)

  const int j = threadIdx.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < H * G; i += nthreads) w[i] = whhT[i];
  for (int i = tid; i < 2 * tile_rows * H; i += nthreads) hbuf[i] = 0.0f;

  const int lr0 = threadIdx.y * kRowsPerThread;
  const int row0 = blockIdx.x * tile_rows + lr0;
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
        const size_t o = ((size_t)t * R + r) * H + j;
        hs[o] = h;
        cs[o] = c[q];
      }
    }
    __syncthreads();
  }
}

__global__ void lstm_train_bwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ whhT,
    const float* __restrict__ hs, const float* __restrict__ cs,
    const float* __restrict__ dhs, const float* __restrict__ dcs,
    float* __restrict__ dxp, float* __restrict__ dw_part, int T, int R,
    int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int ws = G + 1;  // padded row stride of w
  const int tile_rows = blockDim.y * kRowsPerThread;
  float* w = smem;                // (H, 4H + 1)
  float* hp = w + H * ws;         // (tile_rows, H): h_{t-1} of the tile
  float* dg = hp + tile_rows * H;  // (tile_rows, 4H): dgates of the tile
  float* dw = dg + tile_rows * G;  // (H, 4H): this block's dW_hh^T sum

  const int j = threadIdx.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < H * G; i += nthreads) {
    const int k = i / G;
    w[k * ws + i - k * G] = whhT[i];
    dw[i] = 0.0f;
  }
  const int lr0 = threadIdx.y * kRowsPerThread;
  const int ntiles = (R + tile_rows - 1) / tile_rows;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tile0 = tile * tile_rows;
    const int row0 = tile0 + lr0;
    float dh_c[kRowsPerThread], dc_c[kRowsPerThread];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) dh_c[q] = dc_c[q] = 0.0f;

    for (int t = T - 1; t >= 0; --t) {
      __syncthreads();  // last step's readers of hp and dg are done
      for (int i = tid; i < tile_rows * H; i += nthreads) {
        const int r = tile0 + i / H;
        hp[i] = (t > 0 && r < R)
                    ? hs[((size_t)(t - 1) * R + r) * H + i % H]
                    : 0.0f;
      }
      __syncthreads();

      // recompute the gates: x_proj_t + h_{t-1} @ w_hh_T
      float acc[kRowsPerThread][4];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int r = row0 + q;
        const float* xr = xp + ((size_t)t * R + r) * G;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          acc[q][g] = r < R ? xr[g * H + j] : 0.0f;
      }
      for (int k = 0; k < H; ++k) {
        const float* wk = w + k * ws + j;
        const float w0 = wk[0], w1 = wk[H], w2 = wk[2 * H], w3 = wk[3 * H];
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q) {
          const float hk = hp[(lr0 + q) * H + k];
          acc[q][0] = fmaf(hk, w0, acc[q][0]);
          acc[q][1] = fmaf(hk, w1, acc[q][1]);
          acc[q][2] = fmaf(hk, w2, acc[q][2]);
          acc[q][3] = fmaf(hk, w3, acc[q][3]);
        }
      }

      // the cell's backward (_cell_bwd)
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int r = row0 + q;
        const bool valid = r < R;
        const size_t o = ((size_t)t * R + r) * H + j;
        const float ig = sigmoidf(acc[q][0]);
        const float fg = sigmoidf(acc[q][1]);
        const float gg = tanhf(acc[q][2]);
        const float og = sigmoidf(acc[q][3]);
        const float ct = valid ? cs[o] : 0.0f;
        const float cp = (valid && t > 0) ? cs[o - (size_t)R * H] : 0.0f;
        const float dh = dh_c[q] + ((valid && dhs) ? dhs[o] : 0.0f);
        const float dc = dc_c[q] + ((valid && dcs) ? dcs[o] : 0.0f);
        const float tc = tanhf(ct);
        const float d_o = dh * tc;
        const float dct = dc + dh * og * (1.0f - tc * tc);
        dc_c[q] = dct * fg;
        float dgate[4];
        dgate[0] = dct * gg * ig * (1.0f - ig);
        dgate[1] = dct * cp * fg * (1.0f - fg);
        dgate[2] = dct * ig * (1.0f - gg * gg);
        dgate[3] = d_o * og * (1.0f - og);
        float* dgr = dg + (lr0 + q) * G + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float v = valid ? dgate[g] : 0.0f;
          dgr[g * H] = v;
          if (valid) dxp[((size_t)t * R + r) * G + g * H + j] = v;
        }
      }
      __syncthreads();

      // dh_{t-1} = dgates @ W_hh  (contract the 4H axis)
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const float* dgr = dg + (lr0 + q) * G;
        const float* wj = w + j * ws;
        float s = 0.0f;
        for (int col = 0; col < G; ++col) s = fmaf(dgr[col], wj[col], s);
        dh_c[q] = s;
      }
      // dW_hh^T += h_{t-1}^T @ dgates, each entry owned by one thread
      for (int i = tid; i < H * G; i += nthreads) {
        const int k = i / G;
        const int col = i - k * G;
        float s = 0.0f;
        for (int rr = 0; rr < tile_rows; ++rr)
          s = fmaf(hp[rr * H + k], dg[rr * G + col], s);
        dw[i] += s;
      }
    }
  }
  float* part = dw_part + (size_t)blockIdx.x * H * G;
  for (int i = tid; i < H * G; i += nthreads) part[i] = dw[i];
}

__global__ void dw_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int P, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int p = 0; p < P; ++p) s += part[(size_t)p * n + i];
  out[i] = s;
}

}  // namespace

extern "C" int lstm_train_fwd_f32(const void* xp, const void* whhT, void* hs,
                                  void* cs, int T, int R, int H,
                                  void* stream) {
  if (T < 1 || R < 1 || H < 1 || H > kMaxHidden) return cudaErrorInvalidValue;
  const int rows_y = rows_y_for(H);
  const int tile_rows = rows_y * kRowsPerThread;
  const size_t smem = (size_t)(H * 4 * H + 2 * tile_rows * H) * sizeof(float);
  cudaError_t err = allow_smem((const void*)lstm_train_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 block(H, rows_y);
  const dim3 grid((R + tile_rows - 1) / tile_rows);
  lstm_train_fwd_kernel<<<grid, block, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(whhT),
      static_cast<float*>(hs), static_cast<float*>(cs), T, R, H);
  return cudaGetLastError();
}

// P blocks stride over the row tiles; dw_part holds P * H * 4H floats.
extern "C" int lstm_train_bwd_f32(const void* xp, const void* whhT,
                                  const void* hs, const void* cs,
                                  const void* dhs, const void* dcs, void* dxp,
                                  void* dw_part, int T, int R, int H, int P,
                                  void* stream) {
  if (T < 1 || R < 1 || H < 1 || H > kMaxHidden || P < 1)
    return cudaErrorInvalidValue;
  const int rows_y = rows_y_for(H);
  const int tile_rows = rows_y * kRowsPerThread;
  const int G = 4 * H;
  const size_t smem =
      (size_t)(H * (G + 1) + tile_rows * H + tile_rows * G + H * G) *
      sizeof(float);
  cudaError_t err = allow_smem((const void*)lstm_train_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 block(H, rows_y);
  lstm_train_bwd_kernel<<<P, block, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(whhT),
      static_cast<const float*>(hs), static_cast<const float*>(cs),
      static_cast<const float*>(dhs), static_cast<const float*>(dcs),
      static_cast<float*>(dxp), static_cast<float*>(dw_part), T, R, H);
  return cudaGetLastError();
}

extern "C" int dw_reduce_f32(const void* part, void* out, int P, int n,
                             void* stream) {
  if (P < 1 || n < 1) return cudaErrorInvalidValue;
  dw_reduce_kernel<<<(n + 255) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), P, n);
  return cudaGetLastError();
}
