// K-LSTM-train: the training forward and the reverse-time BPTT of one LSTM
// layer with zero initial state.
//
// Replaces the TPU kernels of mpgcn_tpu/nn/pallas_lstm.py on the training
// path: _lstm_fwd_kernel (launched by _fused_layer_fwd_impl; stores hs and
// cs as the VJP residuals) and _lstm_bwd_kernel (launched by
// _fused_layer_bwd_pallas).
//
//   lstm_train_fwd_f32   x_proj (T, R, 4H), w_hh_T (H, 4H) -> hs, cs (T, R, H)
//   lstm_train_bwd_f32   x_proj, w_hh_T, hs, cs, dhs, dcs (T, R, H; a null
//                        dhs or dcs means zero) -> dx_proj (T, R, 4H) and
//                        dW_hh^T (H, 4H), through per-block partials
//                        (P, H, 4H) that the same launch sums in order
//   lstm_train_bwd_max_blocks   the most BPTT blocks that can be resident
//                        at once on the current device (the bound on P)
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
// (a grid of a few blocks per SM strides over the tiles, the tiles of the
// last, partial round spread evenly over the grid), and sums dW_hh^T
// into its own shared-memory block. Each block writes that sum once as a
// partial; then the grid meets at a grid-wide barrier (a cooperative
// launch: every block is resident, so P is bounded by the occupancy) and
// every block sums a contiguous share of the H x 4H entries over the
// partials p = 0, 1, ..., P-1 in order. One launch, no float atomics: two
// runs give bit-equal dW. Per step the block stages
// h_{t-1} (read from hs at t-1, zero at t = 0 -- no shifted copies),
// recomputes the gates from x_proj + h_{t-1} w_hh_T exactly as _cell_bwd
// does, writes dgates = dx_proj_t and keeps them in shared memory for
// dh_{t-1} = dgates W_hh and the dW_hh^T update. dh and dc are carried in
// f32 registers. w_hh_T rows are padded by one float so the dh product
// reads it without bank conflicts.
//
// Widths. The two kernels above keep w_hh^T (and the BPTT its dW_hh^T
// sum) in shared memory: the forward fits to H = 118, the BPTT to H = 81
// on the H100, the reference H = 32 among them, and there they run as they
// always did. Past that, each entry takes a second kernel, chosen per call
// from H and the device's shared-memory limit (a separate kernel, not a
// branch inside the resident one, so the resident kernels' registers and
// schedule stay as they were):
//   - the forward, lstm_fwd_wide_kernel of lstm_wide.cuh (w_hh^T read
//     through the read-only cache at every step);
//   - the BPTT, lstm_train_bwd_wide_kernel: phase 1 is the recurrence as
//     above, with w_hh^T read from device memory (coalesced gate columns
//     for the gates, a warp per row for dh) and dh, dc carried in shared
//     memory, writing dgates to dx_proj only; phase 2 forms the block's
//     dW_hh^T partial, sum over its own rows and t >= 1 of
//     h_{t-1} (x) dx_proj_t, in 32 x 64 output tiles of 4 x 4 register
//     micro-tiles from 32 staged rows at a time (its own dx_proj writes,
//     visible after a block barrier); after the grid-wide barrier, phase 3
//     is the same ordered sum of the partials (dw_sum.cuh). Still one
//     cooperative launch, no atomics.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dw_sum.cuh"
#include "lstm_wide.cuh"

namespace {

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
    float* __restrict__ dxp, float* __restrict__ dw_part,
    float* __restrict__ dw_out, int T, int R, int H) {
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

  // Every block takes tiles b, b + P, ... for the rounds all blocks fill;
  // the last round's `extra` tiles go to blocks spread evenly over the grid
  // (block floor(k P / extra) takes tile k of it), so blocks with one more
  // tile do not share an SM wherever the grid is placed.
  const int P = gridDim.x, b = blockIdx.x;
  const int full = ntiles / P, extra = ntiles - full * P;
  const int k_extra = (int)(((long long)b * extra + P - 1) / P);
  const bool has_extra =
      k_extra < extra && (long long)k_extra * P / extra == b;
  const int my_tiles = full + (has_extra ? 1 : 0);
  for (int it = 0; it < my_tiles; ++it) {
    const int tile = it < full ? it * P + b : full * P + k_extra;
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
  // every block's partial is written; each sums its share of the entries
  cooperative_groups::this_grid().sync();
  sum_partials(dw_part, dw_out, gridDim.x, H * G, blockIdx.x, gridDim.x,
               tid, nthreads, smem, H * ws + tile_rows * (H + G) + H * G);
}

// The tile a block takes at its round `it` of ntiles row tiles over P
// blocks: tiles b, b + P, ... for the rounds all blocks fill; the last
// round's `extra` tiles go to blocks spread evenly over the grid (block
// floor(k P / extra) takes tile k of it). Returns the block's tile count.
__device__ __forceinline__ int my_tile_count(int ntiles, int P, int b,
                                             int* k_extra_out) {
  const int full = ntiles / P, extra = ntiles - full * P;
  const int k_extra = (int)(((long long)b * extra + P - 1) / P);
  const bool has_extra =
      k_extra < extra && (long long)k_extra * P / extra == b;
  *k_extra_out = k_extra;
  return full + (has_extra ? 1 : 0);
}

__device__ __forceinline__ int my_tile(int it, int ntiles, int P, int b,
                                       int k_extra) {
  const int full = ntiles / P;
  return it < full ? it * P + b : full * P + k_extra;
}

constexpr int kDwRows = 32;   // staged rows per dW step (phase 2)
constexpr int kDwK = 32;      // dW_hh^T output tile: kDwK x kDwC, in 4 x 4
constexpr int kDwC = 64;      // micro-tiles, one for each of 128 threads

__global__ void lstm_train_bwd_wide_kernel(
    const float* __restrict__ xp, const float* __restrict__ whhT,
    const float* __restrict__ hs, const float* __restrict__ cs,
    const float* __restrict__ dhs, const float* __restrict__ dcs,
    float* __restrict__ dxp, float* __restrict__ dw_part,
    float* __restrict__ dw_out, int T, int R, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int bx = blockDim.x;
  const int tile_rows = blockDim.y * kRowsPerThread;
  float* hp = smem;                 // (tile_rows, H): h_{t-1} of the tile
  float* dg = hp + tile_rows * H;   // (tile_rows, 4H): dgates of the tile
  float* dhc = dg + tile_rows * G;  // (tile_rows, H): dh carried to t-1
  float* dcc = dhc + tile_rows * H;  // (tile_rows, H): dc carried to t-1

  const int tid = threadIdx.y * bx + threadIdx.x;
  const int nthreads = bx * blockDim.y;
  const int warp = tid / 32, lane = tid % 32;
  const int nwarps = nthreads / 32;  // full warps (at least 4: H > 81)
  const int lr0 = threadIdx.y * kRowsPerThread;
  const int ntiles = (R + tile_rows - 1) / tile_rows;
  const int P = gridDim.x, b = blockIdx.x;
  int k_extra;
  const int my_tiles = my_tile_count(ntiles, P, b, &k_extra);

  // phase 1: the recurrence, dgates to dx_proj
  for (int it = 0; it < my_tiles; ++it) {
    const int tile0 = my_tile(it, ntiles, P, b, k_extra) * tile_rows;
    const int row0 = tile0 + lr0;
    for (int j = threadIdx.x; j < H; j += bx)
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q)
        dhc[(lr0 + q) * H + j] = dcc[(lr0 + q) * H + j] = 0.0f;

    for (int t = T - 1; t >= 0; --t) {
      __syncthreads();  // last step's readers of hp and dg are done
      for (int i = tid; i < tile_rows * H; i += nthreads) {
        const int r = tile0 + i / H;
        hp[i] = (t > 0 && r < R)
                    ? hs[((size_t)(t - 1) * R + r) * H + i % H]
                    : 0.0f;
      }
      __syncthreads();

      for (int j = threadIdx.x; j < H; j += bx) {
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
          const float* wk = whhT + (size_t)k * G + j;
          const float w0 = __ldg(wk), w1 = __ldg(wk + H),
                      w2 = __ldg(wk + 2 * H), w3 = __ldg(wk + 3 * H);
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
          const int s = (lr0 + q) * H + j;
          const float dh = dhc[s] + ((valid && dhs) ? dhs[o] : 0.0f);
          const float dc = dcc[s] + ((valid && dcs) ? dcs[o] : 0.0f);
          const float tc = tanhf(ct);
          const float d_o = dh * tc;
          const float dct = dc + dh * og * (1.0f - tc * tc);
          dcc[s] = dct * fg;
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
      }
      if (t == 0) continue;  // dh_{-1} is not needed
      __syncthreads();

      // dh_{t-1} = dgates @ W_hh: a warp per hidden unit j, its lanes over
      // the 4H columns of row j of w_hh_T (coalesced), summed by shuffles
      if (warp < nwarps) {
        for (int j = warp; j < H; j += nwarps) {
          const float* wj = whhT + (size_t)j * G;
          for (int q0 = 0; q0 < tile_rows; q0 += kRowsPerThread) {
            float s[kRowsPerThread];
#pragma unroll
            for (int q = 0; q < kRowsPerThread; ++q) s[q] = 0.0f;
            for (int col = lane; col < G; col += 32) {
              const float wv = __ldg(wj + col);
#pragma unroll
              for (int q = 0; q < kRowsPerThread; ++q)
                s[q] = fmaf(dg[(q0 + q) * G + col], wv, s[q]);
            }
#pragma unroll
            for (int q = 0; q < kRowsPerThread; ++q) {
#pragma unroll
              for (int o = 16; o > 0; o >>= 1)
                s[q] += __shfl_xor_sync(0xffffffffu, s[q], o);
            }
            if (lane == 0) {
#pragma unroll
              for (int q = 0; q < kRowsPerThread; ++q)
                dhc[(q0 + q) * H + j] = s[q];
            }
          }
        }
      }
    }
  }

  // phase 2: this block's partial, sum over its rows and t >= 1 of
  // h_{t-1}^T dx_proj_t, by kDwK x kDwC tiles of dW_hh^T, a 4 x 4
  // micro-tile for each of the first 128 threads; the staged rows u run
  // over (tile, t, row of the tile)
  float* hsm = smem;                  // (kDwRows, kDwK): h_{t-1}
  float* dsm = hsm + kDwRows * kDwK;  // (kDwRows, kDwC): dx_proj_t
  const int per_tile = (T - 1) * tile_rows;
  const int n_u = my_tiles * per_tile;
  const int ty = tid / (kDwC / 4), tx = tid % (kDwC / 4);
  float* part = dw_part + (size_t)b * H * G;
  for (int k0 = 0; k0 < H; k0 += kDwK) {
    for (int c0 = 0; c0 < G; c0 += kDwC) {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
      for (int u0 = 0; u0 < n_u; u0 += kDwRows) {
        __syncthreads();  // the previous stage's (or phase 1's) readers
        for (int i = tid; i < kDwRows * kDwC; i += nthreads) {
          const int uu = i / kDwC, cc = i - uu * kDwC;
          const int u = u0 + uu;
          float hv = 0.0f, dv = 0.0f;
          if (u < n_u) {
            const int it = u / per_tile, rem = u - it * per_tile;
            const int t = 1 + rem / tile_rows;
            const int r = my_tile(it, ntiles, P, b, k_extra) * tile_rows +
                          rem % tile_rows;
            if (r < R) {
              if (cc < kDwK && k0 + cc < H)
                hv = hs[((size_t)(t - 1) * R + r) * H + k0 + cc];
              if (c0 + cc < G) dv = dxp[((size_t)t * R + r) * G + c0 + cc];
            }
          }
          if (cc < kDwK) hsm[uu * kDwK + cc] = hv;
          dsm[i] = dv;
        }
        __syncthreads();
        if (tid < kDwK * kDwC / 16) {
          const int nr = min(kDwRows, n_u - u0);
          for (int uu = 0; uu < nr; ++uu) {
            const float4 hv =
                *reinterpret_cast<const float4*>(hsm + uu * kDwK + ty * 4);
            const float4 dv =
                *reinterpret_cast<const float4*>(dsm + uu * kDwC + tx * 4);
            const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
            const float d4[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[a][c] = fmaf(h4[a], d4[c], acc[a][c]);
          }
        }
      }
      if (tid < kDwK * kDwC / 16) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int k = k0 + ty * 4 + a;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = c0 + tx * 4 + c;
            if (k < H && col < G) part[(size_t)k * G + col] = acc[a][c];
          }
        }
      }
    }
  }
  // phase 3: every block's partial is written; each sums its share
  cooperative_groups::this_grid().sync();
  const int cap = max(7 * tile_rows * H, kDwRows * (kDwK + kDwC));
  sum_partials(dw_part, dw_out, P, H * G, b, P, tid, nthreads, smem, cap);
}

}  // namespace

extern "C" int lstm_train_fwd_f32(const void* xp, const void* whhT, void* hs,
                                  void* cs, int T, int R, int H,
                                  void* stream) {
  if (T < 1 || R < 1 || H < 1) return cudaErrorInvalidValue;
  const int rows_y = rows_y_for(H);
  const int tile_rows = rows_y * kRowsPerThread;
  const size_t smem = (size_t)(H * 4 * H + 2 * tile_rows * H) * sizeof(float);
  bool resident = false;
  cudaError_t err = smem_fits(smem, &resident);
  if (err != cudaSuccess) return err;
  if (!resident)
    return launch_fwd_wide<kFwdTrain>(xp, whhT, hs, cs, T, R, H,
                                      static_cast<cudaStream_t>(stream));
  err = allow_smem((const void*)lstm_train_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 block(H, rows_y);
  const dim3 grid((R + tile_rows - 1) / tile_rows);
  lstm_train_fwd_kernel<<<grid, block, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(whhT),
      static_cast<float*>(hs), static_cast<float*>(cs), T, R, H);
  return cudaGetLastError();
}

namespace {

size_t bwd_smem_bytes(int H) {
  const int tile_rows = rows_y_for(H) * kRowsPerThread;
  const int G = 4 * H;
  return (size_t)(H * (G + 1) + tile_rows * H + tile_rows * G + H * G) *
         sizeof(float);
}

// Phase 1 needs 7 x tile_rows x H floats; phases 2 and 3 at least the
// staged operands of a dW tile.
size_t bwd_wide_smem_bytes(int H) {
  const size_t phase1 = (size_t)7 * rows_y_for(H) * kRowsPerThread * H;
  const size_t phase2 = kDwRows * (kDwK + kDwC);
  return (phase1 > phase2 ? phase1 : phase2) * sizeof(float);
}

// The kernel of the BPTT at width H, its block and its shared memory: the
// resident one where its shared memory fits a block, else the wide one.
struct BwdPlan {
  const void* kernel;
  dim3 block;
  size_t smem;
};

cudaError_t bwd_plan(int H, BwdPlan* plan) {
  bool resident = false;
  cudaError_t err = smem_fits(bwd_smem_bytes(H), &resident);
  if (err != cudaSuccess) return err;
  if (resident) {
    *plan = {(const void*)lstm_train_bwd_kernel, dim3(H, rows_y_for(H)),
             bwd_smem_bytes(H)};
  } else {
    *plan = {(const void*)lstm_train_bwd_wide_kernel,
             dim3(wide_bx(H), rows_y_for(H)), bwd_wide_smem_bytes(H)};
    bool fits = false;
    err = smem_fits(plan->smem, &fits);
    if (err != cudaSuccess) return err;
    if (!fits) return cudaErrorInvalidValue;
  }
  return allow_smem(plan->kernel, plan->smem);
}

}  // namespace

// The most BPTT blocks the current device holds at once at hidden width H:
// the largest P that lstm_train_bwd_f32 takes.
extern "C" int lstm_train_bwd_max_blocks(int H, int* out) {
  if (H < 1) return cudaErrorInvalidValue;
  BwdPlan plan;
  cudaError_t err = bwd_plan(H, &plan);
  if (err != cudaSuccess) return err;
  return max_coresident(plan.kernel, plan.block.x * plan.block.y, plan.smem,
                        out);
}

// P blocks stride over the row tiles and write their partials to dw_part
// (P * H * 4H floats); after a grid-wide barrier they sum them into dw
// (H * 4H). A cooperative launch: it is refused (and nothing runs) when the
// P blocks cannot all be resident at once.
extern "C" int lstm_train_bwd_f32(const void* xp, const void* whhT,
                                  const void* hs, const void* cs,
                                  const void* dhs, const void* dcs, void* dxp,
                                  void* dw_part, void* dw, int T, int R,
                                  int H, int P, void* stream) {
  if (T < 1 || R < 1 || H < 1 || P < 1) return cudaErrorInvalidValue;
  BwdPlan plan;
  cudaError_t err = bwd_plan(H, &plan);
  if (err != cudaSuccess) return err;
  void* args[] = {&xp, &whhT, &hs, &cs, &dhs, &dcs, &dxp, &dw_part, &dw,
                  &T, &R, &H};
  err = cudaLaunchCooperativeKernel(plan.kernel, dim3(P), plan.block, args,
                                    plan.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error behind
    return err;
  }
  return cudaGetLastError();
}
