// The resident LSTM forward: one kernel template for the three forward
// entries, lstm_infer_last_f32 and lstm_infer_collect_f32 (lstm_infer.cu)
// and lstm_train_fwd_f32 (lstm_train.cu), zero initial state.
//
//   gates = in_t + h_{t-1} @ w_hh_T, torch order i, f, g, o;
//   c_t = f * c_{t-1} + i * g;  h_t = o * tanh(c_t).
//
// in_t is read in one of two forms:
//   x_proj (T, R, 4H), time-major: x_t @ W_ih^T + b_ih + b_hh, formed by
//     the caller (every entry takes it; training only this one);
//   fused (the inference entries, 1 <= F <= kFusedMaxF input features):
//     x (R, T, F) batch-first, w_ih (4H, F) and the summed bias b (4H); a
//     thread forms each gate input in registers, at F = 1 exactly as the
//     caller's K = 1 product and add round it, __fadd_rn(__fmul_rn(x, w),
//     b); for F > 1 the products are summed in f order, then b added.
// Outputs by mode (lstm_wide.cuh's LstmFwdMode): kFwdLast h_T (R, H);
// kFwdCollect every h_t (T, R, H); kFwdTrain every h_t and c_t (T, R, H).
// Every tensor is of one storage type S, float or bf16 (the _bf16
// entries; bf16.cuh): bf16 loads are widened to f32, the carry, gates
// and sums stay f32, h is rounded to S before it enters the next step's
// products (the JAX _cell_step's h.astype(dtype)) and every store is
// rounded; the fused form's gate input is rounded as a bf16 x_proj is.
//
// What bounds it on the H100: at the N = 500 step's shape (R = 500,000
// OD-pair sequences, T = 7, H = 32) the recurrent products are 2 T R H 4H
// = 28.7 GFLOP, 0.43 ms at 67 TFLOP/s f32; x_proj is 1.79 GB, 0.53 ms at
// 3.35 TB/s. A first form (PRs 1-2) loaded 4 w values and 4 h values from
// shared memory, one 4-byte load each, per 16 warp FMAs: 0.5 shared
// wavefronts a warp FMA, against one wavefront a clock an SM for 4 warp
// FMAs, so its loop ran at about twice its FMA time. In the fused form no
// x_proj is read: the bound is the FMAs.
//
// Design. One block runs the whole time loop for a tile of rows and blocks
// run in parallel over the tiles (the TPU kernel's sequential time axis
// becomes the loop). Thread (j, y) owns hidden unit j of kFwdRows rows, so
// its four gate columns j, H+j, 2H+j, 3H+j and its c stay in registers.
// w_hh is staged once as (4H, H), one row per gate column, with a row
// stride that is a multiple of 4 whose quarter is odd: a thread reads 4
// consecutive k of a gate column with one 16-byte load, and the eight
// lanes of each 16-byte load phase (rows n..n+7) fall on eight different
// bank groups. h_{t-1} of the tile is double-buffered in shared memory
// (one barrier a step) and read 4 k at a time, a broadcast within a warp.
// Per 4 k a thread loads 4 w fragments and kFwdRows h fragments for
// 16 kFwdRows FMAs: at H = 32, 16 + 4 wavefronts per 64 warp FMAs, 0.3125
// a warp FMA (8 rows: 0.1875). Measured on the H100 at N = 500
// (lstm_fwd_probe.py), the loop is then bound by issuing its FMAs, not
// by the loads, and the gate math (3 expf, 2 tanhf, 3 divisions a row and
// unit) takes a quarter of the kernel: 8 rows a thread were 1% faster in
// the fused form, 4% slower on x_proj (128 registers, 2 blocks an SM, not
// 3) and 26% slower at the N = 47 serve shape (half the blocks: 2 waves
// of tiles, the second nearly empty). So a thread takes 4 rows. Each gate sum starts from its
// input and takes fmaf(h_k, w_k, acc) for k = 0..H-1 in ascending order,
// as the first form did, so the outputs keep its bits; the cell update is
// written out as the first form's compiled code contracted it, so
// restructuring cannot move the rounding. The next step's input is loaded
// before this step's products, so its latency overlaps them. Gate math is
// f32 with expf and tanhf. Time is never padded; rows past R are masked.
//
// Widths: the kernel runs wherever w_hh and the h buffers fit a block's
// shared memory (H <= 116 on the H100, the reference H = 32 among them).
// Past that the entries launch lstm_fwd_wide_kernel (lstm_wide.cuh), which
// takes the same two input forms and runs its recurrent products on the
// tensor cores in split TF32 (other bits than this kernel's f32 sums).

#pragma once

#include <cuda_runtime.h>

#include "bf16.cuh"
#include "lstm_wide.cuh"
#include "smem.cuh"

namespace {

// Sequence rows a thread of the resident BPTT owns (lstm_train.cu).
constexpr int kRowsPerThread = 4;
constexpr int kThreadsTarget = 256;

// Thread rows of a block at hidden width H, max(1, 256 / H), each of
// kRowsPerThread (BPTT) or kFwdRows (resident forward) sequence rows.
inline int rows_y_for(int H) {
  return kThreadsTarget / H > 0 ? kThreadsTarget / H : 1;
}

// Sequence rows a thread of the resident forward owns: each w_hh fragment
// it loads serves this many rows (see the design note above for why 4).
constexpr int kFwdRows = 4;
// Blocks of the resident forward an SM holds at once: 85 registers a
// thread at most. Its blocks are (H, rows_y_for(H)), at most 256 threads.
constexpr int kFwdMinBlocks = 3;
// The most input features the fused form takes.
constexpr int kFusedMaxF = 4;

// Row strides in shared memory, in floats. w_hh (4H, H): H rounded up to 4
// with an odd quarter (36 at H = 32); h (tile_rows, H): H rounded up to 4.
// The pad columns are never read: the products take k < H only.
__host__ __device__ inline int fwd_w_stride(int H) {
  return 4 * (((H + 3) / 4) | 1);
}
__host__ __device__ inline int fwd_h_stride(int H) { return (H + 3) / 4 * 4; }

inline size_t fwd_smem_bytes(int H) {
  const size_t tile_rows = (size_t)rows_y_for(H) * kFwdRows;
  return (4 * (size_t)H * fwd_w_stride(H) +
          2 * tile_rows * fwd_h_stride(H)) *
         sizeof(float);
}

// Resident forward. kF = 0 reads x_proj; kF = F >= 1 the fused form. S:
// the storage type of every tensor it reads and writes (bf16.cuh); h is
// rounded to S before it enters the next step's products.
template <int kMode, int kF, class S>
__global__ void __launch_bounds__(kThreadsTarget, kFwdMinBlocks)
    lstm_fwd_kernel(const S* __restrict__ xp, const S* __restrict__ x,
                    const S* __restrict__ wih, const S* __restrict__ bias,
                    const S* __restrict__ whhT, S* __restrict__ out0,
                    S* __restrict__ out1, int T, int R, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int G = 4 * H;
  const int ws = fwd_w_stride(H), hs = fwd_h_stride(H);
  const int tile_rows = blockDim.y * kFwdRows;
  float* w = smem;             // (4H, ws): w_hh, row n = gate column n
  float* hbuf = w + G * ws;    // 2 x (tile_rows, hs)

  const int j = threadIdx.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < H * G; i += nthreads) {
    const int k = i / G;
    w[(i - k * G) * ws + k] = ldf(whhT + i);
  }
  for (int i = tid; i < 2 * tile_rows * hs; i += nthreads) hbuf[i] = 0.0f;

  // the values a row's step reads: its 4 gate inputs, or its F features
  constexpr int kIn = kF == 0 ? 4 : kF;
  float wi[4][kIn], bi[4];
  if constexpr (kF > 0) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      bi[g] = ldf(bias + g * H + j);
#pragma unroll
      for (int f = 0; f < kF; ++f) wi[g][f] = ldf(wih + (g * H + j) * kF + f);
    }
  }
  const int lr0 = threadIdx.y * kFwdRows;         // first local row
  const int row0 = blockIdx.x * tile_rows + lr0;  // first global row
  float c[kFwdRows];
  // the next step's inputs as loaded, in S: a bf16 value is widened only
  // where the step uses it, so the load's latency overlaps the products
  S in_next[kFwdRows][kIn];
  auto load_in = [&](int t) {
#pragma unroll
    for (int q = 0; q < kFwdRows; ++q) {
      const int r = row0 + q;
#pragma unroll
      for (int v = 0; v < kIn; ++v) {
        if (r >= R)
          in_next[q][v] = static_cast<S>(0.0f);
        else if constexpr (kF == 0)
          in_next[q][v] = xp[((size_t)t * R + r) * G + v * H + j];
        else
          in_next[q][v] = x[((size_t)r * T + t) * kF + v];
      }
    }
  };
#pragma unroll
  for (int q = 0; q < kFwdRows; ++q) c[q] = 0.0f;
  load_in(0);
  __syncthreads();

  const float* wj = w + j * ws;  // gate g's row: wj + g H ws
  for (int t = 0; t < T; ++t) {
    float acc[kFwdRows][4];
#pragma unroll
    for (int q = 0; q < kFwdRows; ++q) {
      float in[kIn];
#pragma unroll
      for (int v = 0; v < kIn; ++v) in[v] = tof(in_next[q][v]);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if constexpr (kF == 0)
          acc[q][g] = in[g];
        else
          acc[q][g] = proj_in_s<S>(in, wi[g], bi[g], kF);
      }
    }
    if (t + 1 < T) load_in(t + 1);
    const float* hcur = hbuf + (t & 1) * tile_rows * hs + lr0 * hs;
    float* hnxt = hbuf + ((t + 1) & 1) * tile_rows * hs + lr0 * hs;
    int k = 0;
    for (; k + 4 <= H; k += 4) {
      float4 wv[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        wv[g] = *reinterpret_cast<const float4*>(wj + g * H * ws + k);
#pragma unroll
      for (int q = 0; q < kFwdRows; ++q) {
        const float4 hv = *reinterpret_cast<const float4*>(hcur + q * hs + k);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float a = acc[q][g];
          a = fmaf(hv.x, wv[g].x, a);
          a = fmaf(hv.y, wv[g].y, a);
          a = fmaf(hv.z, wv[g].z, a);
          a = fmaf(hv.w, wv[g].w, a);
          acc[q][g] = a;
        }
      }
    }
    for (; k < H; ++k) {
      float wk[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) wk[g] = wj[g * H * ws + k];
#pragma unroll
      for (int q = 0; q < kFwdRows; ++q) {
        const float hk = hcur[q * hs + k];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[q][g] = fmaf(hk, wk[g], acc[q][g]);
      }
    }
#pragma unroll
    for (int q = 0; q < kFwdRows; ++q) {
      const float ig = sigmoidf(acc[q][0]);
      const float fg = sigmoidf(acc[q][1]);
      const float gg = tanhf(acc[q][2]);
      const float og = sigmoidf(acc[q][3]);
      c[q] = cell_c(fg, c[q], ig, gg);
      const float h = __fmul_rn(og, tanhf(c[q]));
      hnxt[q * hs + j] = round_to<S>(h);
      const int r = row0 + q;
      if (r < R) {
        const size_t o = ((size_t)t * R + r) * H + j;
        if constexpr (kMode == kFwdLast) {
          if (t == T - 1) stf(out0 + (size_t)r * H + j, h);
        } else {
          stf(out0 + o, h);
          if constexpr (kMode == kFwdTrain) stf(out1 + o, c[q]);
        }
      }
    }
    __syncthreads();
  }
}

template <int kMode, int kF, class S>
cudaError_t launch_fwd_resident(const S* xp, const S* x, const S* wih,
                                const S* b, const S* whhT, S* out0, S* out1,
                                int T, int R, int H, size_t smem,
                                cudaStream_t stream) {
  auto kernel = lstm_fwd_kernel<kMode, kF, S>;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows_y = rows_y_for(H);
  const int tile_rows = rows_y * kFwdRows;
  const dim3 grid((R + tile_rows - 1) / tile_rows);
  kernel<<<grid, dim3(H, rows_y), smem, stream>>>(xp, x, wih, b, whhT, out0,
                                                  out1, T, R, H);
  return cudaGetLastError();
}

// True where the forwards at width H take the wide kernel (the resident
// kernel's shared memory does not fit a block of the current device).
inline cudaError_t fwd_on_wide(int H, bool* wide) {
  bool resident = false;
  const cudaError_t err = smem_fits(fwd_smem_bytes(H), &resident);
  *wide = !resident;
  return err;
}

// One forward entry: x_proj when xp is not null, else the fused form from
// x, w_ih, b with F features (inference modes only, 1 <= F <= kFusedMaxF).
// The resident kernel where its shared memory fits a block, else the wide
// kernel, whose inference modes, and whose training mode in bf16, take
// scratch scr (lstm_wide.cuh). S: the storage type of every tensor.
template <int kMode, class S = float>
int launch_fwd(const void* xp, const void* x, const void* wih, const void* b,
               int F, const void* whhT, void* out0, void* out1, void* scr,
               int T, int R, int H, void* stream_) {
  if (T < 1 || R < 1 || H < 1) return cudaErrorInvalidValue;
  const bool fused = xp == nullptr;
  if (fused && (kMode == kFwdTrain || x == nullptr || wih == nullptr ||
                b == nullptr || F < 1 || F > kFusedMaxF))
    return cudaErrorInvalidValue;
  const auto stream = static_cast<cudaStream_t>(stream_);
  const auto* xp_ = static_cast<const S*>(xp);
  const auto* x_ = static_cast<const S*>(x);
  const auto* w_ = static_cast<const S*>(wih);
  const auto* b_ = static_cast<const S*>(b);
  const auto* u_ = static_cast<const S*>(whhT);
  auto* o0 = static_cast<S*>(out0);
  auto* o1 = static_cast<S*>(out1);
  auto* s_ = static_cast<float*>(scr);
  const size_t smem = fwd_smem_bytes(H);
  bool wide = false;
  cudaError_t err = fwd_on_wide(H, &wide);
  if (err != cudaSuccess) return err;
  if (wide)
    return launch_fwd_wide<kMode, S>(xp_, x_, w_, b_, fused ? F : 0, u_, o0, o1,
                                  s_, T, R, H, stream);
  if constexpr (kMode != kFwdTrain) {
    switch (fused ? F : 0) {
      case 1:
        return launch_fwd_resident<kMode, 1, S>(xp_, x_, w_, b_, u_, o0, o1, T,
                                             R, H, smem, stream);
      case 2:
        return launch_fwd_resident<kMode, 2, S>(xp_, x_, w_, b_, u_, o0, o1, T,
                                             R, H, smem, stream);
      case 3:
        return launch_fwd_resident<kMode, 3, S>(xp_, x_, w_, b_, u_, o0, o1, T,
                                             R, H, smem, stream);
      case 4:
        return launch_fwd_resident<kMode, 4, S>(xp_, x_, w_, b_, u_, o0, o1, T,
                                             R, H, smem, stream);
      default:
        break;
    }
  }
  return launch_fwd_resident<kMode, 0, S>(xp_, x_, w_, b_, u_, o0, o1, T, R, H,
                                       smem, stream);
}

}  // namespace
