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
//                        dW_hh^T (H, 4H), through partials (P, H, 4H) that
//                        the same entry sums in order; 2 R H floats of
//                        scratch on the engine path (see Widths)
//   lstm_train_bwd_max_blocks   the P it takes on the current device
//   lstm_train_bwd_engine       1 where it runs the engine path
//   lstm_train_bwd_smem         a resident block's shared memory
//   lstm_train_fwd_bf16, lstm_train_bwd_bf16 (and _max_blocks_bf16,
//   _bf16_scratch_k): the same on bf16 storage (the JAX kernels in their
//   bf16 dtype): bf16 x_proj, w_hh_T, hs, cs, cotangents and dx_proj;
//   carries, gates and sums in f32, h rounded to bf16 before each
//   recurrent product, dW summed in f32 (the caller casts it). The
//   kernels below take the storage type as a template parameter (bf16
//   loads widened on their way into registers and shared memory, stores
//   rounded); the engine path widens hs and w_hh^T into f32 scratch for
//   its products (bf16.cuh).
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
// Design of the forward: the resident forward of lstm_fwd.cuh in its
// training mode (hs and cs stored; x_proj only), shared with the inference
// entries of lstm_infer.cu. One block runs the whole time loop for a tile
// of rows; thread (j, y) owns hidden unit j of kFwdRows rows, so its four
// gate columns and c stay in registers; h_{t-1} is double-buffered in
// shared memory; w_hh is staged once, its products blocked in registers.
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
// f32 registers.
//
// What bounds the BPTT at the N = 500 step's shape (R = 500,000, T = 7,
// H = 32): its three recurrent products are 3 x 2 x 6 x R x 32 x 128
// flop, 1.10 ms at 67 TFLOP/s f32 on the CUDA cores, beside 1.47 ms for
// its bytes. A first form loaded two shared-memory values per FMA in the
// dh and dW products (about 1.8e9 warp-wide loads, ~7.7 ms at one a clock
// an SM, of its 10.5 ms). Here both products are blocked in registers on
// the same CUDA cores, each sum in the same order as before (so dx_proj
// and the dW partials keep their bits): the dh product reads w_hh_T row j
// and each dgates row 4 columns at a time (16-byte loads; w's row stride a
// multiple of 4 whose quarter is odd, so a warp's rows j fall on
// different bank groups), one w load serving the thread's 4 rows: 5
// loads per 16 FMAs. The dW product gives each thread a 4 x 4 block of
// the H x 4H entries; per tile row one 16-byte load of h_{t-1} (a
// broadcast: a warp shares its block row) and one of dgates (a warp's
// 512 contiguous bytes) for 16 FMAs. The gate recompute reads h_{t-1} 4
// k at a time.
//
// Widths. The two kernels above keep w_hh^T (and the BPTT its dW_hh^T
// sum) in shared memory: the forward fits to H = 116, the BPTT to H = 81
// on the H100, the reference H = 32 among them, and there they run as they
// always did. Past that (chosen per call from H and the device's shared-
// memory limit):
//   - the forward takes lstm_fwd_wide_kernel of lstm_wide.cuh: row tiles
//     of 32-48 sequences whose recurrent products run on split-TF32
//     mma.sync, each w_hh^T slab staged in shared memory serving the
//     tile's rows; hs and cs carry h and c from step to step;
//   - the BPTT runs on the split-TF32 products of bdgcn_gemm.cuh. Of its
//     three products only dh_{t-1} = dgates_t W_hh is sequential in time:
//     the recomputed gates need only hs, complete before the backward
//     starts, and dW_hh^T is a sum over every (t, r). So one entry runs
//     four steps on its stream, 2T + 1 launches:
//       1. pre-activations h_{t-1} w_hh_T for every t >= 1 at once, one
//          product over (T-1) R rows of hs (wgmma), written straight into
//          dx_proj rows R..TR (about to be overwritten with dgates);
//       2. for t = T-1..0, lstm_cell_bwd_kernel: the cell's backward for
//          every (r, j), dgates written over dx_proj_t in place, the dc
//          carry updated in place (2 R H floats of dh and dc carries, in
//          scratch the caller allocates; zero at t = T-1 without a memset);
//       3. for t >= 1, dh_{t-1} = dgates_t W_hh into the dh carry, on
//          mma.sync's 64 x 64 tiles: at the wide training shape (R = 8,836,
//          H = 128) wgmma's 128 x 128 tiles would give 70 blocks for the
//          132 SMs, mma.sync's give 276;
//       4. dW_hh^T = sum over t >= 1 of h_{t-1}^T dgates_t, one product
//          over (T-1) R depths on the cooperative wgmma instance: P depth
//          chunks, each a partial, summed in the order p = 0..P-1 after a
//          grid-wide barrier in the same launch (dw_sum.cuh). No atomics.
//          It runs before the cell step t = 0, which needs it done: the
//          plain sum also takes h_{-1}^T dgates_0 = 0 x dgates_0, NaN in
//          each column where dgates_0 holds an Inf or NaN, and the cell
//          step writes that NaN into dW_hh^T.
//     No shared-memory limit on H. At the wide training shape (T = 7, R =
//     8,836, H = 128) the three products are 3 x 6.95 GFLOP, 0.13 ms at
//     the TF32 rate for their 3 split products; the cell steps move about
//     80 MB each.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bdgcn_gemm.cuh"
#include "bf16.cuh"
#include "dw_sum.cuh"
#include "lstm_fwd.cuh"
#include "lstm_wide.cuh"
#include "smem.cuh"

namespace {

// Shared-memory row strides of the resident BPTT, in floats. w (H, 4H):
// a multiple of 4 (16-byte loads of a row) whose quarter is odd, so the
// eight lanes of each 16-byte load phase that read row j, j + 1, ... of
// the dh product land on different bank groups. hp (tile_rows, H): H
// rounded up to 4 (16-byte loads; the pad columns stay zero).
__host__ __device__ inline int bwd_w_stride(int H) { return 4 * (H | 1); }
__host__ __device__ inline int bwd_h_stride(int H) { return (H + 3) / 4 * 4; }

// db: two h buffers (h_{t-2} staged while step t runs), where they fit;
// vec: hs rows are whole, 16-byte aligned runs of 4 (16-byte copies; f32
// only). Two blocks an SM at the reference width: at most 128 registers.
// S: the storage type of x_proj, w_hh_T, hs, cs, dhs, dcs and dx_proj
// (bf16.cuh): bf16 values are widened on their way into registers and
// shared memory (hs by plain loads, not cp.async), dx_proj is stored
// rounded; the dgates the products read, the carries and dW stay f32.
template <class S>
__global__ void __launch_bounds__(256, 2) lstm_train_bwd_kernel(
    const S* __restrict__ xp, const S* __restrict__ whhT,
    const S* __restrict__ hs, const S* __restrict__ cs,
    const S* __restrict__ dhs, const S* __restrict__ dcs,
    S* __restrict__ dxp, float* __restrict__ dw_part,
    float* __restrict__ dw_out, int T, int R, int H, int db, int vec) {
  constexpr bool kF32 = !kIsBf16<S>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int G = 4 * H;
  const int ws = bwd_w_stride(H), hps = bwd_h_stride(H);
  const int tile_rows = blockDim.y * kRowsPerThread;
  const int nbuf = db ? 2 : 1;
  float* w = smem;                  // (H, ws): w_hh_T
  float* hp = w + H * ws;           // nbuf x (tile_rows, hps): h of the tile
  float* dg = hp + nbuf * tile_rows * hps;  // (tile_rows, 4H): dgates
  float* dw = dg + tile_rows * G;    // (H, 4H): this block's dW_hh^T sum

  const int j = threadIdx.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < H * G; i += nthreads) {
    const int k = i / G;
    w[k * ws + i - k * G] = ldf(whhT + i);
    dw[i] = 0.0f;
  }
  for (int i = tid; i < nbuf * tile_rows * hps; i += nthreads) hp[i] = 0.0f;
  const int lr0 = threadIdx.y * kRowsPerThread;
  const int ntiles = (R + tile_rows - 1) / tile_rows;
  const int H4 = H / 4 * 4;
  // the dW product's 4 x 4 register blocks of the (H, 4H) entries, column
  // blocks fastest: at H = 32 warp w takes rows 4w.. and lane l columns
  // 4l.., so a warp's hp loads are one broadcast and its dg loads 512
  // contiguous bytes
  const int n_cb = H, n_blk = (H + 3) / 4 * n_cb;

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
  float* hb[2] = {hp, hp + (db ? tile_rows * hps : 0)};
  // copy h_tp of the tile's rows into dst with cp.async (zeros for tp < 0
  // and rows past R; the pad columns stay zero), one commit group
  auto stage_h = [&](float* dst, int tile0, int tp) {
    if (kF32 && vec) {
      const int cpr = H / 4;
      for (int q = tid; q < tile_rows * cpr; q += nthreads) {
        const int rl = q / cpr, k = (q - rl * cpr) * 4, r = tile0 + rl;
        const bool ok = tp >= 0 && r < R;
        cp_async16(dst + rl * hps + k,
                   reinterpret_cast<const float*>(
                       ok ? hs + ((size_t)tp * R + r) * H + k : hs),
                   ok ? 16 : 0);
      }
    } else {
      for (int q = tid; q < tile_rows * H; q += nthreads) {
        const int rl = q / H, k = q - rl * H, r = tile0 + rl;
        const bool ok = tp >= 0 && r < R;
        if constexpr (kF32)
          cp_async4(dst + rl * hps + k,
                    ok ? hs + ((size_t)tp * R + r) * H + k : hs, ok ? 4 : 0);
        else  // widened on its way in; seen after the next barrier
          dst[rl * hps + k] = ok ? ldf(hs + ((size_t)tp * R + r) * H + k)
                                 : 0.0f;
      }
    }
    cp_async_commit();
  };
  for (int it = 0; it < my_tiles; ++it) {
    const int tile = it < full ? it * P + b : full * P + k_extra;
    const int tile0 = tile * tile_rows;
    const int row0 = tile0 + lr0;
    float dh_c[kRowsPerThread], dc_c[kRowsPerThread], ct_c[kRowsPerThread];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      dh_c[q] = dc_c[q] = 0.0f;
      const int r = row0 + q;
      ct_c[q] = r < R ? ldf(cs + ((size_t)(T - 1) * R + r) * H + j) : 0.0f;
    }
    __syncthreads();  // the last tile's readers of hp and dg are done
    stage_h(hb[(T - 1) & 1], tile0, T - 2);

    for (int t = T - 1; t >= 0; --t) {
      // h_{t-1} is in hb[t & 1]. Two buffers: it was copied during step
      // t + 1, and h_{t-2} is copied now into the buffer step t + 1 read;
      // one buffer: copied here, after step t + 1's readers are done
      float* const hcur = hb[t & 1];
      if (db) {
        cp_async_wait<0>();
        __syncthreads();  // h_{t-1} landed; step t + 1's readers are done
        if (t >= 1) stage_h(hb[(t - 1) & 1], tile0, t - 2);
      } else {
        if (t < T - 1) {
          __syncthreads();  // step t + 1's readers of hp and dg are done
          stage_h(hp, tile0, t - 1);
        }
        cp_async_wait<0>();
        __syncthreads();  // h_{t-1} landed
      }

      // recompute the gates: x_proj_t + h_{t-1} @ w_hh_T, k ascending; the
      // tile's h_{t-1} rows read 4 k at a time
      float acc[kRowsPerThread][4];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int r = row0 + q;
        const S* xr = xp + ((size_t)t * R + r) * G;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          acc[q][g] = r < R ? ldf(xr + g * H + j) : 0.0f;
      }
      for (int k4 = 0; k4 < H4; k4 += 4) {
        float4 hq[kRowsPerThread];
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q)
          hq[q] = *reinterpret_cast<const float4*>(hcur + (lr0 + q) * hps + k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* wk = w + (k4 + kk) * ws + j;
          const float w0 = wk[0], w1 = wk[H], w2 = wk[2 * H], w3 = wk[3 * H];
#pragma unroll
          for (int q = 0; q < kRowsPerThread; ++q) {
            const float hk = kk == 0   ? hq[q].x
                             : kk == 1 ? hq[q].y
                             : kk == 2 ? hq[q].z
                                       : hq[q].w;
            acc[q][0] = fmaf(hk, w0, acc[q][0]);
            acc[q][1] = fmaf(hk, w1, acc[q][1]);
            acc[q][2] = fmaf(hk, w2, acc[q][2]);
            acc[q][3] = fmaf(hk, w3, acc[q][3]);
          }
        }
      }
      for (int k = H4; k < H; ++k) {
        const float* wk = w + k * ws + j;
        const float w0 = wk[0], w1 = wk[H], w2 = wk[2 * H], w3 = wk[3 * H];
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q) {
          const float hk = hcur[(lr0 + q) * hps + k];
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
        const float ct = ct_c[q];  // c_t, read as c_{t-1} one step later
        const float cp = (valid && t > 0) ? ldf(cs + o - (size_t)R * H) : 0.0f;
        ct_c[q] = cp;
        const float dh = dh_c[q] + ((valid && dhs) ? ldf(dhs + o) : 0.0f);
        const float dc = dc_c[q] + ((valid && dcs) ? ldf(dcs + o) : 0.0f);
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
          if (valid) stf(dxp + ((size_t)t * R + r) * G + g * H + j, v);
        }
      }
      __syncthreads();

      // dh_{t-1} = dgates @ W_hh (contract the 4H axis): per 4 columns one
      // 16-byte load of w_hh_T row j serves the thread's rows, each dgates
      // row a 16-byte broadcast; each sum in ascending column order
      {
        const float* wj = w + j * ws;
        float sd[kRowsPerThread];
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q) sd[q] = 0.0f;
        for (int col = 0; col < G; col += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(wj + col);
#pragma unroll
          for (int q = 0; q < kRowsPerThread; ++q) {
            const float4 d =
                *reinterpret_cast<const float4*>(dg + (lr0 + q) * G + col);
            sd[q] = fmaf(d.x, wv.x, sd[q]);
            sd[q] = fmaf(d.y, wv.y, sd[q]);
            sd[q] = fmaf(d.z, wv.z, sd[q]);
            sd[q] = fmaf(d.w, wv.w, sd[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q) dh_c[q] = sd[q];
      }
      // dW_hh^T += h_{t-1}^T @ dgates: a thread a 4 x 4 block of entries
      // (k, col), per tile row one 16-byte load of h_{t-1} and one of
      // dgates for 16 FMAs; each entry summed over the rows in ascending
      // order from 0, then added into the block's sum
      for (int blk = tid; blk < n_blk; blk += nthreads) {
        const int kb = blk / n_cb, cb = blk - kb * n_cb;
        const float* hq = hcur + 4 * kb;
        const float* dq = dg + 4 * cb;
        float sw[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) sw[a][c] = 0.0f;
        for (int rr = 0; rr < tile_rows; ++rr) {
          const float4 h4 = *reinterpret_cast<const float4*>(hq + rr * hps);
          const float4 d4 = *reinterpret_cast<const float4*>(dq + rr * G);
          const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
          const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              sw[a][c] = fmaf(hv[a], dv[c], sw[a][c]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          if (4 * kb + a >= H) break;
          float4* d = reinterpret_cast<float4*>(dw + (4 * kb + a) * G +
                                                4 * cb);
          float4 v = *d;
          v.x += sw[a][0];
          v.y += sw[a][1];
          v.z += sw[a][2];
          v.w += sw[a][3];
          *d = v;
        }
      }
    }
  }
  float* part = dw_part + (size_t)blockIdx.x * H * G;
  for (int i = tid; i < H * G; i += nthreads) part[i] = dw[i];
  // every block's partial is written; each sums its share of the entries
  cooperative_groups::this_grid().sync();
  sum_partials(dw_part, dw_out, gridDim.x, H * G, blockIdx.x, gridDim.x,
               tid, nthreads, smem,
               H * ws + tile_rows * (nbuf * hps + G) + H * G);
}

// The cell's backward (_cell_bwd) of step t for every (r, j) of the rows:
// the gates are x_proj_t plus the recurrent pre-activations that the gate
// product wrote into dx_proj_t (pre; none at t = 0, where h_{-1} = 0), and
// dgates are written over dx_proj_t in place: one thread reads all four
// gate columns of its (r, j) before it writes them. dh and dc are the
// carries from step t + 1 (not read at t = T - 1, first: zero there); dc
// is updated in place. cp is c_{t-1} (null at t = 0), dhs_t, dcs_t may be
// null (zero). dw_nan (t = 0 only, else null): dW_hh^T, its sum over
// t >= 1 written; the plain sum adds h_{-1}^T dgates_0 = 0 x dgates_0,
// NaN in each column where dgates_0 holds an Inf or NaN, written here.
// S: the storage type of x_proj, c and the cotangents; in bf16, dxp is an
// f32 scratch of the products and dgates are also stored rounded in dxo.
template <class S>
__global__ void lstm_cell_bwd_kernel(
    const S* __restrict__ xp, float* __restrict__ dxp, int pre,
    const S* __restrict__ ct, const S* __restrict__ cp,
    const S* __restrict__ dhs, const S* __restrict__ dcs,
    const float* __restrict__ dh, float* __restrict__ dc,
    float* __restrict__ dw_nan, int first, int R, int H,
    S* __restrict__ dxo) {
  const long long n = (long long)R * H;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long r = i / H;
    const long long o = r * 4 * H + (i - r * H);
    float a[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      a[g] = pre ? ldf(xp + o + g * H) + dxp[o + g * H] : ldf(xp + o + g * H);
    const float ig = sigmoidf(a[0]);
    const float fg = sigmoidf(a[1]);
    const float gg = tanhf(a[2]);
    const float og = sigmoidf(a[3]);
    const float c_t = ldf(ct + i);
    const float c_p = cp ? ldf(cp + i) : 0.0f;
    const float dhv = (first ? 0.0f : dh[i]) + (dhs ? ldf(dhs + i) : 0.0f);
    const float dcv = (first ? 0.0f : dc[i]) + (dcs ? ldf(dcs + i) : 0.0f);
    const float tc = tanhf(c_t);
    const float d_o = dhv * tc;
    const float dct = dcv + dhv * og * (1.0f - tc * tc);
    dc[i] = dct * fg;
    float dg[4];
    dg[0] = dct * gg * ig * (1.0f - ig);
    dg[1] = dct * c_p * fg * (1.0f - fg);
    dg[2] = dct * ig * (1.0f - gg * gg);
    dg[3] = d_o * og * (1.0f - og);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      dxp[o + g * H] = dg[g];
      if constexpr (kIsBf16<S>) stf(dxo + o + g * H, dg[g]);
      if (dw_nan != nullptr && !isfinite(dg[g])) {
        const int col = g * H + (int)(i - r * H);
        for (int k = 0; k < H; ++k)
          dw_nan[(size_t)k * 4 * H + col] = __uint_as_float(0x7fffffffu);
      }
    }
  }
}

}  // namespace

extern "C" int lstm_train_fwd_f32(const void* xp, const void* whhT, void* hs,
                                  void* cs, int T, int R, int H,
                                  void* stream) {
  return launch_fwd<kFwdTrain>(xp, nullptr, nullptr, nullptr, 0, whhT, hs,
                               cs, nullptr, T, R, H, stream);
}

// The training forward on bf16 storage (x_proj, w_hh_T, hs and cs in
// bf16): c carried in f32 and stored rounded, h rounded before each
// recurrent product. The wide kernel (lstm_fwd_wide) carries c in scratch
// (R, H) f32; the resident kernel takes none (null).
extern "C" int lstm_train_fwd_bf16(const void* xp, const void* whhT, void* hs,
                                   void* cs, void* scratch, int T, int R,
                                   int H, void* stream) {
  return launch_fwd<kFwdTrain, bf16>(xp, nullptr, nullptr, nullptr, 0, whhT,
                                     hs, cs, scratch, T, R, H, stream);
}

namespace {

size_t bwd_smem_bytes(int H, int nbuf) {
  const size_t tile_rows = (size_t)rows_y_for(H) * kRowsPerThread;
  const size_t h = H, g = 4 * h;
  return (h * bwd_w_stride(H) + nbuf * tile_rows * bwd_h_stride(H) +
          tile_rows * g + h * g) *
         sizeof(float);
}

// True where the resident BPTT's shared memory (one h buffer) does not fit
// a block: the products run on the engine of bdgcn_gemm.cuh.
cudaError_t bwd_on_engine(int H, bool* engine) {
  bool resident = false;
  cudaError_t err = smem_fits(bwd_smem_bytes(H, 1), &resident);
  *engine = !resident;
  return err;
}

// Whether the resident BPTT at H takes two h buffers (they fit: every
// H <= 81 but the widest few) and its shared memory then; lets the kernel
// of storage type S launch with it.
template <class S>
cudaError_t resident_bwd_plan(int H, bool* db, size_t* smem) {
  cudaError_t err = smem_fits(bwd_smem_bytes(H, 2), db);
  if (err != cudaSuccess) return err;
  *smem = bwd_smem_bytes(H, *db ? 2 : 1);
  return allow_smem((const void*)lstm_train_bwd_kernel<S>, *smem);
}

constexpr int kCellThreads = 256;

// The bf16 engine path's f32 scratch, in floats, after the dh and dc
// carries (2 R H): dgates (T, R, 4H), the widened hs (T, R, H) and w_hh_T
// (H, 4H), each from a multiple of 64 floats. lstm_train_bwd_bf16 takes
// bwd_bf16_scratch floats of scratch there.
inline long long pad64(long long n) { return (n + 63) / 64 * 64; }
inline long long bwd_bf16_off_dx(int R, int H) {
  return pad64(2LL * R * H);
}
inline long long bwd_bf16_off_hs(int T, int R, int H) {
  return bwd_bf16_off_dx(R, H) + pad64(4LL * T * R * H);
}
inline long long bwd_bf16_off_w(int T, int R, int H) {
  return bwd_bf16_off_hs(T, R, H) + pad64((long long)T * R * H);
}
inline long long bwd_bf16_scratch(int T, int R, int H) {
  return bwd_bf16_off_w(T, R, H) + 4LL * H * H;
}

// The engine path of lstm_train_bwd_f32 (the four steps in the header),
// every launch on stream s. S = bf16 (lstm_train_bwd_bf16): hs and w_hh_T
// are widened into f32 scratch first (2 launches) and the products run on
// those and on an f32 dgates scratch; each cell step also stores its
// dgates rounded into dx_proj.
template <class S>
cudaError_t bwd_engine(const S* xp, const S* whhT, const S* hs, const S* cs,
                       const S* dhs, const S* dcs, S* dxp, float* dw_part,
                       float* dw, float* scratch, int T, int R, int H, int P,
                       cudaStream_t s) {
  const int G = 4 * H;
  const long long RG = (long long)R * G, RH = (long long)R * H;
  float* dh = scratch;
  float* dc = scratch + RH;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // the products' f32 operands: dgates (and the pre-activations before
  // them), hs and w_hh_T
  float* dx;
  const float *hs_f, *w_f;
  if constexpr (kIsBf16<S>) {
    dx = scratch + bwd_bf16_off_dx(R, H);
    float* h = scratch + bwd_bf16_off_hs(T, R, H);
    float* w = scratch + bwd_bf16_off_w(T, R, H);
    err = widen_bf16(hs, h, (long long)T * RH, s);
    if (err == cudaSuccess) err = widen_bf16(whhT, w, 4LL * H * H, s);
    if (err != cudaSuccess) return err;
    hs_f = h;
    w_f = w;
  } else {
    dx = dxp;
    hs_f = hs;
    w_f = whhT;
  }

  // 1. pre[t, r, g] = sum_k hs[t-1, r, k] w_hh_T[k, g] for t >= 1, into
  //    dx_proj rows R..TR
  if (T > 1) {
    Gemm p{};
    p.a = hs_f;
    p.b = w_f;
    p.c = dx + RG;
    p.ai = flat(H);  // (t-1, r)
    p.ak = flat(1);  // k
    p.bk = flat(G);  // k
    p.bn = flat(1);  // g
    p.ci = flat(G);  // (t, r)
    p.cn = flat(1);  // g
    p.za = p.zb = p.zc = flat(0);
    p.m = (long long)(T - 1) * R;
    p.batches = 1;
    p.n = G;
    p.k = H;
    err = launch_wgmma<false, false>(p, s);
    if (err != cudaSuccess) return err;
  }

  // 4. dW_hh^T[k, g] = sum over (t >= 1, r) of hs[t-1, r, k] dgates[t, r, g],
  //    P depth chunks, then their ordered sum, in one cooperative launch
  //    (between the cell steps t = 1 and t = 0, which it does not need);
  //    with one step, no depth: the partials and dW are zeros
  Gemm w{};
  w.a = hs_f;
  w.b = dx + RG;
  w.c = dw_part;
  w.ai = flat(1);  // k
  w.ak = flat(H);  // (t-1, r)
  w.bk = flat(G);  // (t, r)
  w.bn = flat(1);  // g
  w.ci = flat(G);  // k
  w.cn = flat(1);  // g
  w.za = w.zb = flat(0);
  w.zc = flat((long long)H * G);  // p
  w.m = H;
  w.batches = P;
  w.n = G;
  w.k = (T - 1) * R;
  // chunks of whole 16-byte runs of depths
  w.k_chunk = (int)(((long long)w.k + P - 1) / P + 3) / 4 * 4;
  if (T == 1) {
    err = cudaMemsetAsync(dw_part, 0, sizeof(float) * P * H * G, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dw, 0, sizeof(float) * H * G, s);
    if (err != cudaSuccess) return err;
  }

  // 2, 3. the reverse loop: the cell's backward, then dh_{t-1} = dgates_t
  //       W_hh (contracting the 4H axis: w_hh_T read as (k = g, n = j))
  Gemm d{};
  d.b = w_f;
  d.c = dh;
  d.ai = flat(G);  // r
  d.ak = flat(1);  // g
  d.bk = flat(1);  // g
  d.bn = flat(G);  // j
  d.ci = flat(H);  // r
  d.cn = flat(1);  // j
  d.za = d.zb = d.zc = flat(0);
  d.m = R;
  d.batches = 1;
  d.n = H;
  d.k = G;
  const long long cells = (RH + kCellThreads - 1) / kCellThreads;
  const int cell_blocks = (int)(cells < 32LL * sms ? cells : 32LL * sms);
  for (int t = T - 1; t >= 0; --t) {
    if (t == 0 && T > 1) {
      err = launch_wgmma_coop(w, dw, H * G, s);
      if (err != cudaSuccess) return err;
    }
    float* dx_t = dx + t * RG;
    lstm_cell_bwd_kernel<S><<<cell_blocks, kCellThreads, 0, s>>>(
        xp + t * RG, dx_t, t > 0, cs + t * RH,
        t > 0 ? cs + (t - 1) * RH : nullptr, dhs ? dhs + t * RH : nullptr,
        dcs ? dcs + t * RH : nullptr, dh, dc, t == 0 ? dw : nullptr,
        t == T - 1, R, H, kIsBf16<S> ? dxp + t * RG : nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess || t == 0) break;
    d.a = dx_t;
    err = launch_gemm<false, true>(d, s);
    if (err != cudaSuccess) return err;
  }
  return err;
}

// The BPTT of storage type S: the engine path where the resident kernel's
// shared memory does not fit (scratch: 2 R H floats in f32,
// bwd_bf16_scratch in bf16), else one cooperative launch of the resident
// kernel (scratch unused).
template <class S>
int train_bwd(const void* xp, const void* whhT, const void* hs,
              const void* cs, const void* dhs, const void* dcs, void* dxp,
              void* dw_part, void* dw, void* scratch, int T, int R, int H,
              int P, void* stream) {
  if (T < 1 || R < 1 || H < 1 || P < 1 ||
      (long long)T * R > 0x7fffffffLL || 16LL * H * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool engine = false;
  cudaError_t err = bwd_on_engine(H, &engine);
  if (err != cudaSuccess) return err;
  if (engine) {
    if (scratch == nullptr || P > 65535) return cudaErrorInvalidValue;
    return bwd_engine<S>(
        static_cast<const S*>(xp), static_cast<const S*>(whhT),
        static_cast<const S*>(hs), static_cast<const S*>(cs),
        static_cast<const S*>(dhs), static_cast<const S*>(dcs),
        static_cast<S*>(dxp), static_cast<float*>(dw_part),
        static_cast<float*>(dw), static_cast<float*>(scratch), T, R, H, P,
        s);
  }
  bool two = false;
  size_t smem = 0;
  err = resident_bwd_plan<S>(H, &two, &smem);
  if (err != cudaSuccess) return err;
  int db = two ? 1 : 0;
  int vec = !kIsBf16<S> && H % 4 == 0 &&
            reinterpret_cast<uintptr_t>(hs) % 16 == 0;
  void* args[] = {&xp, &whhT, &hs, &cs, &dhs, &dcs, &dxp, &dw_part, &dw,
                  &T, &R, &H, &db, &vec};
  err = cudaLaunchCooperativeKernel(
      (const void*)lstm_train_bwd_kernel<S>, dim3(P),
      dim3(H, rows_y_for(H)), args, smem, s);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error behind
    return err;
  }
  return cudaGetLastError();
}

// lstm_train_bwd_max_blocks for the kernel of storage type S.
template <class S>
int bwd_max_blocks(int H, int* out) {
  if (H < 1) return cudaErrorInvalidValue;
  bool engine = false;
  cudaError_t err = bwd_on_engine(H, &engine);
  if (err != cudaSuccess) return err;
  if (engine) return coop_chunks(H, 4LL * H, out);
  bool db = false;
  size_t smem = 0;
  err = resident_bwd_plan<S>(H, &db, &smem);
  if (err != cudaSuccess) return err;
  return max_coresident((const void*)lstm_train_bwd_kernel<S>,
                        H * rows_y_for(H), smem, out);
}

}  // namespace

// 1 where lstm_train_bwd_f32 runs the engine path at hidden width H (and
// takes 2 R H floats of scratch), 0 where it runs the resident kernel.
extern "C" int lstm_train_bwd_engine(int H, int* out) {
  if (H < 1) return cudaErrorInvalidValue;
  bool engine = false;
  cudaError_t err = bwd_on_engine(H, &engine);
  *out = engine ? 1 : 0;
  return err;
}

// The dynamic shared memory of a resident BPTT block at hidden width H.
extern "C" int lstm_train_bwd_smem(int H, int* out) {
  if (H < 1) return cudaErrorInvalidValue;
  bool db = false;
  size_t smem = 0;
  cudaError_t err = resident_bwd_plan<float>(H, &db, &smem);
  *out = (int)smem;
  return err;
}

// The P that lstm_train_bwd_f32 takes at hidden width H: on the resident
// path the most BPTT blocks the current device holds at once (the launch
// is cooperative); on the engine path the depth chunks of the dW product
// that fill its cooperative grid about twice (coop_chunks), any P running.
extern "C" int lstm_train_bwd_max_blocks(int H, int* out) {
  return bwd_max_blocks<float>(H, out);
}

// The same bound for lstm_train_bwd_bf16 (its resident kernel is another
// instantiation, with registers of its own).
extern "C" int lstm_train_bwd_max_blocks_bf16(int H, int* out) {
  return bwd_max_blocks<bf16>(H, out);
}

// dx_proj (T, R, 4H) and dW_hh^T (H, 4H) through P partials dw_part
// (P, H, 4H) that the same launch sums in order. The resident path: one
// cooperative launch of P blocks striding over the row tiles, refused (and
// nothing runs) when they cannot all be resident at once; scratch unused.
// The engine path: 2T + 1 launches on the stream, scratch 2 R H floats,
// the last launch cooperative and refused like the resident one.
extern "C" int lstm_train_bwd_f32(const void* xp, const void* whhT,
                                  const void* hs, const void* cs,
                                  const void* dhs, const void* dcs, void* dxp,
                                  void* dw_part, void* dw, void* scratch,
                                  int T, int R, int H, int P, void* stream) {
  return train_bwd<float>(xp, whhT, hs, cs, dhs, dcs, dxp, dw_part, dw,
                          scratch, T, R, H, P, stream);
}

// The BPTT on bf16 storage (x_proj, w_hh_T, hs, cs, dhs, dcs and dx_proj
// in bf16; dW_hh^T and its partials f32, summed in f32 as the JAX kernel
// sums them): the gates recomputed from the stored bf16 hs as _cell_bwd
// does, dh and dc carried in f32, dx_proj rounded. The engine path takes
// lstm_train_bwd_bf16_scratch floats of scratch and 2T + 3 launches.
extern "C" int lstm_train_bwd_bf16(const void* xp, const void* whhT,
                                   const void* hs, const void* cs,
                                   const void* dhs, const void* dcs,
                                   void* dxp, void* dw_part, void* dw,
                                   void* scratch, int T, int R, int H, int P,
                                   void* stream) {
  return train_bwd<bf16>(xp, whhT, hs, cs, dhs, dcs, dxp, dw_part, dw,
                         scratch, T, R, H, P, stream);
}

// The floats of scratch lstm_train_bwd_bf16 takes on the engine path, in
// units of 1024 floats (rounded up), so that it fits an int.
extern "C" int lstm_train_bwd_bf16_scratch_k(int T, int R, int H, int* out) {
  if (T < 1 || R < 1 || H < 1) return cudaErrorInvalidValue;
  *out = (int)((bwd_bf16_scratch(T, R, H) + 1023) / 1024);
  return cudaSuccess;
}
