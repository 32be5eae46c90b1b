// The LSTM forward for hidden widths whose w_hh^T does not fit a block's
// shared memory beside the resident kernel's h buffers (H > 116 on the
// H100), shared by lstm_infer.cu (h_T only, or every h_t) and
// lstm_train.cu (hs and cs): lstm_fwd_wide_kernel below.
//
// What bounds it on the H100: at the wide model's serve shape (T = 7, R =
// 17,672 sequences, H = 128) the recurrent products of the 6 steps that
// have one (h_{-1} = 0) are 2 (T-1) R H 4H = 13.9 GFLOP: 0.208 ms at 67
// TFLOP/s on the CUDA cores, 0.084 ms at the TF32 rate for 3 split
// products; x_proj is 254 MB (0.076 ms at 3.35 TB/s), the fused form reads
// only x. w_hh^T (16 H^2 = 256 KB) is read at every step: read once per 8
// rows it is ~4 GB from L2 a call at the serve shape, which bounded a
// CUDA-core kernel built that way (lstm_fwd_probe.py), so here many rows
// share each staged slab of it.
//
// Design. A block of 8 warps owns a tile of M = 16 kMI sequence rows (48,
// or 32 at small R: launch_wide_f) and runs the whole time loop for it;
// each w_hh^T slab it stages serves the M rows: 0.66 GB from L2 a call at
// the serve shape. At each step the product h_{t-1} w_hh^T (M x 4H,
// depth H) runs on the tensor cores, mma.sync m16n8k8 on split TF32
// operands, in passes of 256 gate columns (64 hidden units, a chunk): warp
// w takes units 8w..8w+7 of the chunk, all M rows. B's columns are staged
// gate-major within each 8-unit group (the i gates of the 8 units, then f,
// g, o), so the accumulator fragments at one lane position of the warp's
// four n8 tiles are the i, f, g and o of the same (row, unit): the cell
// update runs in registers, without a shuffle or a shared-memory round
// trip. The permutation lives in the staging offsets alone.
//   B: w_hh^T through a cp.async ring of kWideStages slabs of 16 depths by
//   the chunk's 256 columns, each split into TF32 (hi, lo) by the warp
//   that reads it (no two warps read the same column).
//   A: h_{t-1} of the tile, read back from device memory (L2) where the
//   block wrote it at step t-1 (a barrier between: the block reads only
//   its own rows), split once into (hi, lo) pairs in a shared-memory window
//   of 128 depths laid out so that one 16-byte load gives a lane its two
//   fragment values of a row; every warp and chunk reads it. Past H = 128
//   the window moves along the depth and is read again for each chunk.
// Shared memory (the ring and the window, 103 KB at M = 48) does not grow
// with H: every H >= 1 runs, two blocks an SM. h_t goes to out0 (hs or
// every h_t; for h_T only, to out0 and the scratch in turns, so that the
// last step lands in out0) and c_t to cs (training) or the scratch. Both
// are carried in device memory at every H: a tile of c (24 KB) or a second
// h window beside the ring would leave one block an SM, and c in registers
// (4 kMI values a chunk, for a count of chunks fixed at compile time) would
// need a second kernel for the H where it fits; lstm_fwd_probe.py measures
// what the round trips cost (wide-noc, wide-nowin).
// Measured on the H100 (lstm_fwd_probe.py): the products take about half
// of the serve-shape time, the gate inputs' loads, the gate math, the
// window and the stores the rest; the kernel is bound by latency (16
// warps an SM, 128 registers), not by its operations or bytes.
//
// Precision, as the split-TF32 engine of bdgcn_gemm.cuh: each f32 operand
// is split into a TF32 high part and a remainder rounded to TF32
// (split_tf32_rn); each 8 depths' products are summed on the tensor cores
// from 0, the cross terms first, then added in f32, rounded to nearest,
// into sums that start from the gate input: x_proj, or the fused
// projection (proj_in). So the fused and x_proj forms give the same bits.
// The cell update is written as lstm_fwd.cuh writes it (cell_c), with expf
// and tanhf. At t = 0 (h_{-1} = 0) the gates are the inputs.
//
// Inf and NaN: the window folds every h value it splits into x * 0
// (fold_non_finite), and each block folds all of w_hh^T once; a warp
// whose tile held an Inf or NaN in h_{t-1}, or a block whose w_hh^T held
// one, sums each gate again in plain f32 (plain_gate_sum; at t = 0 that
// is the 0 x Inf = NaN of the plain sum). Tiles without one keep their
// bits. x_proj, x, w_ih and b are not split: they enter the gate in f32
// and reach later steps through h.

#pragma once

#include <cuda_runtime.h>

#include "bf16.cuh"
#include "smem.cuh"
#include "tf32_mma.cuh"

namespace {

enum LstmFwdMode { kFwdLast = 0, kFwdCollect = 1, kFwdTrain = 2 };

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// c_t = f * c_{t-1} + i * g as the first resident forward's compiled code
// rounds it (its SASS: FMUL of f and c_{t-1}, then FFMA of i and g onto
// it): f * c_{t-1} rounded, then one FMA with i * g.
__device__ __forceinline__ float cell_c(float fg, float c, float ig,
                                        float gg) {
  return __fmaf_rn(ig, gg, __fmul_rn(fg, c));
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

// proj_in at storage type S, on x and w read from S: for bf16 the
// product sum is rounded to bf16 and so is the sum with b, as a bf16
// projection stores x_proj (a K = F product, then a bias add, each
// rounded to bf16).
template <class S>
__device__ __forceinline__ float proj_in_s(const float* x, const float* w,
                                           float b, int F) {
  if constexpr (kIsBf16<S>) {
    float p = __fmul_rn(x[0], w[0]);
    for (int f = 1; f < F; ++f) p = __fmaf_rn(x[f], w[f], p);
    return round_to<S>(__fadd_rn(round_to<S>(p), b));
  } else {
    return proj_in(x, w, b, F);
  }
}

// proj_in_s on x and w in device memory (stride 1).
template <class S>
__device__ __forceinline__ float proj_in_g(const S* x, const S* w, float b,
                                           int F) {
  if constexpr (kIsBf16<S>) {
    float xv[4], wv[4];
    for (int f = 0; f < F; ++f) {
      xv[f] = ldf(x + f);
      wv[f] = ldf(w + f);
    }
    return proj_in_s<S>(xv, wv, b, F);
  } else {
    return proj_in(x, w, b, F);
  }
}

// --- the wide forward --------------------------------------------------------

constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideUnits = 8 * kWideWarps;  // hidden units of a chunk
constexpr int kWideCols = 4 * kWideUnits;   // its gate columns
constexpr int kWideSlab = 16;               // depths of a staged B slab
constexpr int kWideStages = 3;              // B slabs in flight
constexpr int kWideBS = kWideCols + 8;      // B stage (k, n) row stride
constexpr int kWideKW = 128;  // depths of h a window holds
// the window's row stride (floats): (hi, lo) pairs, 16 more floats so that
// the 8 lanes of a 16-byte load phase (two rows) fall on different banks
constexpr int kWideHS = 2 * kWideKW + 16;
constexpr size_t kWideRing =
    sizeof(float) * kWideStages * kWideSlab * kWideBS;

// shared memory of a block of M rows: the ring and the h window
constexpr size_t wide_smem_bytes(int M) {
  return kWideRing + sizeof(float) * M * kWideHS;
}

// The f32 sum over k < H of h[k] w_hh^T[k][col] in k order, from 0 (h
// null: h_{-1} = 0): what a gate of a warp whose operands held an Inf or
// NaN takes instead of its split-TF32 sum. Rare.
template <class S>
__device__ __noinline__ float plain_gate_sum(const S* h, const S* wcol, int H,
                                             int G) {
  float s = 0.0f;
  for (int k = 0; k < H; ++k)
    s = fmaf(h == nullptr ? 0.0f : ldf(h + k), ldf(wcol + (size_t)k * G), s);
  return s;
}

// kFwdLast writes h_T to out0 (R, H) and uses scr (2, R, H): c, then the
// h buffer of the steps whose h does not land in out0; kFwdCollect every
// h_t to out0 (T, R, H), c in scr (R, H); kFwdTrain every h_t to out0 and
// every c_t to out1 (T, R, H), no scratch. kF = 0 reads x_proj; kF >= 1
// the fused form, x (R, T, kF), w_ih (4H, kF) and b (4H). vec: 16-byte
// copies and loads (H % 4 == 0, every base 16-byte aligned; f32 only).
// S: the storage type of every tensor but scr (bf16.cuh). In bf16, h_t is
// stored rounded (and read back so), w_hh^T is widened as it is staged
// (plain loads, not cp.async), and c is carried in f32: in scr, also in
// training, which then takes scr (R, H) and stores c_t rounded in out1;
// for h_T only, scr's second half holds the h buffer as bf16.
template <int kMode, int kF, int kMI, class S>
__global__ void __launch_bounds__(kWideThreads, 2)
    lstm_fwd_wide_kernel(const S* __restrict__ xp, const S* __restrict__ whhT,
                         S* out0, S* __restrict__ out1, float* scr, int T,
                         int R, int H, const S* __restrict__ x,
                         const S* __restrict__ wih, const S* __restrict__ b,
                         int vec) {
  constexpr int M = 16 * kMI;  // kMI m16 row tiles a warp
  extern __shared__ __align__(16) float wide_smem[];
  float* ring = wide_smem;  // kWideStages x (kWideSlab, kWideBS)
  float* hsp = ring + kWideStages * kWideSlab * kWideBS;  // (M, kWideHS)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int G = 4 * H;
  const int row0 = blockIdx.x * M;
  const int n_chunks = (H + kWideUnits - 1) / kWideUnits;
  const int n_ks = (H + kWideSlab - 1) / kWideSlab;
  const int n_slabs = n_chunks * n_ks;
  constexpr int ks_win = kWideKW / kWideSlab;  // slabs a window spans
  const bool one_window = n_ks <= ks_win;
  const size_t RH = (size_t)R * H;
  constexpr bool kF32 = !kIsBf16<S>;  // the 16-byte and 8-byte paths

  // where h_t lands (h_{t-1} is read back from there at step t)
  auto h_at = [&](int t) -> S* {
    if (kMode == kFwdLast)
      return ((T - 1 - t) & 1) ? reinterpret_cast<S*>(scr + RH) : out0;
    return out0 + t * RH;
  };

  // stage slab s of a step: rows k0.. of w_hh^T at the chunk's columns,
  // gate-major per warp (staged column n: warp n / 32, gate (n / 8) % 4,
  // unit n % 8); entries past H are zero-filled
  auto issue = [&](int s) {
    float* bs = ring + (s % kWideStages) * kWideSlab * kWideBS;
    const int c = s / n_ks, k0 = (s - c * n_ks) * kWideSlab;
    const int u0 = c * kWideUnits;
    if (kF32 && vec) {  // 64 runs of 4 columns a row
      const int q = tid & 63;
      const int g = (q >> 1) & 3, u = u0 + (q >> 3) * 8 + (q & 1) * 4;
#pragma unroll
      for (int j = 0; j < kWideSlab * 64 / kWideThreads; ++j) {
        const int kk = (tid >> 6) + (kWideThreads / 64) * j, k = k0 + kk;
        const bool ok = k < H && u < H;
        cp_async16(bs + kk * kWideBS + 4 * q,
                   reinterpret_cast<const float*>(
                       ok ? whhT + (size_t)k * G + g * H + u : whhT),
                   ok ? 16 : 0);
      }
    } else {  // a column a thread
      const int g = (tid >> 3) & 3, u = u0 + (tid >> 5) * 8 + (tid & 7);
#pragma unroll 4
      for (int kk = 0; kk < kWideSlab; ++kk) {
        const int k = k0 + kk;
        const bool ok = k < H && u < H;
        if constexpr (kF32)
          cp_async4(bs + kk * kWideBS + tid,
                    reinterpret_cast<const float*>(
                        ok ? whhT + (size_t)k * G + g * H + u : whhT),
                    ok ? 4 : 0);
        else  // widened on its way in; seen after the next barrier
          bs[kk * kWideBS + tid] =
              ok ? ldf(whhT + (size_t)k * G + g * H + u) : 0.0f;
      }
    }
  };

  // the window: h_{t-1} of the tile's rows at depths kw0.. kw0 + kWideKW,
  // split into TF32 (hi, lo) pairs, depth k of row r at r kWideHS +
  // (k & ~7) 2 + (k & 3) 4 + ((k >> 2) & 1) 2, so that one 16-byte load
  // gives a lane its A fragment values (k, k + 4) of a row. Zeros past R
  // and H. Returns NaN once a value was Inf or NaN.
  auto load_window = [&](const S* hp, int kw0) {
    // every load first, then the splits: one trip to L2
    constexpr int kRuns = M * (kWideKW / 4) / kWideThreads;
    float v[kRuns][4];
#pragma unroll
    for (int j = 0; j < kRuns; ++j) {
      const int i = tid + j * kWideThreads;
      const int r = i / (kWideKW / 4), kq = (i % (kWideKW / 4)) * 4;
      const int k = kw0 + kq;
      const S* src = hp + (size_t)(row0 + r) * H + k;
      if (kF32 && row0 + r < R && vec && k < H) {
        const float4 f = *reinterpret_cast<const float4*>(src);
        v[j][0] = f.x, v[j][1] = f.y, v[j][2] = f.z, v[j][3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[j][e] = row0 + r < R && k + e < H ? ldf(src + e) : 0.0f;
      }
    }
    float nf = 0.0f;
#pragma unroll
    for (int j = 0; j < kRuns; ++j) {
      const int i = tid + j * kWideThreads;
      const int r = i / (kWideKW / 4), kq = (i % (kWideKW / 4)) * 4;
      float* dst = hsp + r * kWideHS + (kq & ~7) * 2 + ((kq >> 2) & 1) * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        unsigned hi, lo;
        nf = fold_non_finite(v[j][e], nf);
        split_tf32_rn(v[j][e], hi, lo);
        *reinterpret_cast<float2*>(dst + 4 * e) =
            make_float2(__uint_as_float(hi), __uint_as_float(lo));
      }
    }
    return nf;
  };

  // a gate input: x_proj, or x . w_ih + b in the fused form
  auto gate_in = [&](int t, int r, int g, int u) -> float {
    if constexpr (kF > 0)
      return proj_in_g<S>(x + ((size_t)r * T + t) * kF,
                          wih + (size_t)(g * H + u) * kF, ldf(b + g * H + u),
                          kF);
    else
      return ldf(xp + ((size_t)t * R + r) * G + g * H + u);
  };

  // w_bad: w_hh^T holds an Inf or NaN. Then every gate of the block is
  // summed in plain f32, which also makes NaN of 0 x Inf at t = 0.
  bool w_bad;
  {
    float nf = 0.0f;
    const long long n = (long long)H * G;
    if (kF32 && vec) {
      const float4* w4 = reinterpret_cast<const float4*>(whhT);
#pragma unroll 8
      for (long long i = tid; i < n / 4; i += kWideThreads) {
        const float4 f = w4[i];
        nf = fold_non_finite(f.x, nf);
        nf = fold_non_finite(f.y, nf);
        nf = fold_non_finite(f.z, nf);
        nf = fold_non_finite(f.w, nf);
      }
    } else {
#pragma unroll 8
      for (long long i = tid; i < n; i += kWideThreads)
        nf = fold_non_finite(ldf(whhT + i), nf);
    }
    w_bad = __syncthreads_or(isnan(nf)) != 0;
  }

  // x_proj's gate inputs of units u, u + 1 in one 8-byte load
  const bool pairs = kF32 && H % 2 == 0 &&
                     (reinterpret_cast<unsigned long long>(xp) & 7) == 0;
  float acc[kMI][4][4];
  for (int t = 0; t < T; ++t) {
    // step t-1's h and c stores are done, every warp is past the ring's
    // and the window's last reads
    __syncthreads();
    const S* hp = t > 0 ? h_at(t - 1) : nullptr;
    // h_{-1} = 0: no product at t = 0
    const int n_prod = t > 0 ? n_slabs : 0;
    for (int s = 0; s < kWideStages - 1; ++s) {
      if (s < n_prod) issue(s);
      cp_async_commit();
    }
    bool a_bad = false;  // the tile's h_{t-1} held an Inf or NaN
    for (int c = 0; c < n_chunks; ++c) {
      // the warp's units u, u + 1 (lane tq) for rows gq, gq + 8 of each
      // m16 tile; each gate's sum starts from its input
      const int u_w = c * kWideUnits + warp * 8 + 2 * tq;
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int v = 0; v < 4; v += 2) {
          const int r = row0 + i * 16 + gq + (v >> 1) * 8;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            if (kF == 0 && pairs && r < R && u_w < H) {
              const float2 in = *reinterpret_cast<const float2*>(
                  xp + ((size_t)t * R + r) * G + g * H + u_w);
              acc[i][g][v] = in.x;
              acc[i][g][v + 1] = in.y;
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e)
                acc[i][g][v + e] =
                    r < R && u_w + e < H ? gate_in(t, r, g, u_w + e) : 0.0f;
            }
          }
        }
      for (int ks = 0; ks < (t > 0 ? n_ks : 0); ++ks) {
        const int s = c * n_ks + ks, k0 = ks * kWideSlab;
        cp_async_wait<kWideStages - 2>();
        __syncthreads();  // slab s has landed; slab s - 1's readers are done
        if (s + kWideStages - 1 < n_slabs) issue(s + kWideStages - 1);
        cp_async_commit();
        const int kw0 = ks / ks_win * kWideKW;
        if (ks % ks_win == 0 && (c == 0 || !one_window)) {
          if (ks == 0) a_bad = false;
          a_bad |= __syncthreads_or(isnan(load_window(hp, kw0))) != 0;
        }
        const float* bs = ring + (s % kWideStages) * kWideSlab * kWideBS +
                          warp * 32;
#pragma unroll
        for (int k8 = 0; k8 < kWideSlab; k8 += 8) {
          if (k0 + k8 >= H) break;
          unsigned bh[4][2], bl[4][2];
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int v = 0; v < 2; ++v)
              split_tf32_rn(bs[(k8 + tq + 4 * v) * kWideBS + g * 8 + gq],
                            bh[g][v], bl[g][v]);
          const float* ha =
              hsp + gq * kWideHS + (k0 - kw0 + k8) * 2 + tq * 4;
#pragma unroll
          for (int i = 0; i < kMI; ++i) {
            // rows gq and gq + 8 of m16 tile i: (hi, lo) at depths
            // k8 + tq and k8 + tq + 4
            const float4 r0 =
                *reinterpret_cast<const float4*>(ha + i * 16 * kWideHS);
            const float4 r8 = *reinterpret_cast<const float4*>(
                ha + (i * 16 + 8) * kWideHS);
            const unsigned ah[4] = {
                __float_as_uint(r0.x), __float_as_uint(r8.x),
                __float_as_uint(r0.z), __float_as_uint(r8.z)};
            const unsigned al[4] = {
                __float_as_uint(r0.y), __float_as_uint(r8.y),
                __float_as_uint(r0.w), __float_as_uint(r8.w)};
            // the 8 depths' products summed from 0, the small cross terms
            // first, then added in f32; the four gates' sums interleaved,
            // so that no product waits on the one before it
            float p[4][4];
#pragma unroll
            for (int g = 0; g < 4; ++g)
              mma_tf32_zero(p[g], al, bh[g][0], bh[g][1]);
#pragma unroll
            for (int g = 0; g < 4; ++g) mma_tf32(p[g], ah, bl[g][0], bl[g][1]);
#pragma unroll
            for (int g = 0; g < 4; ++g) mma_tf32(p[g], ah, bh[g][0], bh[g][1]);
#pragma unroll
            for (int g = 0; g < 4; ++g)
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[i][g][v] += p[g][v];
          }
        }
      }

      if (__any_sync(0xffffffffu, a_bad || w_bad)) {
        // rare: an Inf or NaN in the operands; the gate input plus the
        // plain f32 sum, as the plain version adds them
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int r = row0 + i * 16 + gq + (v >> 1) * 8;
            const int u = u_w + (v & 1);
            if (r >= R || u >= H) continue;
#pragma unroll
            for (int g = 0; g < 4; ++g)
              acc[i][g][v] = __fadd_rn(
                  gate_in(t, r, g, u),
                  plain_gate_sum(hp == nullptr ? nullptr : hp + (size_t)r * H,
                                 whhT + g * H + u, H, G));
          }
      }
      S* hn = h_at(t);
      // c is carried in cs in f32 training, else in scr
      constexpr bool kCarryCs = kMode == kFwdTrain && kF32;
      float* c_out =
          kCarryCs ? reinterpret_cast<float*>(out1) + t * RH : scr;
      const float* c_in =
          kCarryCs ? reinterpret_cast<float*>(out1) + (t > 0 ? t - 1 : 0) * RH
                   : scr;
      float cp[kMI][4];  // c_{t-1}, every load before the first store
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = row0 + i * 16 + gq + (v >> 1) * 8;
          const int u = u_w + (v & 1);
          cp[i][v] = r < R && u < H && t > 0 ? c_in[(size_t)r * H + u] : 0.0f;
        }
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = row0 + i * 16 + gq + (v >> 1) * 8;
          const int u = u_w + (v & 1);
          if (r >= R || u >= H) continue;
          const float ig = sigmoidf(acc[i][0][v]);
          const float fg = sigmoidf(acc[i][1][v]);
          const float gg = tanhf(acc[i][2][v]);
          const float og = sigmoidf(acc[i][3][v]);
          const float cn = cell_c(fg, cp[i][v], ig, gg);
          const float h = __fmul_rn(og, tanhf(cn));
          const size_t o = (size_t)r * H + u;
          stf(hn + o, h);
          c_out[o] = cn;
          if constexpr (kMode == kFwdTrain && !kF32) stf(out1 + t * RH + o, cn);
        }
    }
  }
}

template <int kMode, int kF, int kMI, class S>
cudaError_t launch_wide_mi(const S* xp, const S* x, const S* wih, const S* b,
                           const S* whhT, S* out0, S* out1, float* scr, int T,
                           int R, int H, int vec, cudaStream_t stream) {
  constexpr int M = 16 * kMI;
  auto kernel = lstm_fwd_wide_kernel<kMode, kF, kMI, S>;
  cudaError_t err = allow_smem((const void*)kernel, wide_smem_bytes(M));
  if (err != cudaSuccess) return err;
  kernel<<<(R + M - 1) / M, kWideThreads, wide_smem_bytes(M), stream>>>(
      xp, whhT, out0, out1, scr, T, R, H, x, wih, b, vec);
  return cudaGetLastError();
}

// The row tile: 48 rows, or 32 where tiles of 32 rows take at most one
// block an SM (R <= 32 SMs), so that each SM's one block has less work.
// On the H100 at H = 128 (lstm_fwd_probe.py): 32 rows 30% faster at R =
// 2,209, level at 4,418, 11-14% slower at 8,836 and 17,672.
template <int kMode, int kF, class S>
cudaError_t launch_wide_f(const S* xp, const S* x, const S* wih, const S* b,
                          const S* whhT, S* out0, S* out1, float* scr, int T,
                          int R, int H, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int vec = !kIsBf16<S> && H % 4 == 0 && aligned16(whhT) &&
                  aligned16(out0) && aligned16(scr);
  if (R <= 32LL * sms)
    return launch_wide_mi<kMode, kF, 2, S>(xp, x, wih, b, whhT, out0, out1,
                                           scr, T, R, H, vec, stream);
  return launch_wide_mi<kMode, kF, 3, S>(xp, x, wih, b, whhT, out0, out1, scr,
                                         T, R, H, vec, stream);
}

// Launch the wide forward on x_proj (F = 0) or, in the inference modes,
// fused from x, w_ih and b with 1 <= F <= 4 features. The inference modes
// need scr (see the kernel); training carries c in out1 in f32, in scr
// (R, H) in bf16.
template <int kMode, class S>
cudaError_t launch_fwd_wide(const S* xp, const S* x, const S* wih, const S* b,
                            int F, const S* whhT, S* out0, S* out1, float* scr,
                            int T, int R, int H, cudaStream_t stream) {
  if ((kMode != kFwdTrain || kIsBf16<S>) && scr == nullptr)
    return cudaErrorInvalidValue;
  if constexpr (kMode != kFwdTrain) {
    switch (F) {
      case 1:
        return launch_wide_f<kMode, 1, S>(xp, x, wih, b, whhT, out0, out1, scr,
                                       T, R, H, stream);
      case 2:
        return launch_wide_f<kMode, 2, S>(xp, x, wih, b, whhT, out0, out1, scr,
                                       T, R, H, stream);
      case 3:
        return launch_wide_f<kMode, 3, S>(xp, x, wih, b, whhT, out0, out1, scr,
                                       T, R, H, stream);
      case 4:
        return launch_wide_f<kMode, 4, S>(xp, x, wih, b, whhT, out0, out1, scr,
                                       T, R, H, stream);
      default:
        break;
    }
  }
  return launch_wide_f<kMode, 0, S>(xp, x, wih, b, whhT, out0, out1, scr, T, R,
                                 H, stream);
}

}  // namespace
