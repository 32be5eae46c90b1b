// K-BDGCN-bwd: the backward of the folded BDGCN pair projection.
//
// Replaces the TPU kernel _bwd_kernel of mpgcn_tpu/nn/pallas_bdgcn.py
// (launched by _bwd_pallas). For the forward (bdgcn_pair_fwd.cu)
//
//   out[b, m, e, :] = sum_{o, d} sum_l (sum_c h1[o, b, m, c, l] G_d[c, e])
//                                        * Wr[o, d, l, :]
//
// and its cotangent dout (B, M, N, H) it computes
//
//   dh1 (K, B, M, N, C)  and  dW (K, K, C, H) f32.
//
// The TPU kernel works pair by pair and recomputes each pair's temp. The
// least work regroups around the destination contraction of dout, which
// every origin o shares:
//
//   Z_d[b, m]   = G_d dout[b, m]                  (N x N by N x H)
//   dh1[o]      = sum_d Z_d Wr[o, d]^T
//   dW[o, d]    = sum_{b, m} h1[o]^T Z_d
//
// so this kernel follows that order. What bounds it on the H100: at the
// training shape (B = 4, M = N = 47, C = H = 32, K = 3, static or per-sample
// supports) the least work is 2 B M N (K N H + 2 K^2 C H) = 0.405 GFLOP
// (6.05 us at 67 TFLOP/s f32 on the CUDA cores) against about 8 MB of
// h1, dout, dh1 and Gk (2.4 us at 3.35 TB/s): compute-bound.
//
// Design. bdgcn_pair_bwd_f32 launches two kernels:
//   1. z_dh1_kernel, one block per (tile of kTileC contraction rows c, origin
//      row m, sample b). It streams dout[b, m] and the K support tiles
//      G_d[c-tile, e-chunk] through shared memory in kTileE-column chunks of
//      the destination axis e, accumulating all K tiles Z_d (kTileC x H) in
//      registers at once, so dout is read once per block and not once per
//      pair. The Z tiles go to shared memory and to a (K, B, M, N, H)
//      scratch buffer, then each origin's dh1 tile is sum_d Z_d Wr[o, d]^T,
//      written once. Shared memory does not grow with N.
//   2. dw_partial_kernel, one block per (chunk p of the B*M*N rows, pair
//      (o, d)): the (C, H) product h1[o]^T Z_d over its rows, written as a
//      partial. The K^2 pair bank never exists; only the K-wide Z does.
//      A cooperative launch: after a grid-wide barrier every block adds a
//      contiguous share of the K^2 C H dW entries over the P partials in a
//      fixed order (dw_sum.cuh, as the LSTM BPTT does), so the sum needs no
//      launch of its own and the grid is bounded by what the device holds
//      at once (bdgcn_pair_bwd_max_blocks).
// No float atomics: two runs give bit-equal dW. Shared-memory rows read
// across a warp's lanes are padded by one float against bank conflicts.
//
// Widths. The register tiles of both kernels hold kTileC x C, kTileC x H
// and C x H entries in fixed slots a thread, and the K Z tiles are a
// template argument, so they take C, H <= kChunk = 64 and K <= kGroup = 5:
// the reference C = H = 32, K = 3 among them, where they run as they
// always did. Any other (K, C, H) takes two wide kernels, chosen per call
// from the widths (separate kernels rather than loops inside these, so
// their registers and schedule stay as they were), which run the same
// sums in chunks of <= 64 and groups of <= 5 supports:
//   1. z_dh1_wide_kernel: the Z tiles by (support group, H chunk), each
//      written to the scratch buffer; then, after a block barrier, each
//      origin's dh1 tile by C chunk, sum over d and H chunks of Z_d tile
//      chunk @ Wr[o, d] chunk^T, the Z chunks read back from the scratch.
//   2. dw_partial_wide_kernel: work items (row chunk p, pair, 64 x 64 tile
//      of (C, H)) strided over a grid sized by the co-resident bound alone,
//      so any pair and tile count fits one cooperative launch; each item
//      writes its tile of partial p, then the ordered sum as above.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dw_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileC = 32;  // contraction rows c per block of kernel 1
constexpr int kTileE = 32;  // destination columns e per shared-memory stage
constexpr int kTileR = 32;  // rows per shared-memory stage of kernel 2
constexpr int kMaxQ = 8;    // register slots: kTileC * max(C, H) / kThreads
constexpr int kChunk = kMaxQ * kThreads / kTileC;  // C, H per chunk: 64
constexpr int kMaxQW = kChunk * kChunk / kThreads;  // C*H per thread
constexpr int kGroup = 5;   // supports per group

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
z_dh1_kernel(const float* __restrict__ g, const float* __restrict__ w,
             const float* __restrict__ dout, float* __restrict__ dh1,
             float* __restrict__ z, int B, int M, int N, int C, int H,
             int Bg) {
  extern __shared__ float smem[];
  float* dos = smem;                    // (kTileE, H): a chunk of dout[b, m]
  float* gs = dos + kTileE * H;         // (K, kTileC, kTileE + 1)
  float* zs = gs + K * kTileC * (kTileE + 1);  // (K, kTileC, H)
  float* ws = zs + K * kTileC * H;      // (C, H + 1): Wr[o, d]

  const int c0 = blockIdx.x * kTileC;
  const int m = blockIdx.y;
  const int b = blockIdx.z;
  const int bg = Bg == 1 ? 0 : b;
  const int tid = threadIdx.x;
  const int gst = kTileE + 1;
  const int n_z = kTileC * H;  // Z entries per support of this tile
  const int n_h = kTileC * C;  // dh1 entries per origin of this tile
  const float* dout_bm = dout + ((size_t)b * M + m) * (size_t)N * H;

  float acc[K][kMaxQ];
#pragma unroll
  for (int d = 0; d < K; ++d)
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) acc[d][q] = 0.0f;

  for (int e0 = 0; e0 < N; e0 += kTileE) {
    const int cols = min(kTileE, N - e0);
    __syncthreads();  // the previous stage's readers are done
    for (int i = tid; i < kTileE * H; i += kThreads)
      dos[i] = i < cols * H ? dout_bm[(size_t)e0 * H + i] : 0.0f;
    for (int i = tid; i < K * kTileC * kTileE; i += kThreads) {
      const int d = i / (kTileC * kTileE);
      const int rem = i - d * (kTileC * kTileE);
      const int cc = rem / kTileE;
      const int ee = rem - cc * kTileE;
      gs[(d * kTileC + cc) * gst + ee] =
          (c0 + cc < N && ee < cols)
              ? g[(((size_t)bg * K + d) * N + c0 + cc) * N + e0 + ee]
              : 0.0f;
    }
    __syncthreads();
    for (int ee = 0; ee < cols; ++ee) {
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        const int i = tid + q * kThreads;
        if (i < n_z) {
          const int cc = i / H;
          const float dv = dos[ee * H + i - cc * H];
#pragma unroll
          for (int d = 0; d < K; ++d)
            acc[d][q] = fmaf(gs[(d * kTileC + cc) * gst + ee], dv, acc[d][q]);
        }
      }
    }
  }

  // Z tiles to shared memory and to the scratch buffer
#pragma unroll
  for (int d = 0; d < K; ++d)
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      const int i = tid + q * kThreads;
      if (i < n_z) {
        zs[d * n_z + i] = acc[d][q];
        const int cc = i / H;
        if (c0 + cc < N)
          z[((((size_t)d * B + b) * M + m) * N + c0 + cc) * H + i - cc * H] =
              acc[d][q];
      }
    }

  // dh1[o] tile = sum_d Z_d tile @ Wr[o, d]^T
  const int wst = H + 1;
  for (int o = 0; o < K; ++o) {
    float a[kMaxQ];
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) a[q] = 0.0f;
    for (int d = 0; d < K; ++d) {
      __syncthreads();  // zs is written; the previous pair's readers are done
      const float* wod = w + ((size_t)o * K + d) * C * H;
      for (int i = tid; i < C * H; i += kThreads) {
        const int l = i / H;
        ws[l * wst + i - l * H] = wod[i];
      }
      __syncthreads();
      const float* zd = zs + d * n_z;
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        const int i = tid + q * kThreads;
        if (i < n_h) {
          const int cc = i / C;
          const int l = i - cc * C;
          const float* zr = zd + cc * H;
          const float* wr = ws + l * wst;
          float s = 0.0f;
          for (int h = 0; h < H; ++h) s = fmaf(zr[h], wr[h], s);
          a[q] += s;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      const int i = tid + q * kThreads;
      if (i < n_h) {
        const int cc = i / C;
        if (c0 + cc < N)
          dh1[((((size_t)o * B + b) * M + m) * N + c0 + cc) * C + i - cc * C] =
              a[q];
      }
    }
  }
}

// Block (p, o*K + d): rows [p*chunk, (p+1)*chunk) of h1[o]^T @ Z[d], as
// partial p; then, after a grid-wide barrier, its share of the sum of the
// P partials into dw.
__global__ void __launch_bounds__(kThreads)
dw_partial_kernel(const float* __restrict__ h1, const float* __restrict__ z,
                  float* __restrict__ part, float* __restrict__ dw, int K,
                  int rows, int chunk, int C, int H) {
  __shared__ float hsm[kTileR * kChunk];
  __shared__ float zsm[kTileR * kChunk];
  const int p = blockIdx.x;
  const int od = blockIdx.y;
  const int o = od / K;
  const int d = od - o * K;
  const int tid = threadIdx.x;
  const int n_w = C * H;
  const float* h1o = h1 + (size_t)o * rows * C;
  const float* zd = z + (size_t)d * rows * H;
  const int r_begin = p * chunk;
  const int r_end = min(rows, r_begin + chunk);

  float acc[kMaxQW];
#pragma unroll
  for (int q = 0; q < kMaxQW; ++q) acc[q] = 0.0f;
  for (int r0 = r_begin; r0 < r_end; r0 += kTileR) {
    const int n_r = min(kTileR, r_end - r0);
    __syncthreads();
    for (int i = tid; i < n_r * C; i += kThreads)
      hsm[i] = h1o[(size_t)r0 * C + i];
    for (int i = tid; i < n_r * H; i += kThreads)
      zsm[i] = zd[(size_t)r0 * H + i];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kMaxQW; ++q) {
      const int i = tid + q * kThreads;
      if (i < n_w) {
        const int l = i / H;
        const int h = i - l * H;
        float s = 0.0f;
        for (int rr = 0; rr < n_r; ++rr)
          s = fmaf(hsm[rr * C + l], zsm[rr * H + h], s);
        acc[q] += s;
      }
    }
  }
  float* out = part + ((size_t)p * K * K + od) * n_w;
#pragma unroll
  for (int q = 0; q < kMaxQW; ++q) {
    const int i = tid + q * kThreads;
    if (i < n_w) out[i] = acc[q];
  }
  cooperative_groups::this_grid().sync();
  sum_partials(part, dw, gridDim.x, K * K * n_w, od * gridDim.x + p,
               gridDim.x * gridDim.y, tid, kThreads, hsm,
               kTileR * kChunk);
}

// The K supports in ceil(K / kGroup) groups of at most group_size(K)
// each (7 -> 4 + 3, 9 -> 5 + 4).
int group_size(int K) {
  const int n = (K + kGroup - 1) / kGroup;
  return (K + n - 1) / n;
}

bool narrow(int K, int C, int H) {
  return K <= kGroup && C <= kChunk && H <= kChunk;
}

template <int KG>
__global__ void __launch_bounds__(kThreads)
z_dh1_wide_kernel(const float* __restrict__ g, const float* __restrict__ w,
                  const float* __restrict__ dout, float* __restrict__ dh1,
                  float* __restrict__ z, int K, int B, int M, int N, int C,
                  int H, int Bg) {
  extern __shared__ float smem[];
  const int gst = kTileE + 1;
  const int wst = kChunk + 1;
  // the Z stage
  float* dos = smem;                     // (kTileE, kChunk): dout chunk
  float* gs = dos + kTileE * kChunk;     // (KG, kTileC, kTileE + 1)
  // the dh1 stage
  float* zs = smem;                      // (kTileC, kChunk): a Z tile chunk
  float* ws = zs + kTileC * kChunk;      // (kChunk, kChunk + 1): Wr chunk

  const int c0 = blockIdx.x * kTileC;
  const int m = blockIdx.y;
  const int b = blockIdx.z;
  const int bg = Bg == 1 ? 0 : b;
  const int tid = threadIdx.x;
  const float* dout_bm = dout + ((size_t)b * M + m) * (size_t)N * H;

  // Z_d tile = G_d[c tile, :] @ dout[b, m], by support group and H chunk
  for (int d0 = 0; d0 < K; d0 += KG) {
    const int nd = min(KG, K - d0);
    for (int h0 = 0; h0 < H; h0 += kChunk) {
      const int Hc = min(kChunk, H - h0);
      const int n_z = kTileC * Hc;
      float acc[KG][kMaxQ];
#pragma unroll
      for (int d = 0; d < KG; ++d)
#pragma unroll
        for (int q = 0; q < kMaxQ; ++q) acc[d][q] = 0.0f;
      for (int e0 = 0; e0 < N; e0 += kTileE) {
        const int cols = min(kTileE, N - e0);
        __syncthreads();  // the previous stage's readers are done
        for (int i = tid; i < kTileE * Hc; i += kThreads) {
          const int ee = i / Hc;
          dos[i] = ee < cols
                       ? dout_bm[(size_t)(e0 + ee) * H + h0 + i - ee * Hc]
                       : 0.0f;
        }
        for (int i = tid; i < KG * kTileC * kTileE; i += kThreads) {
          const int d = i / (kTileC * kTileE);
          const int rem = i - d * (kTileC * kTileE);
          const int cc = rem / kTileE;
          const int ee = rem - cc * kTileE;
          gs[(d * kTileC + cc) * gst + ee] =
              (d < nd && c0 + cc < N && ee < cols)
                  ? g[(((size_t)bg * K + d0 + d) * N + c0 + cc) * N + e0 +
                      ee]
                  : 0.0f;
        }
        __syncthreads();
        for (int ee = 0; ee < cols; ++ee) {
#pragma unroll
          for (int q = 0; q < kMaxQ; ++q) {
            const int i = tid + q * kThreads;
            if (i < n_z) {
              const int cc = i / Hc;
              const float dv = dos[ee * Hc + i - cc * Hc];
#pragma unroll
              for (int d = 0; d < KG; ++d)
                acc[d][q] =
                    fmaf(gs[(d * kTileC + cc) * gst + ee], dv, acc[d][q]);
            }
          }
        }
      }
#pragma unroll
      for (int d = 0; d < KG; ++d) {
        if (d >= nd) break;
#pragma unroll
        for (int q = 0; q < kMaxQ; ++q) {
          const int i = tid + q * kThreads;
          if (i < n_z) {
            const int cc = i / Hc;
            if (c0 + cc < N)
              z[((((size_t)(d0 + d) * B + b) * M + m) * N + c0 + cc) * H +
                h0 + i - cc * Hc] = acc[d][q];
          }
        }
      }
    }
  }

  // dh1[o] tile = sum_d Z_d tile @ Wr[o, d]^T, by C chunk; the Z tiles are
  // read back from the scratch this block wrote (visible after a barrier)
  for (int l0 = 0; l0 < C; l0 += kChunk) {
    const int Lc = min(kChunk, C - l0);
    const int n_h = kTileC * Lc;
    for (int o = 0; o < K; ++o) {
      float a[kMaxQ];
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) a[q] = 0.0f;
      for (int d = 0; d < K; ++d) {
        const float* zd = z + (((size_t)d * B + b) * M + m) * (size_t)N * H;
        const float* wod = w + (((size_t)o * K + d) * C + l0) * H;
        for (int h0 = 0; h0 < H; h0 += kChunk) {
          const int Hc = min(kChunk, H - h0);
          __syncthreads();  // the Z writes, or the last chunk's readers
          for (int i = tid; i < kTileC * Hc; i += kThreads) {
            const int cc = i / Hc;
            zs[i] = c0 + cc < N
                        ? zd[(size_t)(c0 + cc) * H + h0 + i - cc * Hc]
                        : 0.0f;
          }
          for (int i = tid; i < Lc * Hc; i += kThreads) {
            const int l = i / Hc;
            ws[l * wst + i - l * Hc] = wod[(size_t)l * H + h0 + i - l * Hc];
          }
          __syncthreads();
#pragma unroll
          for (int q = 0; q < kMaxQ; ++q) {
            const int i = tid + q * kThreads;
            if (i < n_h) {
              const int cc = i / Lc;
              const int l = i - cc * Lc;
              const float* zr = zs + cc * Hc;
              const float* wr = ws + l * wst;
              float s = 0.0f;
              for (int h = 0; h < Hc; ++h) s = fmaf(zr[h], wr[h], s);
              a[q] += s;
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        const int i = tid + q * kThreads;
        if (i < n_h) {
          const int cc = i / Lc;
          if (c0 + cc < N)
            dh1[((((size_t)o * B + b) * M + m) * N + c0 + cc) * C + l0 + i -
                cc * Lc] = a[q];
        }
      }
    }
  }
}

// Work item it = (p * K^2 + od) * n_tiles + tile: rows [p chunk,
// (p + 1) chunk) of h1[o]^T @ Z[d] on one 64 x 64 tile of (C, H), written
// to partial p; the items are strided over the grid. After a grid-wide
// barrier every block sums its share of the P partials into dw.
__global__ void __launch_bounds__(kThreads)
dw_partial_wide_kernel(const float* __restrict__ h1,
                       const float* __restrict__ z, float* __restrict__ part,
                       float* __restrict__ dw, int K, int rows, int chunk,
                       int C, int H, int P) {
  __shared__ float hsm[kTileR * kChunk];
  __shared__ float zsm[kTileR * kChunk];
  const int tid = threadIdx.x;
  const int n_hc = (H + kChunk - 1) / kChunk;
  const int n_tiles = (C + kChunk - 1) / kChunk * n_hc;
  const long long items = (long long)P * K * K * n_tiles;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = (int)(it % n_tiles);
    const int od = (int)(it / n_tiles % (K * K));
    const int p = (int)(it / n_tiles / (K * K));
    const int o = od / K, d = od - o * K;
    const int l0 = tile / n_hc * kChunk, h0 = tile % n_hc * kChunk;
    const int Lc = min(kChunk, C - l0), Hc = min(kChunk, H - h0);
    const int n_w = Lc * Hc;
    const float* h1o = h1 + (size_t)o * rows * C;
    const float* zd = z + (size_t)d * rows * H;
    const int r_begin = p * chunk;
    const int r_end = min(rows, r_begin + chunk);

    float acc[kMaxQW];
#pragma unroll
    for (int q = 0; q < kMaxQW; ++q) acc[q] = 0.0f;
    for (int r0 = r_begin; r0 < r_end; r0 += kTileR) {
      const int n_r = min(kTileR, r_end - r0);
      __syncthreads();  // the previous stage's readers are done
      for (int i = tid; i < n_r * Lc; i += kThreads) {
        const int rr = i / Lc;
        hsm[i] = h1o[(size_t)(r0 + rr) * C + l0 + i - rr * Lc];
      }
      for (int i = tid; i < n_r * Hc; i += kThreads) {
        const int rr = i / Hc;
        zsm[i] = zd[(size_t)(r0 + rr) * H + h0 + i - rr * Hc];
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kMaxQW; ++q) {
        const int i = tid + q * kThreads;
        if (i < n_w) {
          const int l = i / Hc;
          const int h = i - l * Hc;
          float s = 0.0f;
          for (int rr = 0; rr < n_r; ++rr)
            s = fmaf(hsm[rr * Lc + l], zsm[rr * Hc + h], s);
          acc[q] += s;
        }
      }
    }
    float* out = part + ((size_t)p * K * K + od) * C * H;
#pragma unroll
    for (int q = 0; q < kMaxQW; ++q) {
      const int i = tid + q * kThreads;
      if (i < n_w) {
        const int l = i / Hc;
        out[(size_t)(l0 + l) * H + h0 + i - l * Hc] = acc[q];
      }
    }
  }
  cooperative_groups::this_grid().sync();
  sum_partials(part, dw, P, K * K * C * H, blockIdx.x, gridDim.x, tid,
               kThreads, hsm, kTileR * kChunk);
}

template <int KG>
int launch_wide(const void* h1, const void* g, const void* w,
                const void* dout, void* dh1, void* z, void* dw_part, void* dw,
                int K, int B, int M, int N, int C, int H, int Bg, int P,
                cudaStream_t stream) {
  const int smem_z = kTileE * kChunk + KG * kTileC * (kTileE + 1);
  const int smem_h = kTileC * kChunk + kChunk * (kChunk + 1);
  const size_t smem = (size_t)(smem_z > smem_h ? smem_z : smem_h) * sizeof(float);
  auto kernel = z_dh1_wide_kernel<KG>;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTileC - 1) / kTileC, M, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(w),
      static_cast<const float*>(dout), static_cast<float*>(dh1),
      static_cast<float*>(z), K, B, M, N, C, H, Bg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // as many blocks as the device holds at once, no more than work items
  int blocks = 0;
  err = max_coresident((const void*)dw_partial_wide_kernel, kThreads, 0,
                       &blocks);
  if (err != cudaSuccess) return err;
  const long long items = (long long)P * K * K * ((C + kChunk - 1) / kChunk) *
                          ((H + kChunk - 1) / kChunk);
  if (items < blocks) blocks = (int)items;
  int rows = B * M * N;
  int chunk = (rows + P - 1) / P;
  void* args[] = {&h1, &z, &dw_part, &dw, &K, &rows, &chunk, &C, &H, &P};
  err = cudaLaunchCooperativeKernel((const void*)dw_partial_wide_kernel,
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error behind
    return err;
  }
  return cudaGetLastError();
}

template <int K>
int launch(const void* h1, const void* g, const void* w, const void* dout,
           void* dh1, void* z, void* dw_part, void* dw, int B, int M, int N,
           int C, int H, int Bg, int P, cudaStream_t stream) {
  const size_t smem = (size_t)(kTileE * H + K * kTileC * (kTileE + 1) +
                               K * kTileC * H + C * (H + 1)) *
                      sizeof(float);
  auto kernel = z_dh1_kernel<K>;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTileC - 1) / kTileC, M, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(w),
      static_cast<const float*>(dout), static_cast<float*>(dh1),
      static_cast<float*>(z), B, M, N, C, H, Bg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int rows = B * M * N;
  int chunk = (rows + P - 1) / P;
  int k = K;
  void* args[] = {&h1, &z, &dw_part, &dw, &k, &rows, &chunk, &C, &H};
  err = cudaLaunchCooperativeKernel((const void*)dw_partial_kernel,
                                    dim3(P, K * K), dim3(kThreads), args, 0,
                                    stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error behind
    return err;
  }
  return cudaGetLastError();
}

}  // namespace

// The largest P (row chunks of the dW product) that bdgcn_pair_bwd_f32
// takes at (K, C, H): for the narrow kernels the most blocks the current
// device holds at once over K^2 (their grid is P x K^2 blocks); the wide
// kernel strides its work items over a grid of its own, so any P <= 65535.
extern "C" int bdgcn_pair_bwd_max_blocks(int K, int C, int H, int* out) {
  if (K < 1 || C < 1 || H < 1) return cudaErrorInvalidValue;
  if (!narrow(K, C, H)) {
    *out = 65535;
    return cudaSuccess;
  }
  int blocks = 0;
  cudaError_t err =
      max_coresident((const void*)dw_partial_kernel, kThreads, 0, &blocks);
  *out = blocks / (K * K);
  return err;
}

// dh1 (K, B, M, N, C) and dW (K, K, C, H), through the partials dw_part
// (P, K, K, C, H); z is (K, B, M, N, H) scratch. Two launches, the second
// cooperative: refused (and nothing of it runs) when its blocks cannot all
// be resident at once.
extern "C" int bdgcn_pair_bwd_f32(const void* h1, const void* g,
                                  const void* w, const void* dout, void* dh1,
                                  void* z, void* dw_part, void* dw, int K,
                                  int B, int M, int N, int C, int H, int Bg,
                                  int P, void* stream) {
  if (K < 1 || B < 1 || M < 1 || M > 65535 || B > 65535 || N < 1 || C < 1 ||
      H < 1 || (Bg != 1 && Bg != B) || P < 1 || P > 65535 ||
      (long long)B * M * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (narrow(K, C, H)) {
    switch (K) {
      case 1:
        return launch<1>(h1, g, w, dout, dh1, z, dw_part, dw, B, M, N, C, H,
                         Bg, P, s);
      case 2:
        return launch<2>(h1, g, w, dout, dh1, z, dw_part, dw, B, M, N, C, H,
                         Bg, P, s);
      case 3:
        return launch<3>(h1, g, w, dout, dh1, z, dw_part, dw, B, M, N, C, H,
                         Bg, P, s);
      case 4:
        return launch<4>(h1, g, w, dout, dh1, z, dw_part, dw, B, M, N, C, H,
                         Bg, P, s);
      default:
        return launch<5>(h1, g, w, dout, dh1, z, dw_part, dw, B, M, N, C, H,
                         Bg, P, s);
    }
  }
  switch (group_size(K)) {
    case 1:
      return launch_wide<1>(h1, g, w, dout, dh1, z, dw_part, dw, K, B, M, N,
                            C, H, Bg, P, s);
    case 2:
      return launch_wide<2>(h1, g, w, dout, dh1, z, dw_part, dw, K, B, M, N,
                            C, H, Bg, P, s);
    case 3:
      return launch_wide<3>(h1, g, w, dout, dh1, z, dw_part, dw, K, B, M, N,
                            C, H, Bg, P, s);
    case 4:
      return launch_wide<4>(h1, g, w, dout, dh1, z, dw_part, dw, K, B, M, N,
                            C, H, Bg, P, s);
    default:
      return launch_wide<5>(h1, g, w, dout, dh1, z, dw_part, dw, K, B, M, N,
                            C, H, Bg, P, s);
  }
}
