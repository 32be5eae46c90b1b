// K-BDGCN: the folded BDGCN pair projection, forward.
//
// Replaces the TPU kernel _fwd_kernel of mpgcn_tpu/nn/pallas_bdgcn.py
// (launched by _fwd_impl from folded_pair_project):
//
//   out[b, m, e, :] = sum_o sum_d sum_l (sum_c h1[o, b, m, c, l] G_d[c, e])
//                                          * Wr[o, d, l, :]
//
//   h1  (K, B, M, N, C) f32  origin contractions G_o^T X (one einsum upstream)
//   Gk  (Bg, K, N, N)   f32  destination supports, Bg = 1 (static graph) or
//                            Bg = B (per-sample dynamic graphs)
//   Wr  (K, K, C, H)    f32  the (K^2 C, H) projection weight reshaped
//   out (B, M, N, H)    f32
//
// What bounds it on the H100: at bucket 8 (B = 8, N = 47, C = H = 32,
// K = 3, static graph) it reads 6.8 MB and writes 2.3 MB (2.7 us at
// 3.35 TB/s) for 0.80 GFLOP (12.0 us at 67 TFLOP/s f32 on the CUDA
// cores): compute-bound. The K^2 (o, d) pair bank, 9x the activations at
// K = 3, never reaches device memory: each pair's temp is built and
// consumed in shared memory.
//
// Design: one block per (destination tile of kTileE columns, origin row m,
// sample b). For each origin o the block streams h1[o, b, m] (N, C) and the
// K destination-support tiles through shared memory in kTileC-row stages
// of the contraction axis c, accumulating all K temps t_d = h1^T G_d
// (C, kTileE) in registers at once -- so h1 is read once per origin, not
// once per pair. Each t_d then goes through shared memory into the
// projection t_d^T Wr[o, d], accumulated into an f32 register tile that
// is written to device memory once. The TPU kernel keeps the whole
// (K, N, N) support block resident in VMEM (26 KB at N = 47, 3 MB at
// N = 500); here both the destination axis e and the contraction axis c
// are tiled, so shared memory does not grow with N and any N works.
//
// Widths. The register tiles above hold C x kTileE temps and kTileE x H
// outputs in kMaxQ slots a thread, and the K temps are a template
// argument, so this kernel takes C, H <= kChunk = 64 and K <= kGroup = 5:
// the reference C = H = 32, K = 3 among them, where it runs as it always
// did. Any other (K, C, H) takes bdgcn_pair_fwd_wide_kernel, chosen per
// call from the widths (a separate kernel rather than loops inside this
// one, so this one's registers and schedule stay as they were). It runs
// the same sums in chunks: H in chunks of <= 64 through a grid axis folded
// into blockIdx.x (each chunk recomputes the temps), the channels l in
// chunks of <= 64 inside the block (the projection sums over them, so each
// chunk's product adds into the same accumulators), and the destination
// supports in groups of <= 5 (h1 re-streamed once per group and chunk).
// Shared memory is sized from the chunks, 52 KB at most.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileE = 32;  // destination columns per block
constexpr int kTileC = 32;  // contraction rows per shared-memory stage
constexpr int kMaxQ = 8;    // register slots: C*kTileE and kTileE*H per thread
constexpr int kChunk = kMaxQ * kThreads / kTileE;  // C, H per chunk: 64
constexpr int kGroup = 5;   // destination supports per group

template <int K>
__global__ void __launch_bounds__(kThreads)
bdgcn_pair_fwd_kernel(const float* __restrict__ h1,
                      const float* __restrict__ g,
                      const float* __restrict__ w, float* __restrict__ out,
                      int B, int M, int N, int C, int H, int Bg) {
  extern __shared__ float smem[];
  float* h1s = smem;                       // (kTileC, C)
  float* gs = h1s + kTileC * C;            // (K, kTileC, kTileE)
  float* ts = gs + K * kTileC * kTileE;    // (C, kTileE)
  float* ws = ts + C * kTileE;             // (C, H)

  const int e0 = blockIdx.x * kTileE;
  const int m = blockIdx.y;
  const int b = blockIdx.z;
  const int bg = Bg == 1 ? 0 : b;
  const int tid = threadIdx.x;
  const int e_t = tid % kTileE;  // this thread's temp column
  const int n_t = C * kTileE;    // temp entries per pair
  const int n_acc = kTileE * H;  // output entries per block

  float acc[kMaxQ];
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) acc[q] = 0.0f;

  for (int o = 0; o < K; ++o) {
    float t[K][kMaxQ];
#pragma unroll
    for (int d = 0; d < K; ++d)
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) t[d][q] = 0.0f;

    const float* h1row = h1 + (((size_t)o * B + b) * M + m) * (size_t)N * C;
    for (int c0 = 0; c0 < N; c0 += kTileC) {
      const int rows = min(kTileC, N - c0);
      __syncthreads();  // the previous stage's readers are done
      for (int i = tid; i < kTileC * C; i += kThreads)
        h1s[i] = i < rows * C ? h1row[(size_t)c0 * C + i] : 0.0f;
      for (int i = tid; i < K * kTileC * kTileE; i += kThreads) {
        const int d = i / (kTileC * kTileE);
        const int rem = i - d * (kTileC * kTileE);
        const int cc = rem / kTileE;
        const int e = e0 + rem - cc * kTileE;
        gs[i] = (cc < rows && e < N)
                    ? g[(((size_t)bg * K + d) * N + c0 + cc) * N + e]
                    : 0.0f;
      }
      __syncthreads();
      for (int cc = 0; cc < rows; ++cc) {
        float gv[K];
#pragma unroll
        for (int d = 0; d < K; ++d)
          gv[d] = gs[(d * kTileC + cc) * kTileE + e_t];
#pragma unroll
        for (int q = 0; q < kMaxQ; ++q) {
          const int i = tid + q * kThreads;
          if (i < n_t) {
            const float hv = h1s[cc * C + i / kTileE];
#pragma unroll
            for (int d = 0; d < K; ++d) t[d][q] = fmaf(hv, gv[d], t[d][q]);
          }
        }
      }
    }

#pragma unroll
    for (int d = 0; d < K; ++d) {
      __syncthreads();  // the previous pair's projection readers are done
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        const int i = tid + q * kThreads;
        if (i < n_t) ts[i] = t[d][q];
      }
      const float* wod = w + ((size_t)o * K + d) * C * H;
      for (int i = tid; i < C * H; i += kThreads) ws[i] = wod[i];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        const int i = tid + q * kThreads;
        if (i < n_acc) {
          const int e = i / H;
          const int hh = i - e * H;
          float s = 0.0f;
          for (int l = 0; l < C; ++l)
            s = fmaf(ts[l * kTileE + e], ws[l * H + hh], s);
          acc[q] += s;
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    const int i = tid + q * kThreads;
    if (i < n_acc) {
      const int e = e0 + i / H;
      if (e < N) out[(((size_t)b * M + m) * N + e) * H + i % H] = acc[q];
    }
  }
}

template <int K>
int launch(const void* h1, const void* g, const void* w, void* out, int B,
           int M, int N, int C, int H, int Bg, cudaStream_t stream) {
  const size_t smem =
      (size_t)(kTileC * C + K * kTileC * kTileE + C * kTileE + C * H) *
      sizeof(float);
  auto kernel = bdgcn_pair_fwd_kernel<K>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + kTileE - 1) / kTileE, M, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(h1), static_cast<const float*>(g),
      static_cast<const float*>(w), static_cast<float*>(out), B, M, N, C, H,
      Bg);
  return cudaGetLastError();
}

// The K destination supports in ceil(K / kGroup) groups of at most
// group_size(K) each (7 -> 4 + 3, 9 -> 5 + 4): the fewest groups, as even
// as they come.
int group_size(int K) {
  const int n = (K + kGroup - 1) / kGroup;
  return (K + n - 1) / n;
}

// The same sums as bdgcn_pair_fwd_kernel, in chunks (header). Block
// (e tile x H chunk, m, b); KG destination supports per group.
template <int KG>
__global__ void __launch_bounds__(kThreads)
bdgcn_pair_fwd_wide_kernel(const float* __restrict__ h1,
                           const float* __restrict__ g,
                           const float* __restrict__ w,
                           float* __restrict__ out, int K, int B, int M,
                           int N, int C, int H, int Bg, int n_h) {
  extern __shared__ float smem[];
  float* h1s = smem;                        // (kTileC, kChunk)
  float* gs = h1s + kTileC * kChunk;        // (KG, kTileC, kTileE)
  float* ts = gs + KG * kTileC * kTileE;    // (kChunk, kTileE)
  float* ws = ts + kChunk * kTileE;         // (kChunk, kChunk)

  const int e0 = (blockIdx.x / n_h) * kTileE;
  const int h0 = (blockIdx.x % n_h) * kChunk;
  const int Hc = min(kChunk, H - h0);
  const int m = blockIdx.y;
  const int b = blockIdx.z;
  const int bg = Bg == 1 ? 0 : b;
  const int tid = threadIdx.x;
  const int e_t = tid % kTileE;   // this thread's temp column
  const int n_acc = kTileE * Hc;  // output entries per block

  float acc[kMaxQ];
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) acc[q] = 0.0f;

  for (int o = 0; o < K; ++o) {
    const float* h1row = h1 + (((size_t)o * B + b) * M + m) * (size_t)N * C;
    for (int d0 = 0; d0 < K; d0 += KG) {
      const int nd = min(KG, K - d0);
      for (int l0 = 0; l0 < C; l0 += kChunk) {
        const int Lc = min(kChunk, C - l0);
        const int n_t = Lc * kTileE;  // temp entries per pair
        float t[KG][kMaxQ];
#pragma unroll
        for (int d = 0; d < KG; ++d)
#pragma unroll
          for (int q = 0; q < kMaxQ; ++q) t[d][q] = 0.0f;

        for (int c0 = 0; c0 < N; c0 += kTileC) {
          const int rows = min(kTileC, N - c0);
          __syncthreads();  // the previous stage's readers are done
          for (int i = tid; i < kTileC * Lc; i += kThreads) {
            const int cc = i / Lc;
            h1s[i] = cc < rows ? h1row[(size_t)(c0 + cc) * C + l0 + i -
                                       cc * Lc]
                               : 0.0f;
          }
          for (int i = tid; i < KG * kTileC * kTileE; i += kThreads) {
            const int d = i / (kTileC * kTileE);
            const int rem = i - d * (kTileC * kTileE);
            const int cc = rem / kTileE;
            const int e = e0 + rem - cc * kTileE;
            gs[i] = (d < nd && cc < rows && e < N)
                        ? g[(((size_t)bg * K + d0 + d) * N + c0 + cc) * N + e]
                        : 0.0f;
          }
          __syncthreads();
          for (int cc = 0; cc < rows; ++cc) {
            float gv[KG];
#pragma unroll
            for (int d = 0; d < KG; ++d)
              gv[d] = gs[(d * kTileC + cc) * kTileE + e_t];
#pragma unroll
            for (int q = 0; q < kMaxQ; ++q) {
              const int i = tid + q * kThreads;
              if (i < n_t) {
                const float hv = h1s[cc * Lc + i / kTileE];
#pragma unroll
                for (int d = 0; d < KG; ++d)
                  t[d][q] = fmaf(hv, gv[d], t[d][q]);
              }
            }
          }
        }

#pragma unroll
        for (int d = 0; d < KG; ++d) {
          if (d >= nd) break;  // uniform over the block
          __syncthreads();  // the previous pair's projection readers are done
#pragma unroll
          for (int q = 0; q < kMaxQ; ++q) {
            const int i = tid + q * kThreads;
            if (i < n_t) ts[i] = t[d][q];
          }
          const float* wod =
              w + (((size_t)o * K + d0 + d) * C + l0) * H + h0;
          for (int i = tid; i < Lc * Hc; i += kThreads) {
            const int l = i / Hc;
            ws[i] = wod[(size_t)l * H + i - l * Hc];
          }
          __syncthreads();
#pragma unroll
          for (int q = 0; q < kMaxQ; ++q) {
            const int i = tid + q * kThreads;
            if (i < n_acc) {
              const int e = i / Hc;
              const int hh = i - e * Hc;
              float s = 0.0f;
              for (int l = 0; l < Lc; ++l)
                s = fmaf(ts[l * kTileE + e], ws[l * Hc + hh], s);
              acc[q] += s;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    const int i = tid + q * kThreads;
    if (i < n_acc) {
      const int e = e0 + i / Hc;
      if (e < N)
        out[(((size_t)b * M + m) * N + e) * H + h0 + i % Hc] = acc[q];
    }
  }
}

template <int KG>
int launch_wide(const void* h1, const void* g, const void* w, void* out,
                int K, int B, int M, int N, int C, int H, int Bg,
                cudaStream_t stream) {
  const size_t smem = (size_t)(kTileC * kChunk + KG * kTileC * kTileE +
                               kChunk * kTileE + kChunk * kChunk) *
                      sizeof(float);
  auto kernel = bdgcn_pair_fwd_wide_kernel<KG>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int n_h = (H + kChunk - 1) / kChunk;
  const long long cols = (long long)((N + kTileE - 1) / kTileE) * n_h;
  if (cols > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)cols, M, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(h1), static_cast<const float*>(g),
      static_cast<const float*>(w), static_cast<float*>(out), K, B, M, N, C,
      H, Bg, n_h);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bdgcn_pair_fwd_f32(const void* h1, const void* g,
                                  const void* w, void* out, int K, int B,
                                  int M, int N, int C, int H, int Bg,
                                  void* stream) {
  if (K < 1 || B < 1 || M < 1 || M > 65535 || B > 65535 || N < 1 || C < 1 ||
      H < 1 || (Bg != 1 && Bg != B))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= kGroup && C <= kChunk && H <= kChunk) {
    switch (K) {
      case 1: return launch<1>(h1, g, w, out, B, M, N, C, H, Bg, s);
      case 2: return launch<2>(h1, g, w, out, B, M, N, C, H, Bg, s);
      case 3: return launch<3>(h1, g, w, out, B, M, N, C, H, Bg, s);
      case 4: return launch<4>(h1, g, w, out, B, M, N, C, H, Bg, s);
      default: return launch<5>(h1, g, w, out, B, M, N, C, H, Bg, s);
    }
  }
  switch (group_size(K)) {
    case 1: return launch_wide<1>(h1, g, w, out, K, B, M, N, C, H, Bg, s);
    case 2: return launch_wide<2>(h1, g, w, out, K, B, M, N, C, H, Bg, s);
    case 3: return launch_wide<3>(h1, g, w, out, K, B, M, N, C, H, Bg, s);
    case 4: return launch_wide<4>(h1, g, w, out, K, B, M, N, C, H, Bg, s);
    default: return launch_wide<5>(h1, g, w, out, K, B, M, N, C, H, Bg, s);
  }
}
