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
//   u   (K, B, M, N, H) f32  scratch
//
// The TPU kernel works pair by pair: it builds each pair's temp
// h1[o]^T G_d and projects it. This kernel projects first, which is the
// least work, as two products (rows r = (b, m, c), R = B M N of them):
//
//   1. U_d[r, :] = sum_o h1[o][r, :] Wr[o, d]     (R x K C) by (K C x K H)
//   2. out[b, m] = sum_d G_d^T U_d[b, m]          (N x K N) by (K N x H),
//                                                 one product per (b, m)
//
// What bounds it on the H100: product 1 holds almost all of the work,
// 2 R K^2 C H operations (28.4 GFLOP at the wide serve shape K = 7, B = 8,
// N = 47, C = H = 128; 0.33 GFLOP at the reference K = 3, C = H = 32),
// product 2 adds 2 R K N H. Both run on the TF32 tensor cores in three
// split products ("3xTF32", bdgcn_gemm.cuh), so 3 x 29.9 GFLOP at 495
// TFLOP/s: 0.18 ms wide, bound by operations; U (63 MB wide) goes through
// device memory once each way, about 38 us at 3.35 TB/s.
//
// Design: two launches of the split-TF32 products of bdgcn_gemm.cuh, which
// read each operand in place through its axes (h1 as (R, K C), Wr as
// (K C, K H), G_d^T as (N, K N) with its destination axis contiguous):
// product 1 on wgmma, writing U as (K, R, H), so product 2's rows of U_d
// for one (b, m) are contiguous; product 2 on mma.sync. Every (K, C, H, N)
// is taken: tiles, depth and rows are zero-padded at the edges in shared
// memory, which does not grow with N. Each output entry is written once:
// no float atomics, the same bits from run to run.

#include <cuda_runtime.h>

#include "bdgcn_gemm.cuh"

extern "C" int bdgcn_pair_fwd_f32(const void* h1, const void* g,
                                  const void* w, void* out, void* u, int K,
                                  int B, int M, int N, int C, int H, int Bg,
                                  void* stream) {
  if (K < 1 || B < 1 || M < 1 || M > 65535 || B > 65535 || N < 1 || C < 1 ||
      H < 1 || (Bg != 1 && Bg != B) || (long long)K * C > 0x7fffffffLL ||
      (long long)K * H > 0x7fffffffLL || (long long)K * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long R = (long long)B * M * N;
  const long long NN = (long long)N * N;

  // 1. U[d, r, h] = sum_{o, c} h1[o, r, c] Wr[o, d, c, h]
  Gemm p1{};
  p1.a = static_cast<const float*>(h1);
  p1.b = static_cast<const float*>(w);
  p1.c = static_cast<float*>(u);
  p1.ai = flat(C);                                // r
  p1.ak = split(C, R * C, 1);                     // (o, c)
  p1.bk = split(C, (long long)K * C * H, H);      // (o, c)
  p1.bn = split(H, (long long)C * H, 1);          // (d, h)
  p1.ci = flat(H);                                // r
  p1.cn = split(H, R * H, 1);                     // (d, h)
  p1.za = p1.zb = p1.zc = flat(0);
  p1.m = R;
  p1.batches = 1;
  p1.n = K * H;
  p1.k = K * C;
  cudaError_t err = launch_wgmma<false, false>(p1, s);
  if (err != cudaSuccess) return err;

  // 2. out[b, m, e, h] = sum_{d, c} G[bg, d, c, e] U[d, (b, m, c), h], one
  //    product per (b, m)
  Gemm p2{};
  p2.a = static_cast<const float*>(g);
  p2.b = static_cast<const float*>(u);
  p2.c = static_cast<float*>(out);
  p2.ai = flat(1);                                // e
  p2.ak = split(N, NN, N);                        // (d, c)
  p2.bk = split(N, R * H, H);                     // (d, c)
  p2.bn = flat(1);                                // h
  p2.ci = flat(H);                                // e
  p2.cn = flat(1);                                // h
  p2.za = split(M, Bg == 1 ? 0 : (long long)K * NN, 0);  // (b, m)
  p2.zb = p2.zc = flat((long long)N * H);
  p2.m = N;
  p2.batches = (long long)B * M;
  p2.n = H;
  p2.k = K * N;
  return launch_gemm<true, false>(p2, s);
}
