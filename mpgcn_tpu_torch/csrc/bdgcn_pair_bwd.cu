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
// every origin o shares (rows r = (b, m, c), R = B M N of them):
//
//   1. Z_d[b, m] = G_d dout[b, m]           (K N x N) by (N x H) per (b, m)
//   2. dh1[o]    = sum_d Z_d Wr[o, d]^T     (R x K H) by (K H x K C)
//   3. dW[o, d]  = sum_r h1[o]^T Z_d        (K C x R) by (R x K H)
//
// so this entry follows that order. What bounds it on the H100: the least
// work is 2 R (K N H + 2 K^2 C H) operations (29.1 GFLOP at the wide
// training shape K = 7, B = 4, N = 47, C = H = 128; 0.405 GFLOP at the
// reference K = 3, C = H = 32). All three products run on the TF32 tensor
// cores in three split products ("3xTF32", bdgcn_gemm.cuh): 3 x 29.1
// GFLOP at 495 TFLOP/s, 0.18 ms wide, bound by operations.
//
// Design: three launches of the split-TF32 products of bdgcn_gemm.cuh,
// each reading its operands in place through their axes: product 1 on
// mma.sync, products 2 and 3 on wgmma. Z goes through the (K, B, M, N, H)
// scratch z, written once by product 1 and read by products 2 and 3.
// Product 3 splits the rows r into P chunks, each chunk's product a
// partial (dw_part, (P, K, K, C, H)); it is a cooperative launch whose
// work items (chunk, 128 x 128 tile of dW) are
// strided over a grid of blocks the device holds at once, and after a
// grid-wide barrier every block adds a contiguous share of the K^2 C H dW
// entries over the P partials in a fixed order (dw_sum.cuh, as the LSTM
// BPTT does). No float atomics: two runs give bit-equal dW, equal to
// dw_reduce_plain of the partials. Every (K, C, H, N) is taken.

#include <cuda_runtime.h>

#include "bdgcn_gemm.cuh"

namespace {

// the dW product on the wgmma engine: A (h1[o]^T) contiguous along its rows
// l, B (Z_d) along its columns h
const void* dw_kernel() {
  return (const void*)tf32_wgmma_kernel<true, false, true>;
}
// work items (row chunk, tile) per block the device holds at once
constexpr int kDwWaves = 2;

long long dw_tiles(int K, int C, int H) {
  return (((long long)K * C + kWgBM - 1) / kWgBM) *
         (((long long)K * H + kWgBN - 1) / kWgBN);
}

// The most blocks of the dW kernel the current device holds at once, with
// the shared memory it launches with.
cudaError_t dw_coresident(int* blocks) {
  cudaError_t err = allow_smem(dw_kernel(), kWgSmem);
  if (err != cudaSuccess) return err;
  return max_coresident(dw_kernel(), kWgThreads, kWgSmem, blocks);
}

}  // namespace

// The P (row chunks of the dW product) that bdgcn_pair_bwd_f32's dW
// launch runs in about kDwWaves rounds of its grid, the blocks the current
// device holds at once with the dW kernel's shared memory: kDwWaves x the
// co-resident blocks over the tiles of (K C, K H), at least 1. Any P runs
// (the work items are strided over the grid); more only adds partials.
extern "C" int bdgcn_pair_bwd_max_blocks(int K, int C, int H, int* out) {
  if (K < 1 || C < 1 || H < 1) return cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = dw_coresident(&blocks);
  const long long per = (long long)kDwWaves * blocks / dw_tiles(K, C, H);
  *out = per > 1 ? (int)(per < 65535 ? per : 65535) : 1;
  return err;
}

// dh1 (K, B, M, N, C) and dW (K, K, C, H), through the partials dw_part
// (P, K, K, C, H); z is (K, B, M, N, H) scratch. Three launches, the last
// cooperative: refused (and nothing of it runs) when its grid cannot be
// resident at once.
extern "C" int bdgcn_pair_bwd_f32(const void* h1, const void* g,
                                  const void* w, const void* dout, void* dh1,
                                  void* z, void* dw_part, void* dw, int K,
                                  int B, int M, int N, int C, int H, int Bg,
                                  int P, void* stream) {
  if (K < 1 || B < 1 || M < 1 || M > 65535 || B > 65535 || N < 1 || C < 1 ||
      H < 1 || (Bg != 1 && Bg != B) || P < 1 || P > 65535 ||
      (long long)B * M * N > 0x7fffffffLL ||
      (long long)K * C > 0x7fffffffLL || (long long)K * H > 0x7fffffffLL ||
      (long long)K * N > 0x7fffffffLL ||
      (long long)K * K * C * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long R = (long long)B * M * N;
  const long long NN = (long long)N * N;

  // 1. Z[d, (b, m, c), h] = sum_e G[bg, d, c, e] dout[b, m, e, h], one
  //    product per (b, m)
  Gemm p1{};
  p1.a = static_cast<const float*>(g);
  p1.b = static_cast<const float*>(dout);
  p1.c = static_cast<float*>(z);
  p1.ai = split(N, NN, N);                        // (d, c)
  p1.ak = flat(1);                                // e
  p1.bk = flat(H);                                // e
  p1.bn = flat(1);                                // h
  p1.ci = split(N, R * H, H);                     // (d, c)
  p1.cn = flat(1);                                // h
  p1.za = split(M, Bg == 1 ? 0 : (long long)K * NN, 0);  // (b, m)
  p1.zb = p1.zc = flat((long long)N * H);
  p1.m = (long long)K * N;
  p1.batches = (long long)B * M;
  p1.n = H;
  p1.k = N;
  cudaError_t err = launch_gemm<false, false>(p1, s);
  if (err != cudaSuccess) return err;

  // 2. dh1[o, r, l] = sum_{d, h} Z[d, r, h] Wr[o, d, l, h]
  Gemm p2{};
  p2.a = static_cast<const float*>(z);
  p2.b = static_cast<const float*>(w);
  p2.c = static_cast<float*>(dh1);
  p2.ai = flat(H);                                // r
  p2.ak = split(H, R * H, 1);                     // (d, h)
  p2.bk = split(H, (long long)C * H, 1);          // (d, h)
  p2.bn = split(C, (long long)K * C * H, H);      // (o, l)
  p2.ci = flat(C);                                // r
  p2.cn = split(C, R * C, 1);                     // (o, l)
  p2.za = p2.zb = p2.zc = flat(0);
  p2.m = R;
  p2.batches = 1;
  p2.n = K * C;
  p2.k = K * H;
  err = launch_wgmma<false, true>(p2, s);
  if (err != cudaSuccess) return err;

  // 3. dw_part[p, o, d, l, h] = sum_{r in chunk p} h1[o, r, l] Z[d, r, h],
  //    then dW = the ordered sum over p, in the same launch
  Gemm p3{};
  p3.a = static_cast<const float*>(h1);
  p3.b = static_cast<const float*>(z);
  p3.c = static_cast<float*>(dw_part);
  p3.ai = split(C, R * C, 1);                     // (o, l)
  p3.ak = flat(C);                                // r
  p3.bk = flat(H);                                // r
  p3.bn = split(H, R * H, 1);                     // (d, h)
  p3.ci = split(C, (long long)K * C * H, H);      // (o, l)
  p3.cn = split(H, (long long)C * H, 1);          // (d, h)
  p3.za = p3.zb = flat(0);
  p3.zc = flat((long long)K * K * C * H);         // p
  p3.m = (long long)K * C;
  p3.batches = P;
  p3.n = K * H;
  p3.k = (int)R;
  // chunks of whole 16-byte runs of rows
  p3.k_chunk = (int)((R + P - 1) / P + 3) / 4 * 4;
  prepare<true, false>(p3);
  int blocks = 0;
  err = dw_coresident(&blocks);
  if (err != cudaSuccess) return err;
  const long long items = gemm_items(p3, kWgBM, kWgBN);
  if (items < blocks) blocks = (int)items;
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  float* dwp = static_cast<float*>(dw);
  int n_dw = K * K * C * H;
  void* args[] = {&p3, &dwp, &n_dw};
  err = cudaLaunchCooperativeKernel(dw_kernel(), dim3(blocks),
                                    dim3(kWgThreads), args, kWgSmem, s);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error behind
    return err;
  }
  return cudaGetLastError();
}
