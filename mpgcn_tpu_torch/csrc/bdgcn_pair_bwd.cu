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
#include "bf16.cuh"

// The P (row chunks of the dW product) that bdgcn_pair_bwd_f32's dW
// launch runs in about kCoopWaves rounds of its grid (coop_chunks over the
// tiles of (K C, K H)). Any P runs; more only adds partials.
extern "C" int bdgcn_pair_bwd_max_blocks(int K, int C, int H, int* out) {
  if (K < 1 || C < 1 || H < 1) return cudaErrorInvalidValue;
  return coop_chunks((long long)K * C, (long long)K * H, out);
}

namespace {

bool bwd_dims_ok(int K, int B, int M, int N, int C, int H, int Bg, int P) {
  return !(K < 1 || B < 1 || M < 1 || M > 65535 || B > 65535 || N < 1 ||
           C < 1 || H < 1 || (Bg != 1 && Bg != B) || P < 1 || P > 65535 ||
           (long long)B * M * N > 0x7fffffffLL ||
           (long long)K * C > 0x7fffffffLL ||
           (long long)K * H > 0x7fffffffLL ||
           (long long)K * N > 0x7fffffffLL ||
           (long long)K * K * C * H > 0x7fffffffLL);
}

// The three products on f32 operands; round_z: Z is rounded to bf16 (kept
// in its f32 scratch) before products 2 and 3 read it, as the bf16 entry
// stores it.
cudaError_t pair_bwd(const void* h1, const void* g, const void* w,
                     const void* dout, void* dh1, void* z, void* dw_part,
                     void* dw, int K, int B, int M, int N, int C, int H,
                     int Bg, int P, bool round_z, cudaStream_t s) {
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
  if (err == cudaSuccess && round_z)
    err = round_bf16(static_cast<float*>(z), static_cast<float*>(z),
                     K * R * H, s);
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
  return launch_wgmma_coop(p3, static_cast<float*>(dw), K * K * C * H, s);
}

// The bf16 entry's f32 scratch (floats, each part from a multiple of 64):
// h1, G, Wr and dout widened, Z, and dh1 before its rounding.
struct BwdScratch {
  long long h1, g, w, dout, z, dh1, total;
  BwdScratch(int K, int B, int M, int N, int C, int H, int Bg) {
    const long long R = (long long)B * M * N;
    auto pad = [](long long n) { return (n + 63) / 64 * 64; };
    h1 = 0;
    g = h1 + pad(K * R * C);
    w = g + pad((long long)Bg * K * N * N);
    dout = w + pad((long long)K * K * C * H);
    z = dout + pad(R * H);
    dh1 = z + pad(K * R * H);
    total = dh1 + K * R * C;
  }
};

}  // namespace

// dh1 (K, B, M, N, C) and dW (K, K, C, H), through the partials dw_part
// (P, K, K, C, H); z is (K, B, M, N, H) scratch. Three launches, the last
// cooperative: refused (and nothing of it runs) when its grid cannot be
// resident at once.
extern "C" int bdgcn_pair_bwd_f32(const void* h1, const void* g,
                                  const void* w, const void* dout, void* dh1,
                                  void* z, void* dw_part, void* dw, int K,
                                  int B, int M, int N, int C, int H, int Bg,
                                  int P, void* stream) {
  if (!bwd_dims_ok(K, B, M, N, C, H, Bg, P)) return cudaErrorInvalidValue;
  return pair_bwd(h1, g, w, dout, dh1, z, dw_part, dw, K, B, M, N, C, H, Bg,
                  P, false, static_cast<cudaStream_t>(stream));
}

// The same backward on bf16 storage (h1, Gk, Wr, dout and dh1 in bf16; dW
// and its partials f32, summed in f32 as the JAX kernel sums them): the
// four operands widened into f32 scratch (4 launches), Z rounded to bf16
// after product 1, dh1 rounded at the end (2 launches), the dW launch
// cooperative as above. The scratch (in place of z) takes
// bdgcn_pair_bwd_bf16_scratch_k x 1024 floats.
extern "C" int bdgcn_pair_bwd_bf16(const void* h1, const void* g,
                                   const void* w, const void* dout,
                                   void* dh1, void* scratch, void* dw_part,
                                   void* dw, int K, int B, int M, int N,
                                   int C, int H, int Bg, int P,
                                   void* stream) {
  if (!bwd_dims_ok(K, B, M, N, C, H, Bg, P) || scratch == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdScratch sc(K, B, M, N, C, H, Bg);
  float* f = static_cast<float*>(scratch);
  const long long R = (long long)B * M * N;
  cudaError_t err = widen_bf16(h1, f + sc.h1, K * R * C, s);
  if (err == cudaSuccess)
    err = widen_bf16(g, f + sc.g, (long long)Bg * K * N * N, s);
  if (err == cudaSuccess)
    err = widen_bf16(w, f + sc.w, (long long)K * K * C * H, s);
  if (err == cudaSuccess) err = widen_bf16(dout, f + sc.dout, R * H, s);
  if (err == cudaSuccess)
    err = pair_bwd(f + sc.h1, f + sc.g, f + sc.w, f + sc.dout, f + sc.dh1,
                   f + sc.z, dw_part, dw, K, B, M, N, C, H, Bg, P, true, s);
  if (err == cudaSuccess)
    err = round_bf16(f + sc.dh1, static_cast<bf16*>(dh1), K * R * C, s);
  return err;
}

extern "C" int bdgcn_pair_bwd_bf16_scratch_k(int K, int B, int M, int N,
                                             int C, int H, int Bg, int* out) {
  if (!bwd_dims_ok(K, B, M, N, C, H, Bg, 1)) return cudaErrorInvalidValue;
  *out = (int)((BwdScratch(K, B, M, N, C, H, Bg).total + 1023) / 1024);
  return cudaSuccess;
}
