// The batched split-TF32 matrix products that K-BDGCN (bdgcn_pair_fwd.cu)
// and K-BDGCN-bwd (bdgcn_pair_bwd.cu) run each of their products on:
//
//   C[z](i, n) = sum_k A[z](i, k) B[z](k, n)     for z < batches
//
// Every operand is addressed through its axes: an index x of an axis lands
// at (x / div) * hi + (x % div) * lo floats (div = 0: x * lo), so one
// kernel reads h1 (K, R, C) as an (R, K C) matrix, Wr (K, K, C, H) as a
// (K C, K H) one, the supports as (N, K N) or (K N, N) ones, and so on,
// with no transposed or gathered copy. A batch z moves each base by its
// own axis (the (b, m) pair of a per-(b, m) product; a per-sample support
// moves with b only).
//
// Precision. Each f32 operand is split into a TF32 high part and a
// remainder rounded to TF32 too ("3xTF32": hi*hi + hi*lo + lo*hi, within
// 2^-22 relative per product, unbiased; split_tf32_rn). The tensor cores
// add into their accumulator with truncation, toward zero, so products are
// summed on the tensor cores from 0 over a few depths only, the small cross
// terms first, and then added into f32 accumulators, rounded to nearest:
// per 8 depths on mma.sync; per 32-deep step on wgmma (the step's cross
// terms, then its four hi*hi products: four truncations a step at the
// magnitude of its sum). Twelve truncations a step, with a truncated lo,
// were measurably worse than plain f32 in the whole model's gradients on
// the H100; this order is better than plain f32 there. Each output entry
// is written once by the block that owns it: no float atomics.
//
// Inf and NaN. The split is made for finite values (it turns a NaN such
// as 0x7fffffff into -0, and three split products give an Inf the wrong
// sign or NaN), so each thread folds every operand value it splits into
// x * 0 (fold_non_finite, on the FP pipe beside the split's integer
// work), and a warp (mma.sync: its own A rows and B columns) or block
// (wgmma: B is split once for both warpgroups; a barrier's OR) whose
// operands held an Inf or NaN sums each entry of its tile again in plain
// f32 (plain_entry): Inf, NaN and finite entries as the f32 sum gives
// them. Tiles without one keep their bits.
//
// Staging. An operand is copied by cp.async with its memory-contiguous axis
// along the lanes (k for h1 and dout rows, the destination axis of a
// support, and so on: the template flags), in 16-byte copies where every
// run of 4 along that axis is whole and aligned, else 4-byte ones; entries
// past the edges (ragged rows, columns and depth: N = 47, C = 65, H = 33,
// K C not a multiple of 8) are zero-filled by the copy. The offsets along
// the other axis come from a table of the tile's rows or columns in shared
// memory, or, along k, from a warp shuffle of the offsets the lanes
// computed for the slab's 32 depths: one division a lane and operand per
// slab.
//
// Two engines. tf32_wgmma_kernel, for the large products (U = h1 Wr, dh1
// and dW): a block of two warpgroups owns a 128 x 128 tile on wgmma
// m64n128k8, A from registers, B split once into shared memory.
// tf32_gemm_kernel, for the per-(b, m) products with the supports (out =
// G^T U and Z = G dout): 64 x 64 tiles on mma.sync m16n8k8, four warps of
// 32 x 32; at M = N = 47 rows a 128-row wgmma tile would be two-thirds
// empty, and these products are a few percent of the work.
//
// The dW products of the two backward entries (K-BDGCN-bwd and the wide
// LSTM BPTT) are a cooperative instance (kCoop) of the wgmma kernel: its
// batch z is a chunk of the depth (the rows r of the sum over b, m, c, or
// (t, r) of the BPTT), each chunk's product a partial, the work items (chunk,
// tile) strided over a grid the device holds at once; after a grid-wide
// barrier every block adds its share of the partials in the fixed order
// p = 0, 1, ... (dw_sum.cuh), so dW is bit-equal to dw_reduce_plain of the
// partials and from run to run.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dw_sum.cuh"
#include "smem.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kSlab = 32;    // depth of a staged slab
constexpr int kStagesG = 3;  // slabs in flight (mma.sync engine)
constexpr int kPadK = 4;     // row pad of a k-contiguous stage (floats)
constexpr int kPadMN = 8;    // row pad of an m- or n-contiguous stage

// An axis of an operand: index x at (x / div) * hi + (x % div) * lo.
struct Axis {
  int div;  // 0: x * lo
  long long hi, lo;
  __device__ __forceinline__ long long at(long long x) const {
    if (div == 0) return x * lo;
    const long long q = x <= 0x7fffffffLL ? (long long)((int)x / div)
                                          : x / div;
    return q * hi + (x - q * div) * lo;
  }
};

inline Axis flat(long long lo) { return Axis{0, 0, lo}; }
inline Axis split(int div, long long hi, long long lo) {
  return Axis{div, hi, lo};
}

// C[z](i, n) = sum_k A[z](i, k) B[z](k, n), i < m, n < n, k < k; with
// k_chunk > 0 product z sums only k in [z k_chunk, (z + 1) k_chunk).
// vec_a, vec_b (set by prepare): the operand is staged in 16-byte copies.
struct Gemm {
  const float* a;
  const float* b;
  float* c;
  Axis ai, ak, bk, bn, ci, cn;  // the operands' axes
  Axis za, zb, zc;              // the batch's offsets of each base
  long long m, batches;
  int n, k, k_chunk;
  int vec_a, vec_b;
};

// The f32 sum of C[z](i, n) over the depths [kb, ke) in order, a plain
// fmaf a depth (a at A's row i, b at B's column n): what the entries of a
// tile whose operands held an Inf or NaN take instead of their
// split-TF32 sums. Rare: only a non-finite operand gets here.
__device__ __forceinline__ float plain_entry(Axis ak, Axis bk,
                                             const float* a, const float* b,
                                             int kb, int ke) {
  float s = 0.0f;
  for (int k = kb; k < ke; ++k) s = fmaf(a[ak.at(k)], b[bk.at(k)], s);
  return s;
}

// --- the per-(b, m) products on mma.sync -----------------------------------

// 64 x 64 tiles, 2 x 2 warps of 32 x 32
template <bool kAColM, bool kBColK>
struct GemmShape {
  static constexpr int kWM = 2, kWN = 2;
  static constexpr int kBM = 32 * kWM, kBN = 32 * kWN;
  static constexpr int kThreads = 32 * kWM * kWN;
  static constexpr int kAFloats =
      kAColM ? kSlab * (kBM + kPadMN) : kBM * (kSlab + kPadK);
  static constexpr int kBFloats =
      kBColK ? kBN * (kSlab + kPadK) : kSlab * (kBN + kPadMN);
  static constexpr int kStageFloats = kAFloats + kBFloats;
  // the row and column offset tables, then the stages
  static constexpr size_t kSmem = sizeof(long long) * (kBM + kBN) +
                                  sizeof(float) * kStagesG * kStageFloats;
};

// One operand's slab: a (rows x kSlab) block of an operand whose memory-
// contiguous axis is the depth k (kKCol: staged (row, k), the rows' offsets
// in the table tab) or its rows (staged (k, row), the thread's own row at
// offset fix). In 16-byte copies (vec: every run of 4 entries along the
// contiguous axis is whole and 16-byte aligned) or 4-byte ones; entries
// past the edges are zero-filled. The depths' offsets are computed per
// lane (ko_lane: lane l's for depth k0 + l, -1 past the edge) and
// shuffled to the threads that copy them. Every thread calls it.
template <int kRows, int kT, bool kKCol>
__device__ __forceinline__ void stage_operand(
    float* dst, const float* base, const float* dummy, const Axis& kax,
    int k0, int ke, bool vec, const long long* tab, long long fix,
    int tid) {
  constexpr int RS = kKCol ? kSlab + kPadK : kRows + kPadMN;  // stage row
  const int lane = tid & 31;
  if (kKCol) {
    if (vec) {  // 8 threads a row, 4 depths each
      const int kq = k0 + (tid & 7) * 4;
      const long long ko = kq < ke ? kax.at(kq) : -1;
#pragma unroll
      for (int j = 0; j < kRows * 8 / kT; ++j) {
        const int i = (tid >> 3) + (kT / 8) * j;
        const long long ro = tab[i];
        const bool ok = ro >= 0 && ko >= 0;
        cp_async16(dst + i * RS + (tid & 7) * 4, ok ? base + ro + ko : dummy,
                   ok ? 16 : 0);
      }
    } else {  // a warp a row, a depth a lane
      const long long ko = k0 + lane < ke ? kax.at(k0 + lane) : -1;
#pragma unroll 4
      for (int j = 0; j < kRows * kSlab / kT; ++j) {
        const int i = (tid >> 5) + (kT / 32) * j;
        const long long ro = tab[i];
        const bool ok = ro >= 0 && ko >= 0;
        cp_async4(dst + i * RS + lane, ok ? base + ro + ko : dummy,
                  ok ? 4 : 0);
      }
    }
  } else {
    const long long ko_lane = k0 + lane < ke ? kax.at(k0 + lane) : -1;
    if (vec) {  // kRows / 4 threads a depth, 4 rows each
      constexpr int IV = kRows / 4;
#pragma unroll
      for (int j = 0; j < kRows * 8 / kT; ++j) {
        const int kk = tid / IV + (kT / IV) * j;
        const long long ko = __shfl_sync(0xffffffffu, ko_lane, kk);
        const bool ok = fix >= 0 && ko >= 0;
        cp_async16(dst + kk * RS + (tid % IV) * 4,
                   ok ? base + fix + ko : dummy, ok ? 16 : 0);
      }
    } else {  // kRows threads a depth, a row each
#pragma unroll 4
      for (int j = 0; j < kRows * kSlab / kT; ++j) {
        const int kk = tid / kRows + (kT / kRows) * j;
        const long long ko = __shfl_sync(0xffffffffu, ko_lane, kk);
        const bool ok = fix >= 0 && ko >= 0;
        cp_async4(dst + kk * RS + tid % kRows, ok ? base + fix + ko : dummy,
                  ok ? 4 : 0);
      }
    }
  }
}

// kAColM: A is contiguous along its rows i (staged (k, i)), else along k
// (staged (i, k)); kBColK: B is contiguous along k (staged (n, k)), else
// along its columns n (staged (k, n)). Each warp's 2 x 4 products per
// 8-deep step split their fragments as they load them. 16 warps an SM: at
// most 128 registers a thread.
template <bool kAColM, bool kBColK>
__global__ void __launch_bounds__(128, 4) tf32_gemm_kernel(Gemm g) {
  using S = GemmShape<kAColM, kBColK>;
  constexpr int kWM = S::kWM;
  constexpr int BM = S::kBM, BN = S::kBN, T = S::kThreads;
  constexpr int AS = kAColM ? BM + kPadMN : kSlab + kPadK;  // stage row
  constexpr int BS = kBColK ? kSlab + kPadK : BN + kPadMN;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  long long* row_a = reinterpret_cast<long long*>(gemm_smem);  // (BM)
  long long* col_b = row_a + BM;                               // (BN)
  float* stages = reinterpret_cast<float*>(col_b + BN);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWM, wn = warp / kWM;
  const int gq = lane >> 2, tq = lane & 3;
  const long long mt = (g.m + BM - 1) / BM;
  const int nt = (g.n + BN - 1) / BN;
  const long long items = g.batches * mt * nt;

  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int tn = (int)(it % nt);
    const long long tm = it / nt % mt;
    const long long z = it / nt / mt;
    const long long m0 = tm * BM;
    const int n0 = tn * BN;
    int kb = 0, ke = g.k;
    if (g.k_chunk > 0) {
      kb = (int)min((long long)g.k, z * g.k_chunk);
      ke = (int)min((long long)g.k, (long long)kb + g.k_chunk);
    }
    const float* a = g.a + g.za.at(z);
    const float* b = g.b + g.zb.at(z);

    __syncthreads();  // the previous item's readers of the tables are done
    if (!kAColM)
      for (int i = tid; i < BM; i += T)
        row_a[i] = m0 + i < g.m ? g.ai.at(m0 + i) : -1;
    if (kBColK)
      for (int i = tid; i < BN; i += T)
        col_b[i] = n0 + i < g.n ? g.bn.at(n0 + i) : -1;
    // the thread's own row of A (A contiguous along i) or column of B (B
    // contiguous along n), fixed over the item: the first of 4 in 16-byte
    // copies
    long long a_fix = -1, b_fix = -1;
    if (kAColM) {
      const long long r = m0 + (g.vec_a ? tid % (BM / 4) * 4 : tid % BM);
      if (r < g.m) a_fix = g.ai.at(r);
    }
    if (!kBColK) {
      const int c = n0 + (g.vec_b ? tid % (BN / 4) * 4 : tid % BN);
      if (c < g.n) b_fix = g.bn.at(c);
    }
    __syncthreads();

    auto issue = [&](int s) {
      float* as = stages + (s % kStagesG) * S::kStageFloats;
      const int k0 = kb + s * kSlab;
      stage_operand<BM, T, !kAColM>(as, a, g.a, g.ak, k0, ke, g.vec_a,
                                    row_a, a_fix, tid);
      stage_operand<BN, T, kBColK>(as + S::kAFloats, b, g.b, g.bk, k0, ke,
                                   g.vec_b, col_b, b_fix, tid);
    };

    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;
    // NaN once an operand value was Inf or NaN: A's and B's apart, two
    // short chains of FMAs
    float nf_a = 0.0f, nf_b = 0.0f;

    const int n_slabs = ke > kb ? (ke - kb + kSlab - 1) / kSlab : 0;
    for (int s = 0; s < kStagesG - 1; ++s) {
      if (s < n_slabs) issue(s);
      cp_async_commit();
    }
    for (int s = 0; s < n_slabs; ++s) {
      cp_async_wait<kStagesG - 2>();
      __syncthreads();  // slab s has landed; slab s - 1's readers are done
      if (s + kStagesG - 1 < n_slabs) issue(s + kStagesG - 1);
      cp_async_commit();
      const float* as = stages + (s % kStagesG) * S::kStageFloats;
      const float* bs = as + S::kAFloats;
#pragma unroll
      for (int k8 = 0; k8 < kSlab; k8 += 8) {
        unsigned ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wm * 32 + i * 16 + gq;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int rr = r + (v & 1) * 8, kk = k8 + tq + (v >> 1) * 4;
            const float x = kAColM ? as[kk * AS + rr] : as[rr * AS + kk];
            nf_a = fold_non_finite(x, nf_a);
            split_tf32_rn(x, ah[i][v], al[i][v]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = wn * 32 + j * 8 + gq;
          unsigned bh[2], bl[2];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int kk = k8 + tq + v * 4;
            const float x = kBColK ? bs[c * BS + kk] : bs[kk * BS + c];
            nf_b = fold_non_finite(x, nf_b);
            split_tf32_rn(x, bh[v], bl[v]);
          }
          // the 8 depths' products of each entry summed from 0, the small
          // cross terms first, then added in f32
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float p[4];
            mma_tf32_zero(p, al[i], bh[0], bh[1]);
            mma_tf32(p, ah[i], bl[0], bl[1]);
            mma_tf32(p, ah[i], bh[0], bh[1]);
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[i][j][v] += p[v];
          }
        }
      }
    }

    // a warp splits the A rows and B columns of its own 32 x 32 outputs:
    // its vote decides
    const bool plain = __any_sync(0xffffffffu, isnan(nf_a + nf_b));
    float* c = g.c + g.zc.at(z);
    long long ro[2][2], co[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = m0 + wm * 32 + i * 16 + h * 8 + gq;
        ro[i][h] = r < g.m ? g.ci.at(r) : -1;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int col = n0 + wn * 32 + j * 8 + 2 * tq + p;
        co[j][p] = col < g.n ? g.cn.at(col) : -1;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const long long r = ro[i][v >> 1], q = co[j][v & 1];
          if (r >= 0 && q >= 0) c[r + q] = acc[i][j][v];
        }
    if (plain) {  // rare: after the store, which keeps its registers
#pragma unroll 1
      for (int e = 0; e < 32; ++e) {
        const int i = e >> 4, j = (e >> 2) & 3, v = e & 3;
        const long long r = ro[i][v >> 1], q = co[j][v & 1];
        if (r >= 0 && q >= 0)
          c[r + q] = plain_entry(
              g.ak, g.bk,
              a + g.ai.at(m0 + wm * 32 + i * 16 + (v >> 1) * 8 + gq),
              b + g.bn.at(n0 + wn * 32 + j * 8 + 2 * tq + (v & 1)), kb, ke);
      }
    }
  }
}

// --- the large products on wgmma -------------------------------------------

// A block of two warpgroups owns a 128 x 128 output tile; warpgroup w its
// rows 64 w... Per 32-deep step both operands (128 rows of A, 128 columns
// of B) are copied into a ring of kWgRaw raw steps. B, which both
// warpgroups read, is split once into TF32 (hi, lo) parts in wgmma's
// K-major core-matrix layout (a double-buffered split step: B hi, B lo);
// A goes from the raw step into registers, split there, a warp's rows in
// the mma.sync fragment that wgmma takes for A. Each warpgroup runs 12
// wgmma m64n128k8 a step into p from 0 (the 8 cross-term products, then
// the 4 hi x hi); while they run the threads split B of the next step and
// copy the one kWgRaw ahead; then acc += p in f32. One block an SM (its
// shared memory), 8 warps. What bounds it on the H100: the operands'
// trips from L2 to shared memory (each A row block read once per column
// tile, each B column block once per row tile) and the split, which the
// warps that issue wgmma also run, rather than the tensor cores.
constexpr int kWgBM = 128, kWgBN = 128, kWgThreads = 256;
constexpr int kWgOp = 128 * kSlab;  // floats of one operand's step
constexpr int kWgRowsA = 136;       // a raw (k, row) A step's row stride
constexpr int kWgRawA = kSlab * kWgRowsA;  // floats of A's raw step
constexpr int kWgRaw = 3;           // raw steps in flight
// the row and column offset tables, the raw steps (A, B), the split steps
// (B hi, B lo)
constexpr size_t kWgSmem =
    sizeof(long long) * (kWgBM + kWgBN) +
    sizeof(float) * (kWgRaw * (kWgRawA + kWgOp) + 2 * 2 * kWgOp);

// One operand's raw step: 128 rows (of A, or columns of B) x 32 depths.
// kKCol: the operand is contiguous along k in memory, and is copied
// straight into the core-matrix layout, a row's offset from the table
// tab; else it is copied as it lies, (k, row) with 128 floats a depth, the
// thread's own row at offset fix. In 16-byte copies (vec) or 4-byte ones;
// entries past the edges are zero-filled. Every thread calls it.
template <bool kKCol, int kRS = 128>
__device__ __forceinline__ void wg_stage(float* dst, const float* base,
                                         const float* dummy, const Axis& kax,
                                         int k0, int ke, bool vec,
                                         const long long* tab, long long fix,
                                         int tid) {
  const int lane = tid & 31;
  if (kKCol) {
    if (vec) {  // the 8 rows of a core matrix on neighbouring threads
      const int kc = (tid >> 3) & 7;
      const long long ko = k0 + 4 * kc < ke ? kax.at(k0 + 4 * kc) : -1;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = tid + kWgThreads * u;
        const int row = (q >> 6) * 8 + (q & 7);
        const long long ro = tab[row];
        const bool ok = ro >= 0 && ko >= 0;
        cp_async16(dst + core_off(row, kc), ok ? base + ro + ko : dummy,
                   ok ? 16 : 0);
      }
    } else {  // a warp a row, a lane a depth
      const long long ko = k0 + lane < ke ? kax.at(k0 + lane) : -1;
#pragma unroll 4
      for (int u = 0; u < 16; ++u) {
        const int row = (tid >> 5) + 8 * u;
        const long long ro = tab[row];
        const bool ok = ro >= 0 && ko >= 0;
        cp_async4(dst + core_off(row, lane >> 2) + (lane & 3),
                  ok ? base + ro + ko : dummy, ok ? 4 : 0);
      }
    }
  } else {
    const long long ko_lane = k0 + lane < ke ? kax.at(k0 + lane) : -1;
    if (vec) {  // 4 rows from 4 (tid % 32), depths tid / 32 + 8 u
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kk = (tid >> 5) + 8 * u;
        const long long ko = __shfl_sync(0xffffffffu, ko_lane, kk);
        const bool ok = fix >= 0 && ko >= 0;
        cp_async16(dst + kk * kRS + 4 * lane, ok ? base + fix + ko : dummy,
                   ok ? 16 : 0);
      }
    } else {  // row tid % 128, depths tid / 128 + 2 u
#pragma unroll 4
      for (int u = 0; u < 16; ++u) {
        const int kk = (tid >> 7) + 2 * u;
        const long long ko = __shfl_sync(0xffffffffu, ko_lane, kk);
        const bool ok = fix >= 0 && ko >= 0;
        cp_async4(dst + kk * kRS + (tid & 127), ok ? base + fix + ko : dummy,
                  ok ? 4 : 0);
      }
    }
  }
}

// Splits one operand's raw step into hi (at hi) and lo (kWgOp further), in
// the core-matrix layout, folding each value into nf. Every thread calls
// it.
template <bool kKCol>
__device__ __forceinline__ void wg_split(float* hi, const float* raw,
                                         int tid, float& nf) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int q = tid + kWgThreads * u;
    float x[4];
    int off;
    if (kKCol) {  // raw is in the core-matrix layout already
      off = 4 * q;
      const float4 v = *reinterpret_cast<const float4*>(raw + off);
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {  // raw (k, row): 4 depths of row q % 128
      const int row = q & 127, kc = q >> 7;
      off = core_off(row, kc);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = raw[(4 * kc + i) * 128 + row];
    }
    uint4 h, l;
#pragma unroll
    for (int i = 0; i < 4; ++i) nf = fold_non_finite(x[i], nf);
    split_tf32_rn(x[0], h.x, l.x);
    split_tf32_rn(x[1], h.y, l.y);
    split_tf32_rn(x[2], h.z, l.z);
    split_tf32_rn(x[3], h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(hi + kWgOp + off) = l;
  }
}

template <bool kAColM, bool kBColK, bool kCoop>
__global__ void __launch_bounds__(kWgThreads, 1)
    tf32_wgmma_kernel(Gemm g, float* dw, int n_dw) {
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  long long* row_a = reinterpret_cast<long long*>(gemm_smem);  // (128)
  long long* col_b = row_a + kWgBM;                            // (128)
  float* raw = reinterpret_cast<float*>(col_b + kWgBN);  // (A, B) steps
  float* spl = raw + kWgRaw * (kWgRawA + kWgOp);          // (hi, lo) of B

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, gid = lane >> 2, tig = lane & 3;
  const long long mt = (g.m + kWgBM - 1) / kWgBM;
  const int nt = (g.n + kWgBN - 1) / kWgBN;
  const long long items = g.batches * mt * nt;

  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int tn = (int)(it % nt);
    const long long tm = it / nt % mt;
    const long long z = it / nt / mt;
    const long long m0 = tm * kWgBM;
    const int n0 = tn * kWgBN;
    int kb = 0, ke = g.k;
    if (g.k_chunk > 0) {
      kb = (int)min((long long)g.k, z * g.k_chunk);
      ke = (int)min((long long)g.k, (long long)kb + g.k_chunk);
    }
    const float* a = g.a + g.za.at(z);
    const float* b = g.b + g.zb.at(z);

    __syncthreads();  // the previous item's readers of the tables are done
    if (!kAColM && tid < kWgBM)
      row_a[tid] = m0 + tid < g.m ? g.ai.at(m0 + tid) : -1;
    if (kBColK && tid < kWgBN)
      col_b[tid] = n0 + tid < g.n ? g.bn.at(n0 + tid) : -1;
    long long a_fix = -1, b_fix = -1;
    if (kAColM) {
      const long long r = m0 + (g.vec_a ? 4 * lane : tid & 127);
      if (r < g.m) a_fix = g.ai.at(r);
    }
    if (!kBColK) {
      const int c = n0 + (g.vec_b ? 4 * lane : tid & 127);
      if (c < g.n) b_fix = g.bn.at(c);
    }
    __syncthreads();

    const int n_steps = ke > kb ? (ke - kb + kSlab - 1) / kSlab : 0;
    auto stage = [&](int t) {
      float* r = raw + (t % kWgRaw) * (kWgRawA + kWgOp);
      const int k0 = kb + t * kSlab;
      wg_stage<!kAColM, kWgRowsA>(r, a, g.a, g.ak, k0, ke, g.vec_a, row_a,
                                  a_fix, tid);
      wg_stage<kBColK>(r + kWgRawA, b, g.b, g.bk, k0, ke, g.vec_b, col_b,
                       b_fix, tid);
    };
    float nf = 0.0f;  // NaN once an operand value was Inf or NaN
    auto split = [&](int t) {
      wg_split<kBColK>(spl + (t & 1) * 2 * kWgOp,
                       raw + (t % kWgRaw) * (kWgRawA + kWgOp) + kWgRawA, tid,
                       nf);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };
    // this thread's A fragment value v of depth 8 ks + tig (+ 4) from raw
    // step t: rows 16 (warp % 4) + gid (+ 8) of its warpgroup's 64
    const int fr = wg * 64 + (warp & 3) * 16 + gid;
    auto a_val = [&](const float* ra, int ks, int v) {
      const int row = fr + (v & 1) * 8, k = ks * 8 + tig + (v >> 1) * 4;
      return kAColM ? ra[k * kWgRowsA + row]
                    : ra[core_off(row, k >> 2) + (k & 3)];
    };

    // p: the step's products, summed on the tensor cores from 0, the small
    // cross terms of all 32 depths first, then hi x hi: four truncations at
    // the magnitude of the sum, then acc += p in f32
    float acc[64], p[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = p[i] = 0.0f;
    for (int t = 0; t < kWgRaw; ++t) {
      if (t < n_steps) stage(t);
      cp_async_commit();
    }
    if (n_steps > 0) {
      cp_async_wait<kWgRaw - 1>();
      __syncthreads();  // step 0 has landed for every thread's copies
      split(0);
    }
    __syncthreads();
    for (int t = 0; t < n_steps; ++t) {
      const float* pb = spl + (t & 1) * 2 * kWgOp;
      const float* ra = raw + (t % kWgRaw) * (kWgRawA + kWgOp);
      // per 8 depths: this thread's A fragment, split in registers, and the
      // cross terms; then the hi x hi products
      unsigned ah[kSlab / 8][4], al[kSlab / 8][4];
      fence_regs(p);
#pragma unroll
      for (int ks = 0; ks < kSlab / 8; ++ks) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float x = a_val(ra, ks, v);
          nf = fold_non_finite(x, nf);
          split_tf32_rn(x, ah[ks][v], al[ks][v]);
        }
        wgmma_fence();
        const float* q = pb + ks * 64;  // two core matrices along k
        wgmma_m64k8_ra(p, al[ks], wgmma_desc(q), ks > 0);
        wgmma_m64k8_ra(p, ah[ks], wgmma_desc(q + kWgOp), 1);
      }
#pragma unroll
      for (int ks = 0; ks < kSlab / 8; ++ks)
        wgmma_m64k8_ra(p, ah[ks], wgmma_desc(pb + ks * 64), 1);
      wgmma_commit();
      // while they run: split B of step t + 1 (its split step, read by
      // step t - 1's wgmma, is free), then copy step t + kWgRaw into raw
      // step t's place (every thread has its A fragments of step t)
      if (t + 1 < n_steps) {
        cp_async_wait<kWgRaw - 2>();
        __syncthreads();  // step t + 1 has landed for every thread's copies
        split(t + 1);
      }
      if (t + kWgRaw < n_steps) stage(t + kWgRaw);
      cp_async_commit();
      wgmma_wait<0>();
      fence_regs(p);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += p[i];
      __syncthreads();  // step t + 1 is split; step t's wgmma are done
    }
    cp_async_wait<0>();

    // D fragment: warp w % 4 of the warpgroup holds rows 16 (w % 4) + gid
    // (+ 8), columns 8 j + 2 tig (+ 1) of each 8-column chunk j. The
    // columns' offsets go to a table in the (free) raw steps.
    long long* col_c = reinterpret_cast<long long*>(raw);
    if (tid < kWgBN) col_c[tid] = n0 + tid < g.n ? g.cn.at(n0 + tid) : -1;
    const bool plain = __syncthreads_or(isnan(nf));
    float* c = g.c + g.zc.at(z);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = m0 + wg * 64 + (warp & 3) * 16 + h * 8 + gid;
      if (r >= g.m) continue;
      const long long ro = g.ci.at(r);
#pragma unroll
      for (int j = 0; j < kWgBN / 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const long long co = col_c[j * 8 + 2 * tig + u];
          if (co >= 0) c[ro + co] = acc[j * 4 + 2 * h + u];
        }
    }
    if (plain) {  // rare: after the store, which keeps its registers
#pragma unroll 1
      for (int e = 0; e < 64; ++e) {
        const int h = e >> 5, col = (e >> 1 & 15) * 8 + 2 * tig + (e & 1);
        const long long r = m0 + wg * 64 + (warp & 3) * 16 + h * 8 + gid;
        const long long co = col_c[col];
        if (r < g.m && co >= 0)
          c[g.ci.at(r) + co] = plain_entry(g.ak, g.bk, a + g.ai.at(r),
                                           b + g.bn.at(n0 + col), kb, ke);
      }
    }
  }

  if constexpr (kCoop) {
    cooperative_groups::this_grid().sync();
    sum_partials(g.c, dw, (int)g.batches, n_dw, blockIdx.x, gridDim.x, tid,
                 kWgThreads, raw, kWgRaw * (kWgRawA + kWgOp));
  }
}

// x runs through memory in whole, 16-byte aligned runs of 4 over an
// extent that is a multiple of 4
inline bool runs4(const Axis& x, long long extent) {
  return x.lo == 1 && (x.div == 0 || (x.div % 4 == 0 && x.hi % 4 == 0)) &&
         extent % 4 == 0;
}
// every offset of x is a multiple of 4 floats
inline bool steps4(const Axis& x) {
  return x.lo % 4 == 0 && (x.div == 0 || x.hi % 4 == 0);
}
// Sets g's 16-byte copy flags for the kernel's staging layout.
template <bool kAColM, bool kBColK>
void prepare(Gemm& g) {
  const bool chunk4 = g.k_chunk % 4 == 0;
  g.vec_a = aligned16(g.a) && steps4(g.za) &&
            (kAColM ? runs4(g.ai, g.m) && steps4(g.ak)
                    : runs4(g.ak, g.k) && chunk4 && steps4(g.ai));
  g.vec_b = aligned16(g.b) && steps4(g.zb) &&
            (kBColK ? runs4(g.bk, g.k) && chunk4 && steps4(g.bn)
                    : runs4(g.bn, g.n) && steps4(g.bk));
}

// work items (batch, tile) of g at bm x bn tiles
inline long long gemm_items(const Gemm& g, int bm, int bn) {
  return g.batches * ((g.m + bm - 1) / bm) * ((g.n + bn - 1) / bn);
}

// One launch of g on the mma.sync engine, one block per work item.
template <bool kAColM, bool kBColK>
cudaError_t launch_gemm(const Gemm& g, cudaStream_t stream) {
  using S = GemmShape<kAColM, kBColK>;
  auto kernel = tf32_gemm_kernel<kAColM, kBColK>;
  cudaError_t err = allow_smem((const void*)kernel, S::kSmem);
  if (err != cudaSuccess) return err;
  const long long items = gemm_items(g, S::kBM, S::kBN);
  Gemm gv = g;
  prepare<kAColM, kBColK>(gv);
  kernel<<<(unsigned)(items < 0x7fffffffLL ? items : 0x7fffffffLL),
           S::kThreads, S::kSmem, stream>>>(gv);
  return cudaGetLastError();
}

// One launch of g on the wgmma engine, one block per work item.
template <bool kAColM, bool kBColK>
cudaError_t launch_wgmma(const Gemm& g, cudaStream_t stream) {
  auto kernel = tf32_wgmma_kernel<kAColM, kBColK, false>;
  cudaError_t err = allow_smem((const void*)kernel, kWgSmem);
  if (err != cudaSuccess) return err;
  const long long items = gemm_items(g, kWgBM, kWgBN);
  Gemm gv = g;
  prepare<kAColM, kBColK>(gv);
  kernel<<<(unsigned)(items < 0x7fffffffLL ? items : 0x7fffffffLL),
           kWgThreads, kWgSmem, stream>>>(gv, nullptr, 0);
  return cudaGetLastError();
}

// --- the cooperative dW products -------------------------------------------

// The dW products of both backward entries (K-BDGCN-bwd's dW, the BPTT's
// dW_hh^T) run on one cooperative instance: A contiguous along its rows, B
// along its columns, the batch z a chunk of the depth, each chunk's product
// a partial of the (m x n) dW.
inline const void* coop_kernel() {
  return (const void*)tf32_wgmma_kernel<true, false, true>;
}
// work items (chunk, tile) per block the device holds at once
constexpr int kCoopWaves = 2;

// The most blocks of the cooperative kernel the current device holds at
// once, with the shared memory it launches with.
inline cudaError_t coop_coresident(int* blocks) {
  cudaError_t err = allow_smem(coop_kernel(), kWgSmem);
  if (err != cudaSuccess) return err;
  return max_coresident(coop_kernel(), kWgThreads, kWgSmem, blocks);
}

// The depth chunks P that an (m x n) dW product runs in about kCoopWaves
// rounds of the co-resident grid: kCoopWaves x the co-resident blocks over
// the product's 128 x 128 tiles, at least 1, at most 65535. Any P runs
// (the work items are strided over the grid); more only adds partials.
inline cudaError_t coop_chunks(long long m, long long n, int* out) {
  int blocks = 0;
  cudaError_t err = coop_coresident(&blocks);
  const long long tiles =
      ((m + kWgBM - 1) / kWgBM) * ((n + kWgBN - 1) / kWgBN);
  const long long per = (long long)kCoopWaves * blocks / tiles;
  *out = per > 1 ? (int)(per < 65535 ? per : 65535) : 1;
  return err;
}

// One cooperative launch of g (g.batches chunks of g.k_chunk depths, the
// partials at g.c): its work items strided over the blocks the device
// holds at once; after the grid-wide barrier every block adds its share of
// the n_dw entries of dw over the partials in order. Refused (and nothing
// of it runs) when its grid cannot be resident at once.
inline cudaError_t launch_wgmma_coop(Gemm g, float* dw, int n_dw,
                                     cudaStream_t stream) {
  prepare<true, false>(g);
  int blocks = 0;
  cudaError_t err = coop_coresident(&blocks);
  if (err != cudaSuccess) return err;
  const long long items = gemm_items(g, kWgBM, kWgBN);
  if (items < blocks) blocks = (int)items;
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&g, &dw, &n_dw};
  err = cudaLaunchCooperativeKernel(coop_kernel(), dim3(blocks),
                                    dim3(kWgThreads), args, kWgSmem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error behind
    return err;
  }
  return cudaGetLastError();
}

}  // namespace
