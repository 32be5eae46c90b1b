// ELL SpMM: the blocked-ELL sparse-dense product of the sparse BDGCN arm,
// its dX and its dBlocks, for a stack of S operators.
//
// A container (sparse/formats.py) stores each operator A_s (n_rows x
// n_cols) as row blocks of kBR = 8 rows; row block i keeps MB tiles
// blocks[s, i, j] (8 x BC) and their column-block ids cols[s, i, j]. X
// holds G = S / x_div dense (n_cols, F) inputs: slice s reads X[s / x_div]
// (x_div = S: one X shared by the stack; x_div = K: per-sample X of a
// (B, K) stack). X rows past n_cols and dout rows past n_rows read as 0.
//
// Entries, and the TPU kernels of mpgcn_tpu/sparse/pallas_ell.py each
// replaces:
//   ell_fwd       out[s, i-block] = sum_j blocks[s,i,j] @ X[cols[s,i,j]]
//                 (_fwd_kernel, launched by _fwd_impl); f32 or bf16 tiles
//   ell_fwd_q     the same on int8 codes x one f32 scale per row block
//                 (_fwd_kernel_q, _fwd_impl_q)
//   ell_bwd_dx    dX[g, c-block] = sum over the slots (s, i, j) of group g
//                 with cols == c of blocks[s,i,j]^T @ dout[s, i-block]
//                 (_bwd_dx_kernel, _bwd_impl)
//   ell_bwd_dx_q  the same on the int8 payload (_bwd_dx_kernel_q,
//                 _bwd_dx_impl_q)
//   ell_bwd_dblk  dBlocks[s,i,j] = dout[s, i-block] @ X[cols[s,i,j]]^T,
//                 summed over F, pad slots included (_bwd_dblk_kernel,
//                 _bwd_impl)
//
// What bounds them on the H100. At the large-N training shape (N = 500,
// batch 2, C = 32: F = B N C = 32,000 shared or N C = 16,000 per sample,
// S = 3 or 6, NB = 63, MB = 2, BC = 128) the least work is 2 * F times
// the operator entries that the populated tiles cover inside the (N, N)
// operator: 14.5 GFLOP for the static origin contraction (229 of 378
// slots populated), against 258 MB of X, output and tiles (0.077 ms at
// 3.35 TB/s). On the CUDA cores (67 TFLOP/s f32: 0.217 ms) that is bound
// by operations; the forward runs on the TF32 tensor cores in three
// products for f32 tiles (3 x 14.5 GFLOP at 495 TFLOP/s: 0.088 ms, bound
// by operations) and two for bf16 tiles and int8 codes (bound by bytes).
// dX does the same work in the other direction (each populated tile
// transposed against its 8 dout rows), bound the same way: 0.088 ms on the
// TF32 tensor cores in three products. dBlocks on a pad-free N = 500
// container (S = 3, NB = 63, MB = 4, F = 32,000) is 2 S N^2 F = 48 GFLOP:
// on the TF32 tensor cores in three products 0.291 ms, bound by
// operations (0.716 ms on the CUDA cores).
// The forward and dX run mma.sync (neither's operands are K-major, which
// wgmma needs for TF32 operands); dBlocks, whose dout rows and X slab are
// both K-major, runs wgmma.
//
// Design.
//   Forward: the TPU kernel takes one row block per grid cell and reads
//     an X slab for each of its MB slots, pad slots included: at the shape
//     above 6.1 GB of X per launch for 8-row tiles that reuse each X value
//     8 times. Here a block owns a row group of 8 row blocks (64 rows), an
//     X group g (the x_div slices that read X[g], one after the other, so
//     each re-reads the same slabs while they sit in L2) and every
//     n_chunks-th 32-column F tile (the blocks in flight walk F side by
//     side). Per slice it gathers the column blocks that its row blocks'
//     populated slots name, in ascending order, from the container's
//     transposed block index (t_ptr, t_slot: per slice, the populated
//     slots sorted by column block, then row block, so a group's slots on
//     column block c are one sub-run, found by binary search, one column
//     block per thread). It stages those tiles once, as (64 x K) operands
//     in shared memory in mma fragment order (K = BC padded with zeros to
//     a multiple of 8; one 16-byte load per fragment), and reuses them
//     over all its F tiles. X slabs (32 columns) stream through a
//     double-buffered cp.async ring, one per (F tile, live column block),
//     each multiplied by the operand of that column block. A slab holds
//     only the rows of the columns (rounded out to multiples of 8) in which
//     one of the operand's tiles is non-zero, and the products skip the
//     other k steps: in a banded operator a row group meets only part of a
//     column block. That reads 0.27 GB of X per launch at the shape above,
//     against 0.64 GB for whole slabs. Two blocks share an SM, so one's
//     staging and stores overlap the other's products. Pad slots are not
//     multiplied: their tiles are zero, so for finite X leaving them out
//     gives the same sum (as in dX below); the plain version still
//     computes every slot. A 16-row fragment whose two row blocks have no
//     slot on the column block is skipped. A group whose live column blocks do not
//     all fit in shared memory takes them in batches, each adding its sum
//     into the output in order.
//     The products are mma.sync m16n8k8 TF32 with f32 accumulators (wgmma
//     takes TF32 operands only K-major, and the X slab is not). TF32 keeps
//     10 mantissa bits, so each f32 operand is split into a TF32 high part
//     and the remainder: f32 tiles take hi*hi + hi*lo + lo*hi ("3xTF32",
//     error about 2^-21 relative per product); bf16 tiles and int8 codes
//     are exact in TF32, so only X is split (two products). The tensor
//     cores add into their accumulator with truncation, so hi*hi is summed
//     per k step from 0 and added in f32, and the cross terms accumulate
//     apart. The int8 scale is one per (s, row block), constant over the
//     slots, and is applied to the f32 accumulator in the epilogue:
//     (sum code * x) * scale, a different rounding from the TPU kernel's
//     float(code) * scale at the operand read, within rtol 1e-5. Repeated
//     column ids in a row block (ell_from_dense never makes them) are
//     summed into the staged operand, which is then split as f32 tiles
//     are. No float atomics: each block owns its output tiles and sums in
//     a fixed order, bit-equal from run to run.
//   Inf and NaN. The plain sum multiplies every entry of every slot's
//     tile, pad slots included, so an Inf or NaN in X makes its column of
//     the output non-finite wherever a slot names its column block (0 x
//     Inf is NaN), and one in a tile (or an int8 scale) makes its row
//     non-finite; the skips above and the split (made for finite values,
//     split_tf32) lose that. The split's lo of an Inf or NaN is NaN, and
//     the tensor cores give NaN for NaN times any value, 0 included, so
//     an Inf or NaN in an X value a warp multiplies leaves its column of
//     the cross-term accumulator NaN: a warp whose accumulator is not
//     finite when it stores an F tile flags (X group, column block, F
//     tile) for its batch's column blocks (a vote an F tile; nothing is
//     added to the products). The blocks tag the X rows they read, and stage_ops flags
//     the row blocks of the tiles it stages that hold one (once a batch,
//     off the products). A fix-up pass after the forward
//     (ell_fwd_fix_kernel) sums again in plain f32 every row of a flagged
//     row block or of one whose scale is not finite, reads the rows no
//     block read, and sums again the columns that a flagged column block
//     reaches through any slot of a row group, pad slots included (cols
//     names them): Inf, NaN and finite entries as the plain sum gives
//     them. Every other entry keeps its bits. Flags and tags hold the
//     call's generation (the wrapper's count of calls; the scratch is
//     zeroed once, when it is allocated), so nothing is cleared between
//     calls. On the H100 a flag pass that read all of X before the
//     forward cost it 10-22% (it held registers the forward's second
//     block per SM needs, overlapped or not), and folding each X value
//     into x * 0 beside the split about 3%.
//   dX: the TPU sums dX over row blocks because its grid runs in order.
//     Here one block owns one (X group g, column block c, 128-column F
//     tile): the whole (BC x 128) tile of dX in f32 accumulators, written
//     once. Its k loop is the slots of c in g's x_div slices, in the order
//     the transposed block index (t_ptr, t_slot) lists them: one slot is
//     one 8-deep k step of mma.sync m16n8k8, A its tile transposed (m = the
//     tile's column, k = its row), B its row block's 8 dout rows. Pad slots
//     are not in the index and are not multiplied (their tiles are zero;
//     for finite dout the sum is the same). A column block without a slot gets
//     zeros. Neither operand is K-major in shared memory, so mma.sync and
//     not wgmma. Slots stream through a cp.async ring of kDxStages stages
//     of kDxSlots slots each (one 8-deep k step is too shallow to hide a
//     load behind), 16-byte copies where a row's run is whole and aligned,
//     zero-filled 4-byte copies of dout at ragged edges (rows past n_rows
//     and columns past F read as 0), plain loads for a tile row that is
//     not a whole number of 16-byte chunks. Tiles land raw (row-major, each
//     row padded so that the four rows a fragment load reads lie on
//     different banks) and dout rows padded the same way, so fragment
//     loads are conflict-free without reordering the copies. Eight warps:
//     warp (wm, wn) owns the 16-column fragments wm and wm + 4 of the
//     tile and 64 of the 128 F columns. A banded operator leaves most of a
//     tile's columns zero: a warp whose fragment of a slot's tile is zero
//     in every lane (a ballot) skips its products, and one with none live
//     skips the slot; the live fragments of a band lie side by side, and
//     side by side they fall to warps on different schedulers. An Inf or
//     NaN in dout, a tile or an int8 scale: the warps wm = 0 fold the
//     dout values (and the slot's scale) they read into x * 0, and the
//     sum of magnitudes by which every warp tests its tile fragments for
//     zero is not finite for an Inf or NaN; either flags the block. A
//     flagged block sums again in plain f32 the columns of its tile where
//     a slot's dout rows hold one and the rows where a slot's tile (or
//     scale) does (the skipped fragments and the split lose them). Pad
//     slots, which name column block 0 with zero tiles, put NaN there in
//     the plain sum: flagged blocks mark the row blocks they found a
//     non-finite dout in (with the call's generation, as the forward),
//     and a pad pass after dX (ell_dx_pad_kernel) writes that NaN, in
//     every column where a pad slot's scale is not finite. Two launches
//     per call.
//     The split is the forward's: f32 tiles take hi*hi + hi*lo + lo*hi,
//     bf16 tiles and int8 codes are exact in TF32 and take two. Each k step's
//     products are summed on the tensor cores from 0, the small cross
//     terms first and hi*hi last, so the step's partial is truncated once,
//     as hi*hi alone would be, and added into the f32 accumulator: one
//     accumulator, not two, so a warp holds 32 x 64 of dX and two blocks
//     fit on an SM. The int8 scale
//     (one per (s, row block), so one per k step) is copied beside the
//     slot and multiplies the slot's dout values before their split:
//     code * (scale * dout), one f32 rounding as the TPU kernel's
//     (code * scale) * dout has, and one multiply per B value where
//     scaling each step's partial would take one per accumulator; within
//     rtol 1e-5. What bounds it: issuing the copies (about 0.47 GB staged
//     per launch at the shape above, each tile once per F tile) and the
//     per-stage barrier, not the tensor cores: a wider F tile stages each
//     tile for more columns. No float atomics and no
//     second launch: dX is bit-equal from run to run.
//   dBlocks: the TPU kernel takes one slot per grid cell and reads its
//     column block's whole X slab over F for an 8-row tile: at the shape
//     above 12.1 GB of X per launch. Here the slots of an X group g (its
//     x_div slices) that name one column block c form a gathered matrix of
//     8-row dout strips that all contract against the same X slab. A block
//     owns (g, c, a tile of up to 16 such slots, found by scanning g's
//     column ids in slot order, pad slots included: 128 gathered dout rows;
//     an F chunk), and per 32-column F step stages once the 128 dout rows
//     and the X slab (BC rows, zero-padded to 128) with cp.async, three
//     steps ahead, in wgmma's K-major core-matrix layout: 0.77 GB of X per
//     launch at the shape above (and 0.77 GB of dout, as before). Each
//     thread splits the values it copied into TF32 (hi, lo) parts; two
//     warpgroups (64 rows x 128 columns each) issue wgmma m64n128k8 for the
//     step's three products, summed from 0 on the tensor cores and added
//     into f32 accumulators, while the threads split the next step. F is
//     split into chunks (at most 128 steps each, and enough blocks for two
//     waves); a block
//     writes its chunk's sum as a partial, and the last block of a tile to
//     finish (an integer ticket) adds the chunks in order 0, 1, ...: no
//     float atomics, bit-equal from run to run. What bounds it: moving the
//     1.54 GB staged per launch through L2 and shared memory (the three
//     products re-read their operands there), not the tensor cores.
// Every entry launches on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <float.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "smem.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kBR = 8;        // rows per row block (the containers' tiles)
constexpr int kMaxBC = 128;   // widest column block

constexpr int kGroupRB = 8;                       // row blocks per group
constexpr int kFwdMF = kGroupRB * kBR / 16;       // 16-row mma fragments
constexpr int kFwdWarps = 2 * kFwdMF;             // (fragment, column half)
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdTF = 32;                        // F columns per X slab
constexpr int kFwdNF = kFwdTF / 2 / 8;            // 8-column tiles per warp
constexpr int kXStride = kFwdTF + 8;              // staged X row, padded
constexpr int kStages = 2;                        // X slabs in flight
constexpr int kACap = 16384;                      // staged operand floats
constexpr int kMaxOps = kACap / (kGroupRB * kBR * 8);  // at the least K
constexpr int kFwdBlocksPerSM = 2;                // resident forward blocks
constexpr int kFwdWaves = 4;                      // blocks per SM to aim at

constexpr int kDxThreads = 256;  // 8 warps: 4 along BC x 2 along F
constexpr int kDxBlocksPerSM = 2;                 // resident dX blocks
constexpr int kDxTF = 128;                        // dX columns per block
constexpr int kDxMF = kMaxBC / 4 / 16;            // 16-row fragments a warp
constexpr int kDxNT = kDxTF / 2 / 8;              // 8-column tiles a warp
constexpr int kDxSlots = 2;                       // slots (k steps) a stage
constexpr int kDxStages = 3;                      // stages in flight
constexpr int kDxBStride = kDxTF + 8;             // staged dout row, floats
constexpr int kDxBBytes = kBR * kDxBStride * 4;   // one slot's dout rows

constexpr int kDbSlots = 16;                      // slots per dBlocks tile
constexpr int kDbRows = kDbSlots * kBR;           // gathered dout rows
constexpr int kDbTF = 32;                         // F columns per staged step
constexpr int kDbThreads = 256;                   // two warpgroups
constexpr int kDbAcc = 64;                        // accumulators a thread

enum Payload { kF32 = 0, kBF16 = 1, kI8 = 2 };

// a tile element as f32 (int8 codes unscaled)
__device__ __forceinline__ float tile_value(const float* p, size_t e) {
  return p[e];
}
__device__ __forceinline__ float tile_value(const __nv_bfloat16* p,
                                            size_t e) {
  return __bfloat162float(p[e]);
}
__device__ __forceinline__ float tile_value(const int8_t* p, size_t e) {
  return static_cast<float>(p[e]);
}

// --- the forward on TF32 tensor cores ---------------------------------------

// bf16 tiles and int8 codes are exact in TF32; f32 tiles are not
template <typename T>
__host__ __device__ constexpr bool exact_in_tf32() {
  return !std::is_same<T, float>::value;
}

// wait until at most kStages - 2 copy groups are in flight
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// First entry in t_slot[lo, hi) (sorted by row block) whose row block is
// >= rb.
__device__ __forceinline__ int lower_rb(const int* tsl, int lo, int hi,
                                        int MB, int rb) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tsl[mid] / MB < rb)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The shared state of a forward block: one batch of live column blocks
// of its row group, ascending, each with its sub-run [a, b) of t_slot, the
// mask of row blocks holding a slot there (bit 31: a row block holds two)
// and the columns [klo, khi) of the block in which any of those tiles is
// non-zero.
struct FwdBatch {
  int c[kMaxOps], a[kMaxOps], b[kMaxOps], klo[kMaxOps], khi[kMaxOps];
  unsigned mask[kMaxOps];
  int warp_n[kFwdWarps];
  int resume;
};

// Gather up to cap live column blocks from *c_from on, one column block
// per thread and binary search at a time; *c_from moves past them (to nbc
// when none are left). Returns the count, the same in every thread.
__device__ int gather_live(FwdBatch& L, const int* ptr, const int* tsl,
                           int* c_from, int nbc, int MB, int i0, int cap) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int n = 0, c0 = *c_from;
  while (c0 < nbc && n < cap) {
    const int c = c0 + tid;
    int a = 0, b = 0;
    if (c < nbc) {
      const int hi = ptr[c + 1];
      a = lower_rb(tsl, ptr[c], hi, MB, i0);
      b = lower_rb(tsl, a, hi, MB, i0 + kGroupRB);
    }
    const bool live = a < b;
    const unsigned ball = __ballot_sync(0xffffffffu, live);
    if (lane == 0) L.warp_n[warp] = __popc(ball);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kFwdWarps; ++w) {
      before += w < warp ? L.warp_n[w] : 0;
      total += L.warp_n[w];
    }
    const int rank = n + before + __popc(ball & ((1u << lane) - 1u));
    if (live && rank < cap) {
      L.c[rank] = c;
      L.a[rank] = a;
      L.b[rank] = b;
    }
    if (live && rank == cap) L.resume = c;  // the first one left over
    __syncthreads();
    if (n + total > cap) {
      c0 = L.resume;
      n = cap;
    } else {
      n += total;
      c0 += kFwdThreads;
    }
    __syncthreads();  // warp_n and resume are read before reuse
  }
  *c_from = min(c0, nbc);
  return n;
}

// Stage rows [k0, k1) of column block c's X slab (X rows c BC + k, F
// columns [f0, f0 + kFwdTF)) into rows k0.. of dst (rows of kXStride);
// rows past BC or n_cols and columns past F are 0.
template <bool kVec>
__device__ __forceinline__ void stage_x(float* dst, const float* xs, int c,
                                        int BC, int k0, int k1, int n_cols,
                                        int F, int f0) {
  const int r0 = c * BC;
  const int nr = min(BC, n_cols - r0);
  dst += k0 * kXStride;
  if (kVec) {  // F % 4 == 0 and X 16-byte aligned: 16-byte copies
    constexpr int kChunks = kFwdTF / 4;
    for (int q = threadIdx.x; q < (k1 - k0) * kChunks; q += kFwdThreads) {
      const int k = k0 + q / kChunks;
      const int f = (q % kChunks) * 4;
      const bool ok = k < nr && f0 + f < F;
      cp_async16(dst + (k - k0) * kXStride + f,
                 ok ? xs + (size_t)(r0 + k) * F + f0 + f : xs, ok ? 16 : 0);
    }
  } else {
    for (int q = threadIdx.x; q < (k1 - k0) * kFwdTF; q += kFwdThreads) {
      const int k = k0 + q / kFwdTF;
      const int f = q % kFwdTF;
      const bool ok = k < nr && f0 + f < F;
      cp_async4(dst + (k - k0) * kXStride + f,
                ok ? xs + (size_t)(r0 + k) * F + f0 + f : xs, ok ? 4 : 0);
    }
  }
}

// Index of operand element (row r of the group, k) in fragment order:
// float4 ((r / 16) * ks_n + k / 8) * 32 + lane, component reg, with lane
// and reg those of the m16n8k8 A fragment.
__device__ __forceinline__ int afrag_index(int r, int k, int ks_n) {
  const int rr = r & 15, kk = k & 7;
  return ((((r >> 4) * ks_n + (k >> 3)) * 32 + (rr & 7) * 4 + (kk & 3))
          << 2) + (rr >> 3) + 2 * (kk >> 2);
}

// Stage the batch's n operands into ops (op_size floats each), as (64 x kp)
// matrices in fragment order. Tiles enter raw (int8 codes unscaled). A
// row block's first slot on a column block is stored, a later one added
// (in a second pass, in order); row blocks without a slot are zero where
// their fragment partner has one, and left unwritten otherwise (their
// fragment is skipped). Each tile's loads are in flight together. Also
// finds each operand's non-zero columns [klo, khi), and sets rbf[i] = gen
// for each row block i of the slice whose tile holds an Inf or NaN.
template <typename T>
__device__ void stage_ops(FwdBatch& L, int n, float* ops, int op_size,
                          const int* tsl, const T* blocks, size_t slot0,
                          int MB, int BC, int kp, int i0, int* rbf,
                          int gen) {
  const int tid = threadIdx.x;
  const int ks_n = kp / 8;
  const int per = kBR * kp;  // elements of one tile
  if (tid < n) {  // the masks
    unsigned mask = 0;
    int prev = -1;
    for (int e = L.a[tid]; e < L.b[tid]; ++e) {
      const int rb = tsl[e] / MB - i0;
      if (rb == prev) mask |= 1u << 31;
      prev = rb;
      mask |= 1u << rb;
    }
    L.mask[tid] = mask;
    L.klo[tid] = kp;
    L.khi[tid] = 0;
  }
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {
    bool any = false;
    for (int k = 0; k < n; ++k) {
      if (pass == 1 && !(L.mask[k] >> 31)) continue;
      any = true;
      float* dst = ops + k * op_size;
      int prev = -1;
      int lo = kp, hi = 0;  // this thread's non-zero columns
      for (int e = L.a[k]; e < L.b[k]; ++e) {
        const int slot = tsl[e];
        const int rb = slot / MB - i0;
        const bool later = rb == prev;
        prev = rb;
        if (later != (pass == 1)) continue;
        const T* blk = blocks + (slot0 + slot) * kBR * BC;
        constexpr int kPer = kBR * kMaxBC / kFwdThreads;
        float v[kPer];
        bool bad = false;
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int q = tid + u * kFwdThreads;
          const int rl = q / kp, kc = q - rl * kp;
          v[u] = q < per && kc < BC
                     ? tile_value(blk, (size_t)rl * BC + kc)
                     : 0.0f;
          if (v[u] != 0.0f) {
            lo = min(lo, kc);
            hi = max(hi, kc + 1);
          }
          if constexpr (!std::is_same<T, int8_t>::value)
            bad = bad || !isfinite(v[u]);
        }
        if (bad) rbf[slot / MB] = gen;  // rare; stores of gen, no order
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int q = tid + u * kFwdThreads;
          if (q >= per) break;
          const int rl = q / kp;
          float* d = dst + afrag_index(rb * kBR + rl, q - rl * kp, ks_n);
          *d = later ? *d + v[u] : v[u];
        }
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (tid % 32 == 0) {
        atomicMin(&L.klo[k], lo);
        atomicMax(&L.khi[k], hi);
      }
      if (pass == 0) {
        const unsigned mask = L.mask[k];
        for (int rb = 0; rb < kGroupRB; ++rb) {
          if ((mask >> rb & 1u) || !(mask >> (rb ^ 1) & 1u)) continue;
          for (int q = tid; q < per; q += kFwdThreads) {
            const int rl = q / kp;
            dst[afrag_index(rb * kBR + rl, q - rl * kp, ks_n)] = 0.0f;
          }
        }
      }
    }
    if (pass == 0 || any) __syncthreads();
  }
}

// The warp's products for one staged X slab: its 16-row fragment m of the
// operand against its kFwdNF 8-column tiles of the slab, over the k steps
// [ks0, ks1) that hold the operand's non-zero columns. The hi * hi
// products go into acc through mma_tf32_add; the cross terms, about 2^-11
// of them, into their own accumulator acc_lo, whose truncation is as
// small: over hundreds of products a single accumulator's truncation
// would add up to more than f32 rounding.
template <bool kExactA>
__device__ __forceinline__ void fwd_products(float (&acc)[kFwdNF][4],
                                             float (&acc_lo)[kFwdNF][4],
                                             const float* xb,
                                             const float* op, unsigned mask,
                                             int m, int ks0, int ks1,
                                             int ks_n, int lane) {
  if (!(mask >> (2 * m) & 3u)) return;  // no slot in these 16 rows
  // bf16 tiles and int8 codes are exact in TF32: only X is split, unless
  // two tiles were summed
  const bool split_a = !kExactA || (mask >> 31);
  const int gid = lane / 4, tig = lane % 4;
  const float4* af = reinterpret_cast<const float4*>(op) + m * ks_n * 32 +
                     lane;
  const float* x0 = xb + (ks0 * 8 + tig) * kXStride + gid;
  for (int ks = ks0; ks < ks1; ++ks, x0 += 8 * kXStride) {
    const float4 v = af[ks * 32];
    unsigned ah[4], al[4];
    if (split_a) {
      split_tf32(v.x, ah[0], al[0]);
      split_tf32(v.y, ah[1], al[1]);
      split_tf32(v.z, ah[2], al[2]);
      split_tf32(v.w, ah[3], al[3]);
    } else {
      ah[0] = __float_as_uint(v.x);
      ah[1] = __float_as_uint(v.y);
      ah[2] = __float_as_uint(v.z);
      ah[3] = __float_as_uint(v.w);
    }
    unsigned bh[kFwdNF][2], bl[kFwdNF][2];
#pragma unroll
    for (int n = 0; n < kFwdNF; ++n) {
      split_tf32(x0[n * 8], bh[n][0], bl[n][0]);
      split_tf32(x0[4 * kXStride + n * 8], bh[n][1], bl[n][1]);
    }
    if (split_a) {
#pragma unroll
      for (int n = 0; n < kFwdNF; ++n)
        mma_tf32(acc_lo[n], al, bh[n][0], bh[n][1]);
    }
#pragma unroll
    for (int n = 0; n < kFwdNF; ++n)
      mma_tf32(acc_lo[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
    for (int n = 0; n < kFwdNF; ++n)
      mma_tf32_add(acc[n], ah, bh[n][0], bh[n][1]);
  }
}

// Dynamic shared memory of the forward: kStages X slabs and the operands.
inline size_t fwd_smem_bytes(int kp) {
  return sizeof(float) * ((size_t)kStages * kp * kXStride + kACap);
}

// The forward's plain f32 sum for output row `row` of slice s, column f:
// every slot of its row block, pad slots included (their zero tiles name
// column block 0), each tile entry times its X value (rows past n_cols
// read 0), int8 codes times the row block's scale first, as the plain
// version takes them. For the rare entries that an Inf or NaN reaches.
template <typename T>
__device__ __noinline__ float fwd_plain_entry(
    const int* __restrict__ cols, const T* __restrict__ blocks,
    const float* __restrict__ scale, const float* __restrict__ xs, int s,
    int row, int f, int NB, int MB, int BC, int n_cols, int F) {
  const int i = row / kBR;
  const size_t rb = (size_t)s * NB + i;
  const float sc = scale != nullptr ? scale[rb] : 1.0f;
  float v = 0.0f;
  for (int j = 0; j < MB; ++j) {
    const int c = cols[rb * MB + j];
    const T* tile = blocks + ((rb * MB + j) * kBR + row % kBR) * BC;
    for (int k = 0; k < BC; ++k) {
      const int xr = c * BC + k;
      v = fmaf(tile_value(tile, k) * sc,
               xr < n_cols ? xs[(size_t)xr * F + f] : 0.0f, v);
    }
  }
  return v;
}

// the fix-up pass takes an F tile a warp, a column a lane
static_assert(kFwdTF == 32, "a lane per column of a forward F tile");

template <typename T, bool kVec>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocksPerSM)
ell_fwd_kernel(const int* __restrict__ t_ptr, const int* __restrict__ t_slot,
               const T* __restrict__ blocks, const float* __restrict__ scale,
               const float* __restrict__ x, int* __restrict__ staged,
               int* __restrict__ flags, int* __restrict__ rbf, int gen,
               float* __restrict__ out, int S, int NB, int MB, int BC,
               int nbc, int n_rows, int n_cols, int F, int x_div,
               int n_chunks) {
  extern __shared__ float4 smem4[];
  __shared__ FwdBatch L;
  float* xbuf = reinterpret_cast<float*>(smem4);  // kStages slabs
  const int kp = (BC + 7) / 8 * 8;                // K padded to the mma depth
  const int ks_n = kp / 8;
  const int slab = kp * kXStride;
  const int op_size = kFwdMF * 16 * kp;           // one operand, 64 x kp
  float* ops = xbuf + kStages * slab;
  const int cap = min(kMaxOps, kACap / op_size);
  const int n_groups = (NB + kGroupRB - 1) / kGroupRB;
  const int n_ft = (F + kFwdTF - 1) / kFwdTF;
  int bid = blockIdx.x;
  const int grp = bid % n_groups;
  bid /= n_groups;
  const int G = S / x_div;
  const int g = bid % G;                          // the X its slices read
  // this block's F tiles: ch, ch + n_chunks, ...; the blocks in flight
  // walk F side by side, so the X they read stays in L2
  const int ch = bid / G;
  const int n_tiles = (n_ft - ch + n_chunks - 1) / n_chunks;
  const int i0 = grp * kGroupRB;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m = warp % kFwdMF, half = warp / kFwdMF;
  const int gid = lane / 4, tig = lane % 4;
  const float* xs = x + (size_t)g * n_cols * F;

  float acc[kFwdNF][4], acc_lo[kFwdNF][4];
#pragma unroll
  for (int n = 0; n < kFwdNF; ++n)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[n][v] = acc_lo[n][v] = 0.0f;

  // the epilogue of F tile t: rows gid and gid + 8 of the warp's fragment,
  // columns 2 tig and 2 tig + 1 of each 8-column tile, times the row
  // block's int8 scale; added to what an earlier batch wrote when
  // accumulate. Zeroes the accumulator. True in every lane when an Inf or
  // NaN in X reached the warp's products: it left NaN in every row of its
  // column of acc_lo, so row gid of each lane's columns tells (a finite
  // overflow flags too).
  auto store = [&](int s, int t, bool accumulate) {
    const bool pair = (F & 1) == 0;
    float z = 0.0f;
#pragma unroll
    for (int n = 0; n < kFwdNF; ++n) z += acc_lo[n][0] + acc_lo[n][1];
    const bool bad = !(fabsf(z) <= FLT_MAX);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m * 16 + h * 8 + gid;
      const int row = i0 * kBR + r;
      if (row >= n_rows) continue;
      const float sc =
          scale != nullptr ? scale[(size_t)s * NB + i0 + r / kBR] : 1.0f;
      float* o = out + ((size_t)s * n_rows + row) * F;
#pragma unroll
      for (int n = 0; n < kFwdNF; ++n) {
        const int col = (ch + t * n_chunks) * kFwdTF + half * (kFwdTF / 2) +
                        n * 8 + 2 * tig;
        float v0 = (acc[n][2 * h] + acc_lo[n][2 * h]) * sc;
        float v1 = (acc[n][2 * h + 1] + acc_lo[n][2 * h + 1]) * sc;
        if (pair && col + 1 < F) {
          float2* o2 = reinterpret_cast<float2*>(o + col);
          if (accumulate) {
            const float2 w = *o2;
            v0 += w.x;
            v1 += w.y;
          }
          *o2 = make_float2(v0, v1);
        } else {
          if (col < F) o[col] = accumulate ? o[col] + v0 : v0;
          if (col + 1 < F) o[col + 1] = accumulate ? o[col + 1] + v1 : v1;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kFwdNF; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[n][v] = acc_lo[n][v] = 0.0f;
    return __any_sync(0xffffffffu, bad);
  };

  // The X group's slices one after the other, each re-reading the same X
  // slabs while they are in L2. Per slice, batches of up to cap live
  // column blocks: their operands are staged once and reused over the
  // block's n_tiles F tiles; X slabs stream through a ring of kStages, one
  // (F tile, column block) after the other. A row group with more live
  // column blocks than fit takes more batches, each adding its sum into
  // the output (in a fixed order).
  for (int s = g * x_div; s < (g + 1) * x_div; ++s) {
  const int* ptr = t_ptr + (size_t)s * (nbc + 1);
  const int* tsl = t_slot + (size_t)s * NB * MB;
  const size_t slot0 = (size_t)s * NB * MB;
  int c_from = 0;
  for (int batch = 0;; ++batch) {
    const int n = gather_live(L, ptr, tsl, &c_from, nbc, MB, i0, cap);
    if (n == 0) {
      if (batch == 0)  // no slot in the group: its rows are 0
        for (int t = 0; t < n_tiles; ++t) store(s, t, false);
      break;
    }
    stage_ops(L, n, ops, op_size, tsl, blocks, slot0, MB, BC, kp, i0,
              rbf + (size_t)s * NB, gen);
    // operand k's k steps: its non-zero columns, in steps of 8
    auto ks_lo = [&](int k) { return L.klo[k] / 8; };
    auto ks_hi = [&](int k) { return max(ks_lo(k), (L.khi[k] + 7) / 8); };
    // the X rows whose every F tile the group's blocks read (and fold);
    // the other chunks stage the same rows
    if (ch == 0)
      for (int k = 0; k < n; ++k) {
        const int r0 = L.c[k] * BC;
        const int r1 = r0 + min(min(8 * ks_hi(k), BC), n_cols - r0);
        for (int r = r0 + 8 * ks_lo(k) + threadIdx.x; r < r1;
             r += kFwdThreads)
          staged[(size_t)g * n_cols + r] = gen;
      }
    auto stage = [&](int t) {
      const int k = t % n;
      stage_x<kVec>(xbuf + (t % kStages) * slab, xs, L.c[k], BC, 8 * ks_lo(k),
                    8 * ks_hi(k), n_cols, F, (ch + t / n * n_chunks) * kFwdTF);
    };
    const int total = n_tiles * n;
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < total) stage(t);
      cp_async_commit();
    }
    for (int t = 0; t < total; ++t) {
      cp_async_wait_stage();
      __syncthreads();  // slab t has landed; slab t - 1's readers are done
      if (t + kStages - 1 < total) stage(t + kStages - 1);
      cp_async_commit();
      const int k = t % n;
      fwd_products<exact_in_tf32<T>()>(
          acc, acc_lo, xbuf + (t % kStages) * slab + half * (kFwdTF / 2),
          ops + k * op_size, L.mask[k], m, ks_lo(k), ks_hi(k), ks_n, lane);
      // an Inf or NaN in an X value the warp multiplied left its column of
      // acc_lo NaN (the split's lo of it is NaN, and NaN times any A value,
      // 0 included, is NaN): flag (X group, column block, F tile) for the
      // batch's column blocks, for the fix-up pass (rare; stores of gen,
      // no order; after an overflow the pass finds nothing to redo)
      if (k == n - 1 && store(s, t / n, batch > 0) && lane == 0)
        for (int kk = 0; kk < n; ++kk)
          flags[((size_t)g * nbc + L.c[kk]) * n_ft + ch + t / n * n_chunks] =
              gen;
    }
    __syncthreads();  // the operands and slabs are free for the next batch
    if (c_from >= nbc) break;
  }

  }
}

// The forward's fix-up pass, after it on the stream: one block per (X
// group g, kFixTiles F tiles). Marks equal to gen are this call's. (0)
// Every row of a row block of g's slices whose tile the forward flagged
// (rbf) or whose int8 scale is not finite is summed again in plain f32
// over the block's F tiles. The forward folds every X value it reads and
// flags (g, column block, F tile) where one was Inf or NaN, and tags the
// X rows it reads in every F tile (staged). The plain sum also
// multiplies what the forward skips: X rows outside a group's
// [klo, khi), and column block 0 through pad slots, so (1) the rows that
// no group read are read here (none at the N = 500 shape: a band reads
// every row) and flag the same way; (2) for each (slice, row group, F
// tile) whose slots, pad slots included (cols), name a flagged column
// block, a warp finds the Inf and NaN columns of those blocks' rows and
// sums those columns again in plain f32 in every row of the group (a
// fragment partner's zero rows took 0 x Inf there too), over the
// forward's store. Lists of what to read and fix are gathered in shared
// memory, 256 at a time; with finite operands one round of reads of the
// marks, the scales and its flags finds nothing to do. Where (0) and (2)
// meet, both write the same plain sum.
constexpr int kFixTiles = 8;

template <typename T>
__global__ void __launch_bounds__(256) ell_fwd_fix_kernel(
    const int* __restrict__ cols, const T* __restrict__ blocks,
    const float* __restrict__ scale, const float* __restrict__ x,
    const int* __restrict__ staged, int* __restrict__ flags,
    const int* __restrict__ rbf, int gen, float* __restrict__ out, int NB,
    int MB, int BC, int nbc, int n_rows, int n_cols, int F, int x_div) {
  __shared__ int s_list[256];
  __shared__ int s_n;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_ft = (F + kFwdTF - 1) / kFwdTF;
  const int n_fb = (n_ft + kFixTiles - 1) / kFixTiles;
  const int g = blockIdx.x / n_fb;
  const int ft0 = (blockIdx.x % n_fb) * kFixTiles;
  const int nt = min(kFixTiles, n_ft - ft0);
  const float* xs = x + (size_t)g * n_cols * F;
  const int n_groups = (NB + kGroupRB - 1) / kGroupRB;
  // finite operands (the rule): one round of reads finds nothing to do
  bool work = false;
  for (int q = tid; q < x_div * NB; q += 256) {
    const size_t rb = (size_t)g * x_div * NB + q;
    work |= rbf[rb] == gen || (scale != nullptr && !isfinite(scale[rb]));
  }
  for (int k = tid; k < n_cols; k += 256)
    work |= staged[(size_t)g * n_cols + k] != gen;
  for (int q = tid; q < nbc * nt; q += 256)
    work |= flags[((size_t)g * nbc + q / nt) * n_ft + ft0 + q % nt] == gen;
  if (!__syncthreads_or(work)) return;
  // 0. row blocks with an Inf or NaN in a tile or the scale: whole rows
  for (int base = 0; base < x_div * NB; base += 256) {
    if (tid == 0) s_n = 0;
    __syncthreads();
    const int q = base + tid;  // (slice of g, row block)
    const size_t rb = (size_t)g * x_div * NB + q;
    if (q < x_div * NB &&
        (rbf[rb] == gen || (scale != nullptr && !isfinite(scale[rb]))))
      s_list[atomicAdd(&s_n, 1)] = q;
    __syncthreads();
    for (int w = warp; w < s_n * nt; w += 8) {
      const int q2 = s_list[w / nt];
      const int s = g * x_div + q2 / NB, i = q2 % NB;
      const int f = (ft0 + w % nt) * kFwdTF + lane;  // a lane a column
      if (f >= F) continue;
      for (int row = i * kBR; row < min(n_rows, (i + 1) * kBR); ++row)
        out[((size_t)s * n_rows + row) * F + f] = fwd_plain_entry(
            cols, blocks, scale, xs, s, row, f, NB, MB, BC, n_cols, F);
    }
    __syncthreads();
  }
  // 1. rows no group read: flag their column blocks' Inf and NaN tiles
  for (int base = 0; base < n_cols; base += 256) {
    if (tid == 0) s_n = 0;
    __syncthreads();
    const int k = base + tid;
    if (k < n_cols && staged[(size_t)g * n_cols + k] != gen)
      s_list[atomicAdd(&s_n, 1)] = k;
    __syncthreads();
    for (int q = warp; q < s_n * nt; q += 8) {
      const int k2 = s_list[q / nt], ft = ft0 + q % nt;
      const int f = ft * kFwdTF + lane;
      const bool bad = f < F && !isfinite(xs[(size_t)k2 * F + f]);
      if (__any_sync(0xffffffffu, bad) && lane == 0)
        flags[((size_t)g * nbc + k2 / BC) * n_ft + ft] = gen;
    }
    __syncthreads();
  }
  // with no flag in the block's F tiles (finite X), nothing more to fix
  if (tid == 0) s_n = 0;
  __syncthreads();
  for (int q = tid; q < nbc * nt; q += 256)
    if (flags[((size_t)g * nbc + q / nt) * n_ft + ft0 + q % nt] == gen)
      s_n = 1;
  __syncthreads();
  if (!s_n) return;
  // 2. (slice, row group, F tile) items that a flagged block reaches
  const int items = x_div * n_groups * nt;
  for (int base = 0; base < items; base += 256) {
    if (tid == 0) s_n = 0;
    __syncthreads();
    const int q = base + tid;
    if (q < items) {
      const int ft = ft0 + q % nt, i0 = (q / nt) % n_groups * kGroupRB;
      const int s = g * x_div + q / nt / n_groups;
      bool hit = false;
      for (int e = 0; e < kGroupRB * MB && !hit; ++e) {
        const int i = i0 + e / MB;
        if (i >= NB) break;
        hit = flags[((size_t)g * nbc + cols[((size_t)s * NB + i) * MB +
                                            e % MB]) * n_ft + ft] == gen;
      }
      if (hit) s_list[atomicAdd(&s_n, 1)] = q;
    }
    __syncthreads();
    for (int w = warp; w < s_n; w += 8) {
      const int q2 = s_list[w];
      const int ft = ft0 + q2 % nt, i0 = (q2 / nt) % n_groups * kGroupRB;
      const int s = g * x_div + q2 / nt / n_groups;
      const int f = ft * kFwdTF + lane;  // a lane a column
      bool bad = false;
      for (int e = 0; e < kGroupRB * MB && f < F; ++e) {
        const int i = i0 + e / MB;
        if (i >= NB) break;
        const int r0 = cols[((size_t)s * NB + i) * MB + e % MB] * BC;
        for (int r = r0; r < min(r0 + BC, n_cols); ++r)
          bad = bad || !isfinite(xs[(size_t)r * F + f]);
      }
      if (!bad) continue;
      for (int row = i0 * kBR; row < min(n_rows, (i0 + kGroupRB) * kBR);
           ++row)
        out[((size_t)s * n_rows + row) * F + f] = fwd_plain_entry(
            cols, blocks, scale, xs, s, row, f, NB, MB, BC, n_cols, F);
    }
    __syncthreads();
  }
}
// --- dX on TF32 tensor cores -----------------------------------------------

// A staged tile row in bytes: kMaxBC elements and a pad that puts the rows
// tig = 0..3, which one fragment load reads, on different banks (8 floats
// further; 16 bytes further for bf16 and int8), 16-byte aligned.
template <typename T>
__host__ __device__ constexpr int dx_row_bytes() {
  return kMaxBC * (int)sizeof(T) + (sizeof(T) == 4 ? 32 : 16);
}
// one staged slot: its tile's 8 rows, then its row block's 8 dout rows
template <typename T>
__host__ __device__ constexpr int dx_slot_bytes() {
  return kBR * dx_row_bytes<T>() + kDxBBytes;
}
template <typename T>
inline size_t dx_smem_bytes() {
  return (size_t)kDxStages * kDxSlots * dx_slot_bytes<T>();
}

// A dX block that met an Inf or NaN (its fold): marks each of its
// columns where one of its slots' dout rows holds one, and each such row
// block in rb_flags with this call's generation gen (for the pad pass,
// ell_dx_pad_kernel); marks each of its rows m where a slot's tile holds
// one in column m, or every row where a slot's int8 scale is not finite;
// then sums the marked columns and rows again in plain f32 over its slots
// and writes them over the store: Inf and NaN as the plain sum gives them
// (0 x Inf is NaN, each Inf of its sign; tile rows past n_rows meet dout
// rows that read 0), which the products do not, as they skip zero
// fragments and the TF32 split turns a NaN such as 0x7fffffff into -0.
// Out of line and after the store, so that the products keep their
// registers; every thread of the block calls it. Integer OR into shared
// memory and stores of gen: no order to keep.
template <typename T>
__device__ __noinline__ void dx_fix_non_finite(
    const int* __restrict__ t_ptr, const int* __restrict__ t_slot,
    const T* __restrict__ blocks, const float* __restrict__ scale,
    const float* __restrict__ dout, float* __restrict__ dx,
    int* __restrict__ rb_flags, int gen, unsigned* s_bad, int NB, int MB,
    int BC, int nbc, int n_rows, int n_cols, int F, int x_div, int c, int g,
    int f0) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  __shared__ unsigned s_bad_m[kMaxBC / 32];  // rows of the tile to redo
  const int tid = threadIdx.x;
  const int s0 = g * x_div;
  const size_t per_slice = (size_t)NB * MB;
  if (tid < kDxTF / 32) s_bad[tid] = 0u;
  if (tid < kMaxBC / 32) s_bad_m[tid] = 0u;
  __syncthreads();
  for (int s = s0; s < s0 + x_div; ++s) {
    const int* ptr = t_ptr + (size_t)s * (nbc + 1);
    for (int e = ptr[c]; e < ptr[c + 1]; ++e) {
      const int slot = t_slot[(size_t)s * per_slice + e], i = slot / MB;
      bool hit = false;
      for (int q = tid; q < kBR * kDxTF; q += kDxThreads) {
        const int r = i * kBR + q / kDxTF, lc = q % kDxTF;
        if (r < n_rows && f0 + lc < F &&
            !isfinite(dout[((size_t)s * n_rows + r) * F + f0 + lc])) {
          atomicOr(&s_bad[lc / 32], 1u << (lc % 32));
          hit = true;
        }
      }
      if (hit) rb_flags[(size_t)s * NB + i] = gen;
      const bool all = kScaled && !isfinite(scale[(size_t)s * NB + i]);
      const T* tile = blocks + ((size_t)s * per_slice + slot) * kBR * BC;
      for (int q = tid; q < kBR * BC; q += kDxThreads) {
        const int m = q % BC;
        if (all || (!kScaled && !isfinite(tile_value(tile, q))))
          atomicOr(&s_bad_m[m / 32], 1u << (m % 32));
      }
    }
  }
  __syncthreads();
  for (int q = tid; q < kMaxBC * kDxTF; q += kDxThreads) {
    const int m = q / kDxTF, lc = q % kDxTF, f = f0 + lc;
    if (!((s_bad[lc / 32] >> (lc % 32)) & 1u) &&
        !((s_bad_m[m / 32] >> (m % 32)) & 1u))
      continue;
    if (m >= BC || c * BC + m >= n_cols || f >= F) continue;
    float v = 0.0f;
    for (int s = s0; s < s0 + x_div; ++s) {
      const int* ptr = t_ptr + (size_t)s * (nbc + 1);
      for (int e = ptr[c]; e < ptr[c + 1]; ++e) {
        const int slot = t_slot[(size_t)s * per_slice + e], i = slot / MB;
        const float sc = kScaled ? scale[(size_t)s * NB + i] : 1.0f;
        const T* tile = blocks + ((size_t)s * per_slice + slot) * kBR * BC + m;
        for (int r = 0; r < kBR; ++r) {
          const int row = i * kBR + r;
          v = fmaf(tile_value(tile, (size_t)r * BC) * sc,
                   row < n_rows ? dout[((size_t)s * n_rows + row) * F + f]
                                : 0.0f,
                   v);
        }
      }
    }
    dx[((size_t)g * n_cols + c * BC + m) * F + f] = v;
  }
}

// One block per (X group g, F tile, column block c; c fastest): dX rows
// c BC.. of group g, columns f0..f0 + kDxTF. a_vec: tile rows are whole
// 16-byte chunks and aligned; d_vec: F % 4 == 0 and dout aligned.
template <typename T>
__global__ void __launch_bounds__(kDxThreads, kDxBlocksPerSM)
ell_bwd_dx_kernel(const int* __restrict__ t_ptr,
                  const int* __restrict__ t_slot, const T* __restrict__ blocks,
                  const float* __restrict__ scale,
                  const float* __restrict__ dout, float* __restrict__ dx,
                  int* __restrict__ rb_flags, int gen, int NB, int MB, int BC,
                  int nbc, int n_rows, int n_cols, int F, int x_div,
                  int a_vec, int d_vec) {
  extern __shared__ float4 smem4[];
  __shared__ float s_scale[kDxStages][kDxSlots];
  unsigned char* sbuf = reinterpret_cast<unsigned char*>(smem4);
  constexpr int kRow = dx_row_bytes<T>();
  constexpr int kSlot = dx_slot_bytes<T>();
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  // warp (wm, wn) owns the 16-column fragments wm and wm + 4 of the tile
  // and half of the F columns: a band's live fragments, side by side,
  // fall to warps on different schedulers (warp % 4)
  const int wm = warp / 2, wn = warp % 2;
  const int n_ft = (F + kDxTF - 1) / kDxTF;
  int bid = blockIdx.x;
  const int c = bid % nbc;
  bid /= nbc;
  const int f0 = (bid % n_ft) * kDxTF;
  const int g = bid / n_ft;
  const int s0 = g * x_div;
  const size_t per_slice = (size_t)NB * MB;

  int n_slots = 0;  // c's slots in g's slices
  for (int s = s0; s < s0 + x_div; ++s) {
    const int* ptr = t_ptr + (size_t)s * (nbc + 1);
    n_slots += ptr[c + 1] - ptr[c];
  }
  const int n_st = (n_slots + kDxSlots - 1) / kDxSlots;

  // the next stage's slots (slice, slot), read one stage ahead of their
  // copies so the index loads are in flight during the products
  int cur_s = s0;
  int cur_e = t_ptr[(size_t)s0 * (nbc + 1) + c];
  int cur_end = t_ptr[(size_t)s0 * (nbc + 1) + c + 1];
  int fetched = 0;
  int nx_s[kDxSlots], nx_slot[kDxSlots];
  auto fetch = [&]() {
#pragma unroll
    for (int j = 0; j < kDxSlots; ++j) {
      nx_s[j] = nx_slot[j] = 0;
      if (fetched == n_slots) continue;
      while (cur_e == cur_end) {  // the next slice with a slot on c
        const int* ptr = t_ptr + (size_t)++cur_s * (nbc + 1);
        cur_e = ptr[c];
        cur_end = ptr[c + 1];
      }
      nx_s[j] = cur_s;
      nx_slot[j] = t_slot[(size_t)cur_s * per_slice + cur_e++];
      ++fetched;
    }
  };
  // copy stage t's tiles and dout rows into ring place t % kDxStages
  auto stage = [&](int t) {
    const int nj = min(kDxSlots, n_slots - t * kDxSlots);
    unsigned char* base = sbuf + (size_t)(t % kDxStages) * kDxSlots * kSlot;
#pragma unroll
    for (int j = 0; j < kDxSlots; ++j) {
      if (j >= nj) break;
      const int s = nx_s[j], slot = nx_slot[j];
      const int row0 = slot / MB * kBR;
      unsigned char* a_dst = base + j * kSlot;
      float* b_dst = reinterpret_cast<float*>(a_dst + kBR * kRow);
      const T* tile = blocks + ((size_t)s * per_slice + slot) * kBR * BC;
      if (a_vec) {
        const int cpr = BC * (int)sizeof(T) / 16;  // 16-byte chunks a row
        const unsigned char* src = reinterpret_cast<const unsigned char*>(tile);
        for (int q = tid; q < kBR * cpr; q += kDxThreads) {
          const int r = q / cpr, k = q - r * cpr;
          cp_async16(reinterpret_cast<float*>(a_dst + r * kRow + k * 16),
                     reinterpret_cast<const float*>(
                         src + ((size_t)r * BC * sizeof(T) + k * 16)),
                     16);
        }
      } else {
        for (int q = tid; q < kBR * BC; q += kDxThreads) {
          const int r = q / BC;
          reinterpret_cast<T*>(a_dst + r * kRow)[q - r * BC] = tile[q];
        }
      }
      const float* src = dout + ((size_t)s * n_rows + row0) * F + f0;
      if (d_vec) {
        constexpr int kChunks = kDxTF / 4;
        for (int q = tid; q < kBR * kChunks; q += kDxThreads) {
          const int r = q / kChunks, f = (q % kChunks) * 4;
          const bool ok = row0 + r < n_rows && f0 + f < F;
          cp_async16(b_dst + r * kDxBStride + f,
                     ok ? src + (size_t)r * F + f : dout, ok ? 16 : 0);
        }
      } else {
        for (int q = tid; q < kBR * kDxTF; q += kDxThreads) {
          const int r = q / kDxTF, f = q % kDxTF;
          const bool ok = row0 + r < n_rows && f0 + f < F;
          cp_async4(b_dst + r * kDxBStride + f,
                    ok ? src + (size_t)r * F + f : dout, ok ? 4 : 0);
        }
      }
      if (kScaled && tid == 0)  // with the copies: no wait on the index
        cp_async4(&s_scale[t % kDxStages][j], scale + (size_t)s * NB +
                  slot / MB, 4);
    }
  };

  // a fragment that straddles BC reads the columns up to the next multiple
  // of 16: zero them once (nothing is copied there)
  if (BC % 16 != 0) {
    const int lo = BC * (int)sizeof(T);
    const int pad = (BC + 15) / 16 * 16 * (int)sizeof(T) - lo;
    for (int q = tid; q < kDxStages * kDxSlots * kBR * pad;
         q += kDxThreads) {
      const int row = q / pad;  // (ring slot) * 8 + tile row
      sbuf[(row / kBR) * kSlot + (row % kBR) * kRow + lo + q % pad] = 0;
    }
  }

  float acc[kDxMF][kDxNT][4];
#pragma unroll
  for (int mf = 0; mf < kDxMF; ++mf)
#pragma unroll
    for (int n = 0; n < kDxNT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mf][n][v] = 0.0f;
  // set where a dout value that a warp read was Inf or NaN
  __shared__ int s_nonfinite;
  __shared__ unsigned s_bad[kDxTF / 32];
  if (tid == 0) s_nonfinite = 0;  // seen after the k loop's barriers

  // the warp's products for stage t: per slot (one k step), its fragments
  // of the transposed tile that are not zero in every lane, against its
  // kDxNT 8-column tiles of the dout rows. The dout fragments are read
  // beside the tile's, not after the ballot, so the two loads overlap.
  // Warps wm = 0 also flag an Inf or NaN among the dout values and the
  // slot's scale, every warp one among its tile values, from the sum of
  // their magnitudes that the zero test takes (not finite for an Inf or
  // NaN; an overflow flags too, and the rescan finds nothing).
  auto products = [&](int t) {
    const unsigned char* base =
        sbuf + (size_t)(t % kDxStages) * kDxSlots * kSlot;
    const int nj = min(kDxSlots, n_slots - t * kDxSlots);
#pragma unroll
    for (int j = 0; j < kDxSlots; ++j) {
      if (j >= nj) break;
      const unsigned char* a = base + j * kSlot;
      const float* b = reinterpret_cast<const float*>(a + kBR * kRow) +
                       tig * kDxBStride + wn * (kDxTF / 2) + gid;
      float av[kDxMF][4], bv[kDxNT][2];
#pragma unroll
      for (int mf = 0; mf < kDxMF; ++mf) {
        // A[m][k] = tile[k][m]: (gid, tig), (gid + 8, tig), (gid, tig + 4),
        // (gid + 8, tig + 4); nothing past the fragment that holds BC - 1
        const int m = (wm + 4 * mf) * 16;
        const T* r0 = reinterpret_cast<const T*>(a + tig * kRow) + m + gid;
        const T* r4 = reinterpret_cast<const T*>(a + (tig + 4) * kRow) + m +
                      gid;
        const bool in = m < BC;
        av[mf][0] = in ? tile_value(r0, 0) : 0.0f;
        av[mf][1] = in ? tile_value(r0, 8) : 0.0f;
        av[mf][2] = in ? tile_value(r4, 0) : 0.0f;
        av[mf][3] = in ? tile_value(r4, 8) : 0.0f;
      }
#pragma unroll
      for (int n = 0; n < kDxNT; ++n) {
        bv[n][0] = b[n * 8];
        bv[n][1] = b[4 * kDxBStride + n * 8];
      }
      if (wm == 0) {  // the warps of one F half read the same dout values
        float z = 0.0f;  // NaN if an Inf or NaN passes (x * 0), else 0
#pragma unroll
        for (int n = 0; n < kDxNT; ++n) {
          z = fmaf(bv[n][0], 0.0f, z);
          z = fmaf(bv[n][1], 0.0f, z);
        }
        if constexpr (kScaled)
          z = fold_non_finite(s_scale[t % kDxStages][j], z);
        if (isnan(z)) s_nonfinite = 1;
      }
      bool live[kDxMF];
      bool any = false;
#pragma unroll
      for (int mf = 0; mf < kDxMF; ++mf) {
        // 0 only when all four are 0 (no cancellation, denormals kept)
        const float mag = fabsf(av[mf][0]) + fabsf(av[mf][1]) +
                          fabsf(av[mf][2]) + fabsf(av[mf][3]);
        live[mf] = __any_sync(0xffffffffu, mag != 0.0f);
        any = any || live[mf];
        if constexpr (!kScaled)
          if (!(mag <= FLT_MAX)) s_nonfinite = 1;  // Inf or NaN
      }
      if (!any) continue;  // the same in every lane
      const float sc = kScaled ? s_scale[t % kDxStages][j] : 1.0f;
      unsigned bh[kDxNT][2], bl[kDxNT][2];
#pragma unroll
      for (int n = 0; n < kDxNT; ++n)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          split_tf32_rn(kScaled ? bv[n][u] * sc : bv[n][u], bh[n][u],
                        bl[n][u]);
#pragma unroll
      for (int mf = 0; mf < kDxMF; ++mf) {
        if (!live[mf]) continue;
        unsigned ah[4], al[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if constexpr (exact_in_tf32<T>())
            ah[v] = __float_as_uint(av[mf][v]);
          else
            split_tf32_rn(av[mf][v], ah[v], al[v]);
        }
#pragma unroll
        for (int n = 0; n < kDxNT; ++n) {
          // the step's sum from 0, cross terms first: one truncation, of
          // the step's partial, as hi * hi alone would take
          float p[4];
          if constexpr (exact_in_tf32<T>()) {
            mma_tf32_zero(p, ah, bl[n][0], bl[n][1]);
          } else {
            mma_tf32_zero(p, al, bh[n][0], bh[n][1]);
            mma_tf32(p, ah, bl[n][0], bl[n][1]);
          }
          mma_tf32(p, ah, bh[n][0], bh[n][1]);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[mf][n][v] += p[v];
        }
      }
    }
  };

  for (int t = 0; t < kDxStages - 1; ++t) {
    if (t < n_st) {
      fetch();
      stage(t);
    }
    cp_async_commit();
  }
  fetch();
  for (int t = 0; t < n_st; ++t) {
    cp_async_wait<kDxStages - 2>();
    __syncthreads();  // stage t has landed; stage t - 1's readers are done
    if (t + kDxStages - 1 < n_st) {
      stage(t + kDxStages - 1);
      fetch();
    }
    cp_async_commit();
    products(t);
  }

  // D fragment: rows gid and gid + 8 of each 16-row fragment, columns
  // 2 tig and 2 tig + 1 of each 8-column tile
  const bool pair = (F & 1) == 0;
#pragma unroll
  for (int mf = 0; mf < kDxMF; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wm + 4 * mf) * 16 + h * 8 + gid;
      const int row = c * BC + m;
      if (m >= BC || row >= n_cols) continue;
      float* o = dx + ((size_t)g * n_cols + row) * F;
#pragma unroll
      for (int n = 0; n < kDxNT; ++n) {
        const int col = f0 + wn * (kDxTF / 2) + n * 8 + 2 * tig;
        const float v0 = acc[mf][n][2 * h], v1 = acc[mf][n][2 * h + 1];
        if (pair && col + 1 < F) {
          *reinterpret_cast<float2*>(o + col) = make_float2(v0, v1);
        } else {
          if (col < F) o[col] = v0;
          if (col + 1 < F) o[col + 1] = v1;
        }
      }
    }
  __syncthreads();  // the store is done; s_nonfinite set
  if (s_nonfinite)  // the same in every thread
    dx_fix_non_finite<T>(t_ptr, t_slot, blocks, scale, dout, dx, rb_flags,
                         gen, s_bad, NB, MB, BC, nbc, n_rows, n_cols, F,
                         x_div, c, g, f0);
}

// The pad pass of dX, after it on the stream: one block per X group g.
// Pad slots are zero tiles naming column block 0; dX leaves them out, but
// in the plain sum a pad slot of row block i puts 0 x dout there, NaN in
// each column where i's dout rows hold an Inf or NaN, in every row of
// column block 0. Such a row block was flagged by a dX block that staged
// it (rb_flags == gen) or, holding no populated slot, was staged by none:
// only those rows are read here (none at the N = 500 shape), 128 columns
// at a time. A row block with a pad slot whose int8 scale is not finite
// puts NaN (0 x Inf) in every column. The block counts each row block's
// populated slots from the transposed index in shared memory (x_div x NB
// ints).
__global__ void __launch_bounds__(256) ell_dx_pad_kernel(
    const int* __restrict__ t_ptr, const int* __restrict__ t_slot,
    const float* __restrict__ scale, const float* __restrict__ dout,
    const int* __restrict__ rb_flags, int gen, float* __restrict__ dx,
    int NB, int MB, int BC, int nbc, int n_rows, int n_cols, int F,
    int x_div) {
  extern __shared__ int n_pop[];  // (x_div, NB) populated slots
  __shared__ unsigned s_bad[kDxTF / 32];
  __shared__ int s_any, s_all;
  const int tid = threadIdx.x, g = blockIdx.x;
  const size_t per_slice = (size_t)NB * MB;
  for (int q = tid; q < x_div * NB; q += blockDim.x) n_pop[q] = 0;
  if (tid == 0) s_any = s_all = 0;
  __syncthreads();
  for (int sl = 0; sl < x_div; ++sl) {
    const int s = g * x_div + sl;
    const int n = t_ptr[(size_t)s * (nbc + 1) + nbc];
    for (int e = tid; e < n; e += blockDim.x)
      atomicAdd(&n_pop[sl * NB + t_slot[(size_t)s * per_slice + e] / MB], 1);
  }
  __syncthreads();
  // n_pop[q] becomes 1 where row block q's rows are read, else 0
  for (int q = tid; q < x_div * NB; q += blockDim.x) {
    const size_t rb = (size_t)g * x_div * NB + q;  // (slice, row block)
    const bool pad = n_pop[q] < MB;
    const bool read = pad && (n_pop[q] == 0 || rb_flags[rb] == gen);
    if (pad && scale != nullptr && !isfinite(scale[rb])) s_all = 1;
    n_pop[q] = read;
    if (read) s_any = 1;
  }
  __syncthreads();
  if (!s_any && !s_all) return;
  const int rows = min(BC, n_cols);
  for (int f0 = 0; f0 < F; f0 += kDxTF) {
    if (tid < kDxTF / 32) s_bad[tid] = 0u;
    __syncthreads();
    for (int q = 0; q < x_div * NB; ++q) {
      if (!n_pop[q]) continue;
      const int s = g * x_div + q / NB, i = q % NB;
      for (int e = tid; e < kBR * kDxTF; e += blockDim.x) {
        const int r = i * kBR + e / kDxTF, lc = e % kDxTF;
        if (r < n_rows && f0 + lc < F &&
            !isfinite(dout[((size_t)s * n_rows + r) * F + f0 + lc]))
          atomicOr(&s_bad[lc / 32], 1u << (lc % 32));
      }
    }
    __syncthreads();
    for (int e = tid; e < rows * kDxTF; e += blockDim.x) {
      const int m = e / kDxTF, lc = e % kDxTF;
      if ((s_all || (s_bad[lc / 32] >> (lc % 32)) & 1u) && f0 + lc < F)
        dx[((size_t)g * n_cols + m) * F + f0 + lc] =
            __uint_as_float(0x7fffffffu);
    }
    __syncthreads();  // s_bad's readers are done
  }
}

// --- dBlocks on wgmma -------------------------------------------------------

constexpr int kDbKC = kDbTF / 4;                  // 16-byte chunks a row
constexpr int kDbOp = kDbRows * kDbTF;            // floats of one operand
// the copies land in a ring of raw steps (A: the 128 gathered dout rows,
// B: 128 X rows), issued three steps ahead of their products; each step is
// split into a double-buffered split step: A hi, A lo, B hi, B lo
constexpr int kDbRawSteps = 3;
constexpr int kDbRaw = 2 * kDbOp;
constexpr int kDbSplit = 4 * kDbOp;
constexpr size_t kDbSmemBytes =
    sizeof(float) * (kDbRawSteps * kDbRaw + 2 * kDbSplit);

// core_off and wgmma_desc (tf32_mma.cuh) take 32-deep steps
static_assert(kDbKC == kCoreKC, "dBlocks steps are 32 deep");

// One block per (X group g, column block c, tile of up to kDbSlots slots of
// g's slices whose column id is c, in slot order, pad slots included; F
// chunk ch): the (kDbSlots * 8) x BC block of dBlocks rows, as
// dout-rows x X-slab^T on wgmma. Warpgroup w owns gathered rows 64 w.. and
// all 128 columns. Per F step the copies land in the core-matrix
// layout, three steps ahead; each thread splits the values it copied into
// (hi, lo); the step's 3 x 4 wgmma (lo x hi, hi x lo, hi x hi) sum into p
// from 0 and run while the threads split the next step and stage the one
// three ahead; then acc += p in f32, rounded to nearest, so the tensor
// cores' truncation stays relative to one step. With more than one chunk
// each block writes its chunk's sum to part, and the last block of a tile
// to finish (an integer ticket) adds the chunks in order 0, 1, ... into
// dblk. Grid: nbc column blocks fastest, then tiles_max tiles, then the G
// groups, then the n_chunks chunks; a tile past g's slots on c exits.
template <bool kVec>
__global__ void __launch_bounds__(kDbThreads, 1)
ell_bwd_dblk_kernel(const int* __restrict__ cols, const float* __restrict__ x,
                    const float* __restrict__ dout, float* __restrict__ dblk,
                    float* __restrict__ part, int* __restrict__ tickets,
                    int S, int NB, int MB, int BC, int nbc, int n_rows,
                    int n_cols, int F, int x_div, int n_chunks,
                    int tiles_max) {
  extern __shared__ float4 smem4[];
  __shared__ int s_slot[kDbSlots];
  __shared__ long long s_aoff[kDbRows];
  __shared__ int s_warp_n[kDbThreads / 32];
  __shared__ int s_last;
  float* sbuf = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int G = S / x_div;
  int bid = blockIdx.x;
  const int c = bid % nbc;
  bid /= nbc;
  const int tile = bid % tiles_max;
  bid /= tiles_max;
  const int g = bid % G;
  const int ch = bid / G;
  const int per_group = x_div * NB * MB;
  const int* gcols = cols + (size_t)g * per_group;

  const int want0 = tile * kDbSlots;
  int n = 0;
  for (int e0 = 0; e0 < per_group && n < want0 + kDbSlots;
       e0 += kDbThreads) {
    const int e = e0 + tid;
    const bool hit = e < per_group && gcols[e] == c;
    const unsigned ball = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp_n[warp] = __popc(ball);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kDbThreads / 32; ++w) {
      before += w < warp ? s_warp_n[w] : 0;
      total += s_warp_n[w];
    }
    const int rank = n + before + __popc(ball & ((1u << lane) - 1u));
    if (hit && rank >= want0 && rank < want0 + kDbSlots)
      s_slot[rank - want0] = e;
    n += total;
    __syncthreads();
  }
  const int nslots = min(kDbSlots, n - want0);
  if (nslots <= 0) return;
  for (int m = tid; m < kDbRows; m += kDbThreads) {
    const int q = m / kBR;
    long long off = -1;
    if (q < nslots) {
      const int e = s_slot[q];
      const int s = g * x_div + e / (NB * MB);
      const int row = (e / MB) % NB * kBR + m % kBR;
      if (row < n_rows) off = ((long long)s * n_rows + row) * F;
    }
    s_aoff[m] = off;
  }
  __syncthreads();

  const int xrows = min(BC, n_cols - c * BC);
  const float* xs = x + ((size_t)g * n_cols + (size_t)c * BC) * F;
  const int n_st = (F + kDbTF - 1) / kDbTF;
  const int per = (n_st + n_chunks - 1) / n_chunks;
  const int st0 = ch * per;
  const int n_steps = min(n_st, st0 + per) - st0;
  // copies of kW floats; the 8 rows of a core matrix on neighbouring
  // threads, so each 8 threads fill 128 contiguous bytes
  constexpr int kW = kVec ? 4 : 1;
  constexpr int kCopies = 2 * kDbRows * kDbTF / kW;
  constexpr int kPer = kCopies / kDbThreads;

  auto copy_at = [&](int q, int& op, int& row, int& f) {
    op = q / (kCopies / 2);                     // 0: dout rows, 1: X rows
    int r = q - op * (kCopies / 2);
    const int e = r % (4 / kW);
    r /= 4 / kW;
    row = r / (8 * kDbKC) * 8 + r % 8;
    f = (r / 8) % kDbKC * 4 + e * kW;
  };
  auto stage = [&](int st, float* buf) {
    const int f0 = st * kDbTF;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      int op, row, f;
      copy_at(tid + u * kDbThreads, op, row, f);
      const float* src;
      bool ok;
      if (op == 0) {
        const long long off = s_aoff[row];
        ok = off >= 0 && f0 + f < F;
        src = dout + off + f0 + f;
      } else {
        ok = row < xrows && f0 + f < F;
        src = xs + (size_t)row * F + f0 + f;
      }
      float* dst = buf + op * kDbOp + core_off(row, f / 4) + f % 4;
      if (kVec)
        cp_async16(dst, ok ? src : dout, ok ? 16 : 0);
      else
        cp_async4(dst, ok ? src : dout, ok ? 4 : 0);
    }
  };
  // each thread splits what it copied from raw step rbuf into split step
  // sbuf: hi at the raw value's place in its operand, lo one part further;
  // nf turns NaN once a value it splits is Inf or NaN
  float nf = 0.0f;
  auto split = [&](const float* rbuf, float* sbuf_) {
    float v[kPer][kW];
    float* h[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      int op, row, f;
      copy_at(tid + u * kDbThreads, op, row, f);
      const int off = core_off(row, f / 4) + f % 4;
      const float* r = rbuf + op * kDbOp + off;
      h[u] = sbuf_ + 2 * op * kDbOp + off;
      if (kVec) {
        const float4 w = *reinterpret_cast<const float4*>(r);
        v[u][0] = w.x;
        v[u][kW > 1 ? 1 : 0] = w.y;
        v[u][kW > 2 ? 2 : 0] = w.z;
        v[u][kW > 3 ? 3 : 0] = w.w;
      } else {
        v[u][0] = *r;
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      unsigned hi[kW], lo[kW];
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        nf = fold_non_finite(v[u][k], nf);
        split_tf32(v[u][k], hi[k], lo[k]);
      }
      if (kVec) {
        *reinterpret_cast<uint4*>(h[u]) =
            make_uint4(hi[0], hi[kW > 1 ? 1 : 0], hi[kW > 2 ? 2 : 0],
                       hi[kW > 3 ? 3 : 0]);
        *reinterpret_cast<uint4*>(h[u] + kDbOp) =
            make_uint4(lo[0], lo[kW > 1 ? 1 : 0], lo[kW > 2 ? 2 : 0],
                       lo[kW > 3 ? 3 : 0]);
      } else {
        *h[u] = __uint_as_float(hi[0]);
        h[u][kDbOp] = __uint_as_float(lo[0]);
      }
    }
  };

  const int wg = warp / 4;
  const bool wg_live = 8 * wg < nslots;
  float acc[kDbAcc], pp[kDbAcc];
#pragma unroll
  for (int i = 0; i < kDbAcc; ++i) acc[i] = pp[i] = 0.0f;
  // this warpgroup's 64 rows of A (8 row groups further each); all of B
  const int a_off = wg * 64 * kDbTF, b_off = 2 * kDbOp;

  float* raw = sbuf;                              // kDbRawSteps steps
  float* spl = sbuf + kDbRawSteps * kDbRaw;       // 2 steps
  for (int t = 0; t < kDbRawSteps; ++t) {
    if (t < n_steps) stage(st0 + t, raw + t * kDbRaw);
    cp_async_commit();
  }
  if (n_steps > 0) {
    cp_async_wait<kDbRawSteps - 1>();
    split(raw, spl);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  for (int t = 0; t < n_steps; ++t) {
    const float* buf = spl + (t & 1) * kDbSplit;
    {  // step t's products, in flight while the threads work. A warpgroup
       // without live rows multiplies zero-filled rows: no branch around
       // wgmma, which the compiler would serialize
      fence_regs(pp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kDbTF / 8; ++ks) {
        const int o = ks * 2 * 32;  // two core matrices along K
        const float* a = buf + a_off + o;
        const float* b = buf + b_off + o;
        wgmma_m64k8(pp, wgmma_desc(a + kDbOp), wgmma_desc(b), ks > 0);
        wgmma_m64k8(pp, wgmma_desc(a), wgmma_desc(b + kDbOp), 1);
        wgmma_m64k8(pp, wgmma_desc(a), wgmma_desc(b), 1);
      }
      wgmma_commit();
    }
    // stage step t + 3 into raw step t's place (this thread split its own
    // copies of step t already), then split step t + 1 once this thread's
    // copies of it have landed (its split step, read by step t - 1's
    // wgmma, is free)
    if (t + kDbRawSteps < n_steps)
      stage(st0 + t + kDbRawSteps, raw + t % kDbRawSteps * kDbRaw);
    cp_async_commit();
    if (t + 1 < n_steps) {
      cp_async_wait<kDbRawSteps - 1>();
      split(raw + (t + 1) % kDbRawSteps * kDbRaw,
            spl + ((t + 1) & 1) * kDbSplit);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    wgmma_wait<0>();
    fence_regs(pp);
#pragma unroll
    for (int i = 0; i < kDbAcc; ++i) acc[i] += pp[i];
    __syncthreads();  // step t + 1 is split; step t's wgmma are done
  }
  cp_async_wait<0>();
  // an Inf or NaN among the block's operands: its entries are summed
  // again in plain f32 (each_plain)
  const bool plain = __syncthreads_or(isnan(nf));
  if (!wg_live && n_chunks == 1) return;

  // D fragment: warp w % 4 of the warpgroup holds rows 16 (w % 4) + gid
  // (+ 8), columns 8 j + 2 tig (+ 1) of each 8-column chunk j. In a block
  // whose operands held an Inf or NaN each entry is summed again in plain
  // f32 over the chunk's columns (the split is made for finite values):
  // Inf, NaN and finite entries as the f32 sum gives them; rows past
  // n_rows and X rows past the slab read 0, as in the products.
  const size_t slot_base = (size_t)g * per_group;
  const size_t chunk_size = (size_t)S * NB * MB * kBR * BC;
  const int f_lo = st0 * kDbTF, f_hi = min(F, (st0 + n_steps) * kDbTF);
  auto dblk_plain_entry = [&](int m, int col) {
    const long long off = s_aoff[m];
    const float* xr = xs + (size_t)col * F;
    float v = 0.0f;
    for (int f = f_lo; f < f_hi; ++f)
      v = fmaf(off >= 0 ? dout[off + f] : 0.0f, col < xrows ? xr[f] : 0.0f,
               v);
    return v;
  };
  auto each_out = [&](auto&& fn) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wg * 64 + (warp % 4) * 16 + h * 8 + gid;
      const int q = m / kBR;
      if (q >= nslots) continue;
      const size_t o0 = ((slot_base + s_slot[q]) * kBR + m % kBR) * BC;
#pragma unroll
      for (int j = 0; j < kMaxBC / 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = j * 8 + 2 * tig + u;
          if (col >= BC) continue;
          fn(o0 + col, acc[j * 4 + 2 * h + u]);
        }
    }
  };
  // the same entries summed in plain f32, a compact loop (rare)
  auto each_plain = [&](auto&& fn) {
#pragma unroll 1
    for (int e = 0; e < 2 * kMaxBC; ++e) {
      const int h = e / kMaxBC, col = e % kMaxBC;
      const int m = wg * 64 + (warp % 4) * 16 + h * 8 + gid;
      const int q = m / kBR;
      if (q >= nslots || col >= BC || (col / 2) % 4 != tig) continue;
      fn(((slot_base + s_slot[q]) * kBR + m % kBR) * BC + col,
         dblk_plain_entry(m, col));
    }
  };
  auto write = [&](auto&& fn) {
    if (plain)
      each_plain(fn);
    else
      each_out(fn);
  };
  if (n_chunks == 1) {
    if (wg_live) write([&](size_t o, float v) { dblk[o] = v; });
    return;
  }
  if (wg_live)
    write([&](size_t o, float v) { part[ch * chunk_size + o] = v; });
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(&tickets[((size_t)g * tiles_max + tile) * nbc + c],
                       1) == n_chunks - 1;
  __syncthreads();
  if (!s_last || !wg_live) return;
  __threadfence();
  write([&](size_t o, float v) {
    float sum = ch == 0 ? v : __ldcg(part + o);
    for (int k = 1; k < n_chunks; ++k)
      sum += k == ch ? v : __ldcg(part + k * chunk_size + o);
    dblk[o] = sum;
  });
}

bool shape_ok(int S, int NB, int MB, int BC, int n_rows, int n_cols, int F,
              int x_div) {
  if (S < 1 || NB < 1 || MB < 1 || BC < 1 || BC > kMaxBC || F < 1 ||
      x_div < 1 || S % x_div != 0 || n_rows < 1 || n_cols < 1)
    return false;
  const int nbc = (n_cols + BC - 1) / BC;
  return n_rows <= NB * kBR && MB <= nbc;
}

template <typename T>
int launch_fwd(const void* t_ptr, const void* t_slot, const void* cols,
               const void* blocks, const void* scale, const void* x,
               void* out, void* scratch, int S, int NB, int MB, int BC,
               int n_rows, int n_cols, int F, int x_div, int gen,
               cudaStream_t st) {
  const int nbc = (n_cols + BC - 1) / BC;
  // each block walks every n_chunks-th F tile of one (X group, row group):
  // enough blocks for kFwdWaves per SM, no more, so the index walk and the
  // staged operands serve as many F tiles as they can
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int G = S / x_div;
  const long long cells = (long long)((NB + kGroupRB - 1) / kGroupRB) * G;
  const long long n_ft = (F + kFwdTF - 1) / kFwdTF;
  const long long want = ((long long)kFwdWaves * sms + cells - 1) / cells;
  const long long n_chunks = want < 1 ? 1 : (want > n_ft ? n_ft : want);
  const long long grid = cells * n_chunks;
  const long long fix_grid = G * ((n_ft + kFixTiles - 1) / kFixTiles);
  if (grid > 0x7fffffffLL || fix_grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes((BC + 7) / 8 * 8);
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kern = vec ? ell_fwd_kernel<T, true> : ell_fwd_kernel<T, false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  // scratch: the staged-row tags (G, n_cols), the flags (G, nbc, n_ft),
  // the row-block flags (S, NB); marks of this call equal gen
  int* staged = static_cast<int*>(scratch);
  int* flags = staged + (size_t)G * n_cols;
  int* rbf = flags + (size_t)G * nbc * n_ft;
  kern<<<(unsigned)grid, kFwdThreads, smem, st>>>(
      static_cast<const int*>(t_ptr), static_cast<const int*>(t_slot),
      static_cast<const T*>(blocks), static_cast<const float*>(scale),
      static_cast<const float*>(x), staged, flags, rbf, gen,
      static_cast<float*>(out), S, NB, MB, BC, nbc, n_rows, n_cols, F, x_div,
      (int)n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ell_fwd_fix_kernel<T><<<(unsigned)fix_grid, 256, 0, st>>>(
      static_cast<const int*>(cols), static_cast<const T*>(blocks),
      static_cast<const float*>(scale), static_cast<const float*>(x), staged,
      flags, rbf, gen, static_cast<float*>(out), NB, MB, BC, nbc, n_rows,
      n_cols, F, x_div);
  return cudaGetLastError();
}

template <typename T>
int launch_dx(const void* t_ptr, const void* t_slot, const void* blocks,
              const void* scale, const void* dout, void* dx, void* rb_flags,
              int S, int NB, int MB, int BC, int n_rows, int n_cols, int F,
              int x_div, int gen, cudaStream_t st) {
  const int nbc = (n_cols + BC - 1) / BC;
  const long long n_ft = (F + kDxTF - 1) / kDxTF;
  const long long grid = (long long)(S / x_div) * n_ft * nbc;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = dx_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      ell_bwd_dx_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const size_t pad_smem = sizeof(int) * x_div * NB;
  err = allow_smem((const void*)ell_dx_pad_kernel, pad_smem);
  if (err != cudaSuccess) return err;
  const int a_vec = BC * (int)sizeof(T) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(blocks) % 16 == 0;
  const int d_vec =
      F % 4 == 0 && reinterpret_cast<uintptr_t>(dout) % 16 == 0;
  ell_bwd_dx_kernel<T><<<(unsigned)grid, kDxThreads, smem, st>>>(
      static_cast<const int*>(t_ptr), static_cast<const int*>(t_slot),
      static_cast<const T*>(blocks), static_cast<const float*>(scale),
      static_cast<const float*>(dout), static_cast<float*>(dx),
      static_cast<int*>(rb_flags), gen, NB, MB, BC, nbc, n_rows, n_cols, F,
      x_div, a_vec, d_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ell_dx_pad_kernel<<<(unsigned)(S / x_div), 256, pad_smem, st>>>(
      static_cast<const int*>(t_ptr), static_cast<const int*>(t_slot),
      static_cast<const float*>(scale), static_cast<const float*>(dout),
      static_cast<const int*>(rb_flags), gen, static_cast<float*>(dx), NB,
      MB, BC, nbc, n_rows, n_cols, F, x_div);
  return cudaGetLastError();
}

}  // namespace

// out (S, n_rows, F) f32 from the transposed block index t_ptr (S, nbc + 1)
// and t_slot (S, NB * MB) int32, blocks (S, NB, MB, 8, BC) f32 (payload 0)
// or bf16 (payload 1), x (S / x_div, n_cols, F) f32.
// cols (S, NB, MB) int32 names each slot's column block (pad slots: 0);
// scratch holds (S / x_div) * (n_cols + nbc * ceil(F / 32)) + S * NB
// ints, none equal to gen, this call's generation (> 0), before the call:
// zeroed once and marked by earlier calls with smaller generations. Two
// launches: the forward, then its fix-up pass.
extern "C" int ell_fwd(const void* t_ptr, const void* t_slot,
                       const void* cols, const void* blocks, const void* x,
                       void* out, void* scratch, int payload, int S, int NB,
                       int MB, int BC, int n_rows, int n_cols, int F,
                       int x_div, int gen, void* stream) {
  if (!shape_ok(S, NB, MB, BC, n_rows, n_cols, F, x_div) || gen < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (payload == kF32)
    return launch_fwd<float>(t_ptr, t_slot, cols, blocks, nullptr, x, out,
                             scratch, S, NB, MB, BC, n_rows, n_cols, F, x_div,
                             gen, st);
  if (payload == kBF16)
    return launch_fwd<__nv_bfloat16>(t_ptr, t_slot, cols, blocks, nullptr, x,
                                     out, scratch, S, NB, MB, BC, n_rows,
                                     n_cols, F, x_div, gen, st);
  return cudaErrorInvalidValue;
}

// The int8 payload: codes (S, NB, MB, 8, BC) int8, scale (S, NB) f32.
extern "C" int ell_fwd_q(const void* t_ptr, const void* t_slot,
                         const void* cols, const void* codes,
                         const void* scale, const void* x, void* out,
                         void* scratch, int S, int NB, int MB, int BC,
                         int n_rows, int n_cols, int F, int x_div, int gen,
                         void* stream) {
  if (!shape_ok(S, NB, MB, BC, n_rows, n_cols, F, x_div) || gen < 1)
    return cudaErrorInvalidValue;
  return launch_fwd<int8_t>(t_ptr, t_slot, cols, codes, scale, x, out, scratch,
                            S, NB, MB, BC, n_rows, n_cols, F, x_div, gen,
                            static_cast<cudaStream_t>(stream));
}

// dx (S / x_div, n_cols, F) f32 from the transposed index t_ptr (S, nbc + 1)
// and t_slot (S, NB * MB) int32, the tiles and dout (S, n_rows, F) f32;
// rb_flags is scratch of S * NB ints, none equal to gen (> 0) before the
// call, as the forward's. Two launches: dX, then its pad pass.
extern "C" int ell_bwd_dx(const void* t_ptr, const void* t_slot,
                          const void* blocks, const void* dout, void* dx,
                          void* rb_flags, int payload, int S, int NB, int MB,
                          int BC, int n_rows, int n_cols, int F, int x_div,
                          int gen, void* stream) {
  if (!shape_ok(S, NB, MB, BC, n_rows, n_cols, F, x_div) || gen < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (payload == kF32)
    return launch_dx<float>(t_ptr, t_slot, blocks, nullptr, dout, dx,
                            rb_flags, S, NB, MB, BC, n_rows, n_cols, F,
                            x_div, gen, st);
  if (payload == kBF16)
    return launch_dx<__nv_bfloat16>(t_ptr, t_slot, blocks, nullptr, dout, dx,
                                    rb_flags, S, NB, MB, BC, n_rows, n_cols,
                                    F, x_div, gen, st);
  return cudaErrorInvalidValue;
}

extern "C" int ell_bwd_dx_q(const void* t_ptr, const void* t_slot,
                            const void* codes, const void* scale,
                            const void* dout, void* dx, void* rb_flags,
                            int S, int NB, int MB, int BC, int n_rows,
                            int n_cols, int F, int x_div, int gen,
                            void* stream) {
  if (!shape_ok(S, NB, MB, BC, n_rows, n_cols, F, x_div) || gen < 1)
    return cudaErrorInvalidValue;
  return launch_dx<int8_t>(t_ptr, t_slot, codes, scale, dout, dx, rb_flags,
                           S, NB, MB, BC, n_rows, n_cols, F, x_div, gen,
                           static_cast<cudaStream_t>(stream));
}

// dblk (S, NB, MB, 8, BC) f32 from cols, x (S / x_div, n_cols, F) and dout
// (S, n_rows, F), with F split into n_chunks chunks. With n_chunks > 1 the
// scratch part holds n_chunks * S * NB * MB * 8 * BC floats and tickets
// (S / x_div) * ceil(x_div * NB * MB / 16) * nbc zeroed ints.
extern "C" int ell_bwd_dblk(const void* cols, const void* x,
                            const void* dout, void* dblk, void* part,
                            void* tickets, int S, int NB, int MB, int BC,
                            int n_rows, int n_cols, int F, int x_div,
                            int n_chunks, void* stream) {
  if (!shape_ok(S, NB, MB, BC, n_rows, n_cols, F, x_div) || n_chunks < 1 ||
      (n_chunks > 1 && (part == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  const int nbc = (n_cols + BC - 1) / BC;
  const long long per_group = (long long)x_div * NB * MB;
  const long long tiles_max = (per_group + kDbSlots - 1) / kDbSlots;
  const long long grid =
      (long long)n_chunks * (S / x_div) * tiles_max * nbc;
  if (grid > 0x7fffffffLL || per_group > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dout) % 16 == 0;
  auto kern = vec ? ell_bwd_dblk_kernel<true> : ell_bwd_dblk_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDbSmemBytes);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)grid, kDbThreads, kDbSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const float*>(x),
      static_cast<const float*>(dout), static_cast<float*>(dblk),
      static_cast<float*>(part), static_cast<int*>(tickets), S, NB, MB, BC,
      nbc, n_rows, n_cols, F, x_div, n_chunks, (int)tiles_max);
  return cudaGetLastError();
}
