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
//                 (_fwd_kernel, launched by _fwd_impl); f32 or bf16 tiles,
//                 promoted to f32 at the operand read
//   ell_fwd_q     the same on int8 codes x one f32 scale per row block,
//                 dequantised at the operand read as float(code) * scale
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
// slots populated), 0.217 ms at 67 TFLOP/s f32 on the CUDA cores,
// against 258 MB of X, output and tiles (0.077 ms at 3.35 TB/s): bound by
// operations. These are first, simple kernels, f32 FMA on the CUDA cores;
// they reread each X slab once per row block that uses it (from L2 when it
// fits) and run well below that bound. Tensor cores (TF32 or bf16 mma) and
// TMA-fed X slabs are later work.
//
// Design.
//   Forward: one block per (row block i, slice s, 512-column F tile), row
//     block fastest, so the blocks in flight share one X slab in L2. It
//     reads its own MB column ids (the TPU prefetches them as scalars),
//     stages each 8 x BC tile in shared memory (dequantised there), and
//     each thread accumulates 8 rows x 4 columns in f32 registers over the
//     tile's columns, reading X straight from global memory, coalesced.
//   dX: the TPU sums dX over row blocks because its grid runs in order.
//     Here one block owns one (group g, column block c, 64-column F tile)
//     of dX and walks, in a fixed order, the slots of its column block
//     from the container's transposed block index (t_ptr, t_slot: per
//     slice, the populated slots sorted by column block, then row block;
//     pad slots are left out, their tiles are zero). No float atomics:
//     dX is bit-equal from run to run.
//   dBlocks: one block per slot (s, i, j); each thread owns 4 of the 8 x BC
//     outputs and adds dout x X over F in order, 32 columns per staged
//     step, each step's partial added into a compensated (Kahan) sum: F is
//     long (32,000), and a plain running f32 sum would lose about eps * F
//     of the result. Bit-equal from run to run.
// Every entry launches on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBR = 8;        // rows per row block (the containers' tiles)
constexpr int kMaxBC = 128;   // widest column block

constexpr int kFwdThreads = 128;
constexpr int kFwdVec = 4;                        // columns per thread
constexpr int kFwdTF = kFwdThreads * kFwdVec;     // columns per block

constexpr int kDxThreads = 256;
constexpr int kDxTF = 64;                         // dX columns per block
constexpr int kDxColLanes = 16;                   // threads across columns
constexpr int kDxVec = kDxTF / kDxColLanes;       // columns per thread
constexpr int kDxRows = kMaxBC / (kDxThreads / kDxColLanes);  // rows per thread

constexpr int kDbThreads = 256;
constexpr int kDbTF = 32;                         // F columns per stage
constexpr int kDbVec = kMaxBC / 32;               // outputs per thread

enum Payload { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float tile_value(const float* p, size_t e, float) {
  return p[e];
}
__device__ __forceinline__ float tile_value(const __nv_bfloat16* p, size_t e,
                                            float) {
  return __bfloat162float(p[e]);
}
__device__ __forceinline__ float tile_value(const int8_t* p, size_t e,
                                            float scale) {
  return static_cast<float>(p[e]) * scale;
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
ell_fwd_kernel(const int* __restrict__ cols, const T* __restrict__ blocks,
               const float* __restrict__ scale, const float* __restrict__ x,
               float* __restrict__ out, int S, int NB, int MB, int BC,
               int n_rows, int n_cols, int F, int x_div) {
  __shared__ float tile[kBR * kMaxBC];
  int bid = blockIdx.x;
  const int i = bid % NB;
  bid /= NB;
  const int s = bid % S;
  const int ft = bid / S;
  const int tid = threadIdx.x;
  const float* xs = x + (size_t)(s / x_div) * n_cols * F;
  const size_t slot0 = ((size_t)s * NB + i) * MB;
  const float sc = scale != nullptr ? scale[(size_t)s * NB + i] : 1.0f;

  int f[kFwdVec];
#pragma unroll
  for (int v = 0; v < kFwdVec; ++v) f[v] = ft * kFwdTF + tid + v * kFwdThreads;
  float acc[kBR][kFwdVec];
#pragma unroll
  for (int r = 0; r < kBR; ++r)
#pragma unroll
    for (int v = 0; v < kFwdVec; ++v) acc[r][v] = 0.0f;

  for (int j = 0; j < MB; ++j) {
    const int c = cols[slot0 + j];
    const T* blk = blocks + (slot0 + j) * kBR * BC;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBR * BC; e += kFwdThreads)
      tile[e] = tile_value(blk, e, sc);
    __syncthreads();
    const int r0 = c * BC;
    const int nc = min(BC, n_cols - r0);
    for (int cc = 0; cc < nc; ++cc) {
      const float* xr = xs + (size_t)(r0 + cc) * F;
      float xv[kFwdVec];
#pragma unroll
      for (int v = 0; v < kFwdVec; ++v) xv[v] = f[v] < F ? xr[f[v]] : 0.0f;
#pragma unroll
      for (int r = 0; r < kBR; ++r) {
        const float a = tile[r * BC + cc];
#pragma unroll
        for (int v = 0; v < kFwdVec; ++v) acc[r][v] = fmaf(a, xv[v], acc[r][v]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kBR; ++r) {
    const int row = i * kBR + r;
    if (row >= n_rows) continue;
    float* o = out + ((size_t)s * n_rows + row) * F;
#pragma unroll
    for (int v = 0; v < kFwdVec; ++v)
      if (f[v] < F) o[f[v]] = acc[r][v];
  }
}

template <typename T>
__global__ void __launch_bounds__(kDxThreads)
ell_bwd_dx_kernel(const int* __restrict__ t_ptr,
                  const int* __restrict__ t_slot, const T* __restrict__ blocks,
                  const float* __restrict__ scale,
                  const float* __restrict__ dout, float* __restrict__ dx,
                  int S, int NB, int MB, int BC, int nbc, int n_rows,
                  int n_cols, int F, int x_div) {
  __shared__ float tile[kBR * kMaxBC];
  __shared__ float dsm[kBR * kDxTF];
  const int n_ft = (F + kDxTF - 1) / kDxTF;
  int bid = blockIdx.x;
  const int c = bid % nbc;
  bid /= nbc;
  const int ft = bid % n_ft;
  const int g = bid / n_ft;
  const int tid = threadIdx.x;
  const int lane_f = tid % kDxColLanes;
  const int row0 = (tid / kDxColLanes) * kDxRows;  // first dX row in block

  float acc[kDxRows][kDxVec];
#pragma unroll
  for (int q = 0; q < kDxRows; ++q)
#pragma unroll
    for (int v = 0; v < kDxVec; ++v) acc[q][v] = 0.0f;

  for (int s = g * x_div; s < (g + 1) * x_div; ++s) {
    const int* ptr = t_ptr + (size_t)s * (nbc + 1);
    const int e_end = ptr[c + 1];
    for (int e = ptr[c]; e < e_end; ++e) {
      const int slot = t_slot[(size_t)s * NB * MB + e];
      const int i = slot / MB;
      const float sc = scale != nullptr ? scale[(size_t)s * NB + i] : 1.0f;
      const T* blk = blocks + ((size_t)s * NB * MB + slot) * kBR * BC;
      __syncthreads();  // the previous slot's readers are done
      for (int q = tid; q < kBR * BC; q += kDxThreads)
        tile[q] = tile_value(blk, q, sc);
      for (int q = tid; q < kBR * kDxTF; q += kDxThreads) {
        const int r = q / kDxTF;
        const int row = i * kBR + r;
        const int fcol = ft * kDxTF + q - r * kDxTF;
        dsm[q] = (row < n_rows && fcol < F)
                     ? dout[((size_t)s * n_rows + row) * F + fcol]
                     : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kBR; ++r) {
        float d[kDxVec];
#pragma unroll
        for (int v = 0; v < kDxVec; ++v)
          d[v] = dsm[r * kDxTF + lane_f + v * kDxColLanes];
#pragma unroll
        for (int q = 0; q < kDxRows; ++q) {
          const int cc = row0 + q;
          const float a = cc < BC ? tile[r * BC + cc] : 0.0f;
#pragma unroll
          for (int v = 0; v < kDxVec; ++v) acc[q][v] = fmaf(a, d[v], acc[q][v]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kDxRows; ++q) {
    const int cc = row0 + q;
    const int row = c * BC + cc;
    if (cc >= BC || row >= n_cols) continue;
    float* o = dx + ((size_t)g * n_cols + row) * F;
#pragma unroll
    for (int v = 0; v < kDxVec; ++v) {
      const int fcol = ft * kDxTF + lane_f + v * kDxColLanes;
      if (fcol < F) o[fcol] = acc[q][v];
    }
  }
}

__global__ void __launch_bounds__(kDbThreads)
ell_bwd_dblk_kernel(const int* __restrict__ cols, const float* __restrict__ x,
                    const float* __restrict__ dout, float* __restrict__ dblk,
                    int NB, int MB, int BC, int n_rows, int n_cols, int F,
                    int x_div) {
  __shared__ float xsm[kMaxBC * (kDbTF + 1)];
  __shared__ float dsm[kBR * kDbTF];
  const size_t slot = blockIdx.x;  // (s * NB + i) * MB + j
  const int s = (int)(slot / ((size_t)NB * MB));
  const int i = (int)((slot / MB) % NB);
  const int c = cols[slot];
  const float* xs = x + (size_t)(s / x_div) * n_cols * F;
  const int tid = threadIdx.x;
  const int r = tid / 32;        // the warp's tile row
  const int lane = tid % 32;

  // the running sums and their compensations: each staged step's partial
  // (kDbTF products) is added in Kahan's compensated form, so the error of a
  // sum over F = 32,000 does not grow with F
  float acc[kDbVec], comp[kDbVec];
#pragma unroll
  for (int v = 0; v < kDbVec; ++v) acc[v] = comp[v] = 0.0f;
  for (int f0 = 0; f0 < F; f0 += kDbTF) {
    __syncthreads();  // the previous stage's readers are done
    for (int q = tid; q < kBR * kDbTF; q += kDbThreads) {
      const int rr = q / kDbTF;
      const int row = i * kBR + rr;
      const int fcol = f0 + q - rr * kDbTF;
      dsm[q] = (row < n_rows && fcol < F)
                   ? dout[((size_t)s * n_rows + row) * F + fcol]
                   : 0.0f;
    }
    for (int q = tid; q < BC * kDbTF; q += kDbThreads) {
      const int cc = q / kDbTF;
      const int fc = q - cc * kDbTF;
      const int xrow = c * BC + cc;
      xsm[cc * (kDbTF + 1) + fc] = (xrow < n_cols && f0 + fc < F)
                                       ? xs[(size_t)xrow * F + f0 + fc]
                                       : 0.0f;
    }
    __syncthreads();
    float part[kDbVec];
#pragma unroll
    for (int v = 0; v < kDbVec; ++v) part[v] = 0.0f;
    for (int fc = 0; fc < kDbTF; ++fc) {
      const float d = dsm[r * kDbTF + fc];
#pragma unroll
      for (int v = 0; v < kDbVec; ++v) {
        const int cc = lane + 32 * v;
        if (cc < BC) part[v] = fmaf(d, xsm[cc * (kDbTF + 1) + fc], part[v]);
      }
    }
#pragma unroll
    for (int v = 0; v < kDbVec; ++v) {
      const float y = part[v] - comp[v];
      const float t = acc[v] + y;
      comp[v] = (t - acc[v]) - y;
      acc[v] = t;
    }
  }
  float* o = dblk + slot * kBR * BC + (size_t)r * BC;
#pragma unroll
  for (int v = 0; v < kDbVec; ++v) {
    const int cc = lane + 32 * v;
    if (cc < BC) o[cc] = acc[v];
  }
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
int launch_fwd(const void* cols, const void* blocks, const void* scale,
               const void* x, void* out, int S, int NB, int MB, int BC,
               int n_rows, int n_cols, int F, int x_div, cudaStream_t st) {
  const long long grid =
      (long long)NB * S * ((F + kFwdTF - 1) / kFwdTF);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  ell_fwd_kernel<T><<<(unsigned)grid, kFwdThreads, 0, st>>>(
      static_cast<const int*>(cols), static_cast<const T*>(blocks),
      static_cast<const float*>(scale), static_cast<const float*>(x),
      static_cast<float*>(out), S, NB, MB, BC, n_rows, n_cols, F, x_div);
  return cudaGetLastError();
}

template <typename T>
int launch_dx(const void* t_ptr, const void* t_slot, const void* blocks,
              const void* scale, const void* dout, void* dx, int S, int NB,
              int MB, int BC, int n_rows, int n_cols, int F, int x_div,
              cudaStream_t st) {
  const int nbc = (n_cols + BC - 1) / BC;
  const long long grid =
      (long long)(S / x_div) * ((F + kDxTF - 1) / kDxTF) * nbc;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  ell_bwd_dx_kernel<T><<<(unsigned)grid, kDxThreads, 0, st>>>(
      static_cast<const int*>(t_ptr), static_cast<const int*>(t_slot),
      static_cast<const T*>(blocks), static_cast<const float*>(scale),
      static_cast<const float*>(dout), static_cast<float*>(dx), S, NB, MB,
      BC, nbc, n_rows, n_cols, F, x_div);
  return cudaGetLastError();
}

}  // namespace

// out (S, n_rows, F) f32 from cols (S, NB, MB) int32, blocks (S, NB, MB, 8,
// BC) f32 (payload 0) or bf16 (payload 1), x (S / x_div, n_cols, F) f32.
extern "C" int ell_fwd(const void* cols, const void* blocks, const void* x,
                       void* out, int payload, int S, int NB, int MB, int BC,
                       int n_rows, int n_cols, int F, int x_div,
                       void* stream) {
  if (!shape_ok(S, NB, MB, BC, n_rows, n_cols, F, x_div))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (payload == kF32)
    return launch_fwd<float>(cols, blocks, nullptr, x, out, S, NB, MB, BC,
                             n_rows, n_cols, F, x_div, st);
  if (payload == kBF16)
    return launch_fwd<__nv_bfloat16>(cols, blocks, nullptr, x, out, S, NB,
                                     MB, BC, n_rows, n_cols, F, x_div, st);
  return cudaErrorInvalidValue;
}

// The int8 payload: codes (S, NB, MB, 8, BC) int8, scale (S, NB) f32.
extern "C" int ell_fwd_q(const void* cols, const void* codes,
                         const void* scale, const void* x, void* out, int S,
                         int NB, int MB, int BC, int n_rows, int n_cols,
                         int F, int x_div, void* stream) {
  if (!shape_ok(S, NB, MB, BC, n_rows, n_cols, F, x_div))
    return cudaErrorInvalidValue;
  return launch_fwd<int8_t>(cols, codes, scale, x, out, S, NB, MB, BC,
                            n_rows, n_cols, F, x_div,
                            static_cast<cudaStream_t>(stream));
}

// dx (S / x_div, n_cols, F) f32 from the transposed index t_ptr (S, nbc + 1)
// and t_slot (S, NB * MB) int32, the tiles and dout (S, n_rows, F) f32.
extern "C" int ell_bwd_dx(const void* t_ptr, const void* t_slot,
                          const void* blocks, const void* dout, void* dx,
                          int payload, int S, int NB, int MB, int BC,
                          int n_rows, int n_cols, int F, int x_div,
                          void* stream) {
  if (!shape_ok(S, NB, MB, BC, n_rows, n_cols, F, x_div))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (payload == kF32)
    return launch_dx<float>(t_ptr, t_slot, blocks, nullptr, dout, dx, S, NB,
                            MB, BC, n_rows, n_cols, F, x_div, st);
  if (payload == kBF16)
    return launch_dx<__nv_bfloat16>(t_ptr, t_slot, blocks, nullptr, dout, dx,
                                    S, NB, MB, BC, n_rows, n_cols, F, x_div,
                                    st);
  return cudaErrorInvalidValue;
}

extern "C" int ell_bwd_dx_q(const void* t_ptr, const void* t_slot,
                            const void* codes, const void* scale,
                            const void* dout, void* dx, int S, int NB, int MB,
                            int BC, int n_rows, int n_cols, int F, int x_div,
                            void* stream) {
  if (!shape_ok(S, NB, MB, BC, n_rows, n_cols, F, x_div))
    return cudaErrorInvalidValue;
  return launch_dx<int8_t>(t_ptr, t_slot, codes, scale, dout, dx, S, NB, MB,
                           BC, n_rows, n_cols, F, x_div,
                           static_cast<cudaStream_t>(stream));
}

// dblk (S, NB, MB, 8, BC) f32 from cols, x (S / x_div, n_cols, F) and dout
// (S, n_rows, F).
extern "C" int ell_bwd_dblk(const void* cols, const void* x,
                            const void* dout, void* dblk, int S, int NB,
                            int MB, int BC, int n_rows, int n_cols, int F,
                            int x_div, void* stream) {
  if (!shape_ok(S, NB, MB, BC, n_rows, n_cols, F, x_div))
    return cudaErrorInvalidValue;
  const long long grid = (long long)S * NB * MB;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  ell_bwd_dblk_kernel<<<(unsigned)grid, kDbThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const float*>(x),
      static_cast<const float*>(dout), static_cast<float*>(dblk), NB, MB, BC,
      n_rows, n_cols, F, x_div);
  return cudaGetLastError();
}
