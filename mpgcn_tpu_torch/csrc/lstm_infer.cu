// K-LSTM: inference forward of one LSTM layer with zero initial state.
//
// Replaces the TPU kernels of mpgcn_tpu/nn/pallas_lstm.py reached from
// _fused_layer_infer: _make_last_kernel (collect=False, writes h_T only)
// and _lstm_infer_kernel (collect=True, streams h_t for every t).
//
//   lstm_infer_last_f32     -> out (R, H)     h_T
//   lstm_infer_collect_f32  -> out (T, R, H)  h_t for all t
//   each from x_proj (T, R, 4H) f32, time-major (x_t @ W_ih^T + b_ih +
//   b_hh), or, where x_proj is null, fused from x (R, T, F), w_ih (4H, F)
//   and b = b_ih + b_hh (4H), 1 <= F <= 4; w_hh_T (H, 4H) f32.
//
// The JAX package leaves the input projection to XLA (pallas_lstm.py:564)
// and its kernels read x_proj. At the model's input width F = 1 that
// projection is a rank-1 update: at N = 500 a (7, 500,000, 128) f32 tensor
// of 1.79 GB, written by a K = 1 product, read and written again by the
// bias add and read by the kernel, about 7.2 GB of traffic for a 14 MB
// input. The fused form forms the gate inputs in registers instead, so
// the kernel reads x alone and is bound by its recurrent FMAs.
//
// Both entries run the resident forward of lstm_fwd.cuh (its design and
// what bounds it are written there) wherever w_hh and the h buffers fit a
// block's shared memory (H <= 116 on the H100), and the wide kernel of
// lstm_wide.cuh past that: a second kernel chosen per call from H and the
// device's shared-memory limit, not a branch inside the resident one. The
// wide kernel runs its recurrent products on split-TF32 tensor cores over
// row tiles that share each staged w_hh^T slab, and carries h and c from
// step to step in device memory: scratch (2, R, H) for h_T only, (1, R, H)
// for every h_t, which the caller allocates (lstm_fwd_wide says where it
// is needed; null on the resident kernel).
//
//   lstm_fwd_wide(H, out)   1 where the entries take the wide kernel at H

#include <cuda_runtime.h>

#include "lstm_fwd.cuh"

extern "C" int lstm_infer_last_f32(const void* xp, const void* whhT,
                                   void* out, const void* x,
                                   const void* w_ih, const void* b,
                                   void* scratch, int T, int R, int H, int F,
                                   void* stream) {
  return launch_fwd<kFwdLast>(xp, x, w_ih, b, F, whhT, out, nullptr, scratch,
                              T, R, H, stream);
}

extern "C" int lstm_infer_collect_f32(const void* xp, const void* whhT,
                                      void* out, const void* x,
                                      const void* w_ih, const void* b,
                                      void* scratch, int T, int R, int H,
                                      int F, void* stream) {
  return launch_fwd<kFwdCollect>(xp, x, w_ih, b, F, whhT, out, nullptr,
                                 scratch, T, R, H, stream);
}

// The same two entries on bf16 storage (x_proj or x, w_ih, b, w_hh_T and
// out in bf16; the JAX kernels in their bf16 dtype): the carries, gates
// and sums in f32, h rounded to bf16 before each recurrent product and
// out rounded to bf16; the fused form rounds each gate input as a bf16
// projection stores x_proj. The wide kernel's scratch stays f32.
extern "C" int lstm_infer_last_bf16(const void* xp, const void* whhT,
                                    void* out, const void* x,
                                    const void* w_ih, const void* b,
                                    void* scratch, int T, int R, int H,
                                    int F, void* stream) {
  return launch_fwd<kFwdLast, bf16>(xp, x, w_ih, b, F, whhT, out, nullptr,
                                    scratch, T, R, H, stream);
}

extern "C" int lstm_infer_collect_bf16(const void* xp, const void* whhT,
                                       void* out, const void* x,
                                       const void* w_ih, const void* b,
                                       void* scratch, int T, int R, int H,
                                       int F, void* stream) {
  return launch_fwd<kFwdCollect, bf16>(xp, x, w_ih, b, F, whhT, out, nullptr,
                                       scratch, T, R, H, stream);
}

extern "C" int lstm_fwd_wide(int H, int* out) {
  if (H < 1) return cudaErrorInvalidValue;
  bool wide = false;
  const cudaError_t err = fwd_on_wide(H, &wide);
  *out = wide ? 1 : 0;
  return err;
}
