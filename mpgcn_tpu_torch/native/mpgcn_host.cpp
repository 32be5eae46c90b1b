// Host kernels of the port's data feed (C++ / OpenMP): the port's own copy
// of the JAX package's host library (mpgcn_tpu/native/mpgcn_host.cpp).
// The card does the model's work; these cover the host paths that feed
// it, where single-threaded numpy becomes the bottleneck at large N:
//
//   * gather_windows_f32 -- the batched sliding-window gather from the
//     resident (T, N, N, 1) OD series into a batch or chunk buffer (the
//     per-step and chunked-stream feeds of data/pipeline.py): an
//     OpenMP-parallel memcpy where numpy fancy indexing is one thread.
//   * dow_mean_f64 -- the day-of-week mean over the training history, the
//     bandwidth-bound first stage of the dynamic-graph build
//     (data/dyn_graphs.py); the Gram products stay in BLAS.
//
// A plain C interface, loaded with ctypes (native/host.py), which keeps
// a numpy version of each entry.

#include <cstdint>
#include <cstring>

extern "C" {

// out[b, t, :] = base[starts[b] + t, :] for feat floats per timestep.
// base: (T, feat) row-major f32; out: (n_batch, steps, feat).
void gather_windows_f32(const float *base, const int64_t *starts,
                        int64_t n_batch, int64_t steps, int64_t feat,
                        float *out) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t b = 0; b < n_batch; ++b) {
    for (int64_t t = 0; t < steps; ++t) {
      std::memcpy(out + (b * steps + t) * feat,
                  base + (starts[b] + t) * feat,
                  sizeof(float) * static_cast<size_t>(feat));
    }
  }
}

// out[p, :] = mean over k of history[k * period + p, :], k < Th / period.
// history: (Th, feat) row-major f64, Th a multiple of period.
void dow_mean_f64(const double *history, int64_t Th, int64_t period,
                  int64_t feat, double *out) {
  const int64_t num_periods = Th / period;
  const double inv = num_periods > 0 ? 1.0 / static_cast<double>(num_periods)
                                     : 0.0;
#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < period; ++p) {
    double *o = out + p * feat;
    for (int64_t j = 0; j < feat; ++j) o[j] = 0.0;
    for (int64_t k = 0; k < num_periods; ++k) {
      const double *row = history + (k * period + p) * feat;
      for (int64_t j = 0; j < feat; ++j) o[j] += row[j];
    }
    for (int64_t j = 0; j < feat; ++j) o[j] *= inv;
  }
}

}  // extern "C"
