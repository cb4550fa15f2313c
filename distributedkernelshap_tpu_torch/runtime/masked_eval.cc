// Native host-side data plane for the black-box predictor path.
//
// The reference's native-code surface is Ray's C++ core (object store +
// raylet; SURVEY.md §2.4) shuttling pickled minibatches between actor
// processes.  This package has no object store — its host-side hot loop is
// different: when the predictor is an opaque host callable (XGBoost, pickled
// sklearn pipelines) the synthetic-data tensor  masked[b,s,n,:] =
// x_b ⊙ z_s + bg_n ⊙ (1 - z_s)  must be materialised on the host before
// every predictor call, and the predictor outputs reduced by the background
// weights afterwards.  numpy broadcasts allocate and sweep this B·S·N·D
// tensor twice; these OpenMP kernels build it in one pass and reduce
// without intermediates.
//
// Exposed via ctypes (distributedkernelshap_tpu_torch/runtime/native.py); the
// Python layer falls back to numpy when the shared library is unavailable.

#include <cstdint>

extern "C" {

// out[(b*S + s)*N + n, :] = X[b,:]*zc[s,:] + bg[n,:]*(1 - zc[s,:])
// X: (B, D)  bg: (N, D)  zc: (S, D)  out: (B*S*N, D) preallocated
void dks_masked_fill(const float* X, const float* bg, const float* zc,
                     float* out, int64_t B, int64_t S, int64_t N, int64_t D) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t b = 0; b < B; ++b) {
    for (int64_t s = 0; s < S; ++s) {
      const float* x_row = X + b * D;
      const float* z_row = zc + s * D;
      float* block = out + ((b * S + s) * N) * D;
      for (int64_t n = 0; n < N; ++n) {
        const float* bg_row = bg + n * D;
        float* o = block + n * D;
        for (int64_t d = 0; d < D; ++d) {
          const float z = z_row[d];
          o[d] = x_row[d] * z + bg_row[d] * (1.0f - z);
        }
      }
    }
  }
}

// ey[r, k] = sum_n w[n] * pred[r*N + n, k]   (w pre-normalised)
// pred: (R*N, K)  w: (N,)  ey: (R, K) preallocated;  R = B*S
void dks_weighted_mean(const float* pred, const float* w, float* ey,
                       int64_t R, int64_t N, int64_t K) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < R; ++r) {
    const float* block = pred + r * N * K;
    float* out = ey + r * K;
    for (int64_t k = 0; k < K; ++k) out[k] = 0.0f;
    for (int64_t n = 0; n < N; ++n) {
      const float wn = w[n];
      const float* row = block + n * K;
      for (int64_t k = 0; k < K; ++k) out[k] += wn * row[k];
    }
  }
}

}  // extern "C"
