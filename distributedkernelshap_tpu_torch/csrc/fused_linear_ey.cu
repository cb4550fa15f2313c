// fused_linear_ey: the masked-evaluation reduction of KernelSHAP for a
// logits-linear predictor, in CUDA C++ for Hopper (sm_90a).
//
//   ey[b,s,k] = sum_n bgw[n] * act(p1[b,s,k] + bgW[n,k] - t2[s,n,k])
//   p1[b,s,k] = sum_m mask[s,m] * XWg[b,m,k]
//   t2[s,n,k] = sum_m mask[s,m] * bgWg[n,m,k]
//
// Replaces distributedkernelshap_tpu/ops/pallas_kernels.py:fused_linear_ey
// (body _ey_kernel).  Same three activations: binary softmax (K=2, the
// sigmoid of the logit difference with k=0 as the complement, which needs
// sum(bgw) = 1: the wrapper normalises bgw), general-K softmax, sigmoid.
// Identity never reaches the kernel: the caller collapses it analytically.
//
// What bounds it: the B*S*N activations.  At the Adult headline shape
// (B=2560, S=2072, N=100, K=2) that is 530 M sigmoids, each one exp and one
// reciprocal on the special-function units, against 0.13 GFLOP of group-space
// products and a 42 MB output: the kernel is bound by the SFU rate, not by
// memory.  The design therefore keeps the whole (b, s, n) loop in registers
// and shared memory and writes each output once.
//
// Layout and tiling: the kernel takes and returns the JAX function's own
// layouts (row-major XWg (B,M,K), bgWg (N,M,K), bgW (N,K), bgw (N,),
// mask (S,M), out (B,S,K)); the TPU kernel's K-leading, S-on-lanes layout is
// not carried over.  One block of 256 threads covers a (TB x TS) tile with
// TS = 64 coalitions on threadIdx % 64 and TB = 4*R instances, so each
// thread owns R instances of one coalition and holds their p1 (or dp) and
// accumulators in registers.  The S-tile's background term
// t2'[k,n,s] = t2[s,n,k] - bgW[n,k] (binary: the class difference) is
// staged in shared memory, computed by the block itself from mask and bgWg.
// Shared memory is the scarce resource (227 KB a block at most, 48 KB
// without opting in): the block streams the background axis N in chunks of
// NC rows sized so the staged chunk fits 48 KB, so K*N*TS never has to fit
// at once (K=7, N=100 would need 179 KB) and no opt-in to more dynamic
// shared memory is needed.  The group contraction (depth M) runs in f32
// FMAs, so no TF32 rounding enters, matching the reference's
// Precision.HIGHEST.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTS = 64;                     // coalitions per block
constexpr int kTBY = kThreads / kTS;        // instance rows per pass
constexpr int kSmemBudget = 48 * 1024;      // bytes of staged background:
                                            // the limit without an opt-in
constexpr int kMaxK = 32;
static_assert(kSmemBudget / (4 * (kMaxK * kTS + 1)) >= 1,
              "one background row of the widest class tile must fit");

enum Mode { kBinarySoftmax = 0, kSoftmax = 1, kSigmoid = 2 };

// instances per thread for a register class-array of width KT
__host__ __device__ constexpr int rows_for(int kt) {
  return kt == 1 ? 16 : (kt == 2 ? 8 : (kt <= 8 ? 4 : (kt == 16 ? 2 : 1)));
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int KT, int MODE>
__global__ void __launch_bounds__(kThreads)
ey_kernel(const float* __restrict__ XWg, const float* __restrict__ bgWg,
          const float* __restrict__ bgW, const float* __restrict__ bgw,
          const float* __restrict__ mask, float* __restrict__ out,
          int B, int S, int N, int M, int K, int NC) {
  constexpr int R = rows_for(KT);
  constexpr int TB = kTBY * R;
  // classes carried through the n-loop: the binary path carries one
  const int KE = (MODE == kBinarySoftmax) ? 1 : K;

  extern __shared__ float smem[];
  float* t2s = smem;                        // [KE][NC][kTS]
  float* ws = smem + KE * NC * kTS;         // [NC]

  const int tx = threadIdx.x % kTS;
  const int ty = threadIdx.x / kTS;
  const int s = blockIdx.y * kTS + tx;
  const int b_base = blockIdx.x * TB + ty;
  const bool s_ok = s < S;

  float p[R][KT];
  float acc[R][KT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b_base + r * kTBY;
    const bool ok = s_ok && b < B;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      acc[r][k] = 0.0f;
      p[r][k] = 0.0f;
      if (!ok || k >= KE) continue;
      float v = 0.0f;
      const float* xw = XWg + (size_t)b * M * K;
      const float* mk = mask + (size_t)s * M;
      if (MODE == kBinarySoftmax) {
        for (int m = 0; m < M; ++m)
          v = fmaf(mk[m], xw[m * K + 1] - xw[m * K], v);
      } else {
        for (int m = 0; m < M; ++m) v = fmaf(mk[m], xw[m * K + k], v);
      }
      p[r][k] = v;
    }
  }

  for (int n0 = 0; n0 < N; n0 += NC) {
    const int nc = min(NC, N - n0);
    __syncthreads();  // the previous chunk is consumed
    for (int idx = threadIdx.x; idx < KE * nc * kTS; idx += kThreads) {
      const int sl = idx % kTS;
      const int n = (idx / kTS) % nc;
      const int k = idx / (kTS * nc);
      const int sg = blockIdx.y * kTS + sl;
      float v = 0.0f;
      if (sg < S) {
        const float* mk = mask + (size_t)sg * M;
        const float* bw = bgWg + (size_t)(n0 + n) * M * K;
        const float* bl = bgW + (size_t)(n0 + n) * K;
        if (MODE == kBinarySoftmax) {
          for (int m = 0; m < M; ++m)
            v = fmaf(mk[m], bw[m * K + 1] - bw[m * K], v);
          v -= bl[1] - bl[0];
        } else {
          for (int m = 0; m < M; ++m) v = fmaf(mk[m], bw[m * K + k], v);
          v -= bl[k];
        }
      }
      t2s[(k * NC + n) * kTS + sl] = v;
    }
    for (int idx = threadIdx.x; idx < nc; idx += kThreads) ws[idx] = bgw[n0 + idx];
    __syncthreads();

    for (int n = 0; n < nc; ++n) {
      const float wn = ws[n];
      if (MODE == kSoftmax) {
        float t[KT];
#pragma unroll
        for (int k = 0; k < KT; ++k)
          t[k] = k < KE ? t2s[(k * NC + n) * kTS + tx] : 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float mx = p[r][0] - t[0];
#pragma unroll
          for (int k = 1; k < KT; ++k)
            if (k < KE) mx = fmaxf(mx, p[r][k] - t[k]);
          float e[KT];
          float den = 0.0f;
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            e[k] = k < KE ? expf(p[r][k] - t[k] - mx) : 0.0f;
            den += e[k];
          }
          const float sc = wn / den;
#pragma unroll
          for (int k = 0; k < KT; ++k) acc[r][k] = fmaf(sc, e[k], acc[r][k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          if (k >= KE) continue;
          const float t = t2s[(k * NC + n) * kTS + tx];
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r][k] = fmaf(wn, sigmoid_f32(p[r][k] - t), acc[r][k]);
        }
      }
    }
  }

  if (!s_ok) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b_base + r * kTBY;
    if (b >= B) continue;
    float* o = out + ((size_t)b * S + s) * K;
    if (MODE == kBinarySoftmax) {
      o[1] = acc[r][0];
      o[0] = 1.0f - acc[r][0];
    } else {
#pragma unroll
      for (int k = 0; k < KT; ++k)
        if (k < KE) o[k] = acc[r][k];
    }
  }
}

template <int KT, int MODE>
int launch(const float* XWg, const float* bgWg, const float* bgW,
           const float* bgw, const float* mask, float* out, int B, int S,
           int N, int M, int K, cudaStream_t stream) {
  constexpr int TB = kTBY * rows_for(KT);
  const int KE = (MODE == kBinarySoftmax) ? 1 : K;
  // background rows per shared-memory chunk: KE*NC*kTS + NC floats, at
  // most kSmemBudget bytes (KE <= kMaxK keeps NC >= 1)
  int nc = kSmemBudget / (int)(sizeof(float) * (KE * kTS + 1));
  nc = nc > N ? N : nc;
  const size_t smem = sizeof(float) * ((size_t)KE * nc * kTS + nc);
  dim3 grid((B + TB - 1) / TB, (S + kTS - 1) / kTS);
  ey_kernel<KT, MODE><<<grid, kThreads, smem, stream>>>(
      XWg, bgWg, bgW, bgw, mask, out, B, S, N, M, K, nc);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_k(const float* XWg, const float* bgWg, const float* bgW,
             const float* bgw, const float* mask, float* out, int B, int S,
             int N, int M, int K, cudaStream_t st) {
  if (K <= 1) return launch<1, MODE>(XWg, bgWg, bgW, bgw, mask, out, B, S, N, M, K, st);
  if (K <= 2) return launch<2, MODE>(XWg, bgWg, bgW, bgw, mask, out, B, S, N, M, K, st);
  if (K <= 4) return launch<4, MODE>(XWg, bgWg, bgW, bgw, mask, out, B, S, N, M, K, st);
  if (K <= 8) return launch<8, MODE>(XWg, bgWg, bgW, bgw, mask, out, B, S, N, M, K, st);
  if (K <= 16) return launch<16, MODE>(XWg, bgWg, bgW, bgw, mask, out, B, S, N, M, K, st);
  return launch<32, MODE>(XWg, bgWg, bgW, bgw, mask, out, B, S, N, M, K, st);
}

}  // namespace

extern "C" {

int fused_linear_ey_max_k() { return kMaxK; }

// activation: 0 = softmax, 1 = sigmoid.  All pointers are device pointers
// to contiguous float32 arrays; bgw must sum to 1 for binary softmax.
// Returns the cudaError_t of the launch (0 on success).
int fused_linear_ey_launch(const float* XWg, const float* bgWg,
                           const float* bgW, const float* bgw,
                           const float* mask, float* out, int B, int S, int N,
                           int M, int K, int activation, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || M <= 0 || K <= 0 || K > kMaxK ||
      (activation != 0 && activation != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (activation == 0 && K == 2)
    return launch<1, kBinarySoftmax>(XWg, bgWg, bgW, bgw, mask, out, B, S, N, M, K, st);
  if (activation == 0)
    return launch_k<kSoftmax>(XWg, bgWg, bgW, bgw, mask, out, B, S, N, M, K, st);
  return launch_k<kSigmoid>(XWg, bgWg, bgW, bgw, mask, out, B, S, N, M, K, st);
}

}  // extern "C"
