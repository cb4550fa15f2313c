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
// Layout: the kernel takes and returns the JAX function's own layouts
// (row-major XWg (B,M,K), bgWg (N,M,K), bgW (N,K), bgw (N,), mask (S,M),
// out (B,S,K)).  One block of 256 threads covers TS = 64 coalitions on
// threadIdx % 64 and TB = 4*R instances, so each thread owns R instances of
// one coalition and keeps their sums in registers.  The S-tile's background
// term t'[k,n,s] = t2[s,n,k] - bgW[n,k] (binary: the class difference) is
// computed by the block into shared memory, the background axis N streamed
// in chunks of NC rows so a chunk fits 48 KB (no opt-in).  The group
// contractions (depth M) run in f32 FMAs: no TF32, the reference's
// Precision.HIGHEST.
//
// The sigmoid-form branches (binary softmax, the Adult headline, and
// sigmoid) take the exponential out of the (b, s, n) loop.  With
// dp = p1[b,s,k] and a per-(k, s, chunk) shift c,
//
//   sigmoid(dp - t') = 1 / (1 + u * v),  u = exp(-(dp - c)),  v = exp(t' - c):
//
// v is staged in shared memory in place of t' (one expf per (k, n, s)), u is
// held in registers (one expf per (b, s, k) and chunk), and the inner loop is
// one FFMA (1 + u*v), one approximate reciprocal (rcp.approx.ftz.f32, one
// MUFU op) and one FFMA into the accumulator.  What bounds this design: that
// one MUFU reciprocal per activation.  At the headline (B=2560, S=2072,
// N=100, K=2) 530 M reciprocals and 5.5 M exponentials on 132 SMs x 16 MUFU
// lanes at 1980 MHz take 0.128 ms; the 2 FFMAs per activation on the 128
// FP32 lanes and the 42 MB output are well below that.  The function itself
// needs less: two activations can share one reciprocal (1/(a*b), then
// 1/a = b/(a*b)) at 3.5 FP32 instructions each, which halves the MUFU work
// (0.065 ms at the headline, the bound chip_smoke.py reports).  (The
// unfactored form spends an accurate expf and an IEEE division on every
// activation: twice the MUFU work plus the range reduction and the
// division's slow-path test.)
//
// The guard.  The shift c is the midpoint of the chunk's t' range for that
// coalition and class, and the factored route is taken only where the range
// is at most kSpread = 80, so |t' - c| <= 40 and v lies in [e^-40, e^40]:
// normal floats.  dp - c is clamped to [-kClamp, kClamp] = [-87, 87], where
// u stays normal too (e^87 = 6.1e37 < FLT_MAX, e^-87 = 1.6e-38 > FLT_MIN).
// A clamp changes the result only where |dp - c| > 87, and then the true
// x = (dp - c) - (t' - c) has |x| > 47 and so has the clamped one: sigmoid
// is 1 in f32 there or below e^-47 = 3.9e-21, for both.  (Given the guard,
// the clamp keeps every product's factors normal rather than rescuing a
// result: u*v may still overflow to inf (1/inf = 0) or fall below FLT_MIN
// (1 + u*v = 1), each only where sigmoid is within 3e-38 of 0 or rounds to
// 1 anyway.)  Otherwise the error is that of two accurate expfs, one FFMA
// and a 1-ulp reciprocal, a few 1e-7, against the 1e-5 bar of the plain
// version.  A coalition whose chunk spreads wider than kSpread (or holds a
// non-finite t') takes the kernel's exact loop for that chunk:
// the unfactored 1 / (1 + expf(-x)) with an IEEE division, on t' kept
// unconverted in shared memory.
//
// Staging and tiles.  One block carries one class: binary softmax its class
// difference, sigmoid class k = blockIdx.z, so every class count runs the
// same tile.  Nothing inside a dependent chain reads global memory: per
// chunk and slice of kMC = 16 groups, the block stages the mask's slice
// (transposed, so a warp's 64 coalitions read neighbouring banks), the rows'
// and the background rows' group logits and the background logits, then
// forms t' and every row's dp from shared memory, group-outer over the R
// rows.  A chunk's sums live only through the chunk and are added to the
// output after it.  R = 20 rows a thread (TB = 80), a chunk of 120
// background rows, built for 4 resident blocks an SM: 64 registers, no
// spills.  At the headline the grid is 32 x 33 = 1056 blocks = 132 SMs x 8,
// two full waves of 528.  The general-K softmax branch is a kernel of its
// own with its own tiles (R = 16 at K = 1 down to 1 at K = 32).
//
// Past 32 classes (kRegisterK) the general-K softmax takes a class-tiled
// kernel, softmax_tiled_kernel, so that no register array is K wide and any
// K runs.  A denominator spans every class, so each background chunk of
// kTiledNC rows takes two passes over the classes, kTiledKC at a time, with
// the tile's t' staged in shared memory each time: the first keeps, per
// (row, background row) in registers, the running max and denominator
// (rescaled when the max moves), the second adds w_n * e_k / den into the
// tile's sums and adds them to the thread's own out[b, s, k0..] (written by
// the first chunk).  Each output element has one owning thread, so there
// are no atomics and two launches are bit-identical.  Arithmetic: accurate
// expf, one IEEE division per (b, s, n); K + K/kTiledKC + K exponentials
// per (b, s, n), so at a K of 100 about twice the MUFU work of the
// function's K exponentials.  It is the simple kernel of its branch: its
// times sit beside its bound in PERF.md.  Sigmoid takes any K up to the
// grid's z limit (kMaxGridZ = 65535 classes), one class a block.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTS = 64;                     // coalitions per block
constexpr int kTBY = kThreads / kTS;        // instance rows per pass
constexpr int kSmemBudget = 48 * 1024;      // bytes of staged background:
                                            // the limit without an opt-in
constexpr int kRegisterK = 32;             // widest class array of softmax_kernel
constexpr int kMaxGridZ = 65535;            // sigmoid: classes on the grid's z axis
constexpr float kSpread = 80.0f;            // widest t' range of a chunk the
                                            // factored route takes
constexpr float kClamp = 87.0f;             // |dp - shift| clamp: exp normal
constexpr int kMC = 16;                     // groups a staged mask slice holds
constexpr int kSigmoidBlocks = 4;           // resident blocks an SM the
                                            // sigmoid-form kernel is built for
constexpr int kSigmoidRows = 20;            // sigmoid form: rows a thread
constexpr int kSigmoidTB = kTBY * kSigmoidRows;
// sigmoid form: background rows per chunk, its staged values, weights,
// background logits and background group logits (kTS + 2 + kMC floats a
// row), with the shifts, the mask slice and the rows' slice, within the
// budget
constexpr int kSigmoidChunkRows =
    (kSmemBudget / 4 - kTS - kMC * kTS - kSigmoidTB * kMC) / (kTS + 2 + kMC);

// class-tiled softmax: classes a tile, background rows a chunk, rows a thread
constexpr int kTiledKC = 8;
constexpr int kTiledNC = 16;
constexpr int kTiledRows = 2;
constexpr int kTiledTB = kTBY * kTiledRows;

// softmax: instances per thread for a register class-array of width KT
__host__ __device__ constexpr int rows_for(int kt) {
  return kt == 1 ? 16 : (kt == 2 ? 8 : (kt <= 8 ? 4 : (kt == 16 ? 2 : 1)));
}

static_assert(kSmemBudget / (4 * (kRegisterK * kTS + 1)) >= 1,
              "one background row of the widest class tile must fit");
static_assert(kSigmoidChunkRows >= 1, "one sigmoid-form background row must fit");
static_assert(sizeof(float) * (kTiledKC * kTiledNC * kTS + kTiledNC) <= kSmemBudget,
              "a class tile of a chunk must fit without an opt-in");
static_assert(kTS * 4 == kThreads, "the shift reduction gives four lanes a coalition");

typedef void (*EyKernel)(const float*, const float*, const float*, const float*,
                         const float*, float*, int, int, int, int, int, int);

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// t'[k,n,s] = t2[s,n,k] - bgW[n,k] (binary: of the class difference) for
// coalition sg < S and background row n
__device__ __forceinline__ float background_logit(const float* __restrict__ bgWg,
                                                  const float* __restrict__ bgW,
                                                  const float* __restrict__ mask,
                                                  int sg, int n, int k, int M, int K,
                                                  bool binary) {
  const float* mk = mask + (size_t)sg * M;
  const float* bw = bgWg + (size_t)n * M * K;
  const float* bl = bgW + (size_t)n * K;
  float v = 0.0f;
  if (binary) {
    for (int m = 0; m < M; ++m) v = fmaf(mk[m], bw[m * K + 1] - bw[m * K], v);
    return v - (bl[1] - bl[0]);
  }
  for (int m = 0; m < M; ++m) v = fmaf(mk[m], bw[m * K + k], v);
  return v - bl[k];
}

// The general-K softmax branch.
template <int KT>
__global__ void __launch_bounds__(kThreads)
softmax_kernel(const float* __restrict__ XWg, const float* __restrict__ bgWg,
               const float* __restrict__ bgW, const float* __restrict__ bgw,
               const float* __restrict__ mask, float* __restrict__ out,
               int B, int S, int N, int M, int K, int NC) {
  constexpr int R = rows_for(KT);
  constexpr int TB = kTBY * R;
  const int KE = K;

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
      for (int m = 0; m < M; ++m) v = fmaf(mk[m], xw[m * K + k], v);
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
      t2s[(k * NC + n) * kTS + sl] =
          sg < S ? background_logit(bgWg, bgW, mask, sg, n0 + n, k, M, K, false) : 0.0f;
    }
    for (int idx = threadIdx.x; idx < nc; idx += kThreads) ws[idx] = bgw[n0 + idx];
    __syncthreads();

    for (int n = 0; n < nc; ++n) {
      const float wn = ws[n];
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
    }
  }

  if (!s_ok) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b_base + r * kTBY;
    if (b >= B) continue;
    float* o = out + ((size_t)b * S + s) * K;
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if (k < KE) o[k] = acc[r][k];
  }
}

// Stage the t' of classes [k0, k0 + kc) and background rows [n0, n0 + nc)
// of the block's coalitions, and the chunk's weights, into shared memory.
// Starts with a barrier, so the block is done with the previous tile.
__device__ __forceinline__ void stage_class_tile(float* ts, float* ws,
                                                 const float* __restrict__ bgWg,
                                                 const float* __restrict__ bgW,
                                                 const float* __restrict__ bgw,
                                                 const float* __restrict__ mask,
                                                 int s0, int S, int n0, int nc, int k0,
                                                 int kc, int M, int K) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < kc * nc * kTS; idx += kThreads) {
    const int sl = idx % kTS;
    const int n = (idx / kTS) % nc;
    const int kk = idx / (kTS * nc);
    const int sg = s0 + sl;
    ts[(kk * kTiledNC + n) * kTS + sl] =
        sg < S ? background_logit(bgWg, bgW, mask, sg, n0 + n, k0 + kk, M, K, false) : 0.0f;
  }
  for (int idx = threadIdx.x; idx < nc; idx += kThreads) ws[idx] = bgw[n0 + idx];
  __syncthreads();
}

// p[r][kk] = sum_m mask[s,m] * XWg[b_r,m,k0+kk] for the thread's rows and the
// tile's classes (0 past kc)
__device__ __forceinline__ void tile_row_logits(float (&p)[kTiledRows][kTiledKC],
                                                const float* __restrict__ XWg,
                                                const float* __restrict__ mk,
                                                const int (&br)[kTiledRows], int k0,
                                                int kc, int M, int K) {
#pragma unroll
  for (int r = 0; r < kTiledRows; ++r)
#pragma unroll
    for (int kk = 0; kk < kTiledKC; ++kk) p[r][kk] = 0.0f;
  for (int m = 0; m < M; ++m) {
    const float mv = mk[m];
#pragma unroll
    for (int r = 0; r < kTiledRows; ++r) {
      const float* xw = XWg + ((size_t)br[r] * M + m) * K + k0;
#pragma unroll
      for (int kk = 0; kk < kTiledKC; ++kk)
        if (kk < kc) p[r][kk] = fmaf(mv, xw[kk], p[r][kk]);
    }
  }
}

// The general-K softmax past kRegisterK classes (or forced): class tiles of
// kTiledKC, two passes per background chunk.  See the head comment.
__global__ void __launch_bounds__(kThreads)
softmax_tiled_kernel(const float* __restrict__ XWg, const float* __restrict__ bgWg,
                     const float* __restrict__ bgW, const float* __restrict__ bgw,
                     const float* __restrict__ mask, float* __restrict__ out,
                     int B, int S, int N, int M, int K, int NC) {
  constexpr int R = kTiledRows;
  constexpr int KC = kTiledKC;
  constexpr int NCT = kTiledNC;

  extern __shared__ float smem[];
  float* ts = smem;                         // [KC][NCT][kTS]: t' of a class tile
  float* ws = ts + KC * NCT * kTS;          // [NCT]

  const int tx = threadIdx.x % kTS;
  const int ty = threadIdx.x / kTS;
  const int s0 = blockIdx.y * kTS;
  const int s = s0 + tx;
  const bool s_ok = s < S;
  // coalitions past S and rows past B read the last one and are never written
  const float* mk = mask + (size_t)min(s, S - 1) * M;
  int br[R];
#pragma unroll
  for (int r = 0; r < R; ++r) br[r] = min((int)blockIdx.x * kTiledTB + ty + r * kTBY, B - 1);

  for (int n0 = 0; n0 < N; n0 += NC) {
    const int nc = min(NC, N - n0);
    // pass 1: per (row, background row), the max and the denominator over
    // every class, one class tile at a time
    float mx[R][NCT], den[R][NCT];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int n = 0; n < NCT; ++n) {
        mx[r][n] = -INFINITY;
        den[r][n] = 0.0f;
      }
    for (int k0 = 0; k0 < K; k0 += KC) {
      const int kc = min(KC, K - k0);
      stage_class_tile(ts, ws, bgWg, bgW, bgw, mask, s0, S, n0, nc, k0, kc, M, K);
      float p[R][KC];
      tile_row_logits(p, XWg, mk, br, k0, kc, M, K);
#pragma unroll
      for (int n = 0; n < NCT; ++n) {
        if (n < nc) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float tm = -INFINITY;
#pragma unroll
            for (int kk = 0; kk < KC; ++kk)
              if (kk < kc) tm = fmaxf(tm, p[r][kk] - ts[(kk * NCT + n) * kTS + tx]);
            const float m_new = fmaxf(mx[r][n], tm);
            float sum = mx[r][n] == -INFINITY ? 0.0f : den[r][n] * expf(mx[r][n] - m_new);
#pragma unroll
            for (int kk = 0; kk < KC; ++kk)
              if (kk < kc) sum += expf(p[r][kk] - ts[(kk * NCT + n) * kTS + tx] - m_new);
            mx[r][n] = m_new;
            den[r][n] = sum;
          }
        }
      }
    }
    // den becomes the row's scale w_n / den: one IEEE division per (b, s, n)
#pragma unroll
    for (int n = 0; n < NCT; ++n)
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (n < nc) den[r][n] = ws[n] / den[r][n];
    // pass 2: per class tile, the sums of w_n * e_k / den over the chunk,
    // added to the thread's own output row
    for (int k0 = 0; k0 < K; k0 += KC) {
      const int kc = min(KC, K - k0);
      stage_class_tile(ts, ws, bgWg, bgW, bgw, mask, s0, S, n0, nc, k0, kc, M, K);
      float p[R][KC];
      tile_row_logits(p, XWg, mk, br, k0, kc, M, K);
      float acc[R][KC];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) acc[r][kk] = 0.0f;
#pragma unroll
      for (int n = 0; n < NCT; ++n) {
        if (n < nc) {
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int kk = 0; kk < KC; ++kk)
              if (kk < kc)
                acc[r][kk] = fmaf(den[r][n],
                                  expf(p[r][kk] - ts[(kk * NCT + n) * kTS + tx] - mx[r][n]),
                                  acc[r][kk]);
        }
      }
      if (!s_ok) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = (int)blockIdx.x * kTiledTB + ty + r * kTBY;
        if (b >= B) break;
        float* o = out + ((size_t)b * S + s) * K + k0;
#pragma unroll
        for (int kk = 0; kk < KC; ++kk)
          if (kk < kc) o[kk] = n0 == 0 ? acc[r][kk] : o[kk] + acc[r][kk];
      }
    }
  }
}

// the logit of the block's class in a row of K: binary softmax takes the
// difference of classes 1 and 0, sigmoid class k
template <bool BINARY>
__device__ __forceinline__ float class_logit(const float* p, int k) {
  return BINARY ? p[1] - p[0] : p[k];
}

// The sigmoid-form branches: binary softmax (BINARY, the complement written
// as k=0) and sigmoid (class blockIdx.z).  See the head comment.
template <bool BINARY>
__global__ void __launch_bounds__(kThreads, kSigmoidBlocks)
sigmoid_kernel(const float* __restrict__ XWg, const float* __restrict__ bgWg,
               const float* __restrict__ bgW, const float* __restrict__ bgw,
               const float* __restrict__ mask, float* __restrict__ out,
               int B, int S, int N, int M, int K, int NC) {
  constexpr int R = kSigmoidRows;
  constexpr int TB = kTBY * R;
  const int k = BINARY ? 1 : blockIdx.z;

  extern __shared__ float smem[];
  float* vs = smem;                         // [NC][kTS]: t', then v
  float* ws = vs + NC * kTS;                // [NC]
  float* bl = ws + NC;                      // [NC]: background logits
  float* bd = bl + NC;                      // [NC][kMC]: background group
                                            // logits of a slice of groups
  float* shift = bd + NC * kMC;             // [kTS]; NaN: exact loop
  float* ms = shift + kTS;                  // [kMC][kTS]: the mask's slice
  float* xs = ms + kMC * kTS;               // [TB][kMC]: the rows' slice

  const int tx = threadIdx.x % kTS;
  const int ty = threadIdx.x / kTS;
  const int s0 = blockIdx.y * kTS;
  const int ns = min(kTS, S - s0);
  const int s = s0 + tx;
  const int b0 = blockIdx.x * TB;
  const bool s_ok = tx < ns;

  // Per chunk: dp[r] (then u) and the chunk's sums acc[r], added to the
  // output after the chunk, so no sum is live while the next chunk is
  // staged.
  for (int n0 = 0; n0 < N; n0 += NC) {
    const int nc = min(NC, N - n0);
    float dp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) dp[r] = 0.0f;
    // the group contractions of t' and dp, kMC groups a pass, from shared
    // memory: fmaf chains over m in order
    for (int m0 = 0; m0 < M; m0 += kMC) {
      const int mc = min(kMC, M - m0);
      __syncthreads();  // the previous slice or chunk is consumed
      for (int idx = threadIdx.x; idx < kTS * mc; idx += kThreads) {
        const int sl = idx / mc, mm = idx % mc;
        ms[mm * kTS + sl] = sl < ns ? mask[(size_t)(s0 + sl) * M + m0 + mm] : 0.0f;
      }
      for (int idx = threadIdx.x; idx < nc * mc; idx += kThreads) {
        const int mm = idx % mc, n = idx / mc;
        bd[n * kMC + mm] = class_logit<BINARY>(bgWg + ((size_t)(n0 + n) * M + m0 + mm) * K, k);
      }
      // rows past B repeat row B-1 and are never written
      for (int idx = threadIdx.x; idx < TB * mc; idx += kThreads) {
        const int mm = idx % mc, lr = idx / mc;
        xs[lr * kMC + mm] =
            class_logit<BINARY>(XWg + ((size_t)min(b0 + lr, B - 1) * M + m0 + mm) * K, k);
      }
      if (m0 == 0) {
        for (int idx = threadIdx.x; idx < nc; idx += kThreads) {
          ws[idx] = bgw[n0 + idx];
          bl[idx] = class_logit<BINARY>(bgW + (size_t)(n0 + idx) * K, k);
        }
      }
      __syncthreads();
      const bool last = m0 + mc == M;
      for (int idx = threadIdx.x; idx < nc * kTS; idx += kThreads) {
        const int sl = idx % kTS, n = idx / kTS;
        const float* bk = bd + n * kMC;
        float v = m0 == 0 ? 0.0f : vs[idx];
        for (int mm = 0; mm < mc; ++mm) v = fmaf(ms[mm * kTS + sl], bk[mm], v);
        vs[idx] = last ? v - bl[n] : v;
      }
      for (int mm = 0; mm < mc; ++mm) {
        const float mv = ms[mm * kTS + tx];
#pragma unroll
        for (int r = 0; r < R; ++r) dp[r] = fmaf(mv, xs[(ty + r * kTBY) * kMC + mm], dp[r]);
      }
    }
    __syncthreads();
    // the shift of each coalition: the midpoint of the chunk's t' range, or
    // NaN where the range is wider than kSpread or not finite; four
    // neighbouring lanes share a coalition (kTS * 4 == kThreads)
    {
      const int q = threadIdx.x % 4, sl = threadIdx.x / 4;
      float lo = vs[sl], hi = vs[sl];
      for (int n = q; n < nc; n += 4) {
        lo = fminf(lo, vs[n * kTS + sl]);
        hi = fmaxf(hi, vs[n * kTS + sl]);
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      if (q == 0) shift[sl] = hi - lo <= kSpread ? 0.5f * (lo + hi) : nanf("");
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nc * kTS; idx += kThreads) {
      const float c = shift[idx % kTS];
      if (!isnan(c)) vs[idx] = expf(vs[idx] - c);
    }
    __syncthreads();
    if (!s_ok) continue;

    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    const float c = shift[tx];
    const float* col = vs + tx;
    if (isnan(c)) {
      for (int n = 0; n < nc; ++n) {
        const float t = col[n * kTS], wn = ws[n];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(wn, sigmoid_f32(dp[r] - t), acc[r]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a = dp[r] - c;      // comparisons, not fminf/fmaxf: NaN stays NaN
        a = a > kClamp ? kClamp : (a < -kClamp ? -kClamp : a);
        dp[r] = expf(-a);         // u
      }
#pragma unroll 4
      for (int n = 0; n < nc; ++n) {
        const float v = col[n * kTS], wn = ws[n];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(wn, rcp_approx(fmaf(dp[r], v, 1.0f)), acc[r]);
      }
    }
    // rows ascend with r: the first past B ends the thread's rows
    float* o = out + ((size_t)(b0 + ty) * S + s) * K;
#pragma unroll
    for (int r = 0; r < R; ++r, o += (size_t)kTBY * S * K) {
      if (b0 + ty + r * kTBY >= B) break;
      if (BINARY) {
        // two stores, not one float2: its register pair made the build spill
        const float e = n0 == 0 ? acc[r] : o[1] + acc[r];
        o[0] = 1.0f - e;
        o[1] = e;
      } else {
        o[k] = n0 == 0 ? acc[r] : o[k] + acc[r];
      }
    }
  }
}

// What one call launches: the kernel, its grid, its dynamic shared memory
// and its background rows per chunk.
struct Plan {
  EyKernel fn;
  dim3 grid;
  size_t smem;
  int nc;
};

template <int KT>
Plan softmax_plan(int B, int S, int N, int K) {
  constexpr int TB = kTBY * rows_for(KT);
  // background rows per shared-memory chunk: K*NC*kTS + NC floats, at most
  // kSmemBudget bytes (K <= kRegisterK keeps NC >= 1)
  int nc = kSmemBudget / (int)(sizeof(float) * (K * kTS + 1));
  nc = nc > N ? N : nc;
  return {softmax_kernel<KT>, dim3((B + TB - 1) / TB, (S + kTS - 1) / kTS),
          sizeof(float) * ((size_t)K * nc * kTS + nc), nc};
}

// the general-K softmax's class-width instantiation for K classes
Plan softmax_by_width(int B, int S, int N, int K) {
  if (K <= 1) return softmax_plan<1>(B, S, N, K);
  if (K <= 2) return softmax_plan<2>(B, S, N, K);
  if (K <= 4) return softmax_plan<4>(B, S, N, K);
  if (K <= 8) return softmax_plan<8>(B, S, N, K);
  if (K <= 16) return softmax_plan<16>(B, S, N, K);
  return softmax_plan<32>(B, S, N, K);
}

// one class a block: binary softmax's one carried class, or sigmoid's K on
// the grid's z axis
Plan sigmoid_plan(bool binary, int B, int S, int N, int K) {
  const int nc = kSigmoidChunkRows < N ? kSigmoidChunkRows : N;
  return {binary ? sigmoid_kernel<true> : sigmoid_kernel<false>,
          dim3((B + kSigmoidTB - 1) / kSigmoidTB, (S + kTS - 1) / kTS, binary ? 1 : K),
          sizeof(float) * ((size_t)nc * (kTS + 2 + kMC) + kTS + kMC * kTS + kSigmoidTB * kMC),
          nc};
}

// the class-tiled softmax: any K, the chunk fixed at kTiledNC rows
Plan softmax_tiled_plan(int B, int S) {
  return {softmax_tiled_kernel, dim3((B + kTiledTB - 1) / kTiledTB, (S + kTS - 1) / kTS),
          sizeof(float) * ((size_t)kTiledKC * kTiledNC * kTS + kTiledNC), kTiledNC};
}

// activation: 0 = softmax, 1 = sigmoid, 2 = softmax through the class-tiled
// kernel at any K (what K > kRegisterK takes anyway)
bool valid(int B, int S, int N, int M, int K, int activation) {
  return B > 0 && S > 0 && N > 0 && M > 0 && K > 0 &&
         (activation == 0 || activation == 2 || (activation == 1 && K <= kMaxGridZ));
}

Plan make_plan(int B, int S, int N, int K, int activation) {
  if (activation == 1) return sigmoid_plan(false, B, S, N, K);
  if (activation == 2 || K > kRegisterK) return softmax_tiled_plan(B, S);
  return K == 2 ? sigmoid_plan(true, B, S, N, K) : softmax_by_width(B, S, N, K);
}

}  // namespace

extern "C" {

// the most classes the sigmoid branch takes (one class a block on the
// grid's z axis); softmax takes any K
int fused_linear_ey_max_sigmoid_k() { return kMaxGridZ; }

// activation: 0 = softmax, 1 = sigmoid, 2 = softmax through the class-tiled
// kernel (any K; K > 32 takes it with 0 as well).  All pointers are device
// pointers to contiguous float32 arrays; bgw must sum to 1 for binary
// softmax.  Returns the cudaError_t of the launch (0 on success).
int fused_linear_ey_launch(const float* XWg, const float* bgWg,
                           const float* bgW, const float* bgw,
                           const float* mask, float* out, int B, int S, int N,
                           int M, int K, int activation, void* stream) {
  if (!valid(B, S, N, M, K, activation)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, S, N, K, activation);
  p.fn<<<p.grid, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      XWg, bgWg, bgW, bgw, mask, out, B, S, N, M, K, p.nc);
  return (int)cudaGetLastError();
}

// What a call at (B, S, N, K, activation) launches, into info[0..6]: blocks,
// threads a block, dynamic shared memory bytes, resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers a thread and
// local memory bytes a thread (cudaFuncGetAttributes), background rows per
// chunk.  Returns the cudaError_t of the first query that failed.
int fused_linear_ey_launch_info(int B, int S, int N, int K, int activation, int* info) {
  if (!valid(B, S, N, 1, K, activation)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, S, N, K, activation);
  int per_sm = 0;
  int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(p.fn), kThreads, p.smem);
  if (err) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(p.fn));
  if (err) return err;
  info[0] = (int)(p.grid.x * p.grid.y * p.grid.z);
  info[1] = kThreads;
  info[2] = (int)p.smem;
  info[3] = per_sm;
  info[4] = attr.numRegs;
  info[5] = (int)attr.localSizeBytes;
  info[6] = p.nc;
  return 0;
}

}  // extern "C"
