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
// two full waves of 528.  Sigmoid takes any K up to the grid's z limit
// (kMaxGridZ = 65535 classes), one class a block.
//
// The general-K softmax (every softmax K but 2, K = 1 included) runs
// factored: a prologue launch, softmax_v_kernel, then in the same call
// softmax_factored_kernel past kRegsMaxK = 16 classes, and up to it the
// small-K route, softmax_factored_kernel_regs (further down).  The route is
// chosen by K alone (fused_linear_ey_route).  Its logit p1[b,s,k] - t'[k,n,s] is a
// sum of an instance term and a background term, so the exponential
// factors.  With the shifts alpha[b,s] = max_k p1 and gamma[s,n] =
// max_k -t',
//
//   u[b,s,k]  = exp(p1 - alpha)   in (0, 1]    K B S exponentials
//   v[s,n,k]  = exp(-t' - gamma)  in (0, 1]    K S N exponentials
//   D[b,s,n]  = sum_k u v                      K FFMAs per (b, s, n)
//   r[b,s,n]  = bgw[n] / D                     one reciprocal per (b, s, n)
//   ey[b,s,k] = u[b,s,k] * sum_n r v[s,n,k]    K FFMAs per (b, s, n)
//
// (at K = 2 the sigmoid form's 1 / (1 + u v)).  Per coalition these are two
// small f32 products, (rows x K)(K x N) and (rows x N)(N x K), around an
// elementwise reciprocal: the exponentials leave the (b, s, n) loop and the
// work goes to the FP32 lanes.  The prologue writes v once per (s, n, k),
// one warp per (s, n), into the wrapper's scratch (S N K floats).  A block
// of the main kernel takes kFTB = 64 rows and up to kFMaxSPB = 16
// coalitions, one after another (fewer where the grid would fall under 8
// waves); the row tiles run fastest, so a group of coalitions' v stays in
// L2 across them.  Where they fit beside two blocks an SM, the rows' XWg
// stay in shared memory for all the block's coalitions (at a Covertype
// chunk; not at K = 100, M = 12, 300 KB).  Per coalition the block forms
// p1 for every class in shared memory (ures: where that fits, every K up
// to ~400; past it u is formed per class tile), four elements a thread at
// a time; alpha and u, four lanes a row; then per pass over at most
// kFMaxNR background rows:
//
// - pass 1, D: each thread owns 4 rows x 8 background rows in registers;
//   per class tile (KC = 4 CG classes, CG = 1..16 the class groups of pass
//   2) v is staged in shared memory with cp.async and u and v are read as
//   float4s, 32 FFMAs per three loads; a background chunk is kFNC = 128
//   rows.  Then r = w * rcp.approx.ftz(D), or 0 and a flag (the guard,
//   below), goes to shared memory;
// - pass 2, the output: per class tile each thread owns 4 rows x 4 classes
//   of one of NG = 16 / CG background groups (n = g mod NG) and adds r v
//   over the pass's rows, 16 FFMAs per two loads; the groups' partial sums
//   are added in group order through shared memory (in v's place), times u,
//   and written once (added to, on a second pass past kFMaxNR background
//   rows).
//
// No atomics touch the output: each element has one owner in each step, so
// two launches are bit-identical (the flags are set by a shared-memory
// atomicOr, which commutes).  Shared memory: ~100 KB at N = 100, K = 100,
// ~78 KB at a Covertype chunk (two blocks an SM), up to ~218 KB at K = 257,
// N >= kFMaxNR, opted into past 48 KB with cudaFuncSetAttribute.
//
// The guard.  u and v are at most 1, so D <= K and nothing overflows; D can
// underflow, where the instance's top class and the background row's top
// class disagree by more than ~87 in logit.  The factored route takes a
// (b, s, n) only where D >= kTau = 2^-100.  Why r = w/D and the sums stay
// finite and right there:
//
// - r <= 2^100 w, so sum_n r v[n,k] <= 2^100 (sum w = 1, v <= 1): every
//   accumulator is finite, far below FLT_MAX = 2^128;
// - D is a normal float, so rcp.approx.ftz does not flush it, and its error
//   is that of K fmafs; a product u v that is subnormal or flushed moves D
//   by at most 2^-149 absolute, 2^-49 of D;
// - a subnormal u or v is off by at most 2^-150, which moves a probability
//   u_k v_k / D by at most 2^-150 / 2^-100 = 2^-50 and the output u_k acc_k
//   by at most 2^-150 2^100 = 2^-50: far below the 1e-5 bar.
//
// Below 2^-126 the reciprocal flushes D to zero, and there K subnormal
// roundings of 2^-150 reach the 1e-5 bar at K = 257; kTau keeps 2^26 of
// room above that and bounds the sums by 2^100.  Where D < kTau, or D is
// NaN (a non-finite p1), or the background row has a non-finite t' (the
// prologue writes its v as zeros, so D = 0 and no NaN reaches the sums of
// pass 2), the kernel computes that (b, s, n) exactly: r is 0 and a bit
// is set, and after the pass's outputs are written the block adds, per
// flagged pair in background order, bgw / Z * exp(x_k - m), with
// x = p1 - t' recomputed from the inputs,
// m = max_k x and Z = sum_k exp(x_k - m) (accurate expf, an IEEE
// division): the reference's max-subtracted exponentials.  Those
// contributions cannot be scaled by u afterwards (u may be e^-80), so they
// go straight into the output, four lanes a row, after a barrier: the exact
// route reads its outputs back, the factored route never does.
//
// The function's floor under this contract (chip_smoke.py's ey_bound_ms):
// B S N reciprocals and K (B S + S N) exponentials on the SFUs, 2 K B S N
// FFMAs and M K (B S + S N) on the FP32 lanes, over the bytes: 3.3688 ms at
// K = 100 and the headline shape, 6.0241 ms a Covertype chunk (FP32, 132
// SMs at 1980 MHz).  What the kernel spends beyond it: class tiles of 64
// past K = 64 (36 of 64 classes live in the second at K = 100) and of 8 at
// K = 7 (7 live), chunks of 128 background rows (100 live at N = 100), the
// group sums of p1 from global memory where XWg is not resident (M loads an
// element), the loads and stores of r and the partial sums, a handful of
// barriers per coalition with 16 warps an SM to hide them (PERF.md).
//
// The small-K route (softmax_factored_kernel_regs<KT>, 1 <= K <= kRegsMaxK,
// K != 2) runs the same arithmetic after the same prologue, with everything
// of a (b, s) in registers: KT = K up to 8, past it 12 or 16 with the
// classes past K zero.  A block of 8 warps takes TBR = 128 rows (64 past
// K = 8) and up to kRMaxGPB groups of 8 coalitions, one coalition a warp,
// so a lane owns R = 4 (2) neighbouring rows of its warp's coalition and
// holds u[R][KT] and the output sums acc[R][KT].  Per background row the
// warp reads v and w as broadcasts from shared memory (two float4s and a
// float at K <= 8, shared by the R rows) and a lane does, per row, K FFMAs
// for D, one rcp.approx.ftz, one multiply by w and K FFMAs into acc: no pass
// 2, no r in shared memory, no barrier inside a coalition.  The block's
// barriers are where it stages v, per group of coalitions and chunk of
// 1024 / KP background rows, with cp.async into one of two buffers while
// the other is read (one buffer, and a barrier more, where two do not fit
// beside the rows' XWg).  p1 comes from the rows' XWg, staged once a block
// into shared memory transposed (44 KB at a Covertype chunk), or, where it
// does not fit beside one buffer, MS groups at a time at each group of
// coalitions.  A warp puts its outputs into its own region of the stage
// buffer, and the block writes each row's outputs of the group's
// coalitions, neighbours in out, with neighbouring threads.
//
// What bounds the route: issue slots, 2K + 2 a (b, s, n) in the loop.  At a
// Covertype chunk (B = 65536, S = 2072, N = 100, K = 7) those 16 slots take
// ~6.5 ms on 132 SMs x 4 schedulers at 1980 MHz, the B S N reciprocals on
// the MUFU ~3.3 ms beside them; the kernel takes ~13.9 ms (PERF.md): p1 and
// u (~10% of the slots), the staging, the guard's check and the output
// flush, with 16 warps an SM (128 registers, two blocks) to hide the
// reciprocal's latency.  The guard is the factored kernel's, checked once a
// chunk for a warp: where u has no NaN and every v of the chunk is at least
// kTau, every D is at least v of the row's top class (u = 1 there, and
// rounding is monotone), so the loop runs unguarded; otherwise r is 0 and a
// flag bit is set for each D below kTau or NaN, and once the outputs are
// formed the lane adds each flagged row's exact contributions in background
// order, D recomputed from v in global memory (the same bits).  No atomics:
// two launches are bit-identical.  The sum over n runs in background order,
// one chain a (b, s, k), so results differ from the factored kernel's in
// rounding only.  The threshold kRegsMaxK = 16 comes from a same-call A/B
// against the factored kernel (PERF.md: the route wins 2.1-3.0x from K = 3
// to 16); past 16 classes u and acc would not fit 128 registers at two rows
// a lane, and the factored kernel's class tiles in shared memory serve K >
// 16 (K = 32, the 100-class LR) as before.
//
// The epilogue.  Every route can write, in place of ey, the right-hand
// operand of the weighted least squares that follows it:
//
//   out[b,s,k] = link(ey[b,s,k]) - E[k] - zl[s] * fxme[b,k],  zl[s] = mask[s,M-1]
//
// with E the expected value in link space and fxme = f(x) - E (the link
// code kLinkNone writes ey itself).  It is applied where an element is
// final: in the small-K route in registers, as a lane forms its rows'
// outputs at a coalition's end (R KT independent chains; a row the guard
// flagged takes it in the warp's region after its exact route), in the
// sigmoid form by each thread on its own outputs after the last background
// chunk's store (inside that store's unrolled loop the R sums would
// spill), and in the factored kernel at pass 2's store of the last pass
// where no (b, s, n) of it took the exact route, else by each lane on its
// own elements after that route.  What it costs a Covertype chunk: ~14%
// (PERF.md), for the B S K logf and IEEE divisions and the coalition-major
// store below.  wls_operand
// does the arithmetic of the torch ops it replaces, op for op, so the
// operand is theirs bit for bit: the logit link's clamp to [1e-7, 1 - 1e-7]
// by comparisons (NaN stays NaN, as torch.clamp leaves it), its bounds the
// float nearest the double each is, 1 - p, an IEEE division and an accurate
// logf (no fast-math intrinsic), then the two subtractions, with explicit
// roundings so that no contraction into an FMA moves a bit.  The small-K
// route writes the operand coalition-major, out[s,b,k] at (s B + b) K + k:
// the layout in which the contraction that follows it ("sm,bsk->bkm", a
// bmm over (S, B K)) reads it, so no transposing copy of it is made.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kTS = 64;                     // coalitions per block
constexpr int kTBY = kThreads / kTS;        // instance rows per pass
constexpr int kSmemBudget = 48 * 1024;      // bytes of staged background:
                                            // the limit without an opt-in
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

// the factored general softmax
constexpr int kFTB = 64;                    // instance rows a block
constexpr int kFGroups = 16;                // row groups of 4; pass 1's
                                            // background groups of 8
constexpr int kFNC = kFGroups * 8;          // background rows a staged chunk
constexpr int kFMaxNR = 256;                // background rows a pass keeps r of
constexpr int kFRS = kFTB + 16;             // row stride of r[n][row]
constexpr int kFMaxCG = 16;                 // class groups of 4 in a tile
constexpr int kFRed = kFGroups * 4 * kFTB;  // pass 2's partials: NG KC = 64 a row
constexpr int kFMaxSPB = 16;                // coalitions a block, at most
constexpr float kTau = 0x1p-100f;           // least D the factored route takes
constexpr int kFMaxSmem = 227 * 1024;       // a block's shared memory on sm_90
constexpr int kFTwoBlocks = 228 * 1024 / 2 - 1024;  // two blocks' share of an SM

// the small-K route (softmax_factored_kernel_regs)
constexpr int kRegsMaxK = 16;               // K_small: the most classes it takes
constexpr int kRWarps = kThreads / 32;      // coalitions a group: one a warp
constexpr int kRChunk = 1024;               // floats of a coalition's staged v chunk
constexpr int kRRegion = kRChunk + 8;       // a warp's region of a stage: a chunk
                                            // and 8 floats that spread the output
                                            // flush over the banks
constexpr int kRMaxGPB = 16;                // groups of coalitions a block, at most

// the epilogue's link codes (fused_linear_ey_launch's link) and the logit
// link's clamp, each bound the float nearest the double ops/links.py has
constexpr int kLinkNone = 0, kLinkIdentity = 1, kLinkLogit = 2;
constexpr float kLogitLo = static_cast<float>(1e-7);
constexpr float kLogitHi = static_cast<float>(1.0 - 1e-7);

static_assert(kSigmoidChunkRows >= 1, "one sigmoid-form background row must fit");
static_assert(kTS * 4 == kThreads, "the shift reduction gives four lanes a coalition");
static_assert(kFGroups * kFGroups == kThreads && kFTB == 4 * kFGroups,
              "the factored passes give each thread 4 of the block's rows");
static_assert(kFTB * 4 == kThreads, "alpha and the exact route take four lanes a row");

// What a call writes in place of ey: the link code, E (K,) and fxme (B, K)
// (both unread under kLinkNone).
struct Epilogue {
  int link;
  const float* ev;
  const float* fxme;
};

typedef void (*EyKernel)(const float*, const float*, const float*, const float*,
                         const float*, float*, Epilogue, int, int, int, int, int, int);

// link(p) - e - zl * fxme, in the torch ops' order and roundings (see the
// head comment)
__device__ __forceinline__ float wls_operand(float p, int link, float e, float zl, float fxme) {
  if (link == kLinkLogit) {
    p = p < kLogitLo ? kLogitLo : (p > kLogitHi ? kLogitHi : p);  // NaN stays NaN
    p = logf(__fdiv_rn(p, __fsub_rn(1.0f, p)));
  }
  return __fsub_rn(__fsub_rn(p, e), __fmul_rn(zl, fxme));
}

// the value stored at out[b,s,k] for the raw ey y: y itself, or its operand
__device__ __forceinline__ float store_value(const Epilogue& ep, float y,
                                             const float* __restrict__ mask, int b, int s,
                                             int k, int M, int K) {
  if (ep.link == kLinkNone) return y;
  return wls_operand(y, ep.link, ep.ev[k], mask[(size_t)s * M + M - 1],
                     ep.fxme[(size_t)b * K + k]);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// sum_m mk[m] * x[m * K]: one fmaf per group, in order (a row's logit of a
// class, or a background row's group sum)
__device__ __forceinline__ float group_sum(const float* __restrict__ x,
                                           const float* __restrict__ mk, int M, int K) {
  float v = 0.0f;
#pragma unroll 4
  for (int m = 0; m < M; ++m) v = fmaf(mk[m], x[(size_t)m * K], v);
  return v;
}

// t'[k,n,s] = t2[s,n,k] - bgW[n,k] for the coalition whose mask row is mk
__device__ __forceinline__ float background_logit(const float* __restrict__ bgWg,
                                                  const float* __restrict__ bgW,
                                                  const float* __restrict__ mk, int n,
                                                  int k, int M, int K) {
  return group_sum(bgWg + (size_t)n * M * K + k, mk, M, K) - bgW[(size_t)n * K + k];
}

// The factored softmax's prologue: one warp per (coalition s, background row
// n) writes v[s,n,k] = exp(-t' - gamma) for every class, gamma = max_k -t';
// a row with a non-finite t' is written as zeros, which sends each (b, s, n)
// of it to the exact route (D = 0).
__global__ void __launch_bounds__(kThreads)
softmax_v_kernel(const float* __restrict__ bgWg, const float* __restrict__ bgW,
                 const float* __restrict__ mask, float* __restrict__ v, int S, int N,
                 int M, int K) {
  const size_t w = ((size_t)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (size_t)S * N) return;  // whole warps
  const int s = (int)(w / N), n = (int)(w % N);
  const float* mk = mask + (size_t)s * M;
  float g = -INFINITY;
  bool finite = true;
  for (int k = lane; k < K; k += 32) {
    const float t = background_logit(bgWg, bgW, mk, n, k, M, K);
    finite = finite && isfinite(t);
    g = fmaxf(g, -t);
  }
  for (int o = 16; o; o >>= 1) g = fmaxf(g, __shfl_xor_sync(0xffffffffu, g, o));
  finite = __all_sync(0xffffffffu, finite);
  float* dst = v + w * K;
  for (int k = lane; k < K; k += 32)
    dst[k] = finite ? expf(-background_logit(bgWg, bgW, mk, n, k, M, K) - g) : 0.0f;
}

// The exact route of the general softmax for one (b, s, n): adds
// bgw[n] / Z * exp(x_k - m) to o[k os] for k = k0, k0 + dk, ... below K, with
// x = p1 - t' recomputed from the inputs (xr the row's M x K logits, mk the
// coalition's mask row), m = max_k x and Z = sum_k exp(x_k - m): the
// reference's max-subtracted exponentials, accurate expf, an IEEE division.
__device__ __forceinline__ void softmax_exact_add(const float* xr, const float* __restrict__ mk,
                                                  const float* __restrict__ bgWg,
                                                  const float* __restrict__ bgW,
                                                  const float* __restrict__ bgw, int n, int M,
                                                  int K, float* o, int os, int k0,
                                                  int dk) {
  float m = -INFINITY;
  for (int k = 0; k < K; ++k)
    m = fmaxf(m, group_sum(xr + k, mk, M, K) - background_logit(bgWg, bgW, mk, n, k, M, K));
  float z = 0.0f;
  for (int k = 0; k < K; ++k)
    z += expf(group_sum(xr + k, mk, M, K) - background_logit(bgWg, bgW, mk, n, k, M, K) - m);
  const float c = bgw[n] / z;
  for (int k = k0; k < K; k += dk)
    o[k * os] = fmaf(c,
                     expf(group_sum(xr + k, mk, M, K) -
                          background_logit(bgWg, bgW, mk, n, k, M, K) - m),
                     o[k * os]);
}

// One float from global into shared memory, asynchronously (cp.async),
// zero-filled where !ok (src is then not read); cp_async_wait waits for the
// thread's own copies, a barrier after it shows them to the block.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The general-K softmax, factored: kFTB rows and SPB coalitions a block, CG
// class groups of 4 in a class tile, NR background rows a pass; u resident
// for every class (ures) or staged per class tile; the rows' XWg resident
// (xres) or read from global memory.  See the head comment.
__global__ void __launch_bounds__(kThreads, 2)
softmax_factored_kernel(const float* __restrict__ XWg, const float* __restrict__ bgWg,
                        const float* __restrict__ bgW, const float* __restrict__ bgw,
                        const float* __restrict__ mask, const float* __restrict__ v,
                        float* __restrict__ out, Epilogue ep, int B, int S, int N, int M,
                        int K, int CG, int NR, int SPB, int ures, int xres) {
  const int KC = 4 * CG, NG = kFGroups / CG, KCS = KC + 4;
  const int nt = (K + KC - 1) / KC;             // class tiles
  const int US = ures ? nt * KC + 4 : KCS;      // row stride of u
  const int MK = M * K;
  extern __shared__ float4 smem4[];
  float* us = reinterpret_cast<float*>(smem4);  // [kFTB][US]: u, every class or a tile
  float* vs = us + kFTB * US;                   // [kFNC][KCS]: v of a chunk and tile
  float* red = vs;                              // [NG][kFTB][KC]: pass 2's partials,
                                                // in v's place once v is consumed
  float* rs = vs + max(kFNC * KCS, kFRed);      // [NR][kFRS]: r, 0 on the exact route
  float* al = rs + (size_t)NR * kFRS;           // [kFTB]: alpha
  unsigned* xb = reinterpret_cast<unsigned*>(al + kFTB);  // [NR][2]: exact flags,
  unsigned* xany = xb + 2 * NR;                 // and whether any is set
  float* xs = reinterpret_cast<float*>(xany + 1);  // [kFTB][M K]: the rows' XWg (xres)

  // row tiles fast, so a group of coalitions' v stays in L2 across them
  const int nbt = (B + kFTB - 1) / kFTB;
  const int b0 = (blockIdx.x % nbt) * kFTB;
  const int s_lo = (blockIdx.x / nbt) * SPB, s_hi = min(S, s_lo + SPB);
  const int tid = threadIdx.x;
  if (xres) {
    for (int idx = tid; idx < kFTB * MK; idx += kThreads)
      cp_async_f32(xs + idx, XWg + (size_t)min(b0 + idx / MK, B - 1) * MK + idx % MK, true);
    cp_async_wait();
  }
  // a row's M x K logits; rows past B repeat row B-1 and are never written
  auto xrow = [&](int row) {
    return xres ? xs + row * MK : XWg + (size_t)min(b0 + row, B - 1) * MK;
  };
  // u of classes [k0, k0 + KC) into us (0 past K), without ures; mk is the
  // coalition's mask row
  const float* mk = mask;
  auto stage_u = [&](int k0) {
    for (int idx = tid; idx < kFTB * KC; idx += kThreads) {
      const int row = idx / KC, kk = idx % KC, k = k0 + kk;
      us[row * KCS + kk] = k < K ? expf(group_sum(xrow(row) + k, mk, M, K) - al[row]) : 0.0f;
    }
  };

  for (int s = s_lo; s < s_hi; ++s) {
    const float* vrow = v + (size_t)s * N * K;
    mk = mask + (size_t)s * M;
    // v of background rows [n0, n0 + nc) and classes [k0, k0 + KC) into vs
    // (0 past them)
    auto stage_v = [&](int n0, int nc, int k0) {
      for (int idx = tid; idx < kFNC * KC; idx += kThreads) {
        const int n = idx / KC, kk = idx % KC, k = k0 + kk;
        const bool ok = n < nc && k < K;
        cp_async_f32(vs + n * KCS + kk, ok ? vrow + (size_t)(n0 + n) * K + k : vrow, ok);
      }
      cp_async_wait();
    };
    __syncthreads();  // the previous coalition is done with every buffer
    // with ures, p1 of every class into us, four elements a thread at a
    // time (each one fmaf chain over the groups in order)
    if (ures) {
      for (int i0 = tid; i0 < kFTB * K; i0 += 4 * kThreads) {
        const float* x[4];
        float a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = min(i0 + e * kThreads, kFTB * K - 1);
          x[e] = xrow(i / K) + i % K;
          a[e] = 0.0f;
        }
#pragma unroll 2
        for (int m = 0; m < M; ++m) {
          const float mv = mk[m];
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = fmaf(mv, x[e][(size_t)m * K], a[e]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + e * kThreads;
          if (i < kFTB * K) us[(i / K) * US + i % K] = a[e];
        }
      }
      __syncthreads();
    }
    // alpha[row] = max_k p1, four lanes a row; with ures the same lanes
    // turn the row's p1 into u (0 past K)
    {
      const int row = tid / 4, q = tid % 4;
      float a = -INFINITY;
      for (int k = q; k < K; k += 4)
        a = fmaxf(a, ures ? us[row * US + k] : group_sum(xrow(row) + k, mk, M, K));
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 2));
      if (q == 0) al[row] = a;
      if (ures)
        for (int k = q; k < nt * KC; k += 4)
          us[row * US + k] = k < K ? expf(us[row * US + k] - a) : 0.0f;
    }

    for (int p0 = 0; p0 < N; p0 += NR) {
      const int np = min(NR, N - p0);
      const bool last = p0 + np == N;  // the pass that writes the outputs last
      __syncthreads();  // the previous pass is done with rs and xb (and u written)
      for (int i = tid; i < 2 * np; i += kThreads) xb[i] = 0u;
      if (tid == 0) *xany = 0u;

      // pass 1: D over every class tile, then r or the exact flag; the
      // thread's rows are rg + 16 i, its background rows ng + 16 j of each
      // chunk
      {
        const int rg = tid % kFGroups, ng = tid / kFGroups;
        for (int c0 = 0; c0 < np; c0 += kFNC) {
          const int nc = min(kFNC, np - c0);
          float d[4][8];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) d[i][j] = 0.0f;
          for (int k0 = 0; k0 < K; k0 += KC) {
            __syncthreads();  // the tiles are consumed
            if (!ures) stage_u(k0);
            stage_v(p0 + c0, nc, k0);
            __syncthreads();
            const float* ut = us + (ures ? k0 : 0);
            for (int kk = 0; kk < KC; kk += 4) {
              float4 u[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                u[i] = *reinterpret_cast<const float4*>(ut + (rg + 16 * i) * US + kk);
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const float4 w =
                    *reinterpret_cast<const float4*>(vs + (ng + 16 * j) * KCS + kk);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  d[i][j] = fmaf(u[i].x, w.x, d[i][j]);
                  d[i][j] = fmaf(u[i].y, w.y, d[i][j]);
                  d[i][j] = fmaf(u[i].z, w.z, d[i][j]);
                  d[i][j] = fmaf(u[i].w, w.w, d[i][j]);
                }
              }
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (ng + 16 * j >= nc) continue;
            const int nl = c0 + ng + 16 * j;
            const float wn = bgw[p0 + nl];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = rg + 16 * i;
              float r = 0.0f;
              if (d[i][j] >= kTau) {  // NaN fails the comparison
                r = wn * rcp_approx(d[i][j]);
              } else {
                atomicOr(xb + 2 * nl + row / 32, 1u << (row % 32));
                *xany = 1u;
              }
              rs[nl * kFRS + row] = r;
            }
          }
        }
      }

      // pass 2: per class tile, sum_n r v over the pass's rows, the
      // thread's rows 4 rg + i, classes 4 cg + c, background rows g mod NG
      bool exact = false;  // any flag of the pass, read after pass 2's first barrier
      {
        const int rg = tid % kFGroups, cg = (tid / kFGroups) % CG;
        const int g = tid / (kFGroups * CG);
        for (int k0 = 0; k0 < K; k0 += KC) {
          float acc[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
          // one class tile and one chunk: vs still holds them from pass 1
          const bool keep = nt == 1 && np <= kFNC;
          for (int c0 = 0; c0 < np; c0 += kFNC) {
            const int nc = min(kFNC, np - c0);
            __syncthreads();  // vs, us and red are consumed; rs is complete
            exact = *xany != 0u;
            if (!keep) stage_v(p0 + c0, nc, k0);
            if (!ures && c0 == 0) stage_u(k0);
            if (!keep || !ures) __syncthreads();
            for (int n = g; n < nc; n += NG) {
              const float4 r = *reinterpret_cast<const float4*>(rs + (c0 + n) * kFRS + 4 * rg);
              const float4 w = *reinterpret_cast<const float4*>(vs + n * KCS + 4 * cg);
              const float rr[4] = {r.x, r.y, r.z, r.w}, ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(rr[i], ww[c], acc[i][c]);
            }
          }
          __syncthreads();  // v is consumed: red takes its place
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              red[(g * kFTB + 4 * rg + i) * KC + 4 * cg + c] = acc[i][c];
          __syncthreads();
          for (int idx = tid; idx < kFTB * KC; idx += kThreads) {
            const int row = idx / KC, kk = idx % KC, b = b0 + row, k = k0 + kk;
            if (b >= B || k >= K) continue;
            float o = 0.0f;
            for (int gg = 0; gg < NG; ++gg) o += red[(gg * kFTB + row) * KC + kk];
            o *= us[row * US + (ures ? k0 : 0) + kk];
            float* dst = out + ((size_t)b * S + s) * K + k;
            o = p0 == 0 ? o : *dst + o;
            // with an exact route still to add, the epilogue waits for it
            *dst = last && !exact ? store_value(ep, o, mask, b, s, k, M, K) : o;
          }
        }
      }

      // the exact route, after every output of the pass is written: per
      // flagged (row, background row), in background order, four lanes a row;
      // on the last pass each lane then stores its own elements' operand
      if (exact) {
        __syncthreads();
        const int row = tid / 4, q = tid % 4, b = b0 + row;
        if (b < B) {
          const float* xr = xrow(row);
          float* o = out + ((size_t)b * S + s) * K;
          for (int nl = 0; nl < np; ++nl) {
            if (!((xb[2 * nl + row / 32] >> (row % 32)) & 1u)) continue;
            softmax_exact_add(xr, mk, bgWg, bgW, bgw, p0 + nl, M, K, o, 1, q, 4);
          }
          if (last && ep.link != kLinkNone)
            for (int k = q; k < K; k += 4) o[k] = store_value(ep, o[k], mask, b, s, k, M, K);
        }
      }
    }
  }
}

// The small-K route's shapes for KT classes: v's row stride in shared
// memory (4, 8 or 16 floats), rows a thread, background rows a staged chunk.
__host__ __device__ constexpr int regs_stride(int kt) {
  return kt <= 4 ? 4 : (kt <= 8 ? 8 : 16);
}
__host__ __device__ constexpr int regs_rows(int kt) { return kt <= 8 ? 4 : 2; }
__host__ __device__ constexpr int regs_chunk_rows(int kt) {
  return kRChunk / regs_stride(kt);
}

// D = sum_k u v in class order (u, v >= 0: the first product rounds as an
// fmaf onto 0 does)
template <int KT>
__device__ __forceinline__ float regs_dot(const float (&u)[KT], const float (&v)[KT]) {
  float d = u[0] * v[0];
#pragma unroll
  for (int k = 1; k < KT; ++k) d = fmaf(u[k], v[k], d);
  return d;
}

// One staged chunk of background rows for the thread's R rows of its warp's
// coalition: per background row, D, r = w rcp(D) and the output sums.
// GUARD: r = 0 and the row's flag bit where D < kTau or D is NaN; without
// it the caller has shown that every D of the chunk is at least kTau.
template <int KT, int R, bool GUARD>
__device__ __forceinline__ void regs_chunk(const float* vb, const float* wb, int nc,
                                           const float (&u)[R][KT], float (&acc)[R][KT],
                                           unsigned& flag) {
  constexpr int KP = regs_stride(KT);
#pragma unroll 2
  for (int n = 0; n < nc; ++n) {
    float vv[KT];
#pragma unroll
    for (int q = 0; q < (KT + 3) / 4; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(vb + n * KP + 4 * q);
      const float xx[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * q + c < KT) vv[4 * q + c] = xx[c];
    }
    const float wn = wb[n];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float d = regs_dot<KT>(u[i], vv);
      float r;
      if (GUARD) {
        r = 0.0f;
        if (d >= kTau) {  // NaN fails the comparison
          r = wn * rcp_approx(d);
        } else {
          flag |= 1u << i;
        }
      } else {
        r = wn * rcp_approx(d);
      }
#pragma unroll
      for (int k = 0; k < KT; ++k) acc[i][k] = fmaf(r, vv[k], acc[i][k]);
    }
  }
}

// The general softmax at small K (1 <= K <= kRegsMaxK, K != 2), factored as
// softmax_factored_kernel is, with everything of a (b, s) in registers.
// KT classes at compile time: K itself up to 8, else K rounded up to 12 or
// 16 with classes K..KT-1 zero.  A block of kRWarps warps takes TBR = 32 R
// rows and GPB groups of kRWarps coalitions, one coalition a warp; each
// thread owns R consecutive rows, so v is a warp-uniform broadcast.  EPI:
// the epilogue's code and the coalition-major store, compiled only into the
// launches that write the operand (with them, the raw route's build spilled
// at KT = 8 and 16).  See the head comment.
template <int KT, bool EPI>
__global__ void __launch_bounds__(kThreads, 2)
softmax_factored_kernel_regs(const float* __restrict__ XWg, const float* __restrict__ bgWg,
                             const float* __restrict__ bgW, const float* __restrict__ bgw,
                             const float* __restrict__ mask, const float* __restrict__ v,
                             float* __restrict__ out, Epilogue ep, int B, int S, int N,
                             int M, int K, int GPB, int nbuf, int MS) {
  constexpr int KP = regs_stride(KT), R = regs_rows(KT), TBR = 32 * R, XS = TBR + 4;
  constexpr int NCH = regs_chunk_rows(KT);
  constexpr bool kExact = KT <= 8;              // K == KT
  static_assert(KT * TBR <= kRChunk && R * KT % 4 == 0,
                "a warp's outputs fit its region of a stage, a lane's as float4s");
  const int Kr = kExact ? KT : K;               // K, a constant where it is KT
  const int MK = M * Kr;
  extern __shared__ float4 smem4[];
  // [nbuf][kRWarps][kRRegion]: per stage buffer and warp, v of its
  // coalition's chunk ([NCH][KP]); once the warp's last chunk is done, its
  // outputs ([TBR][KT])
  float* vs = reinterpret_cast<float*>(smem4);
  float* ws = vs + nbuf * kRWarps * kRRegion;   // [nbuf][NCH]: the chunk's weights
  float* xs = ws + nbuf * NCH;                  // [MS K][XS]: the rows' XWg, MS
                                                // groups at a time (all M: once)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // row tiles fast, so a group of coalitions' v stays in L2 across them
  const int nbt = (B + TBR - 1) / TBR;
  const int b0 = (blockIdx.x % nbt) * TBR;
  const int s_lo = (blockIdx.x / nbt) * GPB * kRWarps;
  const int ng = min(GPB, (S - s_lo + kRWarps - 1) / kRWarps);
  const int nch = (N + NCH - 1) / NCH, T = ng * nch;
  const int r0 = b0 + R * lane;                 // the thread's first row

  // groups [m0, m0 + mc) of the rows' XWg into xs, transposed (a lane's R
  // rows neighbours), read coalesced; rows past B repeat row B-1 and are
  // never written
  auto stage_x = [&](int m0, int mc) {
    const int w = mc * Kr;
    for (int idx = tid; idx < TBR * w; idx += kThreads) {
      const int row = idx / w, j = idx - row * w;
      cp_async_f32(xs + j * XS + row, XWg + (size_t)min(b0 + row, B - 1) * MK + m0 * Kr + j,
                   true);
    }
  };
  if (MS >= M) stage_x(0, M);
  // stage t: v of group t / nch's coalitions and background chunk t % nch
  // (classes K..KT-1 zero), and the chunk's weights, into buffer t % nbuf
  auto stage = [&](int t) {
    const int s0 = s_lo + (t / nch) * kRWarps, n0 = (t % nch) * NCH, nc = min(NCH, N - n0);
    float* dst = vs + (t & (nbuf - 1)) * kRWarps * kRRegion;
    for (int c = 0; c < kRWarps && s0 + c < S; ++c) {
      const float* src = v + ((size_t)(s0 + c) * N + n0) * Kr;
      for (int j = tid; j < nc * KT; j += kThreads) {
        const int n = j / KT, k = j - n * KT;
        cp_async_f32(dst + c * kRRegion + n * KP + k, src + n * Kr + min(k, Kr - 1), k < Kr);
      }
    }
    for (int n = tid; n < nc; n += kThreads)
      cp_async_f32(ws + (t & (nbuf - 1)) * NCH + n, bgw + n0 + n, true);
  };
  // the outputs of stage t's group, from each warp's region into out: a
  // row's K outputs of the group's coalitions are neighbours in out, so
  // neighbouring threads write neighbouring floats of a row; with EPI out is
  // coalition-major, (S, B, K), and a coalition's TBR K outputs are the
  // neighbours
  auto flush = [&](int t) {
    const int s0 = s_lo + (t / nch) * kRWarps, ncs = min(kRWarps, S - s0);
    const float* src = vs + (t & (nbuf - 1)) * kRWarps * kRRegion;
    if constexpr (EPI) {
      const int n = min(TBR, B - b0) * Kr;  // the coalition's floats of the block's rows
#pragma unroll 1
      for (int c = 0; c < ncs; ++c) {
        float* dst = out + ((size_t)(s0 + c) * B + b0) * Kr;
        const float* sc = src + c * kRRegion;
        for (int e = tid; e < n; e += kThreads) dst[e] = sc[e + e / Kr * (KT - Kr)];
      }
    } else {
      const int width = kRWarps * Kr;
      for (int f = tid; f < TBR * width; f += kThreads) {
        const int row = f / width, e = f - row * width, c = e / Kr;
        if (b0 + row < B && c < ncs)
          out[((size_t)(b0 + row) * S + s0) * Kr + e] = src[c * kRRegion + row * KT + e - c * Kr];
      }
    }
  };
  stage(0);

  float u[R][KT], acc[R][KT];
  unsigned flag = 0u;
  bool bad = false;
  for (int t = 0; t < T; ++t) {
    cp_async_wait();
    __syncthreads();  // stage t is in; with two buffers, stage t - 1 is done
    if (nbuf == 2) {
      if (t > 0 && t % nch == 0) {  // stage t - 1 ended a group: its outputs out
        flush(t - 1);
        __syncthreads();
      }
      if (t + 1 < T) stage(t + 1);  // overlaps this stage's arithmetic
    }
    const int c = t % nch, n0 = c * NCH, nc = min(NCH, N - n0);
    const int s = s_lo + (t / nch) * kRWarps + warp;
    const float* mk = mask + (size_t)min(s, S - 1) * M;
    if (c == 0) {
      // p1 of the thread's rows, one fmaf chain over the groups in order
      // (as group_sum), the rows' XWg staged MS groups at a time where all
      // of it does not stay; then alpha = max_k p1 and u = exp(p1 - alpha)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < KT; ++k) u[i][k] = 0.0f;
      for (int m0 = 0; m0 < M; m0 += MS) {
        const int mc = min(MS, M - m0);
        if (MS < M) {
          __syncthreads();  // the previous slice is consumed
          stage_x(m0, mc);
          cp_async_wait();
          __syncthreads();
        }
#pragma unroll 1
        for (int m = m0; s < S && m < m0 + mc; ++m) {
          const float mv = mk[m];
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            if (k >= Kr) continue;
            const float* xp = xs + ((m - m0) * Kr + k) * XS + R * lane;
            float x[R];
            if constexpr (R == 4) {
              const float4 x4 = *reinterpret_cast<const float4*>(xp);
              x[0] = x4.x, x[1] = x4.y, x[2] = x4.z, x[3] = x4.w;
            } else {
              const float2 x2 = *reinterpret_cast<const float2*>(xp);
              x[0] = x2.x, x[1] = x2.y;
            }
#pragma unroll
            for (int i = 0; i < R; ++i) u[i][k] = fmaf(mv, x[i], u[i][k]);
          }
        }
      }
      bad = false;
      flag = 0u;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float a = -INFINITY;
#pragma unroll
        for (int k = 0; k < KT; ++k)
          if (k < Kr) a = fmaxf(a, u[i][k]);
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          u[i][k] = k < Kr ? expf(u[i][k] - a) : 0.0f;
          bad = bad || isnan(u[i][k]);
          acc[i][k] = 0.0f;
        }
      }
    }
    float* vb = vs + ((t & (nbuf - 1)) * kRWarps + warp) * kRRegion;
    const float* wb = ws + (t & (nbuf - 1)) * NCH;
    if (s < S) {
      // the guard, once a chunk for the warp: u has no NaN and every v of
      // the chunk is at least kTau, so every D >= v of the row's top class
      // >= kTau and the loop runs unguarded
      float vmin = 1.0f;
#pragma unroll 1
      for (int n = lane; n < nc; n += 32)
#pragma unroll
        for (int q = 0; q < (KT + 3) / 4; ++q) {
          const float4 x = *reinterpret_cast<const float4*>(vb + n * KP + 4 * q);
          const float xx[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * q + e < Kr) vmin = fminf(vmin, xx[e]);
        }
#pragma unroll
      for (int o = 16; o; o >>= 1) vmin = fminf(vmin, __shfl_xor_sync(0xffffffffu, vmin, o));
      if (!__any_sync(0xffffffffu, bad) && vmin >= kTau)
        regs_chunk<KT, R, false>(vb, wb, nc, u, acc, flag);
      else
        regs_chunk<KT, R, true>(vb, wb, nc, u, acc, flag);
    }
    if (s < S && c == nch - 1) {
      // the coalition's outputs, with the epilogue in registers (R KT
      // independent chains a lane) for every row no flag holds back, into
      // the warp's region (its v is consumed), a lane's R rows as R KT
      // neighbouring floats; then the exact route of each flagged row there:
      // D recomputed from v in global memory (the same bits), in background
      // order, and that row's epilogue after it
      __syncwarp();
      float* ob = vb + R * KT * lane;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < KT; ++k) acc[i][k] = u[i][k] * acc[i][k];
      if constexpr (EPI) {
        // E in registers up to 7 classes; past them read at each use,
        // through the read-only path (in registers they made the build spill)
        constexpr bool kHeld = KT <= 7;
        const float zl = mk[M - 1];
        float e[KT];
#pragma unroll
        for (int k = 0; k < KT; ++k) e[k] = kHeld && k < Kr ? ep.ev[k] : 0.0f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          // rows past B read row B-1's f(x) - E and are never written
          const float* fr = ep.fxme + (size_t)min(r0 + i, B - 1) * Kr;
          const bool held = (flag >> i) & 1u;
#pragma unroll
          for (int k = 0; k < KT; ++k)
            if (k < Kr && !held)
              acc[i][k] = wls_operand(acc[i][k], ep.link, kHeld ? e[k] : __ldg(ep.ev + k), zl,
                                      kHeld ? fr[k] : __ldg(fr + k));
        }
      }
#pragma unroll
      for (int e = 0; e < R * KT; e += 4)
        *reinterpret_cast<float4*>(ob + e) =
            make_float4(acc[e / KT][e % KT], acc[(e + 1) / KT][(e + 1) % KT],
                        acc[(e + 2) / KT][(e + 2) % KT], acc[(e + 3) / KT][(e + 3) % KT]);
#pragma unroll 1
      for (int i = 0; i < R; ++i) {
        if (!((flag >> i) & 1u) || r0 + i >= B) continue;
        // one copy of the cold path for every row: the row's u by selects
        // (no local memory), its addresses formed here (hoisted out of the
        // loop over t they would hold registers all along)
        float ui[KT];
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          ui[k] = u[0][k];
#pragma unroll
          for (int j = 1; j < R; ++j) ui[k] = i == j ? u[j][k] : ui[k];
        }
        int row = r0 + i;
        asm volatile("" : "+r"(row));
        const float* xr = XWg + (size_t)row * MK;
#pragma unroll 1
        for (int n = 0; n < N; ++n) {
          const float* vr = v + ((size_t)s * N + n) * Kr;
          float vv[KT];
#pragma unroll
          for (int k = 0; k < KT; ++k) vv[k] = k < Kr ? vr[k] : 0.0f;
          if (!(regs_dot<KT>(ui, vv) >= kTau))
            softmax_exact_add(xr, mk, bgWg, bgW, bgw, n, M, Kr, ob + i * KT, 1, 0, 1);
        }
        if constexpr (EPI)
          for (int k = 0; k < Kr; ++k)
            ob[i * KT + k] = store_value(ep, ob[i * KT + k], mask, row, s, k, M, Kr);
      }
    }
    if (nbuf == 1 && t + 1 < T) {
      __syncthreads();  // every warp is done with the one buffer
      if ((t + 1) % nch == 0) {  // stage t ended a group: its outputs out
        flush(t);
        __syncthreads();
      }
      stage(t + 1);
    }
  }
  __syncthreads();
  flush(T - 1);
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
               const float* __restrict__ mask, float* __restrict__ out, Epilogue ep,
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
    // after the last chunk, the thread's own outputs back as the operand,
    // one row at a time: inside the loop above its R sums would spill
    if (ep.link != kLinkNone && n0 + nc == N) {
      o = out + ((size_t)(b0 + ty) * S + s) * K;
#pragma unroll 1
      for (int r = 0; r < R; ++r, o += (size_t)kTBY * S * K) {
        const int b = b0 + ty + r * kTBY;
        if (b >= B) break;
        for (int kk = BINARY ? 0 : k; kk <= (BINARY ? 1 : k); ++kk)
          o[kk] = store_value(ep, o[kk], mask, b, s, kk, M, K);
      }
    }
  }
}

// What one sigmoid-form call launches: the kernel, its grid, its dynamic
// shared memory and its background rows per chunk.
struct Plan {
  EyKernel fn;
  dim3 grid;
  size_t smem;
  int nc;
};

// one class a block: binary softmax's one carried class, or sigmoid's K on
// the grid's z axis
Plan sigmoid_plan(bool binary, int B, int S, int N, int K) {
  const int nc = kSigmoidChunkRows < N ? kSigmoidChunkRows : N;
  return {binary ? sigmoid_kernel<true> : sigmoid_kernel<false>,
          dim3((B + kSigmoidTB - 1) / kSigmoidTB, (S + kTS - 1) / kTS, binary ? 1 : K),
          sizeof(float) * ((size_t)nc * (kTS + 2 + kMC) + kTS + kMC * kTS + kSigmoidTB * kMC),
          nc};
}

// What one general-softmax call launches: the main kernel's blocks, their
// class groups, background rows a pass and coalitions, whether u stays
// resident for every class and the rows' XWg in shared memory, the dynamic
// shared memory; the prologue's blocks.
struct FactoredPlan {
  long long blocks;
  int cg;
  int nr;
  int spb;
  int ures;
  int xres;
  size_t smem;
  long long v_blocks;
};

int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

FactoredPlan factored_plan(int B, int S, int N, int M, int K) {
  int cg = 1;
  while (cg < kFMaxCG && 4 * cg < K) cg *= 2;
  const int kc = 4 * cg, kcs = kc + 4, nt = (K + kc - 1) / kc;
  const int nr = N < kFMaxNR ? N : kFMaxNR;
  const size_t rest = (size_t)(kFNC * kcs > kFRed ? kFNC * kcs : kFRed) +
                      (size_t)nr * kFRS + kFTB + 2 * (size_t)nr + 1;
  // u resident for every class where that fits a block's shared memory
  const size_t resident = sizeof(float) * ((size_t)kFTB * (nt * kc + 4) + rest);
  const int ures = resident <= (size_t)kFMaxSmem;
  const size_t base = ures ? resident : sizeof(float) * ((size_t)kFTB * kcs + rest);
  // the rows' XWg resident where that keeps two blocks an SM, or costs none
  const size_t xs = sizeof(float) * (size_t)kFTB * M * K;
  const int xres = base + xs <= (size_t)kFTwoBlocks ||
                   (base > (size_t)kFTwoBlocks && base + xs <= (size_t)kFMaxSmem);
  // coalitions a block: up to kFMaxSPB while the grid keeps 8 waves
  const long long nbt = (B + kFTB - 1) / kFTB, waves = 8LL * 2 * sm_count();
  int spb = kFMaxSPB;
  while (spb > 1 && nbt * ((S + spb - 1) / spb) < waves) spb /= 2;
  return {nbt * ((S + spb - 1) / spb), cg, nr, spb, ures, xres, base + (xres ? xs : 0),
          ((long long)S * N * 32 + kThreads - 1) / kThreads};
}

typedef void (*RegsKernel)(const float*, const float*, const float*, const float*,
                           const float*, const float*, float*, Epilogue, int, int, int, int,
                           int, int, int, int);

template <int KT>
RegsKernel regs_fn(bool epi) {
  return epi ? softmax_factored_kernel_regs<KT, true> : softmax_factored_kernel_regs<KT, false>;
}

// the small-K kernel for K classes (1 <= K <= kRegsMaxK, K != 2), with the
// epilogue's code where epi
RegsKernel regs_kernel(int K, bool epi) {
  switch (K <= 8 ? K : (K <= 12 ? 12 : 16)) {
    case 1: return regs_fn<1>(epi);
    case 3: return regs_fn<3>(epi);
    case 4: return regs_fn<4>(epi);
    case 5: return regs_fn<5>(epi);
    case 6: return regs_fn<6>(epi);
    case 7: return regs_fn<7>(epi);
    case 8: return regs_fn<8>(epi);
    case 12: return regs_fn<12>(epi);
    case 16: return regs_fn<16>(epi);
    default: return nullptr;
  }
}

// What one small-K call launches (with the epilogue's code where epi): the
// kernel, its blocks, groups of coalitions a block, stage buffers, groups of
// the rows' XWg in shared memory at a time, the dynamic shared memory,
// background rows a chunk; the prologue's blocks.
struct RegsPlan {
  RegsKernel fn;
  long long blocks;
  int gpb;
  int nbuf;
  int ms;
  size_t smem;
  int chunk_rows;
  long long v_blocks;
};

RegsPlan regs_plan(int B, int S, int N, int M, int K, bool epi) {
  const int kt = K <= 8 ? K : (K <= 12 ? 12 : 16), tbr = 32 * regs_rows(kt);
  const int nch = regs_chunk_rows(kt);
  const size_t one = sizeof(float) * (kRWarps * kRRegion + (size_t)nch);
  // the rows' XWg resident where that keeps two blocks an SM, beside two
  // stage buffers or else one; past that as many groups as fit beside one
  const size_t group = sizeof(float) * (size_t)K * (tbr + 4), fit = kFTwoBlocks;
  const int nbuf = 2 * one + M * group <= fit ? 2 : 1;
  const int ms = (int)std::max<size_t>(1, std::min<size_t>(M, (fit - nbuf * one) / group));
  // groups a block: up to kRMaxGPB while the grid keeps 8 waves
  const long long nbt = (B + tbr - 1) / tbr, groups = (S + kRWarps - 1) / kRWarps;
  const long long waves = 8LL * 2 * sm_count();
  int gpb = kRMaxGPB;
  while (gpb > 1 && nbt * ((groups + gpb - 1) / gpb) < waves) gpb /= 2;
  return {regs_kernel(K, epi), nbt * ((groups + gpb - 1) / gpb), gpb, nbuf, ms,
          nbuf * one + ms * group, nch, ((long long)S * N * 32 + kThreads - 1) / kThreads};
}

bool general_softmax(int K, int activation) { return activation == 0 && K != 2; }

// The kernel a call takes: the sigmoid form (sigmoid, and softmax at K = 2),
// the small-K route (softmax at K <= kRegsMaxK) or the factored kernel
// (softmax past it); -1 for a K or activation no route takes.
enum Route { kRouteSigmoid = 0, kRouteFactored = 1, kRouteRegs = 2 };

int route(int K, int activation) {
  if (K <= 0 || (activation != 0 && activation != 1)) return -1;
  if (!general_softmax(K, activation)) return kRouteSigmoid;
  return K <= kRegsMaxK ? kRouteRegs : kRouteFactored;
}

// activation: 0 = softmax, 1 = sigmoid
bool valid(int B, int S, int N, int M, int K, int activation) {
  if (!(B > 0 && S > 0 && N > 0 && M > 0 && K > 0)) return false;
  if (activation == 1) return K <= kMaxGridZ;
  if (activation != 0) return false;
  if (K == 2) return true;
  if (route(K, activation) == kRouteRegs) {
    const RegsPlan p = regs_plan(B, S, N, M, K, false);
    return p.blocks <= INT_MAX && p.v_blocks <= INT_MAX && p.smem <= (size_t)kFMaxSmem;
  }
  const FactoredPlan f = factored_plan(B, S, N, M, K);
  return f.blocks <= INT_MAX && f.v_blocks <= INT_MAX && f.smem <= (size_t)kFMaxSmem;
}

}  // namespace

extern "C" {

// the most classes the sigmoid branch takes (one class a block on the
// grid's z axis); softmax takes any K
int fused_linear_ey_max_sigmoid_k() { return kMaxGridZ; }

// the route a call with K classes and this activation takes: 0 the sigmoid
// form (sigmoid_kernel), 1 the factored general softmax
// (softmax_factored_kernel), 2 the small-K route
// (softmax_factored_kernel_regs); -1 where none does
int fused_linear_ey_route(int K, int activation) { return route(K, activation); }

// floats of device scratch a call at these sizes needs (the general
// softmax's v, S N K floats; 0 otherwise)
long long fused_linear_ey_scratch_floats(int S, int N, int K, int activation) {
  return general_softmax(K, activation) ? (long long)S * N * K : 0;
}

// activation: 0 = softmax, 1 = sigmoid; link: the epilogue, 0 = none (out
// is ey), 1 = identity, 2 = logit (out is link(ey) - ev[k] - mask[s, M-1] *
// fxme[b, k], the weighted least squares' right-hand operand, laid out
// (S, B, K) on the small-K route and (B, S, K) elsewhere; see the head
// comment).  All pointers are device pointers to contiguous float32 arrays:
// ev (K,) and fxme (B, K), read only with a link; bgw must sum to 1 for
// binary softmax; scratch holds fused_linear_ey_scratch_floats(S, N, K,
// activation) floats.  Returns the cudaError_t of the first failed call (0
// on success).
int fused_linear_ey_launch(const float* XWg, const float* bgWg, const float* bgW,
                           const float* bgw, const float* mask, float* out, float* scratch,
                           const float* ev, const float* fxme, int B, int S, int N, int M,
                           int K, int activation, int link, void* stream) {
  if (!valid(B, S, N, M, K, activation)) return (int)cudaErrorInvalidValue;
  const bool known = link == kLinkNone || link == kLinkIdentity || link == kLinkLogit;
  if (!known || (link != kLinkNone && (!ev || !fxme))) return (int)cudaErrorInvalidValue;
  const Epilogue ep = {link, ev, fxme};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!general_softmax(K, activation)) {
    const Plan p = sigmoid_plan(K == 2 && activation == 0, B, S, N, K);
    p.fn<<<p.grid, kThreads, p.smem, st>>>(XWg, bgWg, bgW, bgw, mask, out, ep, B, S, N, M,
                                           K, p.nc);
    return (int)cudaGetLastError();
  }
  if (route(K, activation) == kRouteRegs) {
    const RegsPlan p = regs_plan(B, S, N, M, K, link != kLinkNone);
    softmax_v_kernel<<<(unsigned)p.v_blocks, kThreads, 0, st>>>(bgWg, bgW, mask, scratch, S,
                                                                 N, M, K);
    int err = (int)cudaGetLastError();
    if (err) return err;
    err = (int)cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)p.smem);
    if (err) return err;
    p.fn<<<(unsigned)p.blocks, kThreads, p.smem, st>>>(XWg, bgWg, bgW, bgw, mask, scratch, out,
                                                       ep, B, S, N, M, K, p.gpb, p.nbuf, p.ms);
    return (int)cudaGetLastError();
  }
  const FactoredPlan f = factored_plan(B, S, N, M, K);
  softmax_v_kernel<<<(unsigned)f.v_blocks, kThreads, 0, st>>>(bgWg, bgW, mask, scratch, S,
                                                               N, M, K);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = (int)cudaFuncSetAttribute(softmax_factored_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)f.smem);
  if (err) return err;
  softmax_factored_kernel<<<(unsigned)f.blocks, kThreads, f.smem, st>>>(
      XWg, bgWg, bgW, bgw, mask, scratch, out, ep, B, S, N, M, K, f.cg, f.nr, f.spb, f.ures,
      f.xres);
  return (int)cudaGetLastError();
}

// What a call at (B, S, N, M, K, activation) with the epilogue's link
// launches, into info[0..7]: blocks, threads a block, dynamic shared memory
// bytes, resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers a thread and
// local memory bytes a thread (cudaFuncGetAttributes), background rows per
// staged chunk, coalitions a block; of the kernel the call's route launches
// (fused_linear_ey_route), its prologue not counted.  Returns the
// cudaError_t of the first query that failed.
int fused_linear_ey_launch_info(int B, int S, int N, int M, int K, int activation, int link,
                                int* info) {
  if (!valid(B, S, N, M, K, activation)) return (int)cudaErrorInvalidValue;
  const void* fn;
  long long blocks;
  size_t smem;
  int nc, coalitions;
  if (route(K, activation) == kRouteRegs) {
    const RegsPlan p = regs_plan(B, S, N, M, K, link != kLinkNone);
    fn = reinterpret_cast<const void*>(p.fn);
    blocks = p.blocks;
    smem = p.smem;
    nc = N < p.chunk_rows ? N : p.chunk_rows;
    coalitions = p.gpb * kRWarps;
    const int err = (int)cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)smem);
    if (err) return err;
  } else if (general_softmax(K, activation)) {
    const FactoredPlan f = factored_plan(B, S, N, M, K);
    fn = reinterpret_cast<const void*>(softmax_factored_kernel);
    blocks = f.blocks;
    smem = f.smem;
    nc = N < kFNC ? N : kFNC;
    coalitions = f.spb;
    const int err = (int)cudaFuncSetAttribute(
        softmax_factored_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  } else {
    const Plan p = sigmoid_plan(K == 2 && activation == 0, B, S, N, K);
    fn = reinterpret_cast<const void*>(p.fn);
    blocks = (long long)p.grid.x * p.grid.y * p.grid.z;
    smem = p.smem;
    nc = p.nc;
    coalitions = kTS;
  }
  int per_sm = 0;
  int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (err) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, fn);
  if (err) return err;
  info[0] = (int)blocks;
  info[1] = kThreads;
  info[2] = (int)smem;
  info[3] = per_sm;
  info[4] = attr.numRegs;
  info[5] = (int)attr.localSizeBytes;
  info[6] = nc;
  info[7] = coalitions;
  return 0;
}

}  // extern "C"
