// exact_tree_phi: exact interventional TreeSHAP main effects, in CUDA C++
// for Hopper (sm_90a).
//
// Replaces distributedkernelshap_tpu/ops/pallas_kernels.py:exact_tree_phi
// (body _exact_phi_kernel).  For each instance b, leaf path p and
// background row n, with 0/1 indicators x_only/x_not (B,P,M) and z_ok
// (N,P,M), z_dead (N,P):
//
//   u    = #groups m with x_only & !z_ok        (the leaf needs m IN)
//   v    = #groups m with x_not  &  z_ok        (the leaf needs m OUT)
//   dead = #groups m with x_not  & !z_ok        (neither row takes the path)
//   alive = dead == 0 && !z_dead
//   a  = bgw[n] / C(u+v, u)    with C(u+v,u) = prod_{i<=min(u,dmax)} (v+i)/i
//   wp = a / u,  wm = a / v    (the Beta weights (u-1)!v!/(u+v)!, u!(v-1)!/(u+v)!)
//   s_p[b,p,m] = sum_n wp * (1 - z_ok),  s_m[b,p,m] = sum_n wm * z_ok
//   phi[b,m,k] = sum_p (s_p*x_only - s_m*x_not)[b,p,m] * leaf_val[p,k]
//
// What bounds it: the B*P*N triples (52 M at the Adult GBT's packed shapes,
// B=256, P=2048, N=100), each a handful of integer operations and, when the
// row is alive, three f32 divisions and u+v adds; the inputs are ~60 MB of
// 0/1 floats read once.  So it is bound by operations, and the design
// makes each triple cheap: the indicators are packed into bit masks (x in
// registers, z once per launch by a prep pass), the counts are population
// counts, the binomial is read from a (dmax+1)x(M+1) table built once per
// launch with the reference's own masked product (the plain version's
// arithmetic), and a row that is dead or adds nothing is skipped.  Since
// x_only and x_not are disjoint, each thread keeps ONE accumulator per
// group: s_p on its x-only groups, s_m on its x-not groups.
//
// Layout and tiling: one thread per (b, p); a block of 256 threads is 8
// warps = 8 instances x 32 paths (one path per lane).  The background axis
// is streamed through shared memory in chunks of kNC rows of packed bits,
// so one launch takes any N and any dmax (the TPU kernel held all of N in
// VMEM and its callers sliced N at 256).  The path sum ends in a warp
// shuffle tree per (m, k); blocks write one partial phi per path tile and a
// second kernel sums the tiles in a fixed order: no float atomics, so two
// launches on the same inputs give bit-identical phi (the TPU kernel
// accumulated over a sequential grid axis instead).  Limit: M <= 63 groups
// (one 64-bit word per (n, p) holds the z_ok bits and the z_dead bit).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTP = 32;                  // paths per block: one per lane
constexpr int kTB = kThreads / kTP;      // instances per block: one per warp
constexpr int kNC = 64;                  // background rows staged per chunk
constexpr int kMaxM = 63;
constexpr int kDeadBit = 63;
constexpr int kMaxTable = (kMaxM + 1) * (kMaxM + 1);
constexpr size_t kSmemMax =
    sizeof(unsigned long long) * kNC * kTP + sizeof(float) * (kNC + kMaxTable);
static_assert(kSmemMax <= 48 * 1024, "staging must fit without an opt-in");
static_assert(kTP == 32, "one path per lane: the shuffle reduction spans a warp");

typedef unsigned long long u64;

// Pack z_ok/z_dead into one word per (n, p) and build the binomial table
// table[u*(M+1)+v] = prod_{i=1..u} (v+i)/i for u <= dm, v <= M.
__global__ void prep_kernel(const float* __restrict__ z_ok,
                            const float* __restrict__ z_dead,
                            u64* __restrict__ zbits, float* __restrict__ table,
                            long long NP, int M, int dm) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < NP) {
    const float* z = z_ok + idx * M;
    u64 bits = 0;
    for (int m = 0; m < M; ++m)
      if (z[m] > 0.5f) bits |= 1ull << m;
    if (z_dead[idx] > 0.5f) bits |= 1ull << kDeadBit;
    zbits[idx] = bits;
  }
  if (idx < (long long)(dm + 1) * (M + 1)) {
    const int u = (int)(idx / (M + 1));
    const float fv = (float)(idx % (M + 1));
    float binom = 1.0f;
    for (int i = 1; i <= u; ++i) {
      const float fi = (float)i;
      binom = binom * ((fv + fi) / fi);
    }
    table[idx] = binom;
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
phi_tile_kernel(const float* __restrict__ x_only, const float* __restrict__ x_not,
                const u64* __restrict__ zbits, const float* __restrict__ leaf_val,
                const float* __restrict__ bgw, const float* __restrict__ table,
                float* __restrict__ partial, int B, int P, int N, int M, int K,
                int dm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* zs = reinterpret_cast<u64*>(smem_raw);           // [kNC][kTP]
  float* ws = reinterpret_cast<float*>(zs + kNC * kTP);  // [kNC]
  float* tab = ws + kNC;                                 // [(dm+1)(M+1)]

  const int lane = threadIdx.x % kTP;
  const int b = blockIdx.x * kTB + threadIdx.x / kTP;
  const int p0 = blockIdx.y * kTP;
  const int p = p0 + lane;
  const bool ok = b < B && p < P;
  const int tsize = (dm + 1) * (M + 1);
  for (int i = threadIdx.x; i < tsize; i += kThreads) tab[i] = table[i];

  u64 xo = 0, xn = 0;
  if (ok) {
    const float* a = x_only + ((size_t)b * P + p) * M;
    const float* c = x_not + ((size_t)b * P + p) * M;
    for (int m = 0; m < M; ++m) {
      if (a[m] > 0.5f) xo |= 1ull << m;
      if (c[m] > 0.5f) xn |= 1ull << m;
    }
  }
  const u64 mmask = (1ull << M) - 1;   // M <= 63

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.0f;

  for (int n0 = 0; n0 < N; n0 += kNC) {
    const int nc = min(kNC, N - n0);
    __syncthreads();  // the previous chunk (and the table copy) is done
    for (int i = threadIdx.x; i < nc * kTP; i += kThreads) {
      const int pl = p0 + i % kTP;
      zs[i] = pl < P ? zbits[(size_t)(n0 + i / kTP) * P + pl] : (1ull << kDeadBit);
    }
    for (int i = threadIdx.x; i < nc; i += kThreads) ws[i] = bgw[n0 + i];
    __syncthreads();
    if ((xo | xn) == 0) continue;   // no group on this path: phi adds nothing
    for (int n = 0; n < nc; ++n) {
      const u64 z = zs[n * kTP + lane];
      const u64 nz = ~z & mmask;
      if ((z >> kDeadBit) || (xn & nz)) continue;   // not alive
      const u64 su = xo & nz;    // groups that must be IN the coalition
      const u64 sv = xn & z;     // groups that must be OUT
      const int u = __popcll(su);
      const int v = __popcll(sv);
      if (u + v == 0) continue;  // wp = wm = 0
      const float a = ws[n] / tab[min(u, dm) * (M + 1) + v];
      const float wp = u ? a / (float)u : 0.0f;
      const float wm = v ? a / (float)v : 0.0f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if ((su >> m) & 1ull) acc[m] += wp;
        else if ((sv >> m) & 1ull) acc[m] += wm;
      }
    }
  }

  // d = s_p*x_only - s_m*x_not: +acc on x-only groups, -acc on x-not groups;
  // sum d*leaf_val over the warp's 32 paths in a fixed shuffle tree
  float* out = partial + ((size_t)blockIdx.y * B + b) * M * K;
  for (int k = 0; k < K; ++k) {
    const float lv = ok ? leaf_val[(size_t)p * K + k] : 0.0f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        const float d = ((xo >> m) & 1ull) ? acc[m]
                        : (((xn >> m) & 1ull) ? -acc[m] : 0.0f);
        float s = d * lv;
#pragma unroll
        for (int off = kTP / 2; off > 0; off >>= 1)
          s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0 && b < B) out[m * K + k] = s;
      }
    }
  }
}

// phi[i] = sum over path tiles t = 0, 1, ... of partial[t][i], in order.
__global__ void sum_tiles_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, long long total,
                                 int tiles) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s += partial[(size_t)t * total + i];
  out[i] = s;
}

template <int MT>
int launch_tiles(const float* x_only, const float* x_not, const u64* zbits,
                 const float* leaf_val, const float* bgw, const float* table,
                 float* partial, int B, int P, int N, int M, int K, int dm,
                 cudaStream_t st) {
  const size_t smem = sizeof(u64) * kNC * kTP +
                      sizeof(float) * (kNC + (size_t)(dm + 1) * (M + 1));
  dim3 grid((B + kTB - 1) / kTB, (P + kTP - 1) / kTP);
  phi_tile_kernel<MT><<<grid, kThreads, smem, st>>>(
      x_only, x_not, zbits, leaf_val, bgw, table, partial, B, P, N, M, K, dm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int exact_tree_phi_max_m() { return kMaxM; }

// number of path tiles = leading dimension of the partial-phi scratch
int exact_tree_phi_partial_tiles(int P) { return (P + kTP - 1) / kTP; }

// All pointers are device pointers to contiguous arrays: float32 inputs
// x_only/x_not (B,P,M), z_ok (N,P,M), z_dead (N,P), leaf_val (P,K),
// bgw (N,) (normalised); scratch zbits (N,P) 64-bit, table
// ((dmax+1)*(M+1)) float32, partial (tiles,B,M,K) float32; out (B,M,K).
// dmax must be in [1, M].  Returns the cudaError_t of the launches.
int exact_tree_phi_launch(const float* x_only, const float* x_not,
                          const float* z_ok, const float* z_dead,
                          const float* leaf_val, const float* bgw, void* zbits,
                          float* table, float* partial, float* out, int B,
                          int P, int N, int M, int K, int dmax, void* stream) {
  if (B <= 0 || P <= 0 || N <= 0 || M <= 0 || K <= 0 || M > kMaxM ||
      dmax < 1 || dmax > M || (P + kTP - 1) / kTP > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* zb = static_cast<u64*>(zbits);
  const long long NP = (long long)N * P;
  const long long prep_n = NP > (long long)(dmax + 1) * (M + 1)
                               ? NP : (long long)(dmax + 1) * (M + 1);
  prep_kernel<<<(unsigned)((prep_n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      z_ok, z_dead, zb, table, NP, M, dmax);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (M <= 16)
    err = launch_tiles<16>(x_only, x_not, zb, leaf_val, bgw, table, partial,
                           B, P, N, M, K, dmax, st);
  else if (M <= 32)
    err = launch_tiles<32>(x_only, x_not, zb, leaf_val, bgw, table, partial,
                           B, P, N, M, K, dmax, st);
  else
    err = launch_tiles<64>(x_only, x_not, zb, leaf_val, bgw, table, partial,
                           B, P, N, M, K, dmax, st);
  if (err) return err;
  const long long total = (long long)B * M * K;
  sum_tiles_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      partial, out, total, (P + kTP - 1) / kTP);
  return (int)cudaGetLastError();
}

}  // extern "C"
