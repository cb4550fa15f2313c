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
// The packing, staging, tile sum and launch sequence are in
// exact_tree_common.cuh, shared with exact_tree_inter.cu.

#include "exact_tree_common.cuh"

namespace {

constexpr int kNC = 64;                  // background rows staged per chunk
static_assert(smem_bytes(kNC, kMaxM, kMaxM) <= 48 * 1024,
              "staging must fit without an opt-in");

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

  const int nchunks = (N + kNC - 1) / kNC;
  for (int c = 0; c < nchunks; ++c) {
    const int nc = stage_chunk<kNC>(zs, ws, zbits, bgw, c, N, P, p0);
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

}  // namespace

extern "C" {

int exact_tree_phi_max_m() { return kMaxM; }

// number of path tiles = leading dimension of the partial-phi scratch
int exact_tree_phi_partial_tiles(int P) { return partial_tiles(P); }

// The arguments of launch_exact (exact_tree_common.cuh): partial is
// (tiles,B,M,K) and out (B,M,K).
int exact_tree_phi_launch(const float* x_only, const float* x_not,
                          const float* z_ok, const float* z_dead,
                          const float* leaf_val, const float* bgw, void* zbits,
                          float* table, float* partial, float* out, int B,
                          int P, int N, int M, int K, int dmax, void* stream) {
  return launch_exact<kNC>(phi_tile_kernel<16>, phi_tile_kernel<32>,
                           phi_tile_kernel<64>, (long long)M * K, x_only, x_not,
                           z_ok, z_dead, leaf_val, bgw, zbits, table, partial,
                           out, B, P, N, M, K, dmax, stream);
}

}  // extern "C"
