// exact_tree_inter: exact interventional Shapley interaction sums, in CUDA
// C++ for Hopper (sm_90a).
//
// Replaces distributedkernelshap_tpu/ops/pallas_kernels.py:exact_tree_inter
// (body _exact_inter_kernel).  Inputs as exact_tree_phi's: 0/1 indicators
// x_only/x_not (B,P,M), z_ok (N,P,M), z_dead (N,P), leaf_val (P,K), bgw (N,).
// For each instance b, leaf path p and background row n:
//
//   U = groups with x_only & !z_ok (u of them), V = groups with x_not & z_ok
//   (v), alive = no group with x_not & !z_ok, and !z_dead;
//   C = C(u+v-1, v) = prod_{i<=min(u-1,dmax)} (v+i)/i,  base = alive*bgw[n]/C
//   W_uu = base/(u-1) (u >= 2),  W_uv = -base/v (u, v >= 1),
//   W_vv = base*u/(v(v-1)) (v >= 2, u >= 1),  base*(1/(v-1)) (v >= 2, u = 0)
//   out[b,g,h,k] = sum_{p,n} W(g,h) * leaf_val[p,k], with W(g,h) = W_uu for
//   g, h in U, W_uv for one in U and one in V, W_vv for g, h in V, else 0
//
// the raw pairwise sum, diagonal included, as the TPU kernel returns it (the
// caller scales it, halves the off-diagonal and rebuilds the diagonal).
//
// The structure used: on an alive row every x-not group of (b, p) lies in
// z_ok, so V is the whole x-not set of (b, p) and v is fixed; only U changes
// with n.  So the VV block of (b, p) is ONE sum over n (A_vv), the UV block
// one sum per x-only group (A_uv[g] = sum_n W_uv [g in U]), and only the UU
// block needs a sum per pair.  Pass A computes A_vv and A_uv; then for each
// group g, pass B sums row g of the UU block (W_uu over the rows whose U
// holds g) into M registers and writes row g of the output tile.
//
// What bounds it: the B*P*N triples (39.7 M at the Adult GBT's dense shapes,
// B=256, P=1550, N=100), each a few integer operations, and on a live row
// up to five f32 divisions and u*u + u + 1 adds; the inputs are ~46 MB of
// 0/1 floats read once.  So the function is bound by operations, and the
// design keeps each triple cheap as exact_tree_phi does: indicators as bit
// masks (x in registers, z packed once per launch by a prep pass), counts as
// population counts, the binomial read from a (dmax+1)x(M+1) table built per
// launch with the reference's masked product.  Its cost is the g loop: a
// block walks its staged background once for pass A and once more for every
// group that is x-only on one of its paths, about (1 + M) times in all.
//
// Layout and tiling: one thread per (b, p); a block of 256 threads is 8
// warps = 8 instances x 32 paths (one path per lane).  The background axis
// is staged through shared memory in chunks of kNC rows of packed bits (the
// 100-row background in one chunk, staged once; a longer background is
// staged again for every pass), so one launch takes any N and any dmax (the
// TPU kernel held all of N in VMEM and its callers sliced N at 256).  Rows
// of the output tile end in a warp shuffle tree per (g, h, k); blocks write
// one partial (B, M, M, K) per path tile and a second kernel sums the tiles
// in a fixed order: no float atomics, so two launches on the same inputs
// give bit-identical output (the TPU kernel accumulated over a sequential
// grid axis instead).  Limit: M <= 63 groups (one 64-bit word per (n, p)
// holds the z_ok bits and the z_dead bit).  The packing, staging, tile sum
// and launch sequence are in exact_tree_common.cuh, shared with
// exact_tree_phi.cu.

#include "exact_tree_common.cuh"

namespace {

constexpr int kNC = 112;                 // background rows staged per chunk
static_assert(smem_bytes(kNC, kMaxM, kMaxM) <= 48 * 1024,
              "staging must fit without an opt-in");

template <int MT>
__global__ void __launch_bounds__(kThreads)
inter_tile_kernel(const float* __restrict__ x_only, const float* __restrict__ x_not,
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
  const int v = __popcll(xn);          // |V| on every alive row
  const float fv = (float)v;
  const int nchunks = (N + kNC - 1) / kNC;

  // pass A: A_vv and A_uv[m]
  float avv = 0.0f;
  float auv[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) auv[m] = 0.0f;
  int nc = 0;
  for (int c = 0; c < nchunks; ++c) {
    nc = stage_chunk<kNC>(zs, ws, zbits, bgw, c, N, P, p0);
    if (v == 0) continue;   // no x-not group: no UV or VV term
    for (int n = 0; n < nc; ++n) {
      const u64 z = zs[n * kTP + lane];
      const u64 nz = ~z & mmask;
      if ((z >> kDeadBit) || (xn & nz)) continue;   // not alive
      const u64 su = xo & nz;
      const int u = __popcll(su);
      if (u == 0 && v < 2) continue;
      const float base = ws[n] / tab[min(max(u - 1, 0), dm) * (M + 1) + v];
      if (v >= 2)
        avv += u ? base * ((float)u / (fv * (fv - 1.0f))) : base * (1.0f / (fv - 1.0f));
      if (u) {
        const float w = -(base / fv);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          if ((su >> m) & 1ull) auv[m] += w;
      }
    }
  }

  // pass B, one output row g at a time (g is uniform over the block)
  float* tile = partial + ((size_t)blockIdx.y * B + b) * M * M * K;
  for (int g = 0; g < M; ++g) {
    const bool g_only = (xo >> g) & 1ull;
    const bool g_not = (xn >> g) & 1ull;
    float acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = 0.0f;
    if (__syncthreads_or(g_only)) {
      for (int c = 0; c < nchunks; ++c) {
        // one chunk stays staged from pass A; more are staged again
        if (nchunks > 1) nc = stage_chunk<kNC>(zs, ws, zbits, bgw, c, N, P, p0);
        if (!g_only) continue;
        for (int n = 0; n < nc; ++n) {
          const u64 z = zs[n * kTP + lane];
          const u64 nz = ~z & mmask;
          if ((z >> kDeadBit) || (xn & nz)) continue;   // not alive
          const u64 su = xo & nz;
          if (!((su >> g) & 1ull)) continue;            // g not in U
          const int u = __popcll(su);
          if (u < 2) continue;                          // W_uu = 0
          const float base = ws[n] / tab[min(u - 1, dm) * (M + 1) + v];
          const float w = base / (float)(u - 1);
#pragma unroll
          for (int m = 0; m < MT; ++m)
            if ((su >> m) & 1ull) acc[m] += w;
        }
      }
    }
    // row g of this (b, p): UU on x-only pairs, A_uv on mixed pairs, A_vv on
    // x-not pairs; summed over the warp's 32 paths in a fixed shuffle tree
    float ag = 0.0f;
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m == g) ag = auv[m];
    for (int k = 0; k < K; ++k) {
      const float lv = ok ? leaf_val[(size_t)p * K + k] : 0.0f;
#pragma unroll
      for (int h = 0; h < MT; ++h) {
        if (h < M) {
          const bool h_only = (xo >> h) & 1ull;
          const bool h_not = (xn >> h) & 1ull;
          const float val = g_only ? (h_only ? acc[h] : (h_not ? ag : 0.0f))
                            : (g_not ? (h_only ? auv[h] : (h_not ? avv : 0.0f)) : 0.0f);
          float s = val * lv;
#pragma unroll
          for (int off = kTP / 2; off > 0; off >>= 1)
            s += __shfl_down_sync(0xffffffffu, s, off);
          if (lane == 0 && b < B) tile[((size_t)g * M + h) * K + k] = s;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int exact_tree_inter_max_m() { return kMaxM; }

// number of path tiles = leading dimension of the partial-output scratch
int exact_tree_inter_partial_tiles(int P) { return partial_tiles(P); }

// The arguments of launch_exact (exact_tree_common.cuh): partial is
// (tiles,B,M,M,K) and out (B,M,M,K).
int exact_tree_inter_launch(const float* x_only, const float* x_not,
                            const float* z_ok, const float* z_dead,
                            const float* leaf_val, const float* bgw, void* zbits,
                            float* table, float* partial, float* out, int B,
                            int P, int N, int M, int K, int dmax, void* stream) {
  return launch_exact<kNC>(inter_tile_kernel<16>, inter_tile_kernel<32>,
                           inter_tile_kernel<64>, (long long)M * M * K, x_only,
                           x_not, z_ok, z_dead, leaf_val, bgw, zbits, table,
                           partial, out, B, P, N, M, K, dmax, stream);
}

}  // extern "C"
