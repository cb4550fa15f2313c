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
// caller scales it, halves the off-diagonal and rebuilds the diagonal).  W
// is symmetric, so the kernel sums the triangle g <= h and writes both
// halves.
//
// The structure used: on an alive row every x-not group of (b, p) lies in
// z_ok, so V is the whole x-not set of (b, p) and v is fixed; only U changes
// with n.  So the VV pairs of (b, p) take ONE sum over n, applied once per
// path, and only the UU and UV pairs need a test per row.
//
// What bounds it: the B*P*N triples (39.7 M at the Adult GBT's dense shapes,
// B=256, P=1550, N=100), each a few integer operations, and on a live row
// three weights and u(u+1)/2 + u + 1 adds; the inputs are ~46 MB of 0/1
// floats read once.  So the function is bound by operations (integer counts,
// with the bytes just behind).  What the design does about it:
//
// - A warp is one instance and 32 paths.  Each lane sweeps the staged chunk
//   once for its own path into a live-row mask (alive, and some weight
//   nonzero: v >= 2, or u >= 1 with v = 1, or u >= 2).  The warp then walks
//   its paths one at a time and, for each, that path's live rows -- control
//   flow uniform over the warp, so no lane idles in a divergent body and
//   the warp takes as many steps as it has live triples.
// - Each lane owns PPL pairs (g, h) of the triangle and keeps their sums in
//   registers: on a live row it tests its pairs against U with two bit
//   operations and adds W_uu or W_uv, with no shared-memory read-modify-
//   write and no data-dependent loop.  PPL is 3 up to M = 12 (the Adult
//   width: 78 pairs, one band), 5 up to M = 17 and 8 beyond; where the
//   triangle has more than 32*PPL pairs the walk repeats per band of pairs
//   (M = 32: 3 bands, M = 64: 9).  The leaf value is folded into the row
//   weight, so the sums run over all paths and chunks at once (one walk
//   per class k).
// - The weights come from reciprocal tables staged in shared memory (W_uu,
//   W_uv, W_vv over C(u+v-1, v), built by the wrapper from the reference's
//   masked-product binomial): a live row reads three and multiplies, and
//   divides nothing.
//
// Why not one path per lane with the sums in shared memory: kept by rank,
// [slot][thread], they measured 1.09 ms at the Adult shapes against this
// design's 0.55 ms (H100 80GB HBM3) -- each live row's chain of shared-
// memory read-modify-writes ran divergently on 19% of the lanes.
//
// Layout and tiling: a block of 256 threads is 8 warps = 8 instances x 32
// paths.  The background axis is staged through shared memory kNC rows at a
// time, so one launch takes any N and any dmax (the TPU kernel held all of
// N in VMEM and its callers sliced N at 256).  Blocks write one partial
// (B, M, M, K) per path tile and a second kernel sums the tiles in a fixed
// order: no float atomics, so two launches on the same inputs give
// bit-identical output (the TPU kernel accumulated over a sequential grid
// axis instead).  Limit: M <= 64 groups, the reference's own cap on exact
// interactions (one 64-bit word per (n, p) carries the z_ok bits; at M = 64
// z_dead is a byte array of its own, the DB variant).  The packing, staging, live masks, tile sum and
// launch sequence are in exact_tree_common.cuh, shared with
// exact_tree_phi.cu.

#include "exact_tree_common.cuh"

namespace {

constexpr int kTabs = 3;   // W_uu, W_uv, W_vv over C(u+v-1, v), each table_side(M)^2

__host__ __device__ constexpr int tri(int j) { return j * (j + 1) / 2; }

// The pair (i <= j) at triangle slot s = j(j+1)/2 + i.
__device__ __forceinline__ void pair_of(int s, int& i, int& j) {
  j = 0;
  while (tri(j + 1) <= s) ++j;
  i = s - tri(j);
}

size_t inter_smem(int M) { return stage_bytes(M, kTabs); }

// Group masks of width MaskT (32 bits while M <= 32); each lane owns PPL
// pairs of the triangle per band; DB: the dead flags are bytes (M = 64).
template <typename MaskT, int PPL, bool DB>
__global__ void __launch_bounds__(kThreads)
inter_tile_kernel(const float* __restrict__ x_only, const float* __restrict__ x_not,
                  const u64* __restrict__ zbits, const unsigned char* __restrict__ zdead,
                  const int* __restrict__ slots, const float* __restrict__ leaf_val,
                  const float* __restrict__ bgw, const float* __restrict__ tables,
                  float* __restrict__ partial, int B, int P, int N, int M, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ts = table_side(M);
  const int tn = ts * ts;
  u64* zs = reinterpret_cast<u64*>(smem_raw);           // [kNC][kTP]
  float* ws = reinterpret_cast<float*>(zs + kNC * kTP);  // [kNC]
  float* tab = ws + kNC;                                 // [kTabs][ts][ts]
  unsigned char* ds = reinterpret_cast<unsigned char*>(tab + kTabs * tn);  // DB: [kNC][kTP]
  stage_tables(tab, tables, kTabs * tn);

  const int lane = threadIdx.x % kTP;
  const int b = blockIdx.x * kTB + threadIdx.x / kTP;
  const int p0 = blockIdx.y * kTP;
  const int p = p0 + lane;
  const bool ok = b < B && p < P;
  u64 xo64, xn64;
  group_bits(x_only, x_not, nullptr, (size_t)b * P + p, p, M, ok, xo64, xn64);
  const MaskT xo = (MaskT)xo64, xn = (MaskT)xn64;
  const int v = __popcll(xn64);        // |V| on every alive row of this path
  const int need_u = v >= 2 ? 0 : (v == 1 ? 1 : 2);
  const int npairs = tri(M);
  const int nbands = (npairs + kTP * PPL - 1) / (kTP * PPL);
  const int nchunks = (N + kNC - 1) / kNC;
  float* tile = partial + ((size_t)blockIdx.y * B + b) * M * M * K;

  int nc = 0;
  for (int k = 0; k < K; ++k) {
    const float lv = ok ? leaf_val[(size_t)p * K + k] : 0.0f;
    for (int band = 0; band < nbands; ++band) {
      // this lane's pairs: triangle slot s = j(j+1)/2 + i (i <= j), taken
      // as s = band*32*PPL + e*32 + lane; past the triangle, a pair that is
      // summed but never written
      MaskT pm[PPL];
      float acc[PPL];
#pragma unroll
      for (int e = 0; e < PPL; ++e) {
        const int s = (band * PPL + e) * kTP + lane;
        int i, j;
        pair_of(s, i, j);
        pm[e] = s < npairs ? (MaskT(1) << i) | (MaskT(1) << j) : MaskT(0);
        acc[e] = 0.0f;
      }
      for (int c = 0; c < nchunks; ++c) {
        // one chunk stays staged across walks; more are staged again
        if ((k == 0 && band == 0) || nchunks > 1)
          nc = stage_chunk<DB>(zs, ds, ws, zbits, zdead, bgw, c, N, P, p0);
        const u64 live = live_rows<DB>(zs, ds, nc, lane, xo, xn, need_u);
        for (int q = 0; q < kTP; ++q) {   // the warp's paths, one at a time
          u64 lq = __shfl_sync(0xffffffffu, live, q);
          if (!lq) continue;
          const MaskT xoq = __shfl_sync(0xffffffffu, xo, q);
          const MaskT xnq = __shfl_sync(0xffffffffu, xn, q);
          const float lvq = __shfl_sync(0xffffffffu, lv, q);
          // column v of each table, read at [u * ts]
          const float* t_uu = tab + popc(xnq);
          const float* t_uv = t_uu + tn;
          const float* t_vv = t_uu + 2 * tn;
          // per pair on this path: the groups of it that must be in U for
          // the row to add, and which weight it adds -- W_uu for a pair
          // with no x-not group (both must be in U), W_uv for a pair with
          // one (the other must be in U); a pair with two is VV (never in
          // U: it takes the path's VV sum below)
          MaskT need[PPL];
          bool mixed[PPL];
#pragma unroll
          for (int e = 0; e < PPL; ++e) {
            const MaskT in_v = xnq & pm[e];
            mixed[e] = in_v && in_v != pm[e];
            need[e] = mixed[e] ? pm[e] & ~xnq : pm[e];
          }
          float vvs = 0.0f;
          for (; lq; lq &= lq - 1) {
            const int n = __ffsll(lq) - 1;
            const MaskT su = xoq & ~(MaskT)zs[n * kTP + q];
            const int u = popc(su);
            const float wl = ws[n] * lvq;
            vvs += wl * t_vv[u * ts];
            if (u == 0) continue;
            const float wuu = wl * t_uu[u * ts];
            const float wuv = wl * t_uv[u * ts];
#pragma unroll
            for (int e = 0; e < PPL; ++e)
              if ((su & need[e]) == need[e]) acc[e] += mixed[e] ? wuv : wuu;
          }
#pragma unroll
          for (int e = 0; e < PPL; ++e)
            if ((xnq & pm[e]) == pm[e]) acc[e] += vvs;
        }
      }
      if (b < B) {
#pragma unroll
        for (int e = 0; e < PPL; ++e) {
          if (pm[e]) {
            int i, j;
            pair_of((band * PPL + e) * kTP + lane, i, j);
            tile[((size_t)i * M + j) * K + k] = acc[e];
            tile[((size_t)j * M + i) * K + k] = acc[e];
          }
        }
      }
    }
  }
}

// 32-bit masks up to 32 groups; pairs per lane so that the Adult width (M =
// 12: 78 pairs) takes one band
TileKernel inter_tile(int M) {
  if (M <= 12) return inter_tile_kernel<unsigned, 3, false>;
  if (M <= 17) return inter_tile_kernel<unsigned, 5, false>;
  if (M <= 32) return inter_tile_kernel<unsigned, 8, false>;
  if (!dead_bytes(M)) return inter_tile_kernel<u64, 8, false>;
  return inter_tile_kernel<u64, 8, true>;
}

}  // namespace

extern "C" {

int exact_tree_inter_max_m() { return kMaxM; }

// number of path tiles = leading dimension of the partial-output scratch
int exact_tree_inter_partial_tiles(int P) { return partial_tiles(P); }

// the tile kernel's dynamic shared memory and resident blocks per SM at M
// groups, or -1 (blocks: minus the cudaError_t)
long long exact_tree_inter_smem_bytes(int M) {
  return valid_problem(1, 1, 1, M, 1, 1, false) ? (long long)inter_smem(M) : -1;
}
int exact_tree_inter_blocks_per_sm(int M) {
  if (!valid_problem(1, 1, 1, M, 1, 1, false)) return -(int)cudaErrorInvalidValue;
  return blocks_per_sm(inter_tile(M), inter_smem(M));
}

// The arguments of launch_exact (exact_tree_common.cuh): tables is W_uu,
// W_uv, W_vv over C(u+v-1, v), each table_side(M)^2; slots is unused (by
// group only: M <= 64); partial is (tiles,B,M,M,K) and out (B,M,M,K).
int exact_tree_inter_launch(const float* x_only, const float* x_not,
                            const float* z_ok, const float* z_dead,
                            const float* leaf_val, const float* bgw,
                            const float* tables, const int* slots, void* zbits,
                            void* zdead, float* partial, float* out, int B, int P,
                            int N, int M, int K, int dmax, void* stream) {
  (void)slots;
  return launch_exact(inter_tile(M), inter_smem(M), (long long)M * M * K, x_only,
                      x_not, z_ok, z_dead, leaf_val, bgw, tables, nullptr, zbits, zdead,
                      partial, out, B, P, N, M, K, dmax, stream);
}

}  // extern "C"
