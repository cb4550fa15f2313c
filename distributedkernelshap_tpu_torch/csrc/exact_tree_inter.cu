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
// - The weights come from reciprocal tables (W_uu, W_uv, W_vv over
//   C(u+v-1, v), built by the wrapper from the reference's masked-product
//   binomial): a live row reads three and multiplies, and divides nothing.
//
// Up to 22 groups (the Adult width, M = 12, and every served GBT) each lane
// owns PPL pairs (g, h) of the group triangle and keeps their sums in
// registers: on a live row it tests its pairs against U with two bit
// operations and adds W_uu or W_uv, with no shared-memory read-modify-write
// and no data-dependent loop.  PPL is 3 up to M = 12 (78 pairs, one band),
// 5 up to 17 and 8 beyond (one band up to 22); the leaf value is folded
// into the row weight, so the sums run over all paths and chunks at once.
// Why not one path per lane with the sums in shared memory: kept by rank,
// [slot][thread], they measured 1.09 ms at the Adult shapes against this
// design's 0.55 ms (H100 80GB HBM3) -- each live row's chain of shared-
// memory read-modify-writes ran divergently on 19% of the lanes.
//
// From 23 groups the group triangle takes more than one band of 32*8 pairs
// (M = 64: 2080 pairs, 9 bands), and a walk per band and per class k would
// repeat the staging, the live-mask sweeps and every live triple.  But a
// path's nonzero pairs lie inside its own groups (U is in x_only, V is
// x_not of (b, p)), so the kernel runs by path slot (the (P, 64) slot table
// exact_tree_phi takes from 64 groups): the lanes own slot pairs (i <= j)
// of the path being walked, tri(d) of them for a path whose highest slot
// of (b, p) is d - 1, so a tree path of depth <= 22 takes one band.  After
// a path's live rows in a chunk each lane adds its slot-pair sums (the VV
// sum on pairs of two x-not slots) times leaf_val[p, k] into the warp's
// triangle of group pairs in shared memory, at (sl[i], sl[j]): slots keep
// the groups ascending, and within one path distinct slot pairs are
// distinct group pairs, so no two lanes meet and no atomics are needed;
// paths and chunks are taken in a fixed order.  So the triples are walked
// once for every band and for as many classes as the triangles hold
// (kTwoBlockSmem: two blocks an SM; at M = 64 one class, 8.3 KB a warp).
// Of the tables only the corner u, v < 16, where a tree path's counts lie,
// sits in shared memory; a path that leaves it reads the tables through the
// read-only cache (the reads are warp-uniform).  A path's live rows are
// taken two a step, so that their loads overlap.  The slot table comes
// from the two slot-table passes of exact_tree_common.cuh.  At the dense
// inputs of a 50-tree GBT over 64 columns (B = 64, N = 100) the tile
// kernel took 0.29 ms, where a walk per band and per class took 5.06
// (H100 80GB HBM3).
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
// z_dead is a byte array of its own, the DB variant).  The packing,
// staging, live masks, tile sum and launch sequence are in
// exact_tree_common.cuh, shared with exact_tree_phi.cu.

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

constexpr int kSlotM = 23;     // from this many groups the pairs run by path slot
constexpr int kSlotPPL = 8;    // slot pairs a lane owns per band
constexpr int kFastTab = 16;   // by slot, the tables' counts below this sit in shared memory

// By slot, shared memory before the triangles: the staged chunk (its dead
// flags where dead_bytes(M)), the group of each slot of the block's 32
// paths, one byte each (kMaxM = 64 groups fit), and the weight tables at u,
// v < kFastTab
__host__ __device__ constexpr size_t slot_base_bytes(int M) {
  return stage_bytes(M, 0) + kTP * kMaxM + sizeof(float) * kTabs * kFastTab * kFastTab;
}

// Classes one walk by slot serves: as many as the warps' triangles
// (tri(M) floats a class) hold within two blocks an SM, at least one
__host__ __device__ constexpr int walk_classes(int M, int K) {
  const long long fit = ((long long)kTwoBlockSmem - (long long)slot_base_bytes(M)) /
                        ((long long)kTB * (long long)sizeof(float) * tri(M));
  return (int)(fit < 1 ? 1 : (fit < K ? fit : K));
}

size_t inter_smem(int M, int K) {
  if (M < kSlotM) return stage_bytes(M, kTabs);
  return slot_base_bytes(M) + (size_t)kTB * sizeof(float) * tri(M) * walk_classes(M, K);
}

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

// The slot pair (i <= j) at triangle index s, by the closed form (s <
// tri(64): the fix-ups take at most a step each).
__device__ __forceinline__ void slot_pair_of(int s, int& i, int& j) {
  j = (int)((sqrtf(8.0f * s + 1.0f) - 1.0f) * 0.5f);
  while (tri(j + 1) <= s) ++j;
  while (tri(j) > s) --j;
  i = s - tri(j);
}

// The live rows lq of walked path q (slot masks xoq; its band's pairs'
// need masks and kinds): each row's weights from column v of the tables,
// the first NE pair sums into acc and the VV sum into vvs.  W: the masks'
// width for this path, 32 bits where its slots fit them.  FAST: the
// column t of the tables' corner in shared memory (rows kFastTab apart,
// tables kFastTab^2), where the path's u and v stay below kFastTab; else
// the tables in global memory (rows ts apart, tables tn), read through the
// read-only cache (the reads are warp-uniform).
template <typename W, int NE, bool FAST, typename MaskT>
__device__ __forceinline__ void walk_rows(u64 lq, MaskT xoq, const MaskT* need_m,
                                          const bool* mixed, const u64* zs, int q,
                                          const float* ws, const float* t, int ts, int tn,
                                          float* acc, float& vvs) {
  const W xo = (W)xoq;
  const int row = FAST ? kFastTab : ts;
  const int step = FAST ? kFastTab * kFastTab : tn;
  W need[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) need[e] = (W)need_m[e];
  // two rows a step, their loads issued together; the sums take the rows
  // in order (a row with u = 0 adds to no pair: its su is empty)
  u64 l = lq;
  while (l) {
    const int n0 = __ffsll(l) - 1;
    l &= l - 1;
    const int n1 = l ? __ffsll(l) - 1 : n0;
    const bool two = l != 0;
    l &= l - 1;
    const W su0 = xo & ~(W)zs[n0 * kTP + q];
    const W su1 = two ? xo & ~(W)zs[n1 * kTP + q] : W(0);
    const float w0 = ws[n0], w1 = two ? ws[n1] : 0.0f;
    const float* t0 = t + popc(su0) * row;
    const float* t1 = t + popc(su1) * row;
    const float vv0 = FAST ? t0[2 * step] : __ldg(t0 + 2 * step);
    const float uu0 = FAST ? t0[0] : __ldg(t0), uv0 = FAST ? t0[step] : __ldg(t0 + step);
    const float vv1 = FAST ? t1[2 * step] : __ldg(t1 + 2 * step);
    const float uu1 = FAST ? t1[0] : __ldg(t1), uv1 = FAST ? t1[step] : __ldg(t1 + step);
    vvs += w0 * vv0;
    if (two) vvs += w1 * vv1;
    const float a0 = w0 * uu0, b0 = w0 * uv0, a1 = w1 * uu1, b1 = w1 * uv1;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      if ((su0 & need[e]) == need[e]) acc[e] += mixed[e] ? b0 : a0;
      if ((su1 & need[e]) == need[e]) acc[e] += mixed[e] ? b1 : a1;
    }
  }
}

// walk_rows for the band's ne pairs in use (warp-uniform), so a row tests
// only those
template <typename W, bool FAST, typename MaskT>
__device__ __forceinline__ void walk_band(int ne, u64 lq, MaskT xoq, const MaskT* need,
                                          const bool* mixed, const u64* zs, int q,
                                          const float* ws, const float* t, int ts, int tn,
                                          float* acc, float& vvs) {
#define WALK(NE) walk_rows<W, NE, FAST>(lq, xoq, need, mixed, zs, q, ws, t, ts, tn, acc, vvs)
  switch (ne) {
    case 1: WALK(1); break;
    case 2: WALK(2); break;
    case 3: WALK(3); break;
    case 4: WALK(4); break;
    case 5: WALK(5); break;
    case 6: WALK(6); break;
    case 7: WALK(7); break;
    default: WALK(8); break;
  }
#undef WALK
}
static_assert(kSlotPPL == 8, "walk_band dispatches up to 8 pairs a lane");

// By path slot (M >= kSlotM): slot masks of width MaskT (32 bits while M <=
// 32); each lane owns kSlotPPL slot pairs of the walked path per band; DB:
// the dead flags are bytes (M = 64).  Sums go into the warp's triangle of
// group pairs in shared memory, walk_classes(M, K) classes a walk.
template <typename MaskT, bool DB>
__global__ void __launch_bounds__(kThreads)
inter_slot_kernel(const float* __restrict__ x_only, const float* __restrict__ x_not,
                  const u64* __restrict__ zbits, const unsigned char* __restrict__ zdead,
                  const int* __restrict__ slots, const float* __restrict__ leaf_val,
                  const float* __restrict__ bgw, const float* __restrict__ tables,
                  float* __restrict__ partial, int B, int P, int N, int M, int K) {
  constexpr int kBits = 8 * sizeof(MaskT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ts = table_side(M);
  const int tn = ts * ts;
  const int T = tri(M);
  const int KC = walk_classes(M, K);
  u64* zs = reinterpret_cast<u64*>(smem_raw);                      // [kNC][kTP]
  float* ws = reinterpret_cast<float*>(zs + kNC * kTP);             // [kNC]
  unsigned char* ds = reinterpret_cast<unsigned char*>(ws + kNC);   // DB: [kNC][kTP]
  unsigned char* sg = smem_raw + stage_bytes(M, 0);                 // [kTP][kMaxM]
  float* fast = reinterpret_cast<float*>(sg + kTP * kMaxM);          // [kTabs][16][16]
  float* tri_s = fast + kTabs * kFastTab * kFastTab +
                 (size_t)(threadIdx.x / kTP) * T * KC;              // this warp's [KC][T]

  const int lane = threadIdx.x % kTP;
  const int b = blockIdx.x * kTB + threadIdx.x / kTP;
  const int p0 = blockIdx.y * kTP;
  const int p = p0 + lane;
  const bool ok = b < B && p < P;
  // the group of each slot of the block's paths and the tables' corner
  // (ordered before their first reads by stage_chunk's leading barrier)
  for (int i = threadIdx.x; i < kTP * kMaxM; i += kThreads) {
    const int pl = p0 + i / kMaxM;
    sg[i] = pl < P ? (unsigned char)slots[(size_t)pl * kMaxM + i % kMaxM] : 0;
  }
  for (int i = threadIdx.x; i < kTabs * kFastTab * kFastTab; i += kThreads) {
    const int t = i / (kFastTab * kFastTab), u = i / kFastTab % kFastTab, c = i % kFastTab;
    fast[i] = tables[(size_t)t * tn + u * ts + c];
  }
  u64 xo64, xn64;
  group_bits(x_only, x_not, slots, (size_t)b * P + p, p, M, ok, xo64, xn64);
  const MaskT xo = (MaskT)xo64, xn = (MaskT)xn64;
  const int v = __popcll(xn64);        // |V| on every alive row of this path
  const int need_u = v >= 2 ? 0 : (v == 1 ? 1 : 2);
  const int nchunks = (N + kNC - 1) / kNC;
  float* tile = partial + ((size_t)blockIdx.y * B + b) * M * M * K;

  // this lane's slot pairs of band pm_band: s = (band*kSlotPPL + e)*32 + lane
  MaskT pm[kSlotPPL];
  int pm_band = -1;
  int nc = 0;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kn = min(KC, K - k0);
    for (int t = lane; t < T * kn; t += kTP) tri_s[t] = 0.0f;
    __syncwarp();
    for (int c = 0; c < nchunks; ++c) {
      // one chunk stays staged across walks; more are staged again
      if (k0 == 0 || nchunks > 1)
        nc = stage_chunk<DB>(zs, ds, ws, zbits, zdead, bgw, c, N, P, p0);
      const u64 live = live_rows<DB>(zs, ds, nc, lane, xo, xn, need_u);
      for (int q = 0; q < kTP; ++q) {   // the warp's paths, one at a time
        const u64 lq = __shfl_sync(0xffffffffu, live, q);
        if (!lq) continue;
        const MaskT xoq = __shfl_sync(0xffffffffu, xo, q);
        const MaskT xnq = __shfl_sync(0xffffffffu, xn, q);
        const int npairs = tri(bit_width((MaskT)(xoq | xnq)));
        // column v of the tables: the corner's where u (at most |x_only|)
        // and v stay below kFastTab
        const int vq = popc(xnq);
        const bool in_corner = vq < kFastTab && popc(xoq) < kFastTab;
        const float* lvq = leaf_val + (size_t)(p0 + q) * K + k0;
        const unsigned char* sq = sg + q * kMaxM;
        for (int band = 0; band * kTP * kSlotPPL < npairs; ++band) {
          if (band != pm_band) {
#pragma unroll
            for (int e = 0; e < kSlotPPL; ++e) {
              const int s = (band * kSlotPPL + e) * kTP + lane;
              int i, j;
              slot_pair_of(s, i, j);
              pm[e] = s < tri(kBits) ? (MaskT(1) << i) | (MaskT(1) << j) : MaskT(0);
            }
            pm_band = band;
          }
          // the band's pairs in use: warp-uniform
          const int ne = min(kSlotPPL, (npairs - band * kTP * kSlotPPL + kTP - 1) / kTP);
          // per pair: the slots that must be in U for a row to add, and its
          // weight -- W_uu with no x-not slot, W_uv with one; a pair of two
          // x-not slots takes the VV sum at the flush
          MaskT need[kSlotPPL];
          bool mixed[kSlotPPL];
          float acc[kSlotPPL];
#pragma unroll
          for (int e = 0; e < kSlotPPL; ++e) {
            const MaskT in_v = xnq & pm[e];
            mixed[e] = in_v && in_v != pm[e];
            need[e] = mixed[e] ? pm[e] & ~xnq : pm[e];
            acc[e] = 0.0f;
          }
          float vvs = 0.0f;
#define BAND(W, F, TAB) walk_band<W, F>(ne, lq, xoq, need, mixed, zs, q, ws, TAB, ts, tn, acc, vvs)
          if (sizeof(MaskT) > 4 && npairs <= tri(32)) {   // the path's slots fit 32 bits
            if (in_corner) BAND(unsigned, true, fast + vq);
            else BAND(unsigned, false, tables + vq);
          } else {
            if (in_corner) BAND(MaskT, true, fast + vq);
            else BAND(MaskT, false, tables + vq);
          }
#undef BAND
          // flush: this path's sums times its leaf values into the triangle
#pragma unroll
          for (int e = 0; e < kSlotPPL; ++e) {
            if (e >= ne) break;
            if ((band * kSlotPPL + e) * kTP + lane >= npairs) continue;
            const float val = acc[e] + ((xnq & pm[e]) == pm[e] ? vvs : 0.0f);
            if (val == 0.0f) continue;
            const int i = sq[__ffsll((long long)pm[e]) - 1];
            const int j = sq[bit_width(pm[e]) - 1];
            float* at = tri_s + tri(j) + i;
            for (int kc = 0; kc < kn; ++kc) at[kc * T] += val * __ldg(lvq + kc);
          }
          __syncwarp();
        }
      }
    }
    // this warp's classes of the tile, both halves of the triangle
    if (b < B) {
      for (int i = 0; i < M; ++i)
        for (int j = lane; j < M; j += kTP) {
          const float* at = tri_s + (i <= j ? tri(j) + i : tri(i) + j);
          for (int kc = 0; kc < kn; ++kc)
            tile[((size_t)i * M + j) * K + k0 + kc] = at[kc * T];
        }
    }
    __syncwarp();
  }
}

// 32-bit masks up to 32 groups; by group up to 22 with pairs per lane so
// that the Adult width (M = 12: 78 pairs) takes one band; by path slot from
// 23
TileKernel inter_tile(int M) {
  if (M <= 12) return inter_tile_kernel<unsigned, 3, false>;
  if (M <= 17) return inter_tile_kernel<unsigned, 5, false>;
  if (M < kSlotM) return inter_tile_kernel<unsigned, 8, false>;
  if (M <= 32) return inter_slot_kernel<unsigned, false>;
  if (!dead_bytes(M)) return inter_slot_kernel<u64, false>;
  return inter_slot_kernel<u64, true>;
}

bool inter_valid(int M, int K) { return valid_problem(1, 1, 1, M, K, 1, false); }

}  // namespace

extern "C" {

int exact_tree_inter_max_m() { return kMaxM; }

// from this many groups the kernel runs by path slot and needs the slot table
int exact_tree_inter_slot_m() { return kSlotM; }

// The slot table the kernel runs by (launch_slot_table,
// exact_tree_common.cuh) into slots, a scratch of slot_table_ints int32:
// the (P, 64) table, then each path's group count, then the hit bytes.
long long exact_tree_inter_slot_table_ints(int P, int M) {
  return slot_table_ints(P, M);
}
int exact_tree_inter_slot_table(const float* x_only, const float* x_not, int* slots,
                                int B, int P, int M, void* stream) {
  return launch_slot_table(x_only, x_not, slots, B, P, M, stream);
}

// number of path tiles = leading dimension of the partial-output scratch
int exact_tree_inter_partial_tiles(int P) { return partial_tiles(P); }

// the tile kernel's dynamic shared memory and resident blocks per SM at M
// groups and K classes, or -1 (blocks: minus the cudaError_t)
long long exact_tree_inter_smem_bytes(int M, int K) {
  return inter_valid(M, K) ? (long long)inter_smem(M, K) : -1;
}
int exact_tree_inter_blocks_per_sm(int M, int K) {
  if (!inter_valid(M, K)) return -(int)cudaErrorInvalidValue;
  return blocks_per_sm(inter_tile(M), inter_smem(M, K));
}

// The arguments of launch_exact (exact_tree_common.cuh): tables is W_uu,
// W_uv, W_vv over C(u+v-1, v), each table_side(M)^2; slots the (P,64) slot
// table from exact_tree_inter_slot_m() groups (else unused); partial is
// (tiles,B,M,M,K) and out (B,M,M,K).
int exact_tree_inter_launch(const float* x_only, const float* x_not,
                            const float* z_ok, const float* z_dead,
                            const float* leaf_val, const float* bgw,
                            const float* tables, const int* slots, void* zbits,
                            void* zdead, float* partial, float* out, int B, int P,
                            int N, int M, int K, int dmax, void* stream) {
  const bool by_slot = M >= kSlotM;
  if (M > kMaxM || (by_slot && !slots)) return (int)cudaErrorInvalidValue;
  return launch_exact(inter_tile(M), inter_smem(M, K), (long long)M * M * K, x_only,
                      x_not, z_ok, z_dead, leaf_val, bgw, tables, by_slot ? slots : nullptr,
                      zbits, zdead, partial, out, B, P, N, M, K, dmax, stream);
}

}  // extern "C"
