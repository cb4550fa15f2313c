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
// B=256, P=2048, N=100), each a handful of integer operations, and on a live
// row two weights and u + 1 adds; the inputs are ~60 MB of 0/1 floats read
// once.  So it is bound by operations (integer counts).  What the design
// does about it:
//
// - The indicators are bit masks (x in registers, z packed once per launch
//   by a prep pass) and the counts population counts.
// - On an alive row every x-not group of (b, p) lies in z_ok, so v and the
//   whole V side are fixed per (b, p): s_m is the same ONE scalar sum
//   S_m = sum_n wm for every x-not group, applied in the epilogue.  Only the
//   x-only groups outside z_ok take a per-group add, a predicated add on
//   su = x_only & !z_ok into one register per group.
// - The weights come from two reciprocal tables staged in shared memory,
//   wp_tab[u][v] = 1/(u C(u+v,u)) and wm_tab[u][v] = 1/(v C(u+v,u)), built
//   by the wrapper from the reference's masked-product binomial: a live row
//   costs two table reads and two multiplies by bgw[n], and no division.
// - Each lane sweeps a staged chunk once into a live-row mask (alive, and
//   u + v > 0), and the body runs over its set bits only.
//
// Layout and tiling: one thread per (b, p); a block of 256 threads is 8
// warps = 8 instances x 32 paths (one path per lane).  The background axis
// is streamed through shared memory in chunks of kNC rows of packed bits,
// so one launch takes any N and any dmax (the TPU kernel held all of N in
// VMEM and its callers sliced N at 256).  The path sum ends in a warp
// shuffle tree per (m, k); blocks write one partial phi per path tile and a
// second kernel sums the tiles in a fixed order: no float atomics, so two
// launches on the same inputs give bit-identical phi (the TPU kernel
// accumulated over a sequential grid axis instead).
//
// Width: up to 63 groups the masks are by group, one accumulator register per
// group.  From 64 groups (any M) the masks are by path slot: a path holds at
// most dmax <= 64 groups (the reference kernel's own dmax gate), so the
// (P, 64) slot table maps bit j of a path's masks to its j-th
// group, the pack pass gathers z_ok and the instance bits into slot order,
// and the same body runs on 64 slot registers, looping only to the warp's
// deepest slot (a tree path holds a few groups, not 64).  Its epilogue
// gathers the warp's 32 paths into one row of M*K floats, in shared memory
// where the rows fit two blocks an SM (else in the partial output itself):
// slot-major, for j up to the warp's deepest slot, the lanes whose slot j
// holds the same group (__match_any_sync, on the slots' groups staged in
// shared memory) are summed in lane order by the lowest of them, who adds the
// sum at that group; then the row is written out coalesced.  The order is
// fixed, so two launches stay bit-identical, and a step costs one
// shared-memory add per distinct group (where a lane-by-lane epilogue takes
// 32 serial turns of dependent read-modify-writes a warp).  The state of a
// (b, p) is 64 bits and 64 registers whatever M is; the tables are (min(M,
// 64) + 1)^2.  dmax > 64 past 64 groups raises in the wrapper.  (At M = 64 the
// slots only drop the groups no instance has on the path: the word's 64 bits
// carry groups, so z_dead is a byte array there.)  The packing, staging, live
// masks, tile sum and launch sequence are in exact_tree_common.cuh, shared
// with exact_tree_inter.cu.

#include "exact_tree_common.cuh"

namespace {

constexpr int kTabs = 2;   // wp_tab, wm_tab, each table_side(M)^2

// By slot, the epilogue's shared memory: a 32-float exchange a warp, the
// group of each slot of the block's 32 paths ([slot][path], int), and the
// warps' rows of M*K floats where they fit two blocks an SM
__host__ __device__ constexpr size_t slot_scratch_bytes(int M) {
  return stage_bytes(M, kTabs) + sizeof(float) * kTB * kTP + sizeof(int) * kMaxM * kTP;
}
__host__ __device__ constexpr bool row_in_smem(int M, int K) {
  return slot_scratch_bytes(M) + sizeof(float) * kTB * (size_t)M * K <= kTwoBlockSmem;
}

size_t phi_smem(int M, int K) {
  if (!dead_bytes(M)) return stage_bytes(M, kTabs);
  return slot_scratch_bytes(M) + (row_in_smem(M, K) ? sizeof(float) * kTB * (size_t)M * K : 0);
}

// Group masks of width MaskT (32 bits while M <= 32), MT group registers;
// SLOTS: by path slot (M >= 64), MT = 64, the dead flags as bytes.
template <typename MaskT, int MT, bool SLOTS>
__global__ void __launch_bounds__(kThreads)
phi_tile_kernel(const float* __restrict__ x_only, const float* __restrict__ x_not,
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
  unsigned char* ds = reinterpret_cast<unsigned char*>(tab + kTabs * tn);  // SLOTS: [kNC][kTP]
  stage_tables(tab, tables, kTabs * tn);
  // by slot: the exchange [kTB][kTP], the slots' groups [kMaxM][kTP], the rows
  float* xch = reinterpret_cast<float*>(smem_raw + stage_bytes(M, kTabs));
  int* sg = reinterpret_cast<int*>(xch + kTB * kTP);
  if (SLOTS)   // ordered before the epilogue by stage_chunk's barriers
    for (int i = threadIdx.x; i < kMaxM * kTP; i += kThreads) {
      const int pl = blockIdx.y * kTP + i % kTP;
      sg[i] = pl < P ? slots[(size_t)pl * kMaxM + i / kTP] : -1;
    }

  const int lane = threadIdx.x % kTP;
  const int b = blockIdx.x * kTB + threadIdx.x / kTP;
  const int p0 = blockIdx.y * kTP;
  const int p = p0 + lane;
  const bool ok = b < B && p < P;
  u64 xo64, xn64;
  group_bits(x_only, x_not, SLOTS ? slots : nullptr, (size_t)b * P + p, p, M, ok, xo64,
             xn64);
  const MaskT xo = (MaskT)xo64, xn = (MaskT)xn64;
  // column v = |x_not| of each table, read at [u * ts]
  const float* t_p = tab + __popcll(xn64);
  const float* t_m = t_p + tn;
  // with an x-not group every alive row adds to S_m; without, it needs u > 0
  const int need_u = xn ? 0 : 1;
  // by slot: one past the warp's deepest slot, where every per-slot loop ends
  const int jmax = SLOTS ? (int)__reduce_max_sync(0xffffffffu, (unsigned)bit_width(
                               (MaskT)(xo | xn))) : MT;

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.0f;
  float sm = 0.0f;

  const int nchunks = (N + kNC - 1) / kNC;
  for (int c = 0; c < nchunks; ++c) {
    const int nc = stage_chunk<SLOTS>(zs, ds, ws, zbits, zdead, bgw, c, N, P, p0);
    for (u64 live = live_rows<SLOTS>(zs, ds, nc, lane, xo, xn, need_u); live;
         live &= live - 1) {
      const int n = __ffsll(live) - 1;
      const MaskT su = xo & ~(MaskT)zs[n * kTP + lane];   // groups that must be IN
      const int u = popc(su);
      const float wn = ws[n];
      sm += wn * t_m[u * ts];
      const float wp = wn * t_p[u * ts];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (SLOTS && m >= jmax) break;
        if (su & (MaskT(1) << m)) acc[m] += wp;
      }
    }
  }

  // d = s_p*x_only - s_m*x_not: +acc on x-only groups, -S_m on x-not groups;
  // sum d*leaf_val over the warp's 32 paths in a fixed order
  float* out = partial + ((size_t)blockIdx.y * B + b) * M * K;
  if (SLOTS) {
    // by slot: the warp's row (b, so the branch, is warp-uniform), zeroed;
    // per slot j, each group's lanes summed in lane order by the lowest
    if (b >= B) return;
    float* wx = xch + (threadIdx.x / kTP) * kTP;
    float* row = row_in_smem(M, K)
                     ? reinterpret_cast<float*>(smem_raw + slot_scratch_bytes(M)) +
                           (size_t)(threadIdx.x / kTP) * M * K
                     : out;
    for (size_t i = lane; i < (size_t)M * K; i += kTP) row[i] = 0.0f;
    const MaskT on = xo | xn;   // 0 past B or P
    const float lv0 = ok ? leaf_val[(size_t)p * K] : 0.0f;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (j >= jmax) break;
      const bool has = (on >> j) & 1;
      const int g = has ? sg[j * kTP + lane] : -1;
      const float d = (xo >> j) & 1 ? acc[j] : -sm;
      const unsigned peers = __match_any_sync(0xffffffffu, g);
      const bool lead = has && lane == __ffs(peers) - 1;
      for (int k = 0; k < K; ++k) {
        wx[lane] = has ? d * (k ? leaf_val[(size_t)p * K + k] : lv0) : 0.0f;
        __syncwarp();
        if (lead) {
          float s = 0.0f;
          for (unsigned m = peers; m; m &= m - 1) s += wx[__ffs(m) - 1];
          row[(size_t)g * K + k] += s;
        }
        __syncwarp();
      }
    }
    if (row != out)
      for (size_t i = lane; i < (size_t)M * K; i += kTP) out[i] = row[i];
    return;
  }
  // by group: a shuffle tree per (m, k)
  for (int k = 0; k < K; ++k) {
    const float lv = ok ? leaf_val[(size_t)p * K + k] : 0.0f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        const float d = (xo & (MaskT(1) << m)) ? acc[m] : ((xn & (MaskT(1) << m)) ? -sm : 0.0f);
        float s = d * lv;
#pragma unroll
        for (int off = kTP / 2; off > 0; off >>= 1)
          s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0 && b < B) out[m * K + k] = s;
      }
    }
  }
}

// 32-bit masks up to 32 groups; one register per group, the per-group
// loops unrolled to the template width; from 64 groups, by path slot
TileKernel phi_tile(int M) {
  if (M <= 16) return phi_tile_kernel<unsigned, 16, false>;
  if (M <= 32) return phi_tile_kernel<unsigned, 32, false>;
  if (!dead_bytes(M)) return phi_tile_kernel<u64, 64, false>;
  return phi_tile_kernel<u64, 64, true>;
}

}  // namespace

extern "C" {

// the most groups one word carries: from it the kernel runs by path slot
// and takes dmax <= this
int exact_tree_phi_max_m() { return kMaxM; }

// The slot table the kernel runs by (launch_slot_table,
// exact_tree_common.cuh) into slots, a scratch of slot_table_ints int32:
// the (P, 64) table, then each path's group count, then the hit bytes.
long long exact_tree_phi_slot_table_ints(int P, int M) {
  return slot_table_ints(P, M);
}
int exact_tree_phi_slot_table(const float* x_only, const float* x_not, int* slots,
                              int B, int P, int M, void* stream) {
  return launch_slot_table(x_only, x_not, slots, B, P, M, stream);
}

// number of path tiles = leading dimension of the partial-phi scratch
int exact_tree_phi_partial_tiles(int P) { return partial_tiles(P); }

// the tile kernel's dynamic shared memory and resident blocks per SM at M
// groups and K classes, or -1 (blocks: minus the cudaError_t)
long long exact_tree_phi_smem_bytes(int M, int K) {
  return valid_problem(1, 1, 1, M, K, 1, dead_bytes(M)) ? (long long)phi_smem(M, K) : -1;
}
int exact_tree_phi_blocks_per_sm(int M, int K) {
  if (!valid_problem(1, 1, 1, M, K, 1, dead_bytes(M))) return -(int)cudaErrorInvalidValue;
  return blocks_per_sm(phi_tile(M), phi_smem(M, K));
}

// The arguments of launch_exact (exact_tree_common.cuh): tables is wp_tab,
// wm_tab, each table_side(M)^2; slots the (P,64) slot table from 64 groups
// (else null); partial is (tiles,B,M,K) and out (B,M,K).
int exact_tree_phi_launch(const float* x_only, const float* x_not,
                          const float* z_ok, const float* z_dead,
                          const float* leaf_val, const float* bgw,
                          const float* tables, const int* slots, void* zbits,
                          void* zdead, float* partial, float* out, int B, int P,
                          int N, int M, int K, int dmax, void* stream) {
  return launch_exact(phi_tile(M), phi_smem(M, K), (long long)M * K, x_only, x_not,
                      z_ok, z_dead, leaf_val, bgw, tables, dead_bytes(M) ? slots : nullptr,
                      zbits, zdead, partial, out, B, P, N, M, K, dmax, stream);
}

}  // extern "C"
