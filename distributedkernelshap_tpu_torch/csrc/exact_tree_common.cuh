// What exact_tree_phi.cu and exact_tree_inter.cu share: the packed
// background format, the background staging, the live-row masks, the
// fixed-order tile sum and the launch sequence.  Each .cu adds only its tile
// kernel, its shared-memory size and its extern "C" names.
//
// Packed format: one 64-bit word per (background row n, path p) holds the
// z_ok bits of the groups, bit m for group m.  Up to 63 groups z_dead rides
// in bit 63 (kDeadBit); where all 64 bits carry groups (M = 64, kMaxM, the
// wrapper's MAX_TREE_M, or path slots) z_dead is a byte array of its own,
// (N, P) (the DB variants below: a byte load per staged row, which the word's
// free bit saves on the narrower paths).  By path slot (exact_tree_phi from
// 64 groups, exact_tree_inter from 23) bit j is the path's slot j, the j-th
// group, in ascending order, that any instance has on path p, from a (P, 64)
// int32 slot table the slot-table passes below build (-1 past the path's last
// slot; a path holds at most dmax <= 64 groups), and the instance bits are
// gathered into slot order the same way.  So the state of a (b, p) is 64 bits
// wide whatever M is, and a path's bits stop at its slot count.  A tile
// kernel runs one thread per (instance b, path p) in 256-thread blocks of 8
// instances x 32 paths (one path per lane), stages the background through
// shared memory kNC rows at a time and writes one partial output per 32-path
// tile; sum_tiles_kernel adds the tiles in a fixed order, so two launches
// give bit-identical output.
//
// Live rows: after a chunk is staged each lane sweeps it once and keeps, as
// one 64-bit mask in a register, the rows that are alive for its (b, p) and
// add something to its sums (live_rows).  exact_tree_phi runs its body over
// the set bits of its own mask (a warp steps max-over-lanes(live rows)
// times a chunk); exact_tree_inter shuffles the masks and walks the warp's
// paths one at a time (a warp steps once per live triple).
//
// Weights: the kernels do no division.  The wrapper builds the reciprocal
// weight tables once per (kind, dmax, table side, device) from the
// reference's masked-product binomial and passes them in; each kernel stages
// them in shared memory (exact_tree_inter by slot reads them through the
// read-only cache instead: its reads are warp-uniform), indexed [u][v] with
// row length table_side(M) = min(M, 64) + 1: u and v count bits of one
// word, so at most 64.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTP = 32;                  // paths per block: one per lane
constexpr int kTB = kThreads / kTP;      // instances per block: one per warp
constexpr int kMaxM = 64;                // bits of a group word
constexpr int kDeadBit = 63;             // z_dead's bit, up to 63 groups
constexpr int kNC = 64;                  // rows per chunk: one live-mask word
constexpr size_t kMaxSmem = 232448;      // a block's shared memory after the opt-in
// the most shared memory a block may take for two blocks an SM (the SM's
// 233,472 bytes halved, less the 1 KB the card keeps per block)
constexpr size_t kTwoBlockSmem = 115712;
static_assert(kTP == 32, "one path per lane: the shuffle reduction spans a warp");
static_assert(kNC == 64, "the live mask of a chunk is one 64-bit word");

typedef unsigned long long u64;

// Row length of the weight tables: u and v count bits of one word.
__host__ __device__ constexpr int table_side(int M) { return (M < kMaxM ? M : kMaxM) + 1; }

// Whether z_dead needs a byte array of its own: every bit of the word
// carries a group (or a path slot).
__host__ __device__ constexpr bool dead_bytes(int M) { return M >= kMaxM; }

// Shared memory every tile kernel starts with: kNC rows x kTP packed words,
// kNC weights, ntab weight tables of table_side(M)^2 floats and, where
// dead_bytes(M), kNC x kTP dead flags.
__host__ __device__ constexpr size_t stage_bytes(int M, int ntab) {
  return sizeof(u64) * kNC * kTP +
         sizeof(float) * (kNC + (size_t)ntab * table_side(M) * table_side(M)) +
         (dead_bytes(M) ? kNC * kTP : 0);
}

constexpr int partial_tiles(int P) { return (P + kTP - 1) / kTP; }

// Pack z_ok into one word per (n, p), by group or (slots != nullptr) by
// the path's slots, and z_dead into one byte per (n, p) (zdead !=
// nullptr) or bit 63 of the word.
__global__ void pack_kernel(const float* __restrict__ z_ok,
                            const float* __restrict__ z_dead,
                            const int* __restrict__ slots, u64* __restrict__ zbits,
                            unsigned char* __restrict__ zdead, long long NP, int P,
                            int M) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= NP) return;
  const float* z = z_ok + idx * M;
  u64 bits = 0;
  if (slots) {
    const int* sl = slots + (size_t)(idx % P) * kMaxM;
    for (int j = 0; j < kMaxM && sl[j] >= 0; ++j)
      if (z[sl[j]] > 0.5f) bits |= 1ull << j;
  } else {
    for (int m = 0; m < M; ++m)
      if (z[m] > 0.5f) bits |= 1ull << m;
  }
  if (zdead)
    zdead[idx] = z_dead[idx] > 0.5f;
  else if (z_dead[idx] > 0.5f)
    bits |= 1ull << kDeadBit;
  zbits[idx] = bits;
}

// Copy the n weight-table floats into shared memory (ordered before their
// first use by stage_chunk's leading barrier).
__device__ __forceinline__ void stage_tables(float* tab, const float* __restrict__ tables,
                                             int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) tab[i] = tables[i];
}

// Stage background chunk c (kNC rows: the packed words of the block's 32
// paths and, DB, their dead flags, dead past P, and the weights) into
// shared memory; returns the chunk's row count.  Starts with a barrier, so
// the block is done with the previous chunk (and with the table copy
// before the first call).
template <bool DB>
__device__ __forceinline__ int stage_chunk(u64* zs, unsigned char* ds, float* ws,
                                           const u64* __restrict__ zbits,
                                           const unsigned char* __restrict__ zdead,
                                           const float* __restrict__ bgw,
                                           int c, int N, int P, int p0) {
  const int n0 = c * kNC;
  const int nc = min(kNC, N - n0);
  __syncthreads();
  for (int i = threadIdx.x; i < nc * kTP; i += kThreads) {
    const int pl = p0 + i % kTP;
    const size_t at = (size_t)(n0 + i / kTP) * P + pl;
    if (DB) {
      zs[i] = pl < P ? zbits[at] : 0ull;
      ds[i] = pl < P ? zdead[at] : 1;
    } else {
      zs[i] = pl < P ? zbits[at] : (1ull << kDeadBit);
    }
  }
  for (int i = threadIdx.x; i < nc; i += kThreads) ws[i] = bgw[n0 + i];
  __syncthreads();
  return nc;
}

__device__ __forceinline__ int popc(unsigned x) { return __popc(x); }
__device__ __forceinline__ int popc(u64 x) { return __popcll(x); }
// one past the highest set bit (a path's slot count from its slot mask), 0 for 0
__device__ __forceinline__ int bit_width(unsigned x) { return 32 - __clz(x); }
__device__ __forceinline__ int bit_width(u64 x) { return 64 - __clzll(x); }

// Bit n set: staged row n is alive for this lane's (b, p) -- z_dead clear
// and no x-not group outside z_ok -- and at least need_u of its x-only
// groups lie outside z_ok (the kernel's own "adds something" test).  Group
// masks of width MaskT: 32 bits while M <= 32.  (~z sets bits past the
// groups too; xo and xn have none there.)  DB: the dead flags are bytes.
template <bool DB, typename MaskT>
__device__ __forceinline__ u64 live_rows(const u64* zs, const unsigned char* ds, int nc,
                                         int lane, MaskT xo, MaskT xn, int need_u) {
  u64 live = 0;
#pragma unroll 4
  for (int n = 0; n < nc; ++n) {
    const u64 z = zs[n * kTP + lane];
    const MaskT nz = ~(MaskT)z;
    const bool dead = DB ? ds[n * kTP + lane] != 0 : (z >> kDeadBit) != 0;
    const bool keep = !dead && !(xn & nz) && popc(xo & nz) >= need_u;
    live |= (u64)keep << n;
  }
  return live;
}

// The x-only and x-not groups of (b, p) as bit masks in registers, by group
// or (slots != nullptr) by path p's slots (0 for a thread past B or P).
__device__ __forceinline__ void group_bits(const float* __restrict__ x_only,
                                           const float* __restrict__ x_not,
                                           const int* __restrict__ slots, size_t bp,
                                           int p, int M, bool ok, u64& xo, u64& xn) {
  xo = xn = 0;
  if (!ok) return;
  const float* a = x_only + bp * M;
  const float* c = x_not + bp * M;
  if (slots) {
    const int* sl = slots + (size_t)p * kMaxM;
    for (int j = 0; j < kMaxM && sl[j] >= 0; ++j) {
      if (a[sl[j]] > 0.5f) xo |= 1ull << j;
      if (c[sl[j]] > 0.5f) xn |= 1ull << j;
    }
    return;
  }
  for (int m = 0; m < M; ++m) {
    if (a[m] > 0.5f) xo |= 1ull << m;
    if (c[m] > 0.5f) xn |= 1ull << m;
  }
}

// The slot table of the 0/1 x_only/x_not (B,P,M), in two passes over a
// scratch of slot_table_ints(P, M) int32: first the table, (P, kMaxM) --
// row p the groups any instance has on path p, ascending, then -1 -- then
// each path's group count (P; a row keeps its first kMaxM), then one hit
// byte per (path, group).  Pass 1 (slot_hits_kernel): a thread per (p, m)
// cell and kSlotRows instances, reading the cell's column of both inputs
// (neighbouring threads, neighbouring cells: each input float read once,
// coalesced) and storing 1 where one is set -- every writer stores the
// same byte, so the result does not depend on their order.  Pass 2
// (slot_rank_kernel): a warp per path ranks its hits in group order by
// ballots.
constexpr int kSlotRows = 32;   // instances a thread of pass 1 reads

__host__ __device__ constexpr long long slot_table_ints(int P, int M) {
  return (long long)P * (kMaxM + 1) + ((long long)P * M + 3) / 4;
}

__global__ void slot_hits_kernel(const float* __restrict__ x_only,
                                 const float* __restrict__ x_not,
                                 unsigned char* __restrict__ hit, int B, long long PM) {
  const long long f = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (f >= PM) return;
  const int b1 = min(B, (int)(blockIdx.y + 1) * kSlotRows);
  bool h = false;
  for (int b = blockIdx.y * kSlotRows; b < b1 && !h; b += 8) {
    bool any = false;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (b + i < b1)
        any |= (x_only[(b + i) * PM + f] > 0.5f) | (x_not[(b + i) * PM + f] > 0.5f);
    h = any;
  }
  if (h) hit[f] = 1;
}

__global__ void slot_rank_kernel(const unsigned char* __restrict__ hit,
                                 int* __restrict__ slots, int P, int M) {
  const int p = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (p >= P) return;
  int* row = slots + (size_t)p * kMaxM;
  const unsigned char* h = hit + (size_t)p * M;
  int count = 0;
  for (int m0 = 0; m0 < M; m0 += 32) {
    const bool on = m0 + lane < M && h[m0 + lane];
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    const int rank = count + __popc(ballot & ((1u << lane) - 1));
    if (on && rank < kMaxM) row[rank] = m0 + lane;
    count += __popc(ballot);
  }
  for (int j = count + lane; j < kMaxM; j += 32) row[j] = -1;
  if (lane == 0) slots[(size_t)P * kMaxM + p] = count;
}

// The two passes on stream into slots (slot_table_ints(P, M) int32); the
// cudaError_t of the first step that failed.
inline int launch_slot_table(const float* x_only, const float* x_not, int* slots, int B,
                             int P, int M, void* stream) {
  if (B <= 0 || P <= 0 || M <= 0 || (B + kSlotRows - 1) / kSlotRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long PM = (long long)P * M;
  unsigned char* hit = reinterpret_cast<unsigned char*>(slots + (size_t)P * (kMaxM + 1));
  int err = (int)cudaMemsetAsync(hit, 0, (size_t)PM, st);
  if (err) return err;
  dim3 grid((unsigned)((PM + kThreads - 1) / kThreads), (B + kSlotRows - 1) / kSlotRows);
  slot_hits_kernel<<<grid, kThreads, 0, st>>>(x_only, x_not, hit, B, PM);
  err = (int)cudaGetLastError();
  if (err) return err;
  slot_rank_kernel<<<(P + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(hit, slots,
                                                                                 P, M);
  return (int)cudaGetLastError();
}

// out[i] = sum over path tiles t = 0, 1, ... of partial[t][i], in order.
__global__ void sum_tiles_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, long long total,
                                 int tiles) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s += partial[(size_t)t * total + i];
  out[i] = s;
}

// A tile kernel: (x_only, x_not, zbits, zdead, slots, leaf_val, bgw,
// tables, partial, B, P, N, M, K), writing partial (tiles, B, out_per_b).
typedef void (*TileKernel)(const float*, const float*, const u64*, const unsigned char*,
                           const int*, const float*, const float*, const float*, float*,
                           int, int, int, int, int);

// Let the tile kernel take smem bytes of dynamic shared memory (an opt-in
// above 48 KB); the cudaError_t, or cudaErrorInvalidValue above the card's
// per-block limit.
inline int allow_smem(TileKernel tile, size_t smem) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// Resident blocks per SM of the tile kernel at smem bytes, or minus the
// cudaError_t of the query.
inline int blocks_per_sm(TileKernel tile, size_t smem) {
  int err = allow_smem(tile, smem);
  if (err) return -err;
  int n = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, tile, kThreads, smem);
  return err ? -err : n;
}

// A problem a launch takes: M <= kMaxM groups, or (slots) any M with
// dmax <= kMaxM.
inline bool valid_problem(int B, int P, int N, int M, int K, int dmax, bool slots) {
  return B > 0 && P > 0 && N > 0 && M > 0 && K > 0 && (slots ? dmax <= kMaxM : M <= kMaxM) &&
         dmax >= 1 && dmax <= M && partial_tiles(P) <= 65535;
}

// The launch sequence of an exact kernel: pack, opt the tile kernel in to
// smem bytes of shared memory, run it, sum the tiles.  out_per_b floats per
// instance (M*K for phi, M*M*K for the pairs).  All pointers are device
// pointers to contiguous arrays: float32 inputs x_only/x_not (B,P,M), z_ok
// (N,P,M), z_dead (N,P), leaf_val (P,K), bgw (N,) (normalised), tables (the
// kernel's weight tables, each table_side(M)^2), slots (P,64) int32 (from
// launch_slot_table) or null
// (by group; required past kMaxM groups); scratch zbits (N,P) 64-bit, zdead
// (N,P) bytes where dead_bytes(M) (else unused), partial (tiles,B,out_per_b)
// float32; out (B,out_per_b).
// dmax must be in [1, M].  Returns the cudaError_t of the first step that
// failed.
inline int launch_exact(TileKernel tile, size_t smem, long long out_per_b,
                        const float* x_only, const float* x_not, const float* z_ok,
                        const float* z_dead, const float* leaf_val, const float* bgw,
                        const float* tables, const int* slots, void* zbits, void* zdead,
                        float* partial, float* out, int B, int P, int N, int M, int K,
                        int dmax, void* stream) {
  if (!valid_problem(B, P, N, M, K, dmax, slots != nullptr) || (M > kMaxM && !slots))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* zb = static_cast<u64*>(zbits);
  unsigned char* zd = dead_bytes(M) ? static_cast<unsigned char*>(zdead) : nullptr;
  const long long NP = (long long)N * P;
  pack_kernel<<<(unsigned)((NP + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      z_ok, z_dead, slots, zb, zd, NP, P, M);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = allow_smem(tile, smem);
  if (err) return err;
  dim3 grid((B + kTB - 1) / kTB, partial_tiles(P));
  tile<<<grid, kThreads, smem, st>>>(x_only, x_not, zb, zd, slots, leaf_val, bgw, tables,
                                     partial, B, P, N, M, K);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long total = (long long)B * out_per_b;
  sum_tiles_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      partial, out, total, partial_tiles(P));
  return (int)cudaGetLastError();
}

}  // namespace
