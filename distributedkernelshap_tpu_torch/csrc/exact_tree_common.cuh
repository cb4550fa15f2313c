// What exact_tree_phi.cu and exact_tree_inter.cu share: the packed
// background format, the binomial table, the background staging, the
// fixed-order tile sum and the launch sequence.  Each .cu adds only its tile
// kernel and its extern "C" names.
//
// Packed format: one 64-bit word per (background row n, path p) holds the
// z_ok bits of the M groups in bits 0..M-1 and z_dead in bit 63, so M <= 63
// (kMaxM; the wrapper's MAX_TREE_M).  A tile kernel runs one thread per
// (instance b, path p) in 256-thread blocks of 8 instances x 32 paths (one
// path per lane), stages the background through shared memory NC rows at a
// time and writes one partial output per 32-path tile; sum_tiles_kernel adds
// the tiles in a fixed order, so two launches give bit-identical output.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTP = 32;                  // paths per block: one per lane
constexpr int kTB = kThreads / kTP;      // instances per block: one per warp
constexpr int kMaxM = 63;
constexpr int kDeadBit = 63;
static_assert(kTP == 32, "one path per lane: the shuffle reduction spans a warp");

typedef unsigned long long u64;

// Shared memory of a tile kernel: nc rows x kTP packed words, nc weights and
// the (dm+1)x(M+1) binomial table.
constexpr size_t smem_bytes(int nc, int dm, int M) {
  return sizeof(u64) * nc * kTP + sizeof(float) * (nc + (size_t)(dm + 1) * (M + 1));
}

constexpr int partial_tiles(int P) { return (P + kTP - 1) / kTP; }

// Pack z_ok/z_dead into one word per (n, p) and build the binomial table
// table[t*(M+1)+v] = prod_{i=1..t} (v+i)/i for t <= dm, v <= M, with the
// reference's masked-product arithmetic.
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
    const int t = (int)(idx / (M + 1));
    const float fv = (float)(idx % (M + 1));
    float binom = 1.0f;
    for (int i = 1; i <= t; ++i) {
      const float fi = (float)i;
      binom = binom * ((fv + fi) / fi);
    }
    table[idx] = binom;
  }
}

// Stage background chunk c (NC rows: the packed words of the block's 32
// paths, a dead word past P, and the weights) into shared memory; returns
// the chunk's row count.  Starts with a barrier, so the block is done with
// the previous chunk (and with any table copy before the first call).
template <int NC>
__device__ __forceinline__ int stage_chunk(u64* zs, float* ws,
                                           const u64* __restrict__ zbits,
                                           const float* __restrict__ bgw,
                                           int c, int N, int P, int p0) {
  const int n0 = c * NC;
  const int nc = min(NC, N - n0);
  __syncthreads();
  for (int i = threadIdx.x; i < nc * kTP; i += kThreads) {
    const int pl = p0 + i % kTP;
    zs[i] = pl < P ? zbits[(size_t)(n0 + i / kTP) * P + pl] : (1ull << kDeadBit);
  }
  for (int i = threadIdx.x; i < nc; i += kThreads) ws[i] = bgw[n0 + i];
  __syncthreads();
  return nc;
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

// A tile kernel: (x_only, x_not, zbits, leaf_val, bgw, table, partial,
// B, P, N, M, K, dm), writing partial (tiles, B, out_per_b).
typedef void (*TileKernel)(const float*, const float*, const u64*, const float*,
                           const float*, const float*, float*, int, int, int,
                           int, int, int);

// The launch sequence of an exact kernel: validate, pack and build the
// table, run the tile kernel instantiated for M <= 16, 32 or 64 groups
// (registers per thread grow with the template width), sum the tiles.
// out_per_b floats per instance (M*K for phi, M*M*K for the pairs).  All
// pointers are device pointers to contiguous arrays: float32 inputs
// x_only/x_not (B,P,M), z_ok (N,P,M), z_dead (N,P), leaf_val (P,K), bgw (N,)
// (normalised); scratch zbits (N,P) 64-bit, table ((dmax+1)*(M+1)) float32,
// partial (tiles,B,out_per_b) float32; out (B,out_per_b).  dmax must be in
// [1, M].  Returns the cudaError_t of the launches.
template <int NC>
int launch_exact(TileKernel k16, TileKernel k32, TileKernel k64,
                 long long out_per_b, const float* x_only, const float* x_not,
                 const float* z_ok, const float* z_dead, const float* leaf_val,
                 const float* bgw, void* zbits, float* table, float* partial,
                 float* out, int B, int P, int N, int M, int K, int dmax,
                 void* stream) {
  if (B <= 0 || P <= 0 || N <= 0 || M <= 0 || K <= 0 || M > kMaxM ||
      dmax < 1 || dmax > M || partial_tiles(P) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* zb = static_cast<u64*>(zbits);
  const long long NP = (long long)N * P;
  const long long tsize = (long long)(dmax + 1) * (M + 1);
  const long long prep_n = NP > tsize ? NP : tsize;
  prep_kernel<<<(unsigned)((prep_n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      z_ok, z_dead, zb, table, NP, M, dmax);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const TileKernel tile = M <= 16 ? k16 : (M <= 32 ? k32 : k64);
  dim3 grid((B + kTB - 1) / kTB, partial_tiles(P));
  tile<<<grid, kThreads, smem_bytes(NC, dmax, M), st>>>(
      x_only, x_not, zb, leaf_val, bgw, table, partial, B, P, N, M, K, dmax);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long total = (long long)B * out_per_b;
  sum_tiles_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      partial, out, total, partial_tiles(P));
  return (int)cudaGetLastError();
}

}  // namespace
