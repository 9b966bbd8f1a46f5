// K7: canonical codes of small graphlets (s <= 8 vertices).
//
// Replaces the XLA program grakel_tpu/ops/canonical.py _codes_impl (:50,
// through canonical_codes :60).  A graphlet's code is the minimum, over
// all s! vertex permutations p, of its bit-packed upper triangle under p:
//   code(p) = sum over pairs k = (i, j), i < j in row order, of
//             A[p[i], p[j]] << k                      (s(s-1)/2 <= 28 bits)
// The JAX program gathers a [B, s!, s(s-1)/2] tensor through a
// permutation table and reduces it.
//
// Design: a table walked in lockstep, a lane a graphlet.  The table
// (ops/canonical.py perm_table) lists every permutation of s vertices in
// lexicographic order, p_i packed four bits an element into one uint32;
// for s <= 7 (at most 5,040 words, 20 KB) a block copies it into shared
// memory, and at s = 8 (161,280 bytes) into the 227 KB opt-in (one block
// an SM) or, on the other placement, it is read through L1 (__ldg).  All
// lanes of a warp read the same entry at the same step (a broadcast), so
// no lane diverges and there is no group reduction: each lane keeps the
// minimum of its own graphlet.  A graphlet comes as one 64-bit adjacency
// mask (byte u = row u, bit v for edge u-v), held in two registers.  For
// a permutation p the rows are permuted by one byte permute (PRMT) a
// four rows, whose selector is the packed entry itself; then for each
// column j, bit p_j of every row byte goes to bit j (two shifts) and the
// rows i < j are kept (one and-or): bit 8 i + j of the key is A[p_i][p_j].
// The key's bits are the code's in the same order of significance, so
// the minimum key is the minimum code's; it is packed into the code once
// a graphlet.  Codes are integers: bit-identical to the JAX program and
// to the plain version (ops/canonical.py canonical_codes_plain).
//
// What bounds it on an H100: integer instructions on the INT32 pipe (64
// lanes a clock an SM), against 12 bytes moved a graphlet; at s = 5, the
// GraphletSampling main path, 120 permutations of ~25 instructions a
// graphlet.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ constexpr int factorial(int s) {
  return s <= 1 ? 1 : s * factorial(s - 1);
}

// bit j of the row bytes i < min(j, 4) (rows 0-3), and of rows 4 .. j-1
// in the high word
__host__ __device__ constexpr uint32_t lo_rows(int j) {
  uint32_t m = 0u;
  for (int i = 0; i < (j < 4 ? j : 4); ++i) m |= 1u << (8 * i + j);
  return m;
}

__host__ __device__ constexpr uint32_t hi_rows(int j) {
  uint32_t m = 0u;
  for (int i = 4; i < j; ++i) m |= 1u << (8 * (i - 4) + j);
  return m;
}

// The key of the graphlet (lo: rows 0-3, hi: rows 4-7 of its mask) under
// the packed permutation w: bit 8 i + j (i < j < S) is A[p_i][p_j]; the
// low word holds rows 0-3, the high word rows 4-7.
template <int S>
__device__ __forceinline__ void perm_key(uint32_t lo, uint32_t hi,
                                         uint32_t w, uint32_t& k0,
                                         uint32_t& k1) {
  const uint32_t r0 = __byte_perm(lo, hi, w);   // rows p_0 .. p_3
  const uint32_t r1 = S > 5 ? __byte_perm(lo, hi, w >> 16) : 0u;
  k0 = 0u;
  k1 = 0u;
#pragma unroll
  for (int j = 1; j < S; ++j) {
    const uint32_t pj = (w >> (4 * j)) & 15u;
    k0 |= ((r0 >> pj) << j) & lo_rows(j);
    if (S > 5 && j > 4) k1 |= ((r1 >> pj) << j) & hi_rows(j);
  }
}

// the code of a key: bit k for the k-th pair (i, j) in row order
template <int S>
__device__ __forceinline__ int code_of_key(uint32_t k0, uint32_t k1) {
  uint32_t code = 0u;
  int k = 0;
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = i + 1; j < S; ++j) {
      const uint32_t word = i < 4 ? k0 : k1;
      code |= ((word >> (8 * (i & 3) + j)) & 1u) << k;
      ++k;
    }
  return (int)code;
}

template <int S, bool kShared>
__global__ void __launch_bounds__(kThreads)
canonical_codes_kernel(const long long* __restrict__ masks,
                       const uint32_t* __restrict__ table,
                       int* __restrict__ codes, int n) {
  constexpr int P = factorial(S);
  extern __shared__ uint32_t tab_s[];
  const uint32_t* tab = table;
  if (kShared) {
    for (int i = threadIdx.x; i < P; i += kThreads) tab_s[i] = table[i];
    __syncthreads();
    tab = tab_s;
  }
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;   // after the block's last barrier
  const uint64_t mask = (uint64_t)masks[g];
  const uint32_t lo = (uint32_t)mask, hi = (uint32_t)(mask >> 32);
  // the minimum by selects, no branch: up to s = 5 rows 0-3 hold every
  // pair and the key is its low word
  uint64_t best = ~0ull;
#pragma unroll 4
  for (int p = 0; p < P; ++p) {
    const uint32_t w = kShared ? tab[p] : __ldg(tab + p);
    uint32_t k0, k1;
    perm_key<S>(lo, hi, w, k0, k1);
    if (S <= 5) {
      best = k0 < (uint32_t)best ? k0 : best;
    } else {
      const uint64_t key = ((uint64_t)k1 << 32) | k0;
      best = key < best ? key : best;
    }
  }
  codes[g] = code_of_key<S>((uint32_t)best, (uint32_t)(best >> 32));
}

template <int S, bool kShared>
int launch(const long long* masks, const uint32_t* table, int* codes, int n,
           cudaStream_t stream) {
  const int smem = kShared ? factorial(S) * 4 : 0;
  if (smem > 48 * 1024) {   // s = 8 in shared memory: the opt-in
    static bool smem_set[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 64 || !smem_set[dev]) {
      err = cudaFuncSetAttribute(canonical_codes_kernel<S, kShared>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      if (dev >= 0 && dev < 64) smem_set[dev] = true;
    }
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  canonical_codes_kernel<S, kShared><<<blocks, kThreads, smem, stream>>>(
      masks, table, codes, n);
  return (int)cudaGetLastError();
}

}  // namespace

// masks [n] i64 (bit u * 8 + v for edge u-v, symmetric, no diagonal);
// table [s!] u32, the permutations in lexicographic order packed four
// bits an element; codes [n] i32 output; 2 <= s <= 8; shared != 0 copies
// the table into shared memory (s <= 7 always do).  Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for
// another s).
extern "C" int grakel_canonical_codes(const long long* masks,
                                      const uint32_t* table, int* codes,
                                      int n, int s, int shared,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  switch (s) {
    case 2: return launch<2, true>(masks, table, codes, n, st);
    case 3: return launch<3, true>(masks, table, codes, n, st);
    case 4: return launch<4, true>(masks, table, codes, n, st);
    case 5: return launch<5, true>(masks, table, codes, n, st);
    case 6: return launch<6, true>(masks, table, codes, n, st);
    case 7: return launch<7, true>(masks, table, codes, n, st);
    case 8:
      return shared ? launch<8, true>(masks, table, codes, n, st)
                    : launch<8, false>(masks, table, codes, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
