// K7: canonical codes of small graphlets (s <= 8 vertices).
//
// Replaces the XLA program grakel_tpu/ops/canonical.py _codes_impl (:50,
// through canonical_codes :60).  A graphlet's code is the minimum, over
// all s! vertex permutations p, of its bit-packed upper triangle under p:
//   code(p) = sum over pairs k = (i, j), i < j in row order, of
//             A[p[i], p[j]] << k                      (s(s-1)/2 <= 28 bits)
// The JAX program gathers a [B, s!, s(s-1)/2] tensor through a
// permutation table (40320 x 28 indices at s = 8: 1.1 MB, which fits
// neither constant memory nor one block's shared memory) and reduces it.
//
// Design: no table.  A graphlet comes as one 64-bit adjacency mask (bit
// u * 8 + v for edge u-v), held in registers; a group of G lanes owns a
// graphlet (G = 1, 2, 4, 8 for s = 2..5, a whole warp from s = 6) and
// each lane a contiguous range of the permutations in lexicographic
// order.  A lane decodes its first permutation from its index (the
// factorial number system) and steps to the next one in place; a
// permutation is packed four bits an element into one 32-bit word, so
// the walk uses shifts and no array (no local memory).  Each permutation's
// code reads its s(s-1)/2 bits from the mask.  The group reduces the
// minimum with shuffles (__reduce_min_sync for a whole warp).  Codes are
// integers: bit-identical to the JAX program and to the plain version
// (ops/canonical.py canonical_codes_plain).
//
// What bounds it on an H100: integer operations, s! * s(s-1)/2 bit reads
// (a shift, a mask and an or each) per graphlet against 12 bytes moved;
// at s = 5, the GraphletSampling main path, that is 1200 bit reads per
// graphlet, and the launch and the host side of the call dominate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ constexpr int factorial(int s) {
  return s <= 1 ? 1 : s * factorial(s - 1);
}

__device__ __forceinline__ uint32_t get4(uint32_t p, int i) {
  return (p >> (4 * i)) & 15u;
}

__device__ __forceinline__ uint32_t set4(uint32_t p, int i, uint32_t v) {
  return (p & ~(15u << (4 * i))) | (v << (4 * i));
}

// The permutation of rank `rank` in lexicographic order, packed.
template <int S>
__device__ uint32_t decode(int rank) {
  uint32_t avail = (1u << S) - 1u, p = 0u;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int f = factorial(S - 1 - i);
    int d = rank / f;
    rank -= d * f;
    int x = 0;
    for (;; ++x) {
      if ((avail >> x) & 1u) {
        if (d == 0) break;
        --d;
      }
    }
    avail &= ~(1u << x);
    p = set4(p, i, (uint32_t)x);
  }
  return p;
}

// The next permutation in lexicographic order (std::next_permutation);
// called only where one exists.
template <int S>
__device__ uint32_t next_perm(uint32_t p) {
  int i = S - 2;
  while (i >= 0 && get4(p, i) >= get4(p, i + 1)) --i;
  if (i < 0) return p;
  int j = S - 1;
  while (get4(p, j) <= get4(p, i)) --j;
  const uint32_t a = get4(p, i), b = get4(p, j);
  p = set4(set4(p, i, b), j, a);
  for (int lo = i + 1, hi = S - 1; lo < hi; ++lo, --hi) {
    const uint32_t x = get4(p, lo), y = get4(p, hi);
    p = set4(set4(p, lo, y), hi, x);
  }
  return p;
}

template <int S>
__device__ __forceinline__ uint32_t code_of(uint64_t mask, uint32_t p) {
  uint32_t code = 0u;
  int k = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const uint32_t row = (uint32_t)(mask >> (8 * get4(p, i))) & 0xFFu;
#pragma unroll
    for (int j = i + 1; j < S; ++j) {
      code |= ((row >> get4(p, j)) & 1u) << k;
      ++k;
    }
  }
  return code;
}

template <int S, int G>
__global__ void __launch_bounds__(kThreads)
canonical_codes_kernel(const long long* __restrict__ masks,
                       int* __restrict__ codes, int n) {
  constexpr int P = factorial(S);
  constexpr int kPer = (P + G - 1) / G;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int g = (int)(t / G);
  const int lane = (int)(t % G);
  const bool active = g < n;
  const uint64_t mask = active ? (uint64_t)masks[g] : 0ull;
  uint32_t best = 0xFFFFFFFFu;
  const int lo = lane * kPer;
  const int hi = lo + kPer < P ? lo + kPer : P;
  if (active && lo < hi) {
    uint32_t p = decode<S>(lo);
    for (int r = lo;;) {
      const uint32_t c = code_of<S>(mask, p);
      best = c < best ? c : best;
      if (++r == hi) break;
      p = next_perm<S>(p);
    }
  }
  // every lane of the warp reaches the reduction (no early return)
  if (G == 32) {
    best = __reduce_min_sync(0xFFFFFFFFu, best);
  } else {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const uint32_t o = __shfl_xor_sync(0xFFFFFFFFu, best, off, G);
      best = o < best ? o : best;
    }
  }
  if (active && lane == 0) codes[g] = (int)best;
}

template <int S, int G>
int launch(const long long* masks, int* codes, int n, cudaStream_t stream) {
  const long long threads = (long long)n * G;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  canonical_codes_kernel<S, G><<<blocks, kThreads, 0, stream>>>(masks, codes,
                                                                 n);
  return (int)cudaGetLastError();
}

}  // namespace

// masks [n] i64 (bit u * 8 + v for edge u-v, symmetric, no diagonal);
// codes [n] i32 output; 2 <= s <= 8.  Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for another s).
extern "C" int grakel_canonical_codes(const long long* masks, int* codes,
                                      int n, int s, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  switch (s) {
    case 2: return launch<2, 1>(masks, codes, n, st);
    case 3: return launch<3, 2>(masks, codes, n, st);
    case 4: return launch<4, 4>(masks, codes, n, st);
    case 5: return launch<5, 8>(masks, codes, n, st);
    case 6: return launch<6, 32>(masks, codes, n, st);
    case 7: return launch<7, 32>(masks, codes, n, st);
    case 8: return launch<8, 32>(masks, codes, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
