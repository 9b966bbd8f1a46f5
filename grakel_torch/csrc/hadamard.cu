// K6: one HadamardCode generation, the code-vector neighbour sum and the
// row hash, one pass over a CSR.
//
// Replaces the XLA programs of grakel_tpu/kernels/hadamard_code.py: the
// segment-sum step of _device_run and _row_hash.  Per node v with code
// row c[v, 0:D] (int32) and out-neighbours u (edge v -> u):
//   propagate:  c'[v, j] = c[v, j] + sum over u of c[u, j]   (mod 2^32)
//   otherwise:  c' = c
//   e1(j) = fmix32(c'[v, j] ^ j * 0x9E3779B9, 0x85EBCA6B)
//   e2(j) = fmix32(c'[v, j] + j * 0xC2B2AE35, 0x27D4EB2F)
//   h1 = fmix32(sum_j e1 ^ tag(v) * 0x9E3779B1, 0x165667B1)
//   h2 = fmix32(sum_j e2 + tag(v) * 0x7F4A7C15, 0x7F4A7C15)
// all in uint32 (XLA's int32 adds wrap the same way; signed overflow is
// undefined in C++), and writes the new row (when propagating) and the
// compaction key (h1 ^ 2^31) << 32 | h2 as int64, K2's layout
// (ops/wl.py key_hashes unpacks it).  Wrap-around sums are order-free,
// so the keys are those of the JAX program bit for bit.
//
// What bounds it on an H100: a few dozen integer operations per code
// element against 4 bytes read per element of each neighbour's row and
// 8 moved per element of its own (read, written), so memory bytes; at
// NCI1 scale (1.2e5 nodes, 4.6e5 edges, D = 64) a propagating
// generation must move ~67 MB, ~0.02 ms at 3.35 TB/s.
//
// Design (simple and correct first): the caller hands the valid edges
// grouped by sender (the CSR GraphBatch builds and checks once), and the
// caller keeps two code buffers and swaps them, one launch a generation.
// A warp's time goes to chains of dependent loads (offsets, then
// targets, then rows), so the design keeps those chains short:
//  * D >= 32: a warp per node.  Lane l holds columns l, l + 32, ... of up
//    to 256 columns a pass in registers (their count a template
//    argument); the warp loads up to 32 of the node's targets at once and
//    shuffles them out, so the neighbours' rows (coalesced 128-byte
//    reads) are independent loads; it writes its part of the new row and
//    mixes its columns; the two sums are reduced with __shfl_xor_sync and
//    lane 0 finalizes.
//  * D < 32 (a power of two): 32 / D nodes a warp, a lane a column; the
//    sums are reduced within each aligned segment of D lanes.  D = 1 is a
//    node a lane.
// A node of very high out-degree serialises its warp (the warp walks its
// edges); degrees on the HadamardCode paths are 2-20.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t x, uint32_t seed) {
  x ^= seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ void mix(uint32_t c, uint32_t j, uint32_t& s1,
                                    uint32_t& s2) {
  s1 += fmix32(c ^ (j * 0x9E3779B9u), 0x85EBCA6Bu);
  s2 += fmix32(c + j * 0xC2B2AE35u, 0x27D4EB2Fu);
}

__device__ __forceinline__ long long row_key(uint32_t s1, uint32_t s2,
                                             uint32_t tag) {
  const uint32_t h1 = fmix32(s1 ^ (tag * 0x9E3779B1u), 0x165667B1u);
  const uint32_t h2 = fmix32(s2 + tag * 0x7F4A7C15u, 0x7F4A7C15u);
  return (long long)(((uint64_t)(h1 ^ 0x80000000u) << 32) | h2);
}

constexpr int kThreads = 256;
// Blocks an SM must hold of the row kernel (the launch bound's minimum).
// Without one ptxas held the propagating kernels to 32 registers and
// spilled.  6 (at most 42 registers) spills only the 8-column kernel,
// which takes 4 (64); on an H100 the 2-column one ran a propagating
// NCI1-scale generation in 0.0568 ms at 6 and 0.0656 at 4.
#define K6_ROW_BLOCKS(cols) ((cols) == 8 ? 4 : 6)

// D >= 32, a power of two: a warp per node, lane l holding columns
// base + l + 32 k (k < COLS) of each pass of 32 COLS columns (COLS = D /
// 32 up to 8; wider rows take D / 256 passes).  The loads that depend on
// each other are few: the node's offsets and tag first, then up to 32 of
// its targets in one coalesced load, handed to the lanes by shuffles, so
// the neighbours' rows are independent loads that the unrolled edge loop
// keeps in flight together.
template <bool PROP, int COLS>
__global__ void __launch_bounds__(kThreads, K6_ROW_BLOCKS(COLS))
hadamard_row(const int32_t* __restrict__ cin, int32_t* __restrict__ cout,
             const int32_t* __restrict__ offsets,
             const int32_t* __restrict__ targets,
             const int32_t* __restrict__ tag, long long* __restrict__ key,
             int n_nodes, int D) {
  const long long w =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_nodes) return;   // the whole warp
  const int v = (int)w;
  const size_t row = (size_t)v * D;
  const uint32_t t = (uint32_t)__ldg(tag + v);
  const int e0 = PROP ? __ldg(offsets + v) : 0;
  const int e1 = PROP ? __ldg(offsets + v + 1) : 0;
  uint32_t s1 = 0u, s2 = 0u;
  for (int base = lane; base < D; base += 32 * COLS) {
    uint32_t c[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k)
      c[k] = (uint32_t)__ldg(cin + row + base + 32 * k);
    if (PROP) {
      for (int eb = e0; eb < e1; eb += 32) {
        const int m = min(32, e1 - eb);
        const int mine = lane < m ? __ldg(targets + eb + lane) : 0;
#pragma unroll 4
        for (int i = 0; i < m; ++i) {
          const int32_t* nrow =
              cin + (size_t)__shfl_sync(0xffffffffu, mine, i) * D + base;
#pragma unroll
          for (int k = 0; k < COLS; ++k)
            c[k] += (uint32_t)__ldg(nrow + 32 * k);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      if (PROP) cout[row + base + 32 * k] = (int32_t)c[k];
      mix(c[k], (uint32_t)(base + 32 * k), s1, s2);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if (lane == 0) key[v] = row_key(s1, s2, t);
}

template <bool PROP>
void launch_row(unsigned blocks, cudaStream_t s, const int32_t* cin,
                int32_t* cout, const int32_t* offsets,
                const int32_t* targets, const int32_t* tag, long long* key,
                int n_nodes, int D) {
  if (D == 32)
    hadamard_row<PROP, 1><<<blocks, kThreads, 0, s>>>(
        cin, cout, offsets, targets, tag, key, n_nodes, D);
  else if (D == 64)
    hadamard_row<PROP, 2><<<blocks, kThreads, 0, s>>>(
        cin, cout, offsets, targets, tag, key, n_nodes, D);
  else if (D == 128)
    hadamard_row<PROP, 4><<<blocks, kThreads, 0, s>>>(
        cin, cout, offsets, targets, tag, key, n_nodes, D);
  else
    hadamard_row<PROP, 8><<<blocks, kThreads, 0, s>>>(
        cin, cout, offsets, targets, tag, key, n_nodes, D);
}

// D = 2^log2d < 32: thread t holds column t & (D - 1) of node t >> log2d,
// so a node's D lanes are one aligned segment of its warp.  No thread
// returns early: every lane of a warp reaches the shuffles, and a
// segment is live or dead as a whole.
template <bool PROP>
__global__ void __launch_bounds__(kThreads)
hadamard_packed(const int32_t* __restrict__ cin, int32_t* __restrict__ cout,
                const int32_t* __restrict__ offsets,
                const int32_t* __restrict__ targets,
                const int32_t* __restrict__ tag, long long* __restrict__ key,
                int n_nodes, int log2d) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int D = 1 << log2d;
  const long long v = t >> log2d;
  const uint32_t j = (uint32_t)(t & (D - 1));
  const bool live = v < n_nodes;
  uint32_t s1 = 0u, s2 = 0u;
  if (live) {
    uint32_t c = (uint32_t)__ldg(cin + t);
    if (PROP) {
      const int e1 = offsets[v + 1];
      for (int e = offsets[v]; e < e1; ++e)
        c += (uint32_t)__ldg(cin + ((size_t)__ldg(targets + e) << log2d) + j);
      cout[t] = (int32_t)c;
    }
    mix(c, j, s1, s2);
  }
  for (int o = D >> 1; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if (live && j == 0u) key[v] = row_key(s1, s2, (uint32_t)tag[v]);
}

}  // namespace

// codes_in [n_nodes, D] i32, row-major; codes_out [n_nodes, D] i32, not
// codes_in (read only when propagate is 0, and then not written); offsets
// [n_nodes + 1] i32, non-decreasing, from 0; targets [offsets[n_nodes]]
// i32 in [0, n_nodes); dim_tag [n_nodes] i32 (u32 bit patterns); key
// [n_nodes] i64 output.  D is a power of two.  Launches on `stream`;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a D that is
// not a power of two.
extern "C" int grakel_hadamard_step(const int32_t* codes_in,
                                    int32_t* codes_out,
                                    const int32_t* offsets,
                                    const int32_t* targets,
                                    const int32_t* dim_tag, long long* key,
                                    int n_nodes, int D, int propagate,
                                    void* stream) {
  if (D <= 0 || (D & (D - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (n_nodes <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (D >= 32) {
    const long long threads = 32LL * n_nodes;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    if (propagate)
      launch_row<true>(blocks, s, codes_in, codes_out, offsets, targets,
                       dim_tag, key, n_nodes, D);
    else
      launch_row<false>(blocks, s, codes_in, codes_out, offsets, targets,
                        dim_tag, key, n_nodes, D);
  } else {
    int log2d = 0;
    while ((1 << log2d) < D) ++log2d;
    const long long threads = (long long)n_nodes << log2d;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    if (propagate)
      hadamard_packed<true><<<blocks, kThreads, 0, s>>>(
          codes_in, codes_out, offsets, targets, dim_tag, key, n_nodes,
          log2d);
    else
      hadamard_packed<false><<<blocks, kThreads, 0, s>>>(
          codes_in, codes_out, offsets, targets, dim_tag, key, n_nodes,
          log2d);
  }
  return (int)cudaGetLastError();
}
