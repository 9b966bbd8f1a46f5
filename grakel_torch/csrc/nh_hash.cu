// K4: one NeighborhoodHash round, one pass over a sender CSR.
//
// Replaces the XLA program grakel_tpu/kernels/neighborhood_hash.py
// _nh_rounds (one round of its scan; _rot at :43-47).  Per node v with
// label l(v) and out-neighbours u (edge v -> u), in `bits`-bit words:
//   new_valid(v) = valid(v) && valid(u) for every u
//   simple:          agg = XOR of l(u)
//   count_sensitive: agg = XOR, over the distinct masked labels l of the
//                    neighbours with count o, of ROT(l ^ o, o)
//   new_l(v) = (ROT(l(v) & mask, 1) ^ agg) & mask
// and, for a valid node of graph g, hist[g, new_l(v)] += 1.  Labels of
// invalid nodes are still hashed, as in the JAX program.  XOR is
// order-free, so the labels are those of the JAX program's edge order;
// the int32 histogram atomics are exact in any order, so no segment sum
// pass follows (the caller converts all R rounds to f32 once).  Labels
// are int32 in memory and read as uint32 here (PyTorch has no uint32
// arithmetic, as for K2).
//
// What bounds it on an H100: memory bytes.  A node reads its label,
// validity, graph id and two offsets and writes its new label and
// validity (18 bytes), an edge its target and the target's label and
// validity (9 bytes), against a few integer operations each; at the
// NCI1 scale (1.2e5 nodes, 2.6e5 edges) that is ~4.6 MB, ~1.4 us at
// 3.35 TB/s, so launch latency and the host side of the call are the
// real floor.
//
// Design: one thread per node over the CSR that GraphBatch builds and
// checks once (K2's layout): no sort, no atomics but the histogram's,
// no scratch.  count_sensitive counts each neighbour label's
// multiplicity in registers by scanning the node's own edge range, and
// adds a label's term at its first occurrence: O(deg^2) loads from L1,
// cheap at NCI1's degrees of 2-5.  A node of very high degree serialises
// its warp; a warp per such node is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ROT of x by d in `bits`-bit words, exactly as _rot of the JAX package:
// for d % bits == 0 it returns x itself, unmasked.
__device__ __forceinline__ uint32_t rot(uint32_t x, uint32_t d, uint32_t bits,
                                        uint32_t mask) {
  const uint32_t m = d % bits;
  if (m == 0u) return x;
  return ((x << m) & mask) | ((x & mask) >> (bits - m));
}

template <bool kCountSensitive>
__global__ void __launch_bounds__(256)
nh_round(const int32_t* __restrict__ lab, const uint8_t* __restrict__ valid,
         const int32_t* __restrict__ gids, const int32_t* __restrict__ offsets,
         const int32_t* __restrict__ targets, int32_t* __restrict__ new_lab,
         uint8_t* __restrict__ new_valid, int32_t* __restrict__ hist,
         int n_nodes, int n_graphs, int bits) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_nodes) return;
  const uint32_t nb = (uint32_t)bits;
  const uint32_t mask = (1u << nb) - 1u;
  const int beg = offsets[v], end = offsets[v + 1];
  bool ok = valid[v] != 0;
  uint32_t agg = 0u;
  for (int e = beg; e < end; ++e) {
    const int u = __ldg(targets + e);
    ok = ok & (__ldg(valid + u) != 0);
    const uint32_t l = (uint32_t)__ldg(lab + u);
    if (!kCountSensitive) {
      agg ^= l;
    } else {
      // l's count o over the whole edge range, and whether an earlier
      // edge already carried it (then its term is in agg)
      const uint32_t lm = l & mask;
      uint32_t o = 0u;
      bool first = true;
      for (int f = beg; f < end; ++f) {
        const uint32_t lf = (uint32_t)__ldg(lab + __ldg(targets + f)) & mask;
        if (lf == lm) {
          first = first && f >= e;
          ++o;
        }
      }
      if (first) agg ^= rot(lm ^ o, o, nb, mask);
    }
  }
  const uint32_t nl = (rot((uint32_t)lab[v] & mask, 1u, nb, mask) ^ agg)
                      & mask;
  new_lab[v] = (int32_t)nl;
  new_valid[v] = ok ? 1 : 0;
  const int g = gids[v];
  if (ok && g >= 0 && g < n_graphs) {
    atomicAdd(hist + ((size_t)g << nb) + nl, 1);
  }
}

}  // namespace

// lab [n_nodes] i32; valid [n_nodes] u8 (0/1); gids [n_nodes] i32;
// offsets [n_nodes + 1] i32, non-decreasing, from 0; targets
// [offsets[n_nodes]] i32 in [0, n_nodes); new_lab [n_nodes] i32 and
// new_valid [n_nodes] u8 outputs; hist [n_graphs, 2^bits] i32, added
// into (a valid node whose graph id lies outside [0, n_graphs) counts
// nowhere).  1 <= bits <= 30.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int grakel_nh_round(const int32_t* lab, const uint8_t* valid,
                               const int32_t* gids, const int32_t* offsets,
                               const int32_t* targets, int32_t* new_lab,
                               uint8_t* new_valid, int32_t* hist,
                               int n_nodes, int n_graphs, int bits,
                               int count_sensitive, void* stream) {
  const int tpb = 256;
  if (n_nodes > 0) {
    const dim3 grid((n_nodes + tpb - 1) / tpb);
    cudaStream_t s = (cudaStream_t)stream;
    if (count_sensitive) {
      nh_round<true><<<grid, tpb, 0, s>>>(lab, valid, gids, offsets, targets,
                                          new_lab, new_valid, hist, n_nodes,
                                          n_graphs, bits);
    } else {
      nh_round<false><<<grid, tpb, 0, s>>>(lab, valid, gids, offsets,
                                           targets, new_lab, new_valid, hist,
                                           n_nodes, n_graphs, bits);
    }
  }
  return (int)cudaGetLastError();
}
