// K4: NeighborhoodHash rounds over a sender CSR.
//
// Replaces the XLA program grakel_tpu/kernels/neighborhood_hash.py
// _nh_rounds (its scan of R rounds; _rot at :43-47).  Per round, per
// node v with label l(v) and out-neighbours u (edge v -> u), in
// `bits`-bit words:
//   new_valid(v) = valid(v) && valid(u) for every u
//   simple:          agg = XOR of l(u)
//   count_sensitive: agg = XOR, over the distinct masked labels l of the
//                    neighbours with count o, of ROT(l ^ o, o)
//   new_l(v) = (ROT(l(v) & mask, 1) ^ agg) & mask
// and, for a valid node of graph g, hist[r, g, new_l(v)] += 1.  Labels
// of invalid nodes are still hashed, as in the JAX program.  XOR is
// order-free, so the labels are those of the JAX program's edge order,
// and the counts are exact integers in any order: the histograms equal
// the plain version's (ops/nh.py nh_rounds_plain) bit for bit.  Labels
// are int32 in memory and read as uint32 (PyTorch has no uint32
// arithmetic, as for K2); only their low `bits` bits matter, since the
// final mask drops the rest of every XOR term.
//
// What bounds it on an H100: memory bytes.  The R rounds must read each
// node's label, validity, graph id and offset (13 bytes) and each edge's
// target (4 bytes) once, and write the int32 histogram stack [R,
// n_graphs, 2^bits] once: at the NCI1 scale (131,072 padded nodes,
// 459,806 edges, R = 3, bits = 8) 16.2 MB, ~0.0048 ms at 3.35 TB/s,
// almost all of it the stack.
//
// Routes (ops/nh.py nh_plan picks each graph's from shapes):
// * graph: one launch for all R rounds.  A block owns a run of whole
//   graphs (nodes contiguous, no edge between graphs: GraphBatch checks
//   both) and stages their labels and validity (one word a node: label
//   in the low bits, validity in bit 31), rebased CSR offsets, 16-bit
//   local targets and 16-bit local graph ids in shared memory once; the
//   R rounds then run there on double-buffered words, one barrier a
//   round.  Each graph's histogram row is counted in shared memory
//   (double-buffered too: round r's rows are written to the stack with
//   coalesced 16-byte stores, every bin, and zeroed while round r + 1
//   counts), so there is no zero fill of the stack and no global atomic;
// * round: one launch a round over the nodes of the graphs that do not
//   fit a block (large graphs, or many counters at large `bits`), from
//   global memory, counting with global atomics into rows the caller
//   zeroed.
// Both fold a node of out-degree above `hub` with a whole warp (each
// lane a share of its edges, validity by __all_sync, the XOR by a
// butterfly), so a hub no longer holds its warp for deg (simple) or
// deg^2 (count_sensitive) steps; the other nodes take a thread each.
// count_sensitive needs each distinct neighbour label's count: a thread
// gathers up to kRegDeg neighbour labels into registers and compares them
// there; a warp takes a hub of degree up to 32 one edge a lane and reads
// counts from __match_any_sync; beyond, a label's count comes from
// rescanning the node's edge range (shared memory on the graph route).
// Counts of one warp that hit the same bin are merged with
// __match_any_sync before the atomic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr uint32_t kValid = 0x80000000u;
constexpr int kThreads = 256;
// count_sensitive: a thread folds a node of degree up to this from its
// neighbours' labels gathered into registers
constexpr int kRegDeg = 8;

// ROT of x by d in `bits`-bit words, exactly as _rot of the JAX package:
// for d % bits == 0 it returns x itself, unmasked.
__device__ __forceinline__ uint32_t rot(uint32_t x, uint32_t d, uint32_t bits,
                                        uint32_t mask) {
  const uint32_t m = d % bits;
  if (m == 0u) return x;
  return ((x << m) & mask) | ((x & mask) >> (bits - m));
}

// The round route's view of the nodes: global memory, labels as given.
struct GlobalNodes {
  static constexpr int kRescanUnroll = 1;   // keeps the kernel unspilled
  const int32_t* lab;
  const uint8_t* valid;
  const int32_t* off;
  const int32_t* tgt;
  __device__ int begin(int v) const { return __ldg(off + v); }
  __device__ int end(int v) const { return __ldg(off + v + 1); }
  __device__ int target(int e) const { return __ldg(tgt + e); }
  __device__ uint32_t label(int u, uint32_t mask) const {
    return (uint32_t)__ldg(lab + u) & mask;
  }
  __device__ uint32_t word(int u, uint32_t mask) const {
    return label(u, mask) | (__ldg(valid + u) ? kValid : 0u);
  }
};

// The graph route's view: one block's graphs in shared memory.
struct SharedNodes {
  static constexpr int kRescanUnroll = 4;
  const uint32_t* w;
  const int32_t* off;
  const uint16_t* tgt;
  __device__ int begin(int v) const { return off[v]; }
  __device__ int end(int v) const { return off[v + 1]; }
  __device__ int target(int e) const { return tgt[e]; }
  __device__ uint32_t label(int u, uint32_t mask) const {
    return w[u] & mask;
  }
  __device__ uint32_t word(int u, uint32_t) const { return w[u]; }
};

// The XOR term of the neighbour on edge e of the range [beg, end), whose
// masked label is l: simple, l; count_sensitive, ROT(l ^ o, o) at the
// first edge that carries l (o its count in the range), else 0.
template <bool kCS, class Nodes>
__device__ __forceinline__ uint32_t edge_term(const Nodes& N, int beg,
                                              int end, int e, uint32_t l,
                                              uint32_t nb, uint32_t mask) {
  if (!kCS) return l;
  uint32_t o = 0u;
  bool first = true;
#pragma unroll(Nodes::kRescanUnroll)
  for (int f = beg; f < end; ++f) {
    if (N.label(N.target(f), mask) == l) {
      first = first && f >= e;
      ++o;
    }
  }
  return first ? rot(l ^ o, o, nb, mask) : 0u;
}

// count_sensitive, a node of degree d <= kRegDeg: its neighbours' words
// gathered into registers (all loads in flight), the counts compared
// there.  Adds the terms into agg and the validities into ok.
template <class Nodes>
__device__ __forceinline__ void fold_registers(const Nodes& N, int beg,
                                               int d, uint32_t nb,
                                               uint32_t mask, bool& ok,
                                               uint32_t& agg) {
  uint32_t lb[kRegDeg];
#pragma unroll
  for (int k = 0; k < kRegDeg; ++k) {
    lb[k] = 0u;
    if (k < d) {
      const uint32_t w = N.word(N.target(beg + k), mask);
      ok = ok && (w & kValid);
      lb[k] = w & mask;
    }
  }
#pragma unroll
  for (int k = 0; k < kRegDeg; ++k) {
    uint32_t o = 0u;
    bool first = true;
#pragma unroll
    for (int f = 0; f < kRegDeg; ++f) {
      if (f < d && lb[f] == lb[k]) {
        first = first && f >= k;
        ++o;
      }
    }
    if (k < d && first) agg ^= rot(lb[k] ^ o, o, nb, mask);
  }
}

// A hub's (validity of all neighbours, agg), folded by the whole warp:
// count_sensitive up to degree 32 with one edge a lane, a label's count
// and first lane from __match_any_sync; else each lane a share of the
// edges, a label's count by rescanning the range.
template <bool kCS, class Nodes>
__device__ __forceinline__ uint32_t fold_warp(const Nodes& N, int beg,
                                              int end, int lane, uint32_t nb,
                                              uint32_t mask, bool& ok) {
  bool all = true;
  uint32_t agg = 0u;
  if (kCS && end - beg <= 32) {
    const bool has = lane < end - beg;
    uint32_t l = 0xffffffffu;       // no label: above every masked one
    if (has) {
      const uint32_t w = N.word(N.target(beg + lane), mask);
      all = (w & kValid) != 0u;
      l = w & mask;
    }
    const unsigned peers = __match_any_sync(kAll, l);
    if (has && lane == __ffs(peers) - 1) {
      const uint32_t o = (uint32_t)__popc(peers);
      agg = rot(l ^ o, o, nb, mask);
    }
  } else {
    for (int e = beg + lane; e < end; e += 32) {
      const uint32_t w = N.word(N.target(e), mask);
      all = all && (w & kValid);
      agg ^= edge_term<kCS>(N, beg, end, e, w & mask, nb, mask);
    }
  }
  ok = __all_sync(kAll, all);
  for (int d = 16; d > 0; d >>= 1) agg ^= __shfl_xor_sync(kAll, agg, d);
  return agg;
}

// One round of node v (this lane's; `in` false for none) -> its new
// label, and in `ok` its new validity.  Nodes of out-degree above `hub`
// are folded by the whole warp in turn; every lane of the warp calls it.
template <bool kCS, class Nodes>
__device__ __forceinline__ uint32_t relabel(const Nodes& N, int v, bool in,
                                            int hub, int lane, uint32_t nb,
                                            uint32_t mask, bool& ok) {
  int beg = 0, end = 0;
  uint32_t own = 0u;
  if (in) {
    beg = N.begin(v);
    end = N.end(v);
    own = N.word(v, mask);
  }
  ok = (own & kValid) != 0u;
  uint32_t agg = 0u;
  const bool big = in && end - beg > hub;
  if (kCS && in && !big && end - beg <= kRegDeg) {
    fold_registers(N, beg, end - beg, nb, mask, ok, agg);
  } else if (in && !big) {
    for (int e = beg; e < end; ++e) {
      const uint32_t w = N.word(N.target(e), mask);
      ok = ok && (w & kValid);
      agg ^= edge_term<kCS>(N, beg, end, e, w & mask, nb, mask);
    }
  }
  unsigned hubs = __ballot_sync(kAll, big);
  while (hubs) {
    const int h = __ffs(hubs) - 1;
    hubs &= hubs - 1;
    const int hb = __shfl_sync(kAll, beg, h), he = __shfl_sync(kAll, end, h);
    bool hok;
    const uint32_t hagg = fold_warp<kCS>(N, hb, he, lane, nb, mask, hok);
    if (lane == h) {
      ok = ok && hok;
      agg = hagg;
    }
  }
  return (rot(own & mask, 1u, nb, mask) ^ agg) & mask;
}

template <bool kCS>
__global__ void __launch_bounds__(kThreads)
nh_graph(const int32_t* __restrict__ lab, const uint8_t* __restrict__ valid,
         const int32_t* __restrict__ gids, const int32_t* __restrict__ offsets,
         const int32_t* __restrict__ targets,
         const int32_t* __restrict__ chunks, int32_t* __restrict__ hist,
         int n_graphs, int R, int bits, int hub, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int* ch = chunks + 6 * blockIdx.x;
  const int g0 = ch[0], v0 = ch[2], e0 = ch[4];
  const int nv = ch[3] - v0, ne = ch[5] - e0;
  const uint32_t nb = (uint32_t)bits, L = 1u << nb, mask = L - 1u;
  const int rows = (ch[1] - g0) << bits;      // counters a buffer
  int32_t* hs = reinterpret_cast<int32_t*>(smem);       // [2][rows]
  uint32_t* w = reinterpret_cast<uint32_t*>(hs + 2 * rows);  // [2][nv]
  int32_t* off = reinterpret_cast<int32_t*>(w + 2 * nv);    // [nv + 1]
  uint16_t* lg = reinterpret_cast<uint16_t*>(off + nv + 1);  // [nv]
  uint16_t* tg = lg + nv;                                    // [ne]
  const int tid = threadIdx.x, lane = tid & 31;

  for (int i = tid; i < 2 * rows; i += kThreads) hs[i] = 0;
  for (int i = tid; i < nv; i += kThreads) {
    w[i] = ((uint32_t)lab[v0 + i] & mask) | (valid[v0 + i] ? kValid : 0u);
    lg[i] = (uint16_t)(gids[v0 + i] - g0);
  }
  for (int i = tid; i <= nv; i += kThreads) off[i] = offsets[v0 + i] - e0;
  for (int i = tid; i < ne; i += kThreads)
    tg[i] = (uint16_t)(targets[e0 + i] - v0);
  __syncthreads();

  // round r's rows of the stack, from the counters h, zeroing them
  auto flush = [&](int32_t* h, int r) {
    int32_t* dst = hist + ((size_t)r * n_graphs + g0) * L;
    if (vec) {
      for (int i = tid; i < rows / 4; i += kThreads) {
        int4* s4 = reinterpret_cast<int4*>(h) + i;
        reinterpret_cast<int4*>(dst)[i] = *s4;
        *s4 = make_int4(0, 0, 0, 0);
      }
    } else {
      for (int i = tid; i < rows; i += kThreads) {
        dst[i] = h[i];
        h[i] = 0;
      }
    }
  };

  for (int r = 0; r < R; ++r) {
    const int cur = r & 1;
    const SharedNodes N{w + cur * nv, off, tg};
    uint32_t* next = w + (cur ^ 1) * nv;
    int32_t* hc = hs + cur * rows;
    for (int base = tid - lane; base < nv; base += kThreads) {
      const int v = base + lane;
      const bool in = v < nv;
      bool ok;
      const uint32_t nl = relabel<kCS>(N, v, in, hub, lane, nb, mask, ok);
      if (in) next[v] = nl | (ok ? kValid : 0u);
      const uint32_t key =
          in && ok ? ((uint32_t)lg[v] << nb) + nl : 0xffffffffu;
      const unsigned peers = __match_any_sync(kAll, key);
      if (key != 0xffffffffu && lane == __ffs(peers) - 1)
        atomicAdd(hc + key, __popc(peers));
    }
    if (r > 0) flush(hs + (cur ^ 1) * rows, r - 1);
    __syncthreads();
  }
  flush(hs + ((R - 1) & 1) * rows, R - 1);
}

// (a minimum of one block an SM: without it ptxas 12.8 spills 8 bytes of
// count_sensitive's predicates here, at 40 registers)
template <bool kCS>
__global__ void __launch_bounds__(kThreads, 1)
nh_round(const int32_t* __restrict__ lab, const uint8_t* __restrict__ valid,
         const int32_t* __restrict__ gids, const int32_t* __restrict__ offsets,
         const int32_t* __restrict__ targets,
         const uint8_t* __restrict__ graph_mask, int32_t* __restrict__ new_lab,
         uint8_t* __restrict__ new_valid, int32_t* __restrict__ hist,
         int node_lo, int node_hi, int n_graphs, int bits, int hub) {
  const int v = node_lo + blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const uint32_t nb = (uint32_t)bits, mask = (1u << nb) - 1u;
  bool in = v < node_hi;
  const int g = in ? gids[v] : -1;
  const bool counted = g >= 0 && g < n_graphs;
  if (graph_mask != nullptr) in = in && counted && graph_mask[g];
  const GlobalNodes N{lab, valid, offsets, targets};
  bool ok;
  const uint32_t nl = relabel<kCS>(N, v, in, hub, lane, nb, mask, ok);
  if (in) {
    new_lab[v] = (int32_t)nl;
    new_valid[v] = ok ? 1 : 0;
  }
  const unsigned long long none = ~0ull;
  const unsigned long long key =
      in && ok && counted ? ((unsigned long long)g << nb) + nl : none;
  const unsigned peers = __match_any_sync(kAll, key);
  if (key != none && lane == __ffs(peers) - 1)
    atomicAdd(hist + key, __popc(peers));
}

}  // namespace

// The round route: one round over the nodes [node_lo, node_hi).
// lab [N] i32; valid [N] u8 (0/1); gids [N] i32; offsets [N + 1] i32,
// non-decreasing, from 0; targets [offsets[N]] i32 in [0, N); new_lab
// [N] i32 and new_valid [N] u8 outputs; hist [n_graphs, 2^bits] i32,
// added into (a valid node whose graph id lies outside [0, n_graphs)
// counts nowhere).  graph_mask [n_graphs] u8 or null: when given, only
// nodes of graphs it marks are relabeled and counted (the others' entries
// of new_lab and new_valid are left as they are).  Nodes of out-degree
// above hub are folded by a warp.  1 <= bits <= 30.  Launches on
// `stream`; returns cudaGetLastError() or cudaErrorInvalidValue.
extern "C" int grakel_nh_round(const int32_t* lab, const uint8_t* valid,
                               const int32_t* gids, const int32_t* offsets,
                               const int32_t* targets,
                               const uint8_t* graph_mask, int32_t* new_lab,
                               uint8_t* new_valid, int32_t* hist,
                               int node_lo, int node_hi, int n_graphs,
                               int bits, int count_sensitive, int hub,
                               void* stream) {
  if (bits < 1 || bits > 30 || node_lo < 0 || node_hi < node_lo)
    return (int)cudaErrorInvalidValue;
  if (node_hi > node_lo) {
    const dim3 grid((node_hi - node_lo + kThreads - 1) / kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (count_sensitive) {
      nh_round<true><<<grid, kThreads, 0, s>>>(
          lab, valid, gids, offsets, targets, graph_mask, new_lab, new_valid,
          hist, node_lo, node_hi, n_graphs, bits, hub);
    } else {
      nh_round<false><<<grid, kThreads, 0, s>>>(
          lab, valid, gids, offsets, targets, graph_mask, new_lab, new_valid,
          hist, node_lo, node_hi, n_graphs, bits, hub);
    }
  }
  return (int)cudaGetLastError();
}

// The graph route: all R rounds of the graphs in the chunk table, one
// block a chunk.  chunks [n_chunks, 6] i32, rows (g0, g1, node0, node1,
// edge0, edge1): graphs [g0, g1) own the nodes [node0, node1) and the
// CSR edges [edge0, edge1), and none of those edges leaves them (the
// caller's promise); node1 - node0 and g1 - g0 below 2^16.  lab, valid,
// gids, offsets and targets as for the round route; hist [R, n_graphs,
// 2^bits] i32: every bin of the chunks' rows is written.  smem_bytes:
// the largest chunk's shared memory (ops/nh.py k4_smem_bytes), at most
// 227 KB.  Launches on `stream`; returns cudaGetLastError() or
// cudaErrorInvalidValue.
extern "C" int grakel_nh_graph(const int32_t* lab, const uint8_t* valid,
                               const int32_t* gids, const int32_t* offsets,
                               const int32_t* targets, const int32_t* chunks,
                               int n_chunks, int32_t* hist, int n_graphs,
                               int R, int bits, int count_sensitive, int hub,
                               int smem_bytes, void* stream) {
  if (bits < 1 || bits > 30 || R < 1 || smem_bytes < 0
      || smem_bytes > 232448)
    return (int)cudaErrorInvalidValue;
  if (n_chunks <= 0) return (int)cudaGetLastError();
  const int vec = bits >= 2 && ((uintptr_t)hist & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (count_sensitive) {
    cudaFuncSetAttribute(nh_graph<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
    nh_graph<true><<<n_chunks, kThreads, smem_bytes, s>>>(
        lab, valid, gids, offsets, targets, chunks, hist, n_graphs, R, bits,
        hub, vec);
  } else {
    cudaFuncSetAttribute(nh_graph<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
    nh_graph<false><<<n_chunks, kThreads, smem_bytes, s>>>(
        lab, valid, gids, offsets, targets, chunks, hist, n_graphs, R, bits,
        hub, vec);
  }
  return (int)cudaGetLastError();
}
