// K6: HadamardCode's generations, the code-vector neighbour sum and the
// row hash, over a sender CSR.
//
// Replaces the XLA programs of grakel_tpu/kernels/hadamard_code.py: the
// segment-sum step of _device_run (:199-216) and _row_hash (:49-66).  Per
// node v with out-neighbours u (edge v -> u), generation g of n_iter:
//   g = 0:  c_0[v] = table[row[v]]     (int32, a row of a Hadamard matrix)
//   g > 0:  c_g[v, j] = c_{g-1}[v, j] + sum over u of c_{g-1}[u, j]
//                                       (mod 2^32)
//   e1(j) = fmix32(c_g[v, j] ^ j * 0x9E3779B9, 0x85EBCA6B)
//   e2(j) = fmix32(c_g[v, j] + j * 0xC2B2AE35, 0x27D4EB2F)
//   h1 = fmix32(sum_j e1 ^ tag(v) * 0x9E3779B1, 0x165667B1)
//   h2 = fmix32(sum_j e2 + tag(v) * 0x7F4A7C15, 0x7F4A7C15)
// all in uint32 (XLA's int32 adds wrap the same way; signed overflow is
// undefined in C++), and writes the compaction key (h1 ^ 2^31) << 32 | h2
// as int64, K2's layout (ops/wl.py key_hashes unpacks it), one row of
// keys a generation.  Wrap-around sums are order-free, so the keys are
// those of the JAX program bit for bit.
//
// What bounds it on an H100: integer operations.  The n_iter generations
// must read each node's row index, tag and CSR offset and each edge's
// target once, the table once, and write n_iter keys a node: at NCI1
// scale (123,560 nodes, 459,806 edges, D = 64, five generations) 8.3 MB,
// 0.0025 ms at 3.35 TB/s, against ~24 integer operations an element a
// generation (two fmix32, two sums) and one an edge and column, 1.07 G,
// 0.016 ms at 67 TOP/s (the fp32 rate; an SM has 64 INT32 lanes to its
// 128 FP32 ones, so the integer work alone takes ~4x that).
//
// Routes (ops/hadamard.py hc_plan picks each graph's from shapes):
// * graph: one launch for all n_iter generations.  A block owns a run of
//   whole graphs (nodes contiguous, no edge leaves its graph: GraphBatch
//   checks both) and stages their row indices, tags, rebased CSR offsets
//   and 16-bit local targets in shared memory, then keeps two code
//   buffers there: generation 0's rows are gathered from the table by all
//   the block's threads at once, each later generation sums from one
//   buffer into the other, one barrier a generation.  No code row goes to
//   device memory.  D >= 32: a lane holds COLS = min(D / 32, 4)
//   consecutive columns of each pass of 32 COLS (one 8- or 16-byte
//   shared-memory access a row, conflict-free), a warp sums eight nodes
//   one after the other and then reduces their sixteen hashes together
//   (9 shuffles a hash for the eight, not 40).  D < 32: as the round
//   route's packed kernel.  A chunk without edges (padding rows,
//   edgeless graphs) hashes each row once and writes that key to every
//   generation.
// * round: one launch a generation over the nodes of the graphs whose
//   buffers do not fit a block, from two code buffers in device memory
//   that the caller keeps (rows local to the node range).  D >= 32: a
//   warp a node, lane l holding columns base + l + 32 k (k < COLS) of
//   each pass of 32 COLS columns (COLS = D / 32 up to 8; wider rows take
//   D / 256 passes).
// On both routes at D >= 32 a warp loads up to 32 of a node's targets at
// once and shuffles them out, so the neighbours' rows are independent
// loads that the unrolled edge loop keeps in flight.  D < 32 packs 32 /
// D nodes a warp, a lane a column; the sums are reduced within each
// aligned segment of D lanes with __shfl_xor_sync.  A node of very high
// out-degree serialises its warp (its lanes at D < 32); on the graph
// route the walk reads shared memory, on the round route L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;

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

// --------------------------------------------------------------------- //
// graph route
// --------------------------------------------------------------------- //

// ops/hadamard.py K6_THREADS sizes the padding chunks by it
constexpr int kGraphThreads = 512;
constexpr int kGraphWarps = kGraphThreads / 32;
// D >= 32: the nodes a warp sums and hashes before it reduces their
// hashes together (reduce_scatter8)
constexpr int kGroup = 8;

// COLS (1, 2 or 4) consecutive words at p, one 4-, 8- or 16-byte
// shared-memory access: p is 4 COLS-byte aligned (rows of D >= 32 words
// in a 16-byte-aligned buffer).
template <int COLS>
__device__ __forceinline__ void load_cols(const uint32_t* p,
                                          uint32_t (&c)[COLS]) {
  if constexpr (COLS == 1) {
    c[0] = p[0];
  } else if constexpr (COLS == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    c[0] = x.x;
    c[1] = x.y;
  } else {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    c[0] = x.x;
    c[1] = x.y;
    c[2] = x.z;
    c[3] = x.w;
  }
}

template <int COLS>
__device__ __forceinline__ void store_cols(uint32_t* p,
                                           const uint32_t (&c)[COLS]) {
  if constexpr (COLS == 1)
    p[0] = c[0];
  else if constexpr (COLS == 2)
    *reinterpret_cast<uint2*>(p) = make_uint2(c[0], c[1]);
  else
    *reinterpret_cast<uint4*>(p) = make_uint4(c[0], c[1], c[2], c[3]);
}

// Node v's row plus, when prop, its out-neighbours' rows, at the COLS
// columns col .. col + COLS - 1, from the chunk's rows in shared memory.
template <int COLS>
__device__ __forceinline__ void gather_wide(const uint32_t* cur,
                                            const int32_t* off,
                                            const uint16_t* tgt, int v,
                                            int D, int col, int lane,
                                            bool prop, uint32_t (&c)[COLS]) {
  load_cols<COLS>(cur + v * D + col, c);
  if (!prop) return;
  const int e1 = off[v + 1];
  for (int eb = off[v]; eb < e1; eb += 32) {
    const int m = min(32, e1 - eb);
    const int mine = lane < m ? tgt[eb + lane] : 0;
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      uint32_t n[COLS];
      load_cols<COLS>(cur + __shfl_sync(kAll, mine, i) * D + col, n);
#pragma unroll
      for (int k = 0; k < COLS; ++k) c[k] += n[k];
    }
  }
}

// The warp's sums of eight values a lane, scattered: lane l ends with the
// sum over the 32 lanes of a[(l >> 2) & 7].  Each of the first three
// butterfly steps sends half the values a lane holds and keeps the other
// half, so the eight sums take 9 shuffles, not 40.
__device__ __forceinline__ uint32_t reduce_scatter8(const uint32_t (&a)[8],
                                                    int lane) {
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  uint32_t b[4], c[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = (h4 ? a[i + 4] : a[i])
           + __shfl_xor_sync(kAll, h4 ? a[i] : a[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (h3 ? b[i + 2] : b[i])
           + __shfl_xor_sync(kAll, h3 ? b[i] : b[i + 2], 8);
  uint32_t d =
      (h2 ? c[1] : c[0]) + __shfl_xor_sync(kAll, h2 ? c[0] : c[1], 4);
  d += __shfl_xor_sync(kAll, d, 2);
  d += __shfl_xor_sync(kAll, d, 1);
  return d;
}

// One block a chunk (chunks [C, 6] rows (g0, g1, node0, node1, edge0,
// edge1); the graph ids are not read).  Shared memory: the code buffers
// [2][nv][D] (one for a chunk without edges), the row indices [nv], the
// rebased offsets [nv + 1], the tags [nv] and the local targets [ne] as
// uint16.  The block first stages them, then generation 0's rows,
// gathered from the table by all its threads at once.  COLS > 0: D >=
// 32, lane l holds columns COLS l .. COLS l + COLS - 1 of each pass of
// 32 COLS columns, and a warp sums kGroup nodes (nodes warp + i
// kGraphWarps) a node at a time, then reduces their hashes together;
// COLS == 0: D = 2^log2d < 32, 32 / D nodes a warp.  The loops over
// nodes are warp-uniform (every lane reaches the shuffles).  Generation
// 0 only reads buffer 0; the barrier after each later generation orders
// its writes of one buffer before the next generation's reads, and its
// reads of the other before the generation after writes it.
template <int COLS>
__global__ void __launch_bounds__(kGraphThreads, 2)
hadamard_graph(const int32_t* __restrict__ table,
               const int32_t* __restrict__ row,
               const int32_t* __restrict__ tag,
               const int32_t* __restrict__ offsets,
               const int32_t* __restrict__ targets,
               const int32_t* __restrict__ chunks,
               long long* __restrict__ key, int n_rows, int D, int log2d,
               int n_iter) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int* ch = chunks + 6 * blockIdx.x;
  const int v0 = ch[2], nv = ch[3] - v0, e0 = ch[4], ne = ch[5] - e0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // without an edge a row never changes: one pass, every key written
  const bool still = ne == 0;
  const int words = nv * D;
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem);     // [1 or 2][words]
  int32_t* rw = reinterpret_cast<int32_t*>(buf + (still ? 1 : 2) * words);
  int32_t* off = rw + nv;                                         // [nv + 1]
  uint32_t* tg = reinterpret_cast<uint32_t*>(off + nv + 1);       // [nv]
  uint16_t* tgt = reinterpret_cast<uint16_t*>(tg + nv);           // [ne]
  // a thread issues all its loads of an index before it stores any
  for (int i = tid; i < max(nv + 1, ne); i += kGraphThreads) {
    const bool nd = i < nv, od = !still && i <= nv, ed = i < ne;
    const int r = nd ? __ldg(row + v0 + i) : 0;
    const int t = nd ? __ldg(tag + v0 + i) : 0;
    const int o = od ? __ldg(offsets + v0 + i) : 0;
    const int u = ed ? __ldg(targets + e0 + i) : 0;
    if (nd) {
      rw[i] = r;
      tg[i] = (uint32_t)t;
    }
    if (od) off[i] = o - e0;
    if (ed) tgt[i] = (uint16_t)(u - v0);
  }
  __syncthreads();
  // generation 0's rows, gathered from the table (a few KB: L1-resident)
#pragma unroll 4
  for (int e = tid; e < words; e += kGraphThreads)
    buf[e] = (uint32_t)__ldg(table + ((size_t)rw[e >> log2d] << log2d)
                             + (e & (D - 1)));
  __syncthreads();

  long long* kv = key + v0;
  const int gens = still ? 1 : n_iter;
  for (int g = 0; g < gens; ++g) {
    // generation g - 1's rows (generation 0 hashes buffer 0 as staged)
    const uint32_t* cur = g == 0 ? buf : buf + ((g + 1) & 1) * words;
    uint32_t* nxt = buf + (g & 1) * words;
    const bool prop = g > 0, store = g > 0 && g + 1 < n_iter;
    const int q1 = still ? n_iter : g + 1;   // keys of generations [g, q1)
    if constexpr (COLS > 0) {
      for (int vb = warp; vb < nv; vb += kGraphWarps * kGroup) {
        uint32_t a1[kGroup], a2[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int v = vb + i * kGraphWarps;
          a1[i] = a2[i] = 0u;
          if (v >= nv) continue;
          for (int col = COLS * lane; col < D; col += 32 * COLS) {
            uint32_t c[COLS];
            gather_wide<COLS>(cur, off, tgt, v, D, col, lane, prop, c);
            if (store) store_cols<COLS>(nxt + v * D + col, c);
#pragma unroll
            for (int k = 0; k < COLS; ++k)
              mix(c[k], (uint32_t)(col + k), a1[i], a2[i]);
          }
        }
        const uint32_t s1 = reduce_scatter8(a1, lane);
        const uint32_t s2 = reduce_scatter8(a2, lane);
        const int v = vb + ((lane >> 2) & 7) * kGraphWarps;
        if ((lane & 3) == 0 && v < nv) {
          const long long k = row_key(s1, s2, tg[v]);
          for (int q = g; q < q1; ++q) kv[(size_t)q * n_rows + v] = k;
        }
      }
    } else {
      const int per = 32 >> log2d;           // nodes a warp pass
      const uint32_t j = (uint32_t)(lane & (D - 1));
      for (int vb = warp * per; vb < nv; vb += kGraphWarps * per) {
        const int v = vb + (lane >> log2d);
        const bool live = v < nv;
        uint32_t s1 = 0u, s2 = 0u;
        if (live) {
          uint32_t c = cur[(v << log2d) + j];
          if (prop) {
            const int e1 = off[v + 1];
            for (int e = off[v]; e < e1; ++e)
              c += cur[((int)tgt[e] << log2d) + j];
          }
          if (store) nxt[(v << log2d) + j] = c;
          mix(c, j, s1, s2);
        }
        for (int o = D >> 1; o > 0; o >>= 1) {
          s1 += __shfl_xor_sync(kAll, s1, o);
          s2 += __shfl_xor_sync(kAll, s2, o);
        }
        if (live && j == 0u) {
          const long long k = row_key(s1, s2, tg[v]);
          for (int q = g; q < q1; ++q) kv[(size_t)q * n_rows + v] = k;
        }
      }
    }
    if (store) __syncthreads();
  }
}

template <int COLS>
void launch_graph(unsigned n_chunks, int smem, cudaStream_t s,
                  const int32_t* table, const int32_t* row,
                  const int32_t* tag, const int32_t* offsets,
                  const int32_t* targets, const int32_t* chunks,
                  long long* key, int n_rows, int D, int log2d, int n_iter) {
  cudaFuncSetAttribute(hadamard_graph<COLS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  hadamard_graph<COLS><<<n_chunks, kGraphThreads, smem, s>>>(
      table, row, tag, offsets, targets, chunks, key, n_rows, D, log2d,
      n_iter);
}

// --------------------------------------------------------------------- //
// round route
// --------------------------------------------------------------------- //

constexpr int kThreads = 256;
// Blocks an SM must hold of the row kernel (the launch bound's minimum).
// Without one ptxas held the propagating kernels to 32 registers and
// spilled.  6 (at most 40 registers) spills the 4- and 8-column kernels
// (the 4-column one since the node range and graph mask), which take 4
// (64); on an H100 the 2-column one ran a propagating NCI1-scale
// generation in 0.0568 ms at 6 and 0.0656 at 4.
#define K6_ROW_BLOCKS(cols) ((cols) >= 4 ? 4 : 6)

// Whether node v is one the round route relabels: in the range, and of a
// graph the mask marks (every graph without a mask).
__device__ __forceinline__ bool round_node(int v, int hi,
                                           const int32_t* gids,
                                           const uint8_t* graph_mask,
                                           int n_graphs) {
  if (v >= hi) return false;
  if (graph_mask == nullptr) return true;
  const int g = __ldg(gids + v);
  return g >= 0 && g < n_graphs && graph_mask[g];
}

// D >= 32, a power of two: a warp a node (see the head of the file).
// Code rows are local to the node range: node v's row is v - lo.
template <bool PROP, int COLS>
__global__ void __launch_bounds__(kThreads, K6_ROW_BLOCKS(COLS))
hadamard_row(const int32_t* __restrict__ cin, int32_t* __restrict__ cout,
             const int32_t* __restrict__ offsets,
             const int32_t* __restrict__ targets,
             const int32_t* __restrict__ tag,
             const int32_t* __restrict__ gids,
             const uint8_t* __restrict__ graph_mask,
             long long* __restrict__ key, int lo, int hi, int n_graphs,
             int D) {
  const long long w =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= hi - lo) return;   // the whole warp
  const int v = lo + (int)w;
  if (!round_node(v, hi, gids, graph_mask, n_graphs)) return;
  const size_t row = (size_t)w * D;
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
        const int mine = lane < m ? __ldg(targets + eb + lane) - lo : 0;
#pragma unroll 4
        for (int i = 0; i < m; ++i) {
          const int32_t* nrow =
              cin + (size_t)__shfl_sync(kAll, mine, i) * D + base;
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
    s1 += __shfl_xor_sync(kAll, s1, o);
    s2 += __shfl_xor_sync(kAll, s2, o);
  }
  if (lane == 0) key[v] = row_key(s1, s2, t);
}

template <bool PROP>
void launch_row(unsigned blocks, cudaStream_t s, const int32_t* cin,
                int32_t* cout, const int32_t* offsets,
                const int32_t* targets, const int32_t* tag,
                const int32_t* gids, const uint8_t* graph_mask,
                long long* key, int lo, int hi, int n_graphs, int D) {
  if (D == 32)
    hadamard_row<PROP, 1><<<blocks, kThreads, 0, s>>>(
        cin, cout, offsets, targets, tag, gids, graph_mask, key, lo, hi,
        n_graphs, D);
  else if (D == 64)
    hadamard_row<PROP, 2><<<blocks, kThreads, 0, s>>>(
        cin, cout, offsets, targets, tag, gids, graph_mask, key, lo, hi,
        n_graphs, D);
  else if (D == 128)
    hadamard_row<PROP, 4><<<blocks, kThreads, 0, s>>>(
        cin, cout, offsets, targets, tag, gids, graph_mask, key, lo, hi,
        n_graphs, D);
  else
    hadamard_row<PROP, 8><<<blocks, kThreads, 0, s>>>(
        cin, cout, offsets, targets, tag, gids, graph_mask, key, lo, hi,
        n_graphs, D);
}

// D = 2^log2d < 32: thread t holds column t & (D - 1) of node lo + (t >>
// log2d), so a node's D lanes are one aligned segment of its warp.  No
// thread returns early: every lane of a warp reaches the shuffles, and a
// segment is live or dead as a whole.
template <bool PROP>
__global__ void __launch_bounds__(kThreads)
hadamard_packed(const int32_t* __restrict__ cin, int32_t* __restrict__ cout,
                const int32_t* __restrict__ offsets,
                const int32_t* __restrict__ targets,
                const int32_t* __restrict__ tag,
                const int32_t* __restrict__ gids,
                const uint8_t* __restrict__ graph_mask,
                long long* __restrict__ key, int lo, int hi, int n_graphs,
                int log2d) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int D = 1 << log2d;
  const long long w = t >> log2d;
  const uint32_t j = (uint32_t)(t & (D - 1));
  const int v = w < hi - lo ? lo + (int)w : hi;
  const bool live = round_node(v, hi, gids, graph_mask, n_graphs);
  uint32_t s1 = 0u, s2 = 0u;
  if (live) {
    uint32_t c = (uint32_t)__ldg(cin + t);
    if (PROP) {
      const int e1 = __ldg(offsets + v + 1);
      for (int e = __ldg(offsets + v); e < e1; ++e)
        c += (uint32_t)__ldg(
            cin + ((size_t)(__ldg(targets + e) - lo) << log2d) + j);
      cout[t] = (int32_t)c;
    }
    mix(c, j, s1, s2);
  }
  for (int o = D >> 1; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(kAll, s1, o);
    s2 += __shfl_xor_sync(kAll, s2, o);
  }
  if (live && j == 0u) key[v] = row_key(s1, s2, (uint32_t)__ldg(tag + v));
}

int log2_of(int D) {
  int l = 0;
  while ((1 << l) < D) ++l;
  return l;
}

}  // namespace

// The graph route: all n_iter generations of the chunks' rows, one block
// a chunk.  table [T, D] i32 (row-major); row [n_rows] i32 in [0, T);
// dim_tag [n_rows] i32 (u32 bit patterns); offsets [n_rows + 1] i32,
// non-decreasing, from 0; targets [offsets[n_rows]] i32; chunks
// [n_chunks, 6] i32, rows (g0, g1, node0, node1, edge0, edge1): the
// nodes [node0, node1) own the CSR edges [edge0, edge1) and none of those
// edges leaves the range (the caller's promise), node1 - node0 below
// 2^16; key [n_iter, n_rows] i64: every generation's key of each chunk
// row is written, no other.  smem_bytes: the largest chunk's shared
// memory (ops/hadamard.py), at most 227 KB.  D is a power of two.
// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments out of range.
extern "C" int grakel_hadamard_graph(const int32_t* table, const int32_t* row,
                                     const int32_t* dim_tag,
                                     const int32_t* offsets,
                                     const int32_t* targets,
                                     const int32_t* chunks, int n_chunks,
                                     long long* key, int n_rows, int D,
                                     int n_iter, int smem_bytes,
                                     void* stream) {
  if (D <= 0 || (D & (D - 1)) != 0 || n_iter < 1 || smem_bytes < 0
      || smem_bytes > 232448)
    return (int)cudaErrorInvalidValue;
  if (n_chunks <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int log2d = log2_of(D);
  if (D < 32)
    launch_graph<0>(n_chunks, smem_bytes, s, table, row, dim_tag, offsets,
                    targets, chunks, key, n_rows, D, log2d, n_iter);
  else if (D == 32)
    launch_graph<1>(n_chunks, smem_bytes, s, table, row, dim_tag, offsets,
                    targets, chunks, key, n_rows, D, log2d, n_iter);
  else if (D == 64)
    launch_graph<2>(n_chunks, smem_bytes, s, table, row, dim_tag, offsets,
                    targets, chunks, key, n_rows, D, log2d, n_iter);
  else
    launch_graph<4>(n_chunks, smem_bytes, s, table, row, dim_tag, offsets,
                    targets, chunks, key, n_rows, D, log2d, n_iter);
  return (int)cudaGetLastError();
}

// The round route: one generation over the nodes [lo, hi).  codes_in
// [hi - lo, D] i32, row-major, node v's row at v - lo; codes_out the
// same shape, not codes_in (read only when propagate is 0, and then not
// written); offsets [N + 1] i32, non-decreasing, from 0; targets
// [offsets[N]] i32 (the targets of the range's edges within [lo, hi));
// dim_tag [N] i32 (u32 bit patterns); key [N] i64: written at the nodes
// relabeled.  graph_mask [n_graphs] u8 or null: when given, only nodes
// whose graph (gids [N] i32) it marks are relabeled.  D is a power of
// two.  Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments out of range.
extern "C" int grakel_hadamard_step(const int32_t* codes_in,
                                    int32_t* codes_out,
                                    const int32_t* offsets,
                                    const int32_t* targets,
                                    const int32_t* dim_tag,
                                    const int32_t* gids,
                                    const uint8_t* graph_mask,
                                    long long* key, int lo, int hi,
                                    int n_graphs, int D, int propagate,
                                    void* stream) {
  if (D <= 0 || (D & (D - 1)) != 0 || lo < 0 || hi < lo)
    return (int)cudaErrorInvalidValue;
  if (hi == lo) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (D >= 32) {
    const long long threads = 32LL * (hi - lo);
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    if (propagate)
      launch_row<true>(blocks, s, codes_in, codes_out, offsets, targets,
                       dim_tag, gids, graph_mask, key, lo, hi, n_graphs, D);
    else
      launch_row<false>(blocks, s, codes_in, codes_out, offsets, targets,
                        dim_tag, gids, graph_mask, key, lo, hi, n_graphs, D);
  } else {
    const int log2d = log2_of(D);
    const long long threads = (long long)(hi - lo) << log2d;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    if (propagate)
      hadamard_packed<true><<<blocks, kThreads, 0, s>>>(
          codes_in, codes_out, offsets, targets, dim_tag, gids, graph_mask,
          key, lo, hi, n_graphs, log2d);
    else
      hadamard_packed<false><<<blocks, kThreads, 0, s>>>(
          codes_in, codes_out, offsets, targets, dim_tag, gids, graph_mask,
          key, lo, hi, n_graphs, log2d);
  }
  return (int)cudaGetLastError();
}
