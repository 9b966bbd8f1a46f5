// K2: one Weisfeiler-Lehman hash refinement step, one pass over a CSR.
//
// Replaces the XLA program grakel_tpu/ops/wl.py wl_hash_refine (with
// _fmix32); it is bit-identical to its numpy twin host_hash_refine.
// Per node v with label l(v) and out-neighbours u (edge v -> u):
//   sum_s(v) = sum over valid edges of fmix32(l(u), seed_s)   (mod 2^32)
//   h1(v) = fmix32(l(v) * 0x9E3779B9 + sum_1(v), 0x165667B1)
//   h2(v) = fmix32(l(v) * 0x85EBCA6B + sum_2(v), 0x27D4EB2F)
// and writes only the compaction key (h1 - 2^31) * 2^32 + h2 as int64,
// whose signed order is the unsigned order of the pair and which holds
// both hashes exactly (ops/wl.py key_hashes unpacks them).
// PyTorch has no uint32 arithmetic for this, hence a kernel.
//
// What bounds it on an H100: a few dozen integer operations per edge
// and per node against 8 bytes read per edge and 16 bytes moved per node
// (label, offset, key), so memory bytes; at the sizes WL sees
// (10^5 to 10^6 nodes) one launch is a few microseconds, so launch
// latency and the host side of the call are the real floor.
//
// Design: the caller hands the valid edges grouped by sender (CSR built
// once per GraphBatch on the host, where the endpoints are checked), so
// one thread per node gathers its neighbours' labels, sums both mixes in
// registers and applies both finalizers: one launch, no atomics and no
// zero-filled scratch.  Wrap-around addition is order-free, so the
// hashes are those of the edge-order sum.  Degrees on the WL main path
// are 2-5; a node of very high degree serialises its warp (a warp per
// such node is later work).
//
// Reach 2 (grakel_wl_hash_refine_rows) replaces the hash of XLA
// _refine_step, grakel_tpu/parallel/large_graph.py:47, one graph's
// edge-partitioned refinement: a rank owns the rows [row0, row0 +
// n_rows) of the gathered global label vector, its CSR holds its rows'
// out-edges with global target indices, and a node's own label is
// labels[row0 + v].  The same kernel with row0 = 0 and n_rows = N is
// reach 1, so both reaches do the same arithmetic bit for bit, which is
// what lets one big graph's ids and the small graphs' ids be compacted
// jointly.  Bound: the CSR, the gathered labels (read once) and the keys
// of the rank's rows, so bytes again.
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

__global__ void __launch_bounds__(256)
wl_hash_csr(const int32_t* __restrict__ labels,
            const int32_t* __restrict__ offsets,
            const int32_t* __restrict__ targets, long long* __restrict__ key,
            int n_nodes, int row0) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_nodes) return;
  uint32_t s1 = 0u, s2 = 0u;
  const int end = offsets[v + 1];
  for (int e = offsets[v]; e < end; ++e) {
    const uint32_t nl = (uint32_t)__ldg(labels + __ldg(targets + e));
    s1 += fmix32(nl, 0x9E3779B9u);
    s2 += fmix32(nl, 0x7F4A7C15u);
  }
  const uint32_t l = (uint32_t)labels[row0 + v];
  const uint32_t u1 = fmix32(l * 0x9E3779B9u + s1, 0x165667B1u);
  const uint32_t u2 = fmix32(l * 0x85EBCA6Bu + s2, 0x27D4EB2Fu);
  key[v] = (long long)(((uint64_t)(u1 ^ 0x80000000u) << 32) | u2);
}

}  // namespace

// labels [n_nodes] i32; offsets [n_nodes + 1] i32, non-decreasing, from
// 0; targets [offsets[n_nodes]] i32 in [0, n_nodes); key [n_nodes] i64
// output.  Launches on `stream`; returns cudaGetLastError().
extern "C" int grakel_wl_hash_refine(const int32_t* labels,
                                     const int32_t* offsets,
                                     const int32_t* targets,
                                     long long* key, int n_nodes,
                                     void* stream) {
  const int tpb = 256;
  if (n_nodes > 0) {
    wl_hash_csr<<<(n_nodes + tpb - 1) / tpb, tpb, 0,
                  (cudaStream_t)stream>>>(labels, offsets, targets, key,
                                          n_nodes, 0);
  }
  return (int)cudaGetLastError();
}

// Reach 2: labels [>= row0 + n_rows] i32 (the gathered global vector);
// offsets [n_rows + 1] i32, non-decreasing, from 0; targets
// [offsets[n_rows]] i32, global indices into labels; key [n_rows] i64,
// node v's key at key[v].  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int grakel_wl_hash_refine_rows(const int32_t* labels,
                                          const int32_t* offsets,
                                          const int32_t* targets,
                                          long long* key, int n_rows,
                                          int row0, void* stream) {
  const int tpb = 256;
  if (n_rows > 0) {
    wl_hash_csr<<<(n_rows + tpb - 1) / tpb, tpb, 0,
                  (cudaStream_t)stream>>>(labels, offsets, targets, key,
                                          n_rows, row0);
  }
  return (int)cudaGetLastError();
}
