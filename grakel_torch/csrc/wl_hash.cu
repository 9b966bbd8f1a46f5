// K2: one Weisfeiler-Lehman hash refinement step.
//
// Replaces the XLA program grakel_tpu/ops/wl.py wl_hash_refine (with
// _fmix32); it is bit-identical to its numpy twin host_hash_refine.
// Per node v with label l(v) and out-neighbours u (edge v -> u):
//   sum_s(v) = sum over valid edges of fmix32(l(u), seed_s)   (mod 2^32)
//   h1(v) = fmix32(l(v) * 0x9E3779B9 + sum_1(v), 0x165667B1)
//   h2(v) = fmix32(l(v) * 0x85EBCA6B + sum_2(v), 0x27D4EB2F)
// PyTorch has no uint32 arithmetic for this, hence a kernel.
//
// What bounds it on an H100: a few dozen integer operations per edge
// and per node against 13 bytes read per edge and 12 bytes moved per
// node, so it is bound by memory bytes; at the sizes WL sees (10^5 to
// 10^6 nodes) one call is a few microseconds, so launch latency is the
// real floor.
//
// Design: pass 1, one thread per edge, gathers l(receiver), mixes it
// under both seeds and atomicAdds into sum1/sum2 (unsigned, zeroed by
// the caller).  Wrap-around addition is commutative and associative, so
// the sums do not depend on the order the atomics land in.  Pass 2, one
// thread per node, applies the finalizers and writes the hashes as
// int32 bit patterns.
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

__global__ void wl_edge_sums(const int32_t* __restrict__ labels,
                             const int32_t* __restrict__ senders,
                             const int32_t* __restrict__ receivers,
                             const bool* __restrict__ edge_valid,
                             uint32_t* __restrict__ sum1,
                             uint32_t* __restrict__ sum2, int n_edges) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_edges || !edge_valid[e]) return;
  const uint32_t nl = (uint32_t)labels[receivers[e]];
  const int s = senders[e];
  atomicAdd(sum1 + s, fmix32(nl, 0x9E3779B9u));
  atomicAdd(sum2 + s, fmix32(nl, 0x7F4A7C15u));
}

__global__ void wl_node_hash(const int32_t* __restrict__ labels,
                             const uint32_t* __restrict__ sum1,
                             const uint32_t* __restrict__ sum2,
                             int32_t* __restrict__ h1,
                             int32_t* __restrict__ h2, int n_nodes) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_nodes) return;
  const uint32_t l = (uint32_t)labels[v];
  h1[v] = (int32_t)fmix32(l * 0x9E3779B9u + sum1[v], 0x165667B1u);
  h2[v] = (int32_t)fmix32(l * 0x85EBCA6Bu + sum2[v], 0x27D4EB2Fu);
}

}  // namespace

// labels [n_nodes] i32; senders, receivers [n_edges] i32 in
// [0, n_nodes); edge_valid [n_edges] bool; sum1, sum2 [n_nodes] u32
// zero-filled scratch; h1, h2 [n_nodes] i32 outputs.  Launches both
// passes on `stream`; returns cudaGetLastError().
extern "C" int grakel_wl_hash_refine(const int32_t* labels,
                                     const int32_t* senders,
                                     const int32_t* receivers,
                                     const bool* edge_valid,
                                     uint32_t* sum1, uint32_t* sum2,
                                     int32_t* h1, int32_t* h2,
                                     int n_nodes, int n_edges,
                                     void* stream) {
  const int tpb = 256;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_edges > 0) {
    wl_edge_sums<<<(n_edges + tpb - 1) / tpb, tpb, 0, st>>>(
        labels, senders, receivers, edge_valid, sum1, sum2, n_edges);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_nodes > 0) {
    wl_node_hash<<<(n_nodes + tpb - 1) / tpb, tpb, 0, st>>>(
        labels, sum1, sum2, h1, h2, n_nodes);
  }
  return (int)cudaGetLastError();
}
