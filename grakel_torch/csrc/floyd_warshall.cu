// K3: batched min-plus Floyd-Warshall (all-pairs shortest paths).
//
// Replaces the XLA program grakel_tpu/ops/floyd_warshall.py
// batched_floyd_warshall: for a padded batch adj [n, V, V] f32 (0 means
// "no edge") and mask [n, V] (1 = real vertex) it writes
//   S[g, i, j] = shortest distance, INF = 3.4e38 / 4 where unreachable
//                or where either endpoint is padding, 0 on the diagonal
//                of real vertices,
// bit-identical to the JAX program: the same initialisation, then for
// k = 0 .. V-1 in order S[i, j] = min(S[i, j], S[i, k] + S[k, j]) with
// one round-to-nearest fadd and one compare per update (no fast math,
// no flush to zero; the build never passes --use_fast_math).
//
// In place is exact: during step k row k and column k do not change.
// For a real k, S[k, k] = 0 and x + 0 == x; for a padded k every entry
// of its row and column is INF and INF + x >= INF.  An entry is written
// only where the new path is strictly shorter, so those cells are never
// written in step k and no thread reads a cell another thread writes in
// the same step.
//
// What bounds it on an H100: 2 V^3 floating-point operations per graph
// against 8 V^2 bytes in and out of device memory, so operations (fp32
// on the CUDA cores, 67 TFLOP/s) for V above ~50 and bytes below; each
// of the V steps also needs one barrier (route A) or one launch
// (route B), which at the main path's V = 16..56 costs more than the
// arithmetic.
//
// Route A (V <= ROUTE_A_MAX_V, chosen by the Python wrapper): one block
// per graph holds the whole V x V tile in shared memory (64 KB at
// V = 128, above the 48 KB default, hence the attribute), initialises it
// from adj and mask, runs the V steps with a barrier between them and
// writes S once: device memory sees adj and mask read once and S
// written once.
// Route B (larger V): one initialisation launch, then one in-place
// update launch per k over the whole [n, V, V] batch in device memory
// (a blocked three-phase Floyd-Warshall is later work).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.4e38f / 4.0f;   // ops/floyd_warshall.py INF

// The JAX program's four `where`s collapsed: a pair with a padded
// endpoint is INF, a real diagonal 0, an edge (adj > 0) its weight.
__device__ __forceinline__ float init_value(float a, bool mi, bool mj,
                                            bool diag) {
  if (!(mi && mj)) return kInf;
  if (diag) return 0.0f;
  return a > 0.0f ? a : kInf;
}

__global__ void __launch_bounds__(512)
fw_smem(const float* __restrict__ adj, const uint8_t* __restrict__ mask,
        float* __restrict__ out, int V) {
  extern __shared__ float S[];
  const int VV = V * V;
  const size_t base = (size_t)blockIdx.x * VV;
  const uint8_t* m = mask + (size_t)blockIdx.x * V;
  for (int c = threadIdx.x; c < VV; c += blockDim.x) {
    const int i = c / V, j = c - i * V;
    S[c] = init_value(adj[base + c], m[i] != 0, m[j] != 0, i == j);
  }
  __syncthreads();
  for (int k = 0; k < V; ++k) {
    const float* row_k = S + k * V;
    for (int c = threadIdx.x; c < VV; c += blockDim.x) {
      const int i = c / V, j = c - i * V;
      const float via = S[i * V + k] + row_k[j];
      if (via < S[c]) S[c] = via;
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < VV; c += blockDim.x) out[base + c] = S[c];
}

__global__ void __launch_bounds__(256)
fw_init(const float* __restrict__ adj, const uint8_t* __restrict__ mask,
        float* __restrict__ S, long long total, int V) {
  const long long VV = (long long)V * V;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long g = e / VV;
    const int c = (int)(e - g * VV);
    const int i = c / V, j = c - i * V;
    const uint8_t* m = mask + g * V;
    S[e] = init_value(adj[e], m[i] != 0, m[j] != 0, i == j);
  }
}

__global__ void __launch_bounds__(256)
fw_step(float* __restrict__ S, long long total, int V, int k) {
  const long long VV = (long long)V * V;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long g = e / VV;
    const int c = (int)(e - g * VV);
    const int i = c / V, j = c - i * V;
    const float* Sg = S + g * VV;
    const float via = Sg[i * V + k] + Sg[k * V + j];
    if (via < S[e]) S[e] = via;
  }
}

}  // namespace

// adj [n, V, V] f32, mask [n, V] u8 (0 or 1), S [n, V, V] f32 output,
// all contiguous on the current device.  use_smem selects route A (one
// block per graph, V * V * 4 bytes of shared memory; the caller keeps
// V within the card's limit) or route B.  Launches on `stream`; returns
// the first CUDA error, or cudaGetLastError() after the last launch.
extern "C" int grakel_floyd_warshall(const float* adj, const uint8_t* mask,
                                     float* S, int n, int V, int use_smem,
                                     void* stream) {
  if (n <= 0 || V <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (use_smem) {
    const int VV = V * V;
    const size_t smem = (size_t)VV * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          fw_smem, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    int threads = ((VV + 31) / 32) * 32;
    threads = threads > 512 ? 512 : threads;
    fw_smem<<<n, threads, smem, st>>>(adj, mask, S, V);
    return (int)cudaGetLastError();
  }
  const long long total = (long long)n * V * V;
  const int tpb = 256;
  long long blocks = (total + tpb - 1) / tpb;
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond
  fw_init<<<(int)blocks, tpb, 0, st>>>(adj, mask, S, total, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int k = 0; k < V; ++k) {
    fw_step<<<(int)blocks, tpb, 0, st>>>(S, total, V, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
