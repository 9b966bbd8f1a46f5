// K5: the Jaccard fold of NeighborhoodHash's Gram.
//
// Replaces the epilogue of the XLA program grakel_tpu/ops/intersect.py
// _jaccard_rounds_impl (:153-185): from the per-round min-intersection
// counts c [R, n, m] (exact, from K1 or K1-tc) and the vertex counts
// va [n], vb [m] it writes f32 K [n, m] with, per entry and in the order
// XLA-CPU compiles the JAX program,
//   d = (va[i] + vb[j]) - c_r[i, j]
//   acc += d > 0 ? c_r[i, j] / d : 0          (rounds in order, from 0)
//   acc *= f32(1 / R)
//   K = (acc_ij + acc_ji) * 0.5               (when symmetrizing)
// Every step is an explicitly rounded intrinsic (__fadd_rn, __fsub_rn,
// __fdiv_rn, __fmul_rn), so nvcc contracts nothing into an FMA and the
// division is IEEE whatever the flags: the kernel is bit-identical to
// its plain version (ops/intersect.py jaccard_fold_plain), which is
// bit-identical to the JAX package on the CPU.
//
// What bounds it on an H100: memory bytes, R n m 4 read and n m 4
// written (4046^2 at R = 3: 262 MB, ~0.078 ms at 3.35 TB/s) against a
// division and four adds an entry and round.
//
// Design: rectangular, one thread an entry, coalesced along j.
// Symmetrizing, one block owns a 32 x 32 tile (ti, tj) with ti <= tj
// together with its mirror (tj, ti): the mirror is staged through
// shared memory so that both are read along rows (coalesced), each
// thread folds both entries of its pair (i, j), (j, i), and the mirror
// is written back through shared memory along rows too.  Blocks below
// the diagonal exit at once; each count is read once.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 32;   // tile side, the block's x extent
constexpr int kRows = 8;    // the block's y extent: 4 rows a thread

__device__ __forceinline__ float term(float c, float vi, float vj) {
  const float d = __fsub_rn(__fadd_rn(vi, vj), c);
  return d > 0.f ? __fdiv_rn(c, d) : 0.f;
}

__global__ void __launch_bounds__(256)
jaccard_rect(const float* __restrict__ c, const float* __restrict__ va,
             const float* __restrict__ vb, float* __restrict__ K, int R,
             int n, int m, float inv_r) {
  const size_t nm = (size_t)n * m;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nm) return;
  const int i = (int)(idx / (size_t)m);
  const int j = (int)(idx - (size_t)i * m);
  const float vi = __ldg(va + i), vj = __ldg(vb + j);
  float acc = 0.f;
  for (int r = 0; r < R; ++r) {
    acc = __fadd_rn(acc, term(__ldg(c + r * nm + idx), vi, vj));
  }
  K[idx] = __fmul_rn(acc, inv_r);
}

__global__ void __launch_bounds__(kTile * kRows)
jaccard_sym(const float* __restrict__ c, const float* __restrict__ va,
            const float* __restrict__ vb, float* __restrict__ K, int R,
            int n, float inv_r) {
  const int ti = blockIdx.y, tj = blockIdx.x;
  if (ti > tj) return;
  __shared__ float mirror[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const size_t nn = (size_t)n * n;
  // this thread's entries (i, j) of tile (ti, tj): i = ti*32 + ty + 8k,
  // j = tj*32 + tx; their mirrors (j, i) sit at mirror[tx][ty + 8k]
  const int j = tj * kTile + tx;
  float up[kTile / kRows], dn[kTile / kRows];
#pragma unroll
  for (int k = 0; k < kTile / kRows; ++k) up[k] = dn[k] = 0.f;
  for (int r = 0; r < R; ++r) {
    const float* cr = c + r * nn;
#pragma unroll
    for (int k = 0; k < kTile / kRows; ++k) {
      const int row = tj * kTile + ty + kRows * k, col = ti * kTile + tx;
      mirror[ty + kRows * k][tx] =
          (row < n && col < n) ? __ldg(cr + (size_t)row * n + col) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTile / kRows; ++k) {
      const int i = ti * kTile + ty + kRows * k;
      if (i < n && j < n) {
        up[k] = __fadd_rn(up[k], term(__ldg(cr + (size_t)i * n + j),
                                      __ldg(va + i), __ldg(vb + j)));
        dn[k] = __fadd_rn(dn[k], term(mirror[tx][ty + kRows * k],
                                      __ldg(va + j), __ldg(vb + i)));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kTile / kRows; ++k) {
    const int i = ti * kTile + ty + kRows * k;
    const float v = __fmul_rn(
        __fadd_rn(__fmul_rn(up[k], inv_r), __fmul_rn(dn[k], inv_r)), 0.5f);
    if (i < n && j < n) K[(size_t)i * n + j] = v;
    mirror[tx][ty + kRows * k] = v;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kTile / kRows; ++k) {
    const int row = tj * kTile + ty + kRows * k, col = ti * kTile + tx;
    if (row < n && col < n) K[(size_t)row * n + col] = mirror[ty + kRows * k][tx];
  }
}

}  // namespace

// c [R, n, m] f32; va [n], vb [m] f32; K [n, m] f32 output; inv_r the
// f32 value of 1 / R; symmetrize requires n == m and writes
// K = (acc + acc^T) / 2 as above.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int grakel_jaccard_fold(const float* c, const float* va,
                                   const float* vb, float* K, int R, int n,
                                   int m, float inv_r, int symmetrize,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && m > 0) {
    if (symmetrize) {
      const int tiles = (n + kTile - 1) / kTile;
      jaccard_sym<<<dim3(tiles, tiles), dim3(kTile, kRows), 0, s>>>(
          c, va, vb, K, R, n, inv_r);
    } else {
      const size_t nm = (size_t)n * m;
      const unsigned blocks = (unsigned)((nm + 255) / 256);
      jaccard_rect<<<blocks, 256, 0, s>>>(c, va, vb, K, R, n, m, inv_r);
    }
  }
  return (int)cudaGetLastError();
}
