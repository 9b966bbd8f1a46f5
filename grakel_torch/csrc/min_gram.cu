// K1: min-intersection Gram, K[i, j] = sum_l min(A[i, l], B[j, l]).
//
// Replaces the Pallas TPU kernel grakel_tpu/ops/intersect.py
// _min_gram_kernel (launched by _pallas_min_gram), reached through
// min_intersection_gram from PyramidMatch's per-level Grams.
//
// What bounds it on an H100: it is a (min, +) semiring product, 2*n*m*L
// operations on n*L + m*L + n*m floats, so operations per byte grow
// with L.  Tensor cores only multiply, so it runs on the CUDA cores.  At
// PyramidMatch's labeled level widths (hundreds to ~1800) it is bound
// by CUDA-core throughput; at the unlabeled widths (6..48) by writing
// the n x m output.  fminf and fadd are two instructions (no fused
// min-add), so the reachable rate is half the FMA-counted fp32 peak.
//
// Design: one 256-thread block per 64 x 64 output tile; each thread keeps
// a 4 x 4 tile of f32 accumulators in registers.  The L axis is a loop
// inside the block (the TPU grid's sequential third axis): 32-column
// chunks of A and B are staged, k-major, in shared memory so every
// staged value feeds 64 min-adds from registers.  Thread (tx, ty) owns
// rows ty + 16*i and columns tx + 16*j, so a warp's shared-memory reads
// hit consecutive banks and its stores to K are coalesced.  Ragged
// edges are masked in the kernel: out-of-range rows and columns are
// never written and the L tail is staged as zeros on both sides
// (min(0, 0) = 0), so the caller pads nothing.  The sum is f32 in L
// order, the Pallas kernel's accumulation type; integer histograms stay
// exact below 2^24.  wgmma/TMA have no (min, +) form; a faster version
// is later work (vector loads, larger per-thread tiles, double-buffered
// staging with cp.async).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TPB = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(TPB)
min_gram_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ K, int n, int m, int L) {
  // +1 column of padding: the k-major stores below (consecutive threads
  // write consecutive k) then fall in distinct banks
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    // stage A[row0:row0+64, k0:k0+32] and the same of B; consecutive
    // threads read consecutive columns of one row (coalesced along L)
#pragma unroll
    for (int q = 0; q < BM * BK / TPB; ++q) {
      const int t = tid + q * TPB;
      const int r = t / BK;
      const int c = t % BK;
      const int gr = row0 + r;
      const int gc = k0 + c;
      As[c][r] = (gr < n && gc < L) ? A[(size_t)gr * L + gc] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < BN * BK / TPB; ++q) {
      const int t = tid + q * TPB;
      const int r = t / BK;
      const int c = t % BK;
      const int gr = col0 + r;
      const int gc = k0 + c;
      Bs[c][r] = (gr < m && gc < L) ? B[(size_t)gr * L + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += fminf(a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < m) K[(size_t)r * m + c] = acc[i][j];
    }
  }
}

}  // namespace

// A [n, L], B [m, L], K [n, m]: f32, row-major, contiguous, on the
// current device.  Launches on `stream`; returns cudaGetLastError().
extern "C" int grakel_min_gram(const float* A, const float* B, float* K,
                               int n, int m, int L, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaGetLastError();
  dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  min_gram_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(A, B, K, n, m, L);
  return (int)cudaGetLastError();
}
