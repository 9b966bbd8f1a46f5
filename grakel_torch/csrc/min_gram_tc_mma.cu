// The earlier design of K1-tc (mma.sync m16n8k32 s8, ldmatrix, a cp.async
// ring, one launch a Gram, a block a 128 x 128 tile of the full square),
// kept beside the Hopper design in min_gram_tc.cu for measurement only:
// chip_smoke.py times it on the same indicators, so K1-tc's row keeps
// its earlier time.  No path of the package calls it
// (ops/intersect.py min_gram_tc_mma_cuda).
//
// K = E_A . E_B^T over int8 indicators, as min_gram_tc.cu, for one
// [n, k] x [m, k] product.  One 256-thread block per 128 x 128 output
// tile, 8 warps of 64 x 32, each warp 4 x 4 m16n8 accumulators.  W' is a
// loop of 64-byte chunks staged in a 4-stage ring of shared memory by
// 16-byte cp.async copies, XOR-swizzled by (row / 2) % 4 for ldmatrix.
// Ragged n, m and W' are masked: rows past n or m and chunks past W' are
// zero-filled by cp.async (src-size 0), and stores are masked.  When B is
// A only blocks on or above the diagonal run and each writes its tile and
// the mirrored tile.  The epilogue stages alpha * acc in shared memory
// and writes K = alpha * acc, or K += alpha * acc, in coalesced rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;             // output rows per block
constexpr int BN = 128;             // output columns per block (== BM)
constexpr int BK = 64;              // expanded columns (bytes) per stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;        // 8 warps: 2 (rows) x 4 (columns)
constexpr int TILE = BM * BK;       // bytes of one operand tile
constexpr int SROW = BN + 1;        // f32 row of the staged output tile
constexpr int RING = STAGES * 2 * TILE;   // 65,536 bytes
constexpr int SMEM = RING > BM * SROW * 4 ? RING : BM * SROW * 4;

// byte offset of 16-byte chunk c (0..3) of row r in a [BM][BK] tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * BK + ((c ^ ((r >> 1) & 3)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage X[row0 : row0 + BM, k0 : k0 + BK] (rows of k bytes) at shared
// address dst; rows >= rows and bytes >= k are zero-filled.
__device__ __forceinline__ void load_tile(uint32_t dst, const int8_t* X,
                                          int rows, int k, int row0, int k0,
                                          int tid) {
#pragma unroll
  for (int q = 0; q < TILE / 16 / THREADS; ++q) {
    const int i = tid + q * THREADS;
    const int r = i >> 2;
    const int c = i & 3;
    const int gr = row0 + r;
    const int gk = k0 + (c << 4);
    const bool ok = gr < rows && gk < k;
    cp_async16(dst + swz(r, c), ok ? X + (size_t)gr * k + gk : X,
               ok ? 16 : 0);
  }
}

// Write the staged tile S [BM][SROW] to K [n, m] at (row0, col0), or
// its transpose at (col0, row0), adding to K when accumulating.
// Consecutive threads take consecutive addresses of K, so every warp
// store is 128 contiguous bytes; the SROW = BN + 1 padding keeps the
// column reads of the transpose free of bank conflicts.  Each batch
// loads all its old values before its stores.
template <bool kTransposed>
__device__ __forceinline__ void write_tile(float* K, const float* S,
                                           int row0, int col0, int n, int m,
                                           int accumulate, int tid) {
  constexpr int kBatch = 8;
#pragma unroll 1
  for (int base = 0; base < BM * BN; base += kBatch * THREADS) {
    float v[kBatch];
    size_t at[kBatch];
    bool ok[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = base + q * THREADS + tid;
      const int r = kTransposed ? i % BM : i / BN;   // tile row
      const int c = kTransposed ? i / BM : i % BN;   // tile column
      const int gr = kTransposed ? col0 + c : row0 + r;
      const int gc = kTransposed ? row0 + r : col0 + c;
      ok[q] = gr < n && gc < m;
      at[q] = (size_t)gr * m + gc;
      v[q] = S[r * SROW + c];
    }
    if (accumulate) {
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        if (ok[q]) v[q] += K[at[q]];
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (ok[q]) K[at[q]] = v[q];
  }
}

__global__ void __launch_bounds__(THREADS, 2)
min_gram_tc_mma_kernel(const int8_t* __restrict__ A,
                   const int8_t* __restrict__ B, float* __restrict__ K,
                   int n, int m, int k, float alpha, int accumulate,
                   int symmetric) {
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  if (symmetric && bi > bj) return;   // the mirror block writes this tile
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;   // warp row: 64 output rows
  const int wn = warp & 3;    // warp column: 32 output columns
  const int row0 = bi * BM;
  const int col0 = bj * BN;
  const int nk = (k + BK - 1) / BK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // ldmatrix.x4: lane l addresses row l % 8 of matrix l / 8
  const int lq = lane >> 3;
  const int lr = lane & 7;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      const uint32_t st = sbase + s * 2 * TILE;
      load_tile(st, A, n, k, row0, s * BK, tid);
      load_tile(st + TILE, B, m, k, col0, s * BK, tid);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();   // chunk kt has landed
    __syncthreads();               // ... for every thread; slot kt-1 is free
    const int nt = kt + STAGES - 1;
    if (nt < nk) {
      const uint32_t st = sbase + (nt % STAGES) * 2 * TILE;
      load_tile(st, A, n, k, row0, nt * BK, tid);
      load_tile(st + TILE, B, m, k, col0, nt * BK, tid);
    }
    cp_async_commit();
    const uint32_t sa = sbase + (kt % STAGES) * 2 * TILE;
    const uint32_t sb = sa + TILE;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[4][4], bf[4][2];
      // A fragment of m16n8k32: matrices (rows 0-7, bytes 0-15),
      // (rows 8-15, bytes 0-15), (rows 0-7, bytes 16-31), (rows 8-15,
      // bytes 16-31) give a0..a3
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(sa + swz(wm * 64 + mi * 16 + lr + (lq & 1) * 8,
                             ks * 2 + (lq >> 1)),
                    af[mi][0], af[mi][1], af[mi][2], af[mi][3]);
      // B fragments of two n8 tiles: (cols 0-7, bytes 0-15) -> b0 and
      // (cols 0-7, bytes 16-31) -> b1 of the first, the same of cols 8-15
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(sb + swz(wn * 32 + np * 16 + lr + (lq >> 1) * 8,
                             ks * 2 + (lq & 1)),
                    bf[2 * np][0], bf[2 * np][1], bf[2 * np + 1][0],
                    bf[2 * np + 1][1]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring: it holds the tile

  // accumulator e of tile (mi, ni) holds row g (+8 for e >= 2), column
  // 2 * (lane % 4) + e % 2 of the warp's m16n8 tile
  float* S = reinterpret_cast<float*>(smem);
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        S[(wm * 64 + mi * 16 + g + (e >> 1) * 8) * SROW + wn * 32 + ni * 8 +
          t2 + (e & 1)] = alpha * (float)acc[mi][ni][e];
  __syncthreads();
  write_tile<false>(K, S, row0, col0, n, m, accumulate, tid);
  if (symmetric && bi != bj)
    write_tile<true>(K, S, row0, col0, n, m, accumulate, tid);
}

}  // namespace

// A [n, k], B [m, k]: int8 0/1, row-major, contiguous, k % 16 == 0, on
// the current device; K [n, m] f32.  K = alpha * A B^T, or K += alpha *
// A B^T when accumulate != 0.  symmetric != 0 requires B == A (n == m)
// and computes the upper block triangle only.  Launches on `stream`;
// returns cudaGetLastError() or cudaErrorInvalidValue.
extern "C" int grakel_min_gram_tc_mma(const int8_t* A, const int8_t* B, float* K,
                                  int n, int m, int k, float alpha,
                                  int accumulate, int symmetric,
                                  void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaGetLastError();
  if (k < 0 || k % 16 != 0 || (symmetric && (A != B || n != m)))
    return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory needs an opt-in, once per device
  static bool smem_set[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(min_gram_tc_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) smem_set[dev] = true;
  }
  dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  min_gram_tc_mma_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      A, B, K, n, m, k, alpha, accumulate, symmetric);
  return (int)cudaGetLastError();
}
