// K8: the random-walk pair CG solve (RandomWalk's fast geometric kernel
// on graphs whose spectra it cannot use, and RandomWalkLabeled's).
//
// Replaces the XLA programs grakel_tpu/kernels/random_walk.py _cg_sum
// (:56) in _pair_cg_geometric (:88) and _pair_cg_labeled (:95), vmapped
// over chunks of graph pairs.  For a pair of graphs with adjacencies Ax
// (n1 x n1) and Ay (n2 x n2) it runs `iters` (20) conjugate-gradient
// steps on (I - lam Ax (x) Ay) x = b in matrix form, b the n1 x n2 block
// of ones, x0 = 0, and writes sum(x).  The matvec of a direction P is
//   unlabeled: Q = P - lam (Ax P) Ay
//   labeled:   Q = P - lam sum_c Dx_c Ax (M o (P Dy_c Ay)),
//              M[w, v] = [Lx[w] == Ly[v]], over the labels c both graphs
//              hold (any other label adds exact zeros), in ascending c.
// A step follows _cg_sum: with rs = <r, r>, the pair is frozen once
// sqrt(rs) <= rtol * ||b||; alpha = rs / <p, Q> (0 when that is 0),
// x += alpha p, r -= alpha Q, beta = rs' / rs (0 when rs is 0),
// p = r + beta p.  A frozen pair's later steps change nothing, so the
// block leaves the loop there.  All f32, as the JAX package (x64 off);
// sums are taken in another order than XLA's, so results agree to
// rounding, not bit for bit.
//
// Design: one block a pair; every step of a pair in one launch, with
// every per-pair scalar (rs, alpha, beta, the freeze) in the block.  The
// two products of a matvec are block GEMMs over 32 x 32 output tiles,
// their operands staged through shared-memory tiles (each thread four
// outputs of a tile).  Routes, one kernel:
// * shared: the pair's Ax, Ay and its five n1 x n2 matrices (X, R, P, the
//   product T, Q) live in dynamic shared memory (V1 = V2 = 64: 112 KB);
// * global: larger buckets (DD- or PROTEINS-size graphs, directed graphs
//   over 64 vertices) keep the five matrices in a global scratch, one
//   slot a block, and read Ax, Ay where they lie; the GEMMs stage tiles
//   through shared memory as on the shared route.
// Blocks loop over pairs (grid <= pairs), so the global scratch holds
// only the launched blocks' slots (the host caps the grid to a share of
// the card's free memory).  The launch bound asks for two blocks
// an SM: with the default, ptxas packs the kernel into 40-48 registers
// and spills; with it, 89-96 registers and no spill.
//
// What bounds it on an H100: operations.  A matvec needs 2 n1 n2 (n1 +
// n2) flops, labeled or not (a label's masks split X's rows and
// columns, so the common labels' products add up to one), 20 of them a
// pair, against a few KB of adjacency read once: far above the card's
// ridge.  The labeled matvec here runs two masked n1 x n2 GEMMs a common
// label, so it does that many times the work it needs.  Buckets of 16
// to 64 vertices leave the tile loops short, so the block's syncs and
// reductions, not the FMA rate, set its time.
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;        // GEMM tile side
constexpr int kPad = kT + 1;  // staged tile row stride (no bank conflict)

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  __syncthreads();  // every reader of `red` is done with its last use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];  // one order: all agree
  return s;
}

__device__ __forceinline__ int block_min(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int u = __shfl_xor_sync(0xFFFFFFFFu, v, o);
    v = u < v ? u : v;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = INT_MAX;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s = red[w] < s ? red[w] : s;
  return s;
}

// C(i, j) = fe(i, j, sum_k fa(i, k) fb(k, j)) for i < M, j < N, over
// 32 x 32 output tiles and 32-deep k tiles staged in `sa`, `sb`.  Every
// thread of the block calls it; the caller syncs before C is read.
template <class FA, class FB, class FE>
__device__ __forceinline__ void block_gemm(int M, int N, int K, FA fa,
                                           FB fb, FE fe, float* sa,
                                           float* sb) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i0 = 0; i0 < M; i0 += kT) {
    for (int j0 = 0; j0 < N; j0 += kT) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < K; k0 += kT) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = ty + 8 * r;
          const int ia = i0 + row, ka = k0 + tx;
          sa[row * kPad + tx] = (ia < M && ka < K) ? fa(ia, ka) : 0.f;
          const int kb = k0 + row, jb = j0 + tx;
          sb[row * kPad + tx] = (kb < K && jb < N) ? fb(kb, jb) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kT; ++kk) {
          const float b = sb[kk * kPad + tx];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[r] = fmaf(sa[(ty + 8 * r) * kPad + kk], b, acc[r]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 8 * r, j = j0 + tx;
        if (i < M && j < N) fe(i, j, acc[r]);
      }
    }
  }
}

template <bool kLabeled>
__global__ void __launch_bounds__(kThreads, 2)
rw_cg_kernel(const float* __restrict__ ax_g, const float* __restrict__ ay_g,
             const int* __restrict__ nx, const int* __restrict__ ny,
             const int* __restrict__ lx_g, const int* __restrict__ ly_g,
             float* __restrict__ out, int n_pairs, int V1, int V2,
             float lam, int iters, float rtol, float* scratch) {
  extern __shared__ float smem[];
  float* sa = smem;
  float* sb = sa + kT * kPad;
  float* red = sb + kT * kPad;
  int* ired = reinterpret_cast<int*>(red + 32);
  float* ws = reinterpret_cast<float*>(ired + 32);
  const int tid = threadIdx.x;
  const bool shared = scratch == nullptr;
  for (int pr = blockIdx.x; pr < n_pairs; pr += gridDim.x) {
    const int n1 = nx[pr], n2 = ny[pr], N = n1 * n2;
    const float* axp = ax_g + (size_t)pr * V1 * V1;
    const float* ayp = ay_g + (size_t)pr * V2 * V2;
    const float *ax, *ay;
    const int *lx = nullptr, *ly = nullptr;
    int ldx, ldy;
    float* X;
    if (shared) {
      float* sax = ws;
      float* say = sax + n1 * n1;
      for (int e = tid; e < n1 * n1; e += kThreads)
        sax[e] = axp[(e / n1) * V1 + e % n1];
      for (int e = tid; e < n2 * n2; e += kThreads)
        say[e] = ayp[(e / n2) * V2 + e % n2];
      ax = sax;
      ay = say;
      ldx = n1;
      ldy = n2;
      X = say + n2 * n2;
      if (kLabeled) {
        int* slx = reinterpret_cast<int*>(X + 5 * N);
        int* sly = slx + n1;
        for (int e = tid; e < n1; e += kThreads)
          slx[e] = lx_g[(size_t)pr * V1 + e];
        for (int e = tid; e < n2; e += kThreads)
          sly[e] = ly_g[(size_t)pr * V2 + e];
        lx = slx;
        ly = sly;
      }
    } else {
      ax = axp;
      ay = ayp;
      ldx = V1;
      ldy = V2;
      X = scratch + (size_t)blockIdx.x * 5 * V1 * V2;
      if (kLabeled) {
        lx = lx_g + (size_t)pr * V1;
        ly = ly_g + (size_t)pr * V2;
      }
    }
    float* R = X + N;
    float* P = R + N;
    float* T = P + N;
    float* Q = T + N;
    for (int e = tid; e < N; e += kThreads) {
      X[e] = 0.f;
      R[e] = 1.f;
      P[e] = 1.f;
    }
    float rs = (float)N;  // <b, b>: a sum of N ones, exact in f32
    const float thresh = rtol * sqrtf(rs);
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
      if (sqrtf(rs) <= thresh) break;  // frozen
      // Q = matvec(P)
      if (!kLabeled) {
        block_gemm(n1, n2, n1,
                   [=](int i, int k) { return ax[i * ldx + k]; },
                   [=](int k, int j) { return P[k * n2 + j]; },
                   [=](int i, int j, float v) { T[i * n2 + j] = v; }, sa, sb);
        __syncthreads();
        block_gemm(n1, n2, n2,
                   [=](int i, int k) { return T[i * n2 + k]; },
                   [=](int k, int j) { return ay[k * ldy + j]; },
                   [=](int i, int j, float v) {
                     Q[i * n2 + j] = P[i * n2 + j] - lam * v;
                   },
                   sa, sb);
      } else {
        for (int e = tid; e < N; e += kThreads) Q[e] = 0.f;
        int c = INT_MIN;
        for (;;) {
          // the next label of x above c, and whether y holds it
          int mine = INT_MAX;
          for (int u = tid; u < n1; u += kThreads)
            if (lx[u] > c && lx[u] < mine) mine = lx[u];
          c = block_min(mine, ired);
          if (c == INT_MAX) break;
          int absent = 1;
          for (int z = tid; z < n2; z += kThreads)
            if (ly[z] == c) absent = 0;
          if (block_min(absent, ired)) continue;
          const int cc = c;
          block_gemm(n1, n2, n2,
                     [=](int w, int z) {
                       return ly[z] == cc ? P[w * n2 + z] : 0.f;
                     },
                     [=](int z, int v) { return ay[z * ldy + v]; },
                     [=](int w, int v, float s) {
                       T[w * n2 + v] = lx[w] == ly[v] ? s : 0.f;
                     },
                     sa, sb);
          __syncthreads();
          block_gemm(n1, n2, n1,
                     [=](int u, int w) { return ax[u * ldx + w]; },
                     [=](int w, int v) { return T[w * n2 + v]; },
                     [=](int u, int v, float s) {
                       if (lx[u] == cc) Q[u * n2 + v] += s;
                     },
                     sa, sb);
          __syncthreads();
        }
        for (int e = tid; e < N; e += kThreads) Q[e] = P[e] - lam * Q[e];
      }
      __syncthreads();
      float pq = 0.f;
      for (int e = tid; e < N; e += kThreads) pq += P[e] * Q[e];
      const float denom = block_sum(pq, red);
      const float alpha = denom == 0.f ? 0.f : rs / denom;
      float rr = 0.f;
      for (int e = tid; e < N; e += kThreads) {
        X[e] += alpha * P[e];
        const float r = R[e] - alpha * Q[e];
        R[e] = r;
        rr += r * r;
      }
      const float rs_new = block_sum(rr, red);
      const float beta = rs == 0.f ? 0.f : rs_new / rs;
      for (int e = tid; e < N; e += kThreads) P[e] = R[e] + beta * P[e];
      rs = rs_new;
      __syncthreads();
    }
    float sx = 0.f;
    for (int e = tid; e < N; e += kThreads) sx += X[e];
    const float total = block_sum(sx, red);
    if (tid == 0) out[pr] = total;
    __syncthreads();  // the next pair reuses the workspace
  }
}

template <bool kLabeled>
int launch(const float* ax, const float* ay, const int* nx, const int* ny,
           const int* lx, const int* ly, float* out, int n_pairs, int V1,
           int V2, float lam, int iters, float rtol, float* scratch,
           int grid, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rw_cg_kernel<kLabeled>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  rw_cg_kernel<kLabeled><<<grid, kThreads, smem, stream>>>(
      ax, ay, nx, ny, lx, ly, out, n_pairs, V1, V2, lam, iters, rtol,
      scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// ax [n_pairs, V1, V1], ay [n_pairs, V2, V2] f32; nx, ny [n_pairs] i32
// valid sizes (1 <= n <= V); lx [n_pairs, V1], ly [n_pairs, V2] i32
// labels (both null: unlabeled); out [n_pairs] f32.  scratch null: the
// shared route (smem >= the pair's matrices); else the global route,
// scratch [grid, 5, V1, V2] f32.  Launches `grid` blocks on `stream`;
// returns cudaGetLastError().
extern "C" int grakel_rw_cg(const float* ax, const float* ay, const int* nx,
                            const int* ny, const int* lx, const int* ly,
                            float* out, int n_pairs, int V1, int V2,
                            float lam, int iters, float rtol, float* scratch,
                            int grid, int smem, void* stream) {
  if (n_pairs <= 0 || grid <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (lx != nullptr)
    return launch<true>(ax, ay, nx, ny, lx, ly, out, n_pairs, V1, V2, lam,
                        iters, rtol, scratch, grid, smem, st);
  return launch<false>(ax, ay, nx, ny, lx, ly, out, n_pairs, V1, V2, lam,
                       iters, rtol, scratch, grid, smem, st);
}
