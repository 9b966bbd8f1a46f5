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
// warp or block leaves the loop there.  All f32, as the JAX package (x64 off);
// sums are taken in another order than XLA's, so results agree to
// rounding, not bit for bit.
//
// Inputs: graph tables, each graph packed once (ops/random_walk.py
// cg_table: f32 adjacencies [G, V, V], int32 sizes and, labeled, int32
// labels [G, V], each graph's vertices sorted by label), and a list of
// pairs (ia, ib) of table rows.  Three routes, picked on the host from
// the buckets V1, V2 alone (cg_route):
//
// * warp (V1, V2 <= 32; every MUTAG pair, the NCI1-scale buckets 16 and
//   32): one warp a pair, four warps a block, persistent: a warp takes
//   its next pair from an atomic counter when its pair freezes, so a
//   pair that freezes at step 3 does not idle a warp until step 20.
//   Lane v owns column v of the n1 x n2 matrices: R and P in registers
//   (an array of VX = 8, 16 or 32 rows, the template); x is not kept,
//   its sum is, as sum_k alpha_k sum(p_k) (an array of x spilled at VX =
//   32; the f32 sums round in another order than _cg_sum's); Ax, Ay,
//   P^T and the product column buffer in the warp's slice of shared
//   memory.  The
//   matvec is Q = P - lam Ax (P Ay): the lane's column of P Ay reads P^T
//   (all lanes one row: a broadcast), the left product is lane-local.
//   rs, <p, Q> and the sum of x come from an xor butterfly of shuffles,
//   which gives every lane the same value (each level adds the same two
//   numbers on both lanes), so all lanes agree on the freeze; there is
//   no block barrier in the step loop.  Labeled: the labels are sorted,
//   so each label is a row range of x and a column range of y; the list
//   of common labels with their ranges is built once a pair (a ballot a
//   run of x), and a step multiplies only each common label c's blocks:
//   S = (P[:, Yc] Ay[Yc, :]) masked to the rows of the column's label,
//   then Q[Xc, :] = Ax[Xc, :] S, which adds up to the flops of one
//   unlabeled matvec.  A row of x whose label y lacks keeps Q = P.
// * shared / global (larger buckets): one block a pair, every step of a
//   pair in one launch, with every per-pair scalar (rs, alpha, beta, the
//   freeze) in the block.  The two products of a matvec are block GEMMs
//   over 32 x 32 output tiles, their operands staged through
//   shared-memory tiles (each thread four outputs of a tile).  shared:
//   the pair's Ax, Ay and its five n1 x n2 matrices (X, R, P, the
//   product T, Q) live in dynamic shared memory (V1 = V2 = 64: 112 KB);
//   global: larger buckets (DD- or PROTEINS-size graphs, directed graphs
//   over 64 vertices) keep the five matrices in a global scratch, one
//   slot a block, and read Ax, Ay where they lie.  Blocks loop over
//   pairs (grid <= pairs), so the global scratch holds only the launched
//   blocks' slots (the host caps the grid to a share of the card's free
//   memory).  The launch bound asks for two blocks an SM: with the
//   default, ptxas packs the kernel into 40-48 registers and spills; with
//   it, 89-96 registers and no spill.  The labeled matvec of these routes
//   runs two masked n1 x n2 GEMMs a common label, so it does that many
//   times the work it needs.
//
// What bounds it on an H100: operations.  A matvec needs 2 n1 n2 (n1 +
// n2) flops, labeled or not (a label's masks split X's rows and
// columns), 20 of them a pair at most, against a few KB of adjacency
// read once: far above the card's ridge.  On the warp route a pair's
// step is a few thousand instructions of one warp; on the block routes
// buckets of 16 to 64 vertices leave the tile loops short, so the
// block's syncs and reductions, not the FMA rate, set their time.
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
             const int* __restrict__ ia, const int* __restrict__ ib,
             float* __restrict__ out, int n_pairs, int V1, int V2,
             float lam, int iters, float rtol, float* scratch) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;
  float* sb = sa + kT * kPad;
  float* red = sb + kT * kPad;
  int* ired = reinterpret_cast<int*>(red + 32);
  float* ws = reinterpret_cast<float*>(ired + 32);
  const int tid = threadIdx.x;
  const bool shared = scratch == nullptr;
  for (int pr = blockIdx.x; pr < n_pairs; pr += gridDim.x) {
    const int ga = ia[pr], gb = ib[pr];
    const int n1 = nx[ga], n2 = ny[gb], N = n1 * n2;
    const float* axp = ax_g + (size_t)ga * V1 * V1;
    const float* ayp = ay_g + (size_t)gb * V2 * V2;
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
          slx[e] = lx_g[(size_t)ga * V1 + e];
        for (int e = tid; e < n2; e += kThreads)
          sly[e] = ly_g[(size_t)gb * V2 + e];
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
        lx = lx_g + (size_t)ga * V1;
        ly = ly_g + (size_t)gb * V2;
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

// ---------------------------------------------------------------------
// the warp route
// ---------------------------------------------------------------------

constexpr int kWarpBlock = 128;   // four warps a block
constexpr unsigned kFull = 0xFFFFFFFFu;

// floats of one warp's slice of shared memory at VX rows and V2 columns:
// Ax [VX][VX], Ay [V2][32], P^T [32][VX + 4], the product column buffer
// [VX][32], the common-label list [32] int4.  Every part is a multiple of
// four floats, so each starts 16-byte aligned.
__host__ __device__ constexpr int warp_slice(int VX, int V2) {
  return VX * VX + V2 * 32 + 32 * (VX + 4) + VX * 32 + 4 * 32;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int VX, bool kLabeled>
__global__ void __launch_bounds__(kWarpBlock, VX == 32 ? 3 : VX == 16 ? 4 : 6)
rw_cg_warp_kernel(const float* __restrict__ ax_g,
                  const float* __restrict__ ay_g,
                  const int* __restrict__ nx, const int* __restrict__ ny,
                  const int* __restrict__ lx_g, const int* __restrict__ ly_g,
                  const int* __restrict__ ia, const int* __restrict__ ib,
                  float* __restrict__ out, int n_pairs, int V1, int V2,
                  float lam, int iters, float rtol, int* counter) {
  constexpr int PS = VX + 4;   // P^T row stride: lanes' rows on distinct banks
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  float* ax = smem + (threadIdx.x >> 5) * warp_slice(VX, V2);
  float* ay = ax + VX * VX;
  float* pt = ay + V2 * 32;
  float* qc = pt + 32 * PS;
  int4* cl = reinterpret_cast<int4*>(qc + VX * 32);
  // what no pair writes stays zero: Ax past V1, Ay's columns past V2
  for (int e = lane; e < VX * VX; e += 32) ax[e] = 0.f;
  for (int e = lane; e < V2 * 32; e += 32) ay[e] = 0.f;
  for (;;) {
    int pr = 0;
    if (lane == 0) pr = atomicAdd(counter, 1);
    pr = __shfl_sync(kFull, pr, 0);
    if (pr >= n_pairs) break;
    const int ga = ia[pr], gb = ib[pr];
    const int n1 = nx[ga], n2 = ny[gb];
    __syncwarp();   // every lane is done with the last pair's slice
    const float* sa = ax_g + (size_t)ga * V1 * V1;
    for (int r = 0; r < V1; ++r)
      if (lane < V1) ax[r * VX + lane] = sa[r * V1 + lane];
    const float* sb = ay_g + (size_t)gb * V2 * V2;
    for (int z = 0; z < V2; ++z)
      if (lane < V2) ay[z * 32 + lane] = sb[z * V2 + lane];
#pragma unroll
    for (int u = 0; u < VX; ++u) qc[u * 32 + lane] = 0.f;
    // common labels, ascending: (x rows xs..xe, y columns ys..ye); the
    // lane's own column keeps the rows of its label (mxs..mxe)
    int nl = 1, mxs = 0, mxe = lane < n2 ? n1 : 0;
    if (kLabeled) {
      const int lxv = lane < n1 ? lx_g[(size_t)ga * V1 + lane] : 0;
      const int lyv = lane < n2 ? ly_g[(size_t)gb * V2 + lane] : 0;
      const int prev = __shfl_up_sync(kFull, lxv, 1);
      unsigned runs = __ballot_sync(kFull,
                                    lane < n1 && (lane == 0 || prev != lxv));
      nl = mxe = 0;
      while (runs) {
        const int xs = __ffs(runs) - 1;
        runs &= runs - 1;
        const int xe = runs ? __ffs(runs) - 1 : n1;
        const int c = __shfl_sync(kFull, lxv, xs);
        const unsigned ym = __ballot_sync(kFull, lane < n2 && lyv == c);
        if (ym) {
          const int ys = __ffs(ym) - 1, ye = 32 - __clz(ym);
          if (lane == 0) cl[nl] = make_int4(xs, xe, ys, ye);
          if (lane >= ys && lane < ye) {
            mxs = xs;
            mxe = xe;
          }
          ++nl;
        }
      }
    } else if (lane == 0) {
      cl[0] = make_int4(0, n1, 0, n2);
    }
    // sum(x) = sum_k alpha_k sum(p_k): x itself is never needed, and an
    // array of it would spill at VX = 32
    float R[VX], P[VX], S[VX], sx = 0.f;
#pragma unroll
    for (int u = 0; u < VX; ++u) R[u] = P[u] = (u < n1 && lane < n2) ? 1.f : 0.f;
    float rs = (float)(n1 * n2);   // <b, b>: a sum of ones, exact in f32
    const float thresh = rtol * sqrtf(rs);
    __syncwarp();
    for (int it = 0; it < iters; ++it) {
      if (sqrtf(rs) <= thresh) break;   // frozen: the same on every lane
#pragma unroll
      for (int u = 0; u < VX; u += 4)
        *reinterpret_cast<float4*>(pt + lane * PS + u) =
            make_float4(P[u], P[u + 1], P[u + 2], P[u + 3]);
      __syncwarp();
      for (int k = 0; k < nl; ++k) {
        const int4 L = cl[k];
#pragma unroll
        for (int w = 0; w < VX; ++w) S[w] = 0.f;
        // S[w] = sum_{z in Yc} P[w][z] Ay[z][lane]
        for (int z = L.z; z < L.w; ++z) {
          const float a = ay[z * 32 + lane];
          const float4* row = reinterpret_cast<const float4*>(pt + z * PS);
#pragma unroll
          for (int w = 0; w < VX; w += 4) {
            const float4 p = row[w / 4];
            S[w] = fmaf(p.x, a, S[w]);
            S[w + 1] = fmaf(p.y, a, S[w + 1]);
            S[w + 2] = fmaf(p.z, a, S[w + 2]);
            S[w + 3] = fmaf(p.w, a, S[w + 3]);
          }
        }
        // M: only the rows of the lane's own label
#pragma unroll
        for (int w = 0; w < VX; ++w) S[w] = (w >= mxs && w < mxe) ? S[w] : 0.f;
        // Q[u][lane] = sum_w Ax[u][w] S[w] for the rows of label c
        for (int u = L.x; u < L.y; ++u) {
          const float4* row = reinterpret_cast<const float4*>(ax + u * VX);
          float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f;
#pragma unroll
          for (int w = 0; w < VX; w += 4) {
            const float4 a = row[w / 4];
            q0 = fmaf(a.x, S[w], q0);
            q1 = fmaf(a.y, S[w + 1], q1);
            q2 = fmaf(a.z, S[w + 2], q2);
            q3 = fmaf(a.w, S[w + 3], q3);
          }
          qc[u * 32 + lane] = (q0 + q1) + (q2 + q3);
        }
      }
      float pq = 0.f, ps = 0.f;
#pragma unroll
      for (int u = 0; u < VX; ++u) {
        S[u] = P[u] - lam * qc[u * 32 + lane];   // Q
        pq = fmaf(P[u], S[u], pq);
        ps += P[u];
      }
      const float denom = warp_sum(pq);
      const float alpha = denom == 0.f ? 0.f : rs / denom;
      sx = fmaf(alpha, ps, sx);
      float rr = 0.f;
#pragma unroll
      for (int u = 0; u < VX; ++u) {
        R[u] = fmaf(-alpha, S[u], R[u]);
        rr = fmaf(R[u], R[u], rr);
      }
      const float rs_new = warp_sum(rr);
      const float beta = rs == 0.f ? 0.f : rs_new / rs;
#pragma unroll
      for (int u = 0; u < VX; ++u) P[u] = fmaf(beta, P[u], R[u]);
      rs = rs_new;
      __syncwarp();   // every lane is done reading P^T
    }
    sx = warp_sum(sx);
    if (lane == 0) out[pr] = sx;
  }
}

template <bool kLabeled>
int launch_block(const float* ax, const float* ay, const int* nx,
                 const int* ny, const int* lx, const int* ly, const int* ia,
                 const int* ib, float* out, int n_pairs, int V1, int V2,
                 float lam, int iters, float rtol, float* scratch, int grid,
                 int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rw_cg_kernel<kLabeled>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  rw_cg_kernel<kLabeled><<<grid, kThreads, smem, stream>>>(
      ax, ay, nx, ny, lx, ly, ia, ib, out, n_pairs, V1, V2, lam, iters,
      rtol, scratch);
  return (int)cudaGetLastError();
}

template <int VX, bool kLabeled>
int launch_warp(const float* ax, const float* ay, const int* nx,
                const int* ny, const int* lx, const int* ly, const int* ia,
                const int* ib, float* out, int n_pairs, int V1, int V2,
                float lam, int iters, float rtol, int* counter,
                cudaStream_t stream) {
  auto kernel = rw_cg_warp_kernel<VX, kLabeled>;
  const int smem = (kWarpBlock / 32) * warp_slice(VX, V2) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)   // all of the SM's shared memory for the slices
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kWarpBlock, smem)) != cudaSuccess)
    return (int)err;
  const long long want = ((long long)n_pairs + 3) / 4;
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > want) grid = want;
  kernel<<<(int)grid, kWarpBlock, smem, stream>>>(
      ax, ay, nx, ny, lx, ly, ia, ib, out, n_pairs, V1, V2, lam, iters,
      rtol, counter);
  return (int)cudaGetLastError();
}

template <bool kLabeled>
int warp_route(const float* ax, const float* ay, const int* nx,
               const int* ny, const int* lx, const int* ly, const int* ia,
               const int* ib, float* out, int n_pairs, int V1, int V2,
               float lam, int iters, float rtol, int* counter,
               cudaStream_t st) {
  if (V1 <= 8)
    return launch_warp<8, kLabeled>(ax, ay, nx, ny, lx, ly, ia, ib, out,
                                    n_pairs, V1, V2, lam, iters, rtol,
                                    counter, st);
  if (V1 <= 16)
    return launch_warp<16, kLabeled>(ax, ay, nx, ny, lx, ly, ia, ib, out,
                                     n_pairs, V1, V2, lam, iters, rtol,
                                     counter, st);
  return launch_warp<32, kLabeled>(ax, ay, nx, ny, lx, ly, ia, ib, out,
                                   n_pairs, V1, V2, lam, iters, rtol,
                                   counter, st);
}

}  // namespace

// Graph tables ax [Gx, V1, V1], ay [Gy, V2, V2] f32; nx [Gx], ny [Gy] i32
// valid sizes (1 <= n <= V); lx [Gx, V1], ly [Gy, V2] i32 labels (both
// null: unlabeled); pairs ia, ib [n_pairs] i32 (table rows); out
// [n_pairs] f32.  The block routes: scratch null: the shared route (smem
// >= the pair's matrices); else the global route, scratch [grid, 5, V1,
// V2] f32; `grid` blocks on `stream`.  Returns cudaGetLastError().
extern "C" int grakel_rw_cg(const float* ax, const float* ay, const int* nx,
                            const int* ny, const int* lx, const int* ly,
                            const int* ia, const int* ib, float* out,
                            int n_pairs, int V1, int V2, float lam,
                            int iters, float rtol, float* scratch, int grid,
                            int smem, void* stream) {
  if (n_pairs <= 0 || grid <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (lx != nullptr)
    return launch_block<true>(ax, ay, nx, ny, lx, ly, ia, ib, out, n_pairs,
                              V1, V2, lam, iters, rtol, scratch, grid, smem,
                              st);
  return launch_block<false>(ax, ay, nx, ny, lx, ly, ia, ib, out, n_pairs,
                             V1, V2, lam, iters, rtol, scratch, grid, smem,
                             st);
}

// The warp route (V1, V2 <= 32), the same tables and pairs; each graph's
// labels ascending over its valid vertices; counter: one zeroed i32.
// Launches the resident blocks of four warps (no more than the pairs
// need) on `stream`; returns cudaGetLastError().
extern "C" int grakel_rw_cg_warp(const float* ax, const float* ay,
                                 const int* nx, const int* ny, const int* lx,
                                 const int* ly, const int* ia, const int* ib,
                                 float* out, int n_pairs, int V1, int V2,
                                 float lam, int iters, float rtol,
                                 int* counter, void* stream) {
  if (n_pairs <= 0) return (int)cudaGetLastError();
  if (V1 < 1 || V1 > 32 || V2 < 1 || V2 > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (lx != nullptr)
    return warp_route<true>(ax, ay, nx, ny, lx, ly, ia, ib, out, n_pairs, V1,
                            V2, lam, iters, rtol, counter, st);
  return warp_route<false>(ax, ay, nx, ny, lx, ly, ia, ib, out, n_pairs, V1,
                           V2, lam, iters, rtol, counter, st);
}
