// K12, K13 and K14: LovaszTheta's Douglas-Rachford step, its minimum
// enclosing cones and the DR loop's eigendecomposition.
//
// * K12 (lovasz_dr_step) replaces the DR body of the XLA program
//   grakel_tpu/ops/lovasz_sdp.py _theta_impl (:50; proj_affine :58-62
//   and the body :64-66 around _proj_psd :43), apart from the eigh:
//   given (w, U) = eigh(R) of the reflection R = 2X - Y, it rebuilds
//   Z = U diag(max(w, 0)) U^T, steps Y <- Y + Z - X, projects X <- the
//   support of Y + step J (edges and the valid diagonal) with its
//   diagonal shifted by (1 - trace) / n, and writes the next R = 2X - Y.
//   Y and X are updated in place.  One block a graph, one launch an
//   iteration (300 a solve, each after one batched torch.linalg.eigh).
//   The eigenvectors come as rows, Ut = U^T (the layout torch.linalg.eigh
//   leaves them in on a card: its column-major U is a contiguous U^T).
//   A thread owns a strided set of the V^2 entries: pass 1 forms each
//   entry Z[i, j] = sum_k Ut[k, i] max(w_k, 0) Ut[k, j] (a warp's
//   threads read one Ut[k, i] and 32 consecutive Ut[k, j]: a broadcast
//   and one conflict-free row, from shared memory on route "shared",
//   V <= 128, staged once, or where they lie on route "global"), steps Y
//   and sums the new diagonal; the block's trace follows; pass 2 writes X
//   and R.
//   Bound on an H100: operations at V = 64-128 (2 V^3 flops a graph
//   against 7 V^2 floats moved), bytes below.  This simple design reads
//   U from shared memory twice a multiply-add and reaches neither.
// * K13 (lovasz_min_cone) replaces the XLA program _min_cone_jit of
//   grakel_tpu/kernels/lovasz_theta.py (:48-81), which the JAX package
//   pins to XLA-CPU: for each subset A [d, m] (the labelling columns of
//   one sampled vertex subset, padded by repeating its first column),
//   `iters` (400) Badoiu-Clarkson steps c <- c + (far - c) / (k + 2)
//   from the first column, far the first column farthest from c, then
//   the smallest cosine of a column with c / |c|.  A warp a subset, four
//   a block, every step in one launch.  Lane j (< m) sums column j's
//   squared distance over i in order with a fused multiply-add a term
//   (the order of the plain version, ops/lovasz_sdp.py _sq_dist: the
//   iteration meets exact ties, so the far column is decided by the last
//   bit of the distances); a butterfly of shuffles takes the argmax,
//   larger value first and the smaller index on a tie (JAX's argmax);
//   the lanes then step the centre, a stride of rows each.  The subset's
//   columns and the centre are in the warp's slice of shared memory on
//   route "shared" (four warps' d (m + 1) floats within the budget); on
//   route "global" the columns are read where they lie.
//   Bound on an H100: operations, 3 d m flops a step; the distance loop
//   keeps m of the warp's 32 lanes busy and is a chain of d dependent
//   fused multiply-adds a step, so latency, not the FMA rate, sets its
//   time.
// * K14 (lovasz_jacobi_eigh) is the DR loop's eigendecomposition on a
//   card, where torch.linalg.eigh has no batched route past 32 rows (it
//   runs cuSOLVER's syevj a matrix at a time: 1.43 s a call for 1818
//   64 x 64 matrices on an H100 80GB HBM3, chip_smoke.py) and can report
//   non-convergence, which raises.  It replaces the jnp.linalg.eigh inside
//   _proj_psd (lovasz_sdp.py:44), which XLA runs batched.  A block a
//   matrix of up to 128 rows: the matrix (read from its lower triangle,
//   as eigh's UPLO = "L" does) and the eigenvector rows in shared memory,
//   rows padded by one float; cyclic two-sided Jacobi, each sweep V - 1
//   rounds of V / 2 disjoint rotations (the circle method: row 0 fixed,
//   the others turning), a round's rotation angles from the NR formula
//   (t = sgn(theta) / (|theta| + sqrt(theta^2 + 1))), then every pair's
//   two columns, then its two rows and its two eigenvector rows, in
//   parallel; sweeps stop once the off-diagonal mass is at most V (4
//   eps)^2 of the total (the floor one sweep's rounding leaves), or after
//   16.  Writes w (the diagonal, unsorted) and the eigenvectors as rows,
//   the layout K12 reads.
//   Bound on an H100: operations, about 6 V^3 flops a sweep a matrix,
//   and a chain of 3 (V - 1) barriers a sweep.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kRed = 32;
constexpr int kConeWarps = 4;

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int nw = blockDim.x >> 5;
  if (nw == 1) return v;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w];
  return s;
}

// One block an SM as the floor: with the default bound ptxas packed the
// global route into 32 registers and spilled one.
template <bool kShared>
__global__ void __launch_bounds__(256, 1)
lovasz_dr_step(const float* __restrict__ E, const int* __restrict__ nsz,
               float* __restrict__ Y, float* __restrict__ X,
               const float* __restrict__ w, const float* __restrict__ Ut,
               float* __restrict__ R, int V, float step) {
  extern __shared__ float sm[];
  const int g = blockIdx.x, T = blockDim.x;
  const int n = nsz[g];
  const size_t base = (size_t)g * V * V;
  float* wp = sm;            // max(w, 0)
  float* red = sm + V;
  const float* Ub = Ut + base;
  if (kShared) {
    float* us = sm + V + kRed;
    for (int e = threadIdx.x; e < V * V; e += T) us[e] = Ub[e];
    Ub = us;
  }
  for (int k = threadIdx.x; k < V; k += T)
    wp[k] = fmaxf(w[(size_t)g * V + k], 0.f);
  __syncthreads();

  // pass 1: Z, Y' = Y + Z - X, and the diagonal of Y' + step J
  float trp = 0.f;
  for (int e = threadIdx.x; e < V * V; e += T) {
    const int i = e / V, j = e % V;
    const float* ui = Ub + i;
    const float* uj = Ub + j;
    float z = 0.f;
    for (int k = 0; k < V; ++k, ui += V, uj += V)
      z = fmaf(*ui * wp[k], *uj, z);
    const float y = Y[base + e] + z - X[base + e];
    Y[base + e] = y;
    if (i == j && i < n) trp += y + step;
  }
  const float shift = (1.f - block_sum(trp, red)) / fmaxf((float)n, 1.f);

  // pass 2: X' = proj_affine(Y' + step J), R' = 2 X' - Y'
  for (int e = threadIdx.x; e < V * V; e += T) {
    const int i = e / V, j = e % V;
    const bool inside = i < n && j < n;
    const bool diag = inside && i == j;
    const float y = Y[base + e];
    float x = (E[base + e] > 0.f || diag) ? y + (inside ? step : 0.f) : 0.f;
    if (diag) x += shift;
    X[base + e] = x;
    R[base + e] = 2.f * x - y;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(32 * kConeWarps)
lovasz_min_cone(const float* __restrict__ A, float* __restrict__ out, int S,
                int d, int m, int iters) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int s = blockIdx.x * kConeWarps + wib;
  if (s >= S) return;
  const size_t per = (size_t)d * m;
  const float* As = A + (size_t)s * per;
  float* c = sm + (size_t)wib * (kShared ? per + d : d);
  if (kShared) {
    float* a = c + d;
    for (size_t e = lane; e < per; e += 32) a[e] = As[e];
    As = a;
    __syncwarp();
  }
  for (int i = lane; i < d; i += 32) c[i] = As[(size_t)i * m];
  __syncwarp();

  for (int k = 0; k < iters; ++k) {
    float d2 = -INFINITY;
    if (lane < m) {
      d2 = 0.f;
      for (int i = 0; i < d; ++i) {
        const float df = As[(size_t)i * m + lane] - c[i];
        d2 = __fmaf_rn(df, df, d2);
      }
    }
    __syncwarp();   // every lane has read c before any lane steps it
    float best = d2;
    int arg = lane;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, arg, o);
      if (ov > best || (ov == best && oi < arg)) {
        best = ov;
        arg = oi;
      }
    }
    const float den = (float)(k + 2);
    for (int i = lane; i < d; i += 32)
      c[i] = c[i] + (As[(size_t)i * m + arg] - c[i]) / den;
    __syncwarp();
  }

  float q = 0.f;
  for (int i = lane; i < d; i += 32) q += c[i] * c[i];
#pragma unroll
  for (int o = 16; o; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  const float nc = sqrtf(q);
  for (int i = lane; i < d; i += 32)
    c[i] = nc > 0.f ? c[i] / fmaxf(nc, 1e-30f) : 0.f;
  __syncwarp();
  float dot = INFINITY;
  if (lane < m) {
    dot = 0.f;
    for (int i = 0; i < d; ++i) dot = fmaf(As[(size_t)i * m + lane], c[i], dot);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    dot = fminf(dot, __shfl_xor_sync(0xffffffffu, dot, o));
  if (lane == 0) out[s] = dot;
}

// Pair i of round r of the circle method over V (even) rows: row 0 is
// fixed, rows 1..V-1 turn (r < V - 1, i < V / 2: no division needed).
__device__ __forceinline__ void round_pair(int r, int i, int V, int& p,
                                           int& q) {
  const int m = V - 1;
  if (i == 0) {
    p = 0;
    q = 1 + r;
  } else {
    int a = r + i, b = r - i + m;
    if (a >= m) a -= m;
    if (b >= m) b -= m;
    p = 1 + a;
    q = 1 + b;
  }
}

__global__ void __launch_bounds__(256)
lovasz_jacobi_eigh(const float* __restrict__ M, float* __restrict__ w,
                   float* __restrict__ Ut, int V, int max_sweeps,
                   float tol2) {
  extern __shared__ float sm[];
  const int g = blockIdx.x, T = blockDim.x, ld = V + 1, half = V / 2;
  const int lv = __ffs(V) - 1;          // V is a power of two
  float* A = sm;                        // V x (V + 1)
  float* Q = A + (size_t)V * ld;        // eigenvector rows, V x (V + 1)
  float* cs = Q + (size_t)V * ld;       // c, s of the round's pairs
  int* pq = reinterpret_cast<int*>(cs + V);   // p, q of the round's pairs
  float* red = cs + 2 * V;
  const float* Mg = M + (size_t)g * V * V;
  for (int e = threadIdx.x; e < V * V; e += T) {
    const int i = e >> lv, j = e & (V - 1);
    A[i * ld + j] = i >= j ? Mg[e] : Mg[(size_t)j * V + i];
    Q[i * ld + j] = i == j ? 1.f : 0.f;
  }
  __syncthreads();

  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    float off = 0.f, all = 0.f;
    for (int e = threadIdx.x; e < V * V; e += T) {
      const int i = e >> lv, j = e & (V - 1);
      const float a = A[i * ld + j];
      all += a * a;
      if (i != j) off += a * a;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      off += __shfl_xor_sync(0xffffffffu, off, o);
      all += __shfl_xor_sync(0xffffffffu, all, o);
    }
    if ((threadIdx.x & 31) == 0) {
      red[2 * (threadIdx.x >> 5)] = off;
      red[2 * (threadIdx.x >> 5) + 1] = all;
    }
    __syncthreads();
    off = 0.f;
    all = 0.f;
    for (int k = 0; k < (T >> 5); ++k) {
      off += red[2 * k];
      all += red[2 * k + 1];
    }
    __syncthreads();
    if (off <= tol2 * all) break;       // every thread decides alike

    for (int r = 0; r < V - 1; ++r) {
      for (int i = threadIdx.x; i < half; i += T) {
        int p, q;
        round_pair(r, i, V, p, q);
        const float apq = A[p * ld + q];
        float c = 1.f, sn = 0.f;
        if (apq != 0.f) {
          const float th = (A[q * ld + q] - A[p * ld + p]) / (2.f * apq);
          const float t = fabsf(th) > 1e18f
                              ? 0.5f / th
                              : copysignf(1.f, th)
                                    / (fabsf(th) + sqrtf(th * th + 1.f));
          c = rsqrtf(t * t + 1.f);
          sn = t * c;
        }
        cs[2 * i] = c;
        cs[2 * i + 1] = sn;
        pq[2 * i] = p;
        pq[2 * i + 1] = q;
      }
      __syncthreads();
      // columns p, q of every row: A <- A J
      for (int e = threadIdx.x; e < half * V; e += T) {
        const int i = e >> lv, row = e & (V - 1);
        const int p = pq[2 * i], q = pq[2 * i + 1];
        const float c = cs[2 * i], sn = cs[2 * i + 1];
        const float ap = A[row * ld + p], aq = A[row * ld + q];
        A[row * ld + p] = c * ap - sn * aq;
        A[row * ld + q] = sn * ap + c * aq;
      }
      __syncthreads();
      // rows p, q of A and of the eigenvector rows: A <- J^T A
      for (int e = threadIdx.x; e < half * V; e += T) {
        const int i = e >> lv, col = e & (V - 1);
        const int p = pq[2 * i], q = pq[2 * i + 1];
        const float c = cs[2 * i], sn = cs[2 * i + 1];
        const float ap = A[p * ld + col], aq = A[q * ld + col];
        A[p * ld + col] = c * ap - sn * aq;
        A[q * ld + col] = sn * ap + c * aq;
        const float up = Q[p * ld + col], uq = Q[q * ld + col];
        Q[p * ld + col] = c * up - sn * uq;
        Q[q * ld + col] = sn * up + c * uq;
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < V * V; e += T) {
    const int i = e >> lv, j = e & (V - 1);
    Ut[(size_t)g * V * V + e] = Q[i * ld + j];
  }
  for (int k = threadIdx.x; k < V; k += T)
    w[(size_t)g * V + k] = A[k * ld + k];
}

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

}  // namespace

// K12: one DR step of B graphs padded to V (E, Y, X, R [B, V, V], the
// eigenvectors as rows Ut [B, V, V], w [B, V] f32, sizes n [B] int32); Y
// and X in place, R written; `shared` picks the route.  Launches B blocks on `stream`; returns
// cudaGetLastError().
extern "C" int grakel_lovasz_dr_step(const float* E, const int* n, float* Y,
                                     float* X, const float* w,
                                     const float* Ut, float* R, int B, int V,
                                     float step, int shared, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (V < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = ((shared ? (size_t)V * V : 0) + V + kRed)
                      * sizeof(float);
  const int threads = V * V >= 256 ? 256 : ((V * V + 31) / 32) * 32;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (shared) {
    if ((e = prepare(lovasz_dr_step<true>, smem)) != cudaSuccess) return (int)e;
    lovasz_dr_step<true><<<B, threads, smem, st>>>(E, n, Y, X, w, Ut, R, V,
                                                   step);
  } else {
    if ((e = prepare(lovasz_dr_step<false>, smem)) != cudaSuccess)
      return (int)e;
    lovasz_dr_step<false><<<B, threads, smem, st>>>(E, n, Y, X, w, Ut, R, V,
                                                    step);
  }
  return (int)cudaGetLastError();
}

// K13: t [S] of the subsets A [S, d, m] f32 (1 <= m <= 32) after `iters`
// Badoiu-Clarkson steps; `shared` picks the route.  Launches ceil(S / 4)
// blocks of four warps on `stream`; returns cudaGetLastError().
extern "C" int grakel_lovasz_min_cone(const float* A, float* out, int S,
                                      int d, int m, int iters, int shared,
                                      void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  if (d < 1 || m < 1 || m > 32 || iters < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = kConeWarps * ((shared ? (size_t)d * m : 0) + d)
                      * sizeof(float);
  const int blocks = (S + kConeWarps - 1) / kConeWarps;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (shared) {
    if ((e = prepare(lovasz_min_cone<true>, smem)) != cudaSuccess)
      return (int)e;
    lovasz_min_cone<true><<<blocks, 32 * kConeWarps, smem, st>>>(A, out, S, d,
                                                                 m, iters);
  } else {
    if ((e = prepare(lovasz_min_cone<false>, smem)) != cudaSuccess)
      return (int)e;
    lovasz_min_cone<false><<<blocks, 32 * kConeWarps, smem, st>>>(A, out, S,
                                                                  d, m, iters);
  }
  return (int)cudaGetLastError();
}

// K14: the eigenvalues w [B, V] (unsorted) and eigenvectors as rows Ut
// [B, V, V] of B symmetric f32 matrices M [B, V, V] (their lower
// triangles read), V a power of two, 2 <= V <= 128: Jacobi sweeps until
// the off-diagonal mass is at most V (4 eps)^2 of the total (eps = 2^-23:
// the rounding floor of a sweep) or `max_sweeps`.  Launches B blocks on
// `stream`; returns cudaGetLastError().
extern "C" int grakel_lovasz_jacobi_eigh(const float* M, float* w, float* Ut,
                                         int B, int V, int max_sweeps,
                                         void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (V < 2 || V > 128 || (V & (V - 1))) return (int)cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)V * (V + 1) + 2 * V + 16) * sizeof(float);
  const float eps4 = 4.f * 1.1920929e-7f;
  cudaError_t e;
  if ((e = prepare(lovasz_jacobi_eigh, smem)) != cudaSuccess) return (int)e;
  lovasz_jacobi_eigh<<<B, 256, smem, (cudaStream_t)stream>>>(
      M, w, Ut, V, max_sweeps, (float)V * eps4 * eps4);
  return (int)cudaGetLastError();
}
