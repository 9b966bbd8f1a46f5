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
//   _proj_psd (lovasz_sdp.py:44), which XLA runs batched.  Cyclic
//   two-sided Jacobi on a matrix of up to 128 rows (read from its lower
//   triangle, as eigh's UPLO = "L" does) and its eigenvector rows in
//   shared memory: a warp a matrix up to 16 rows (four a block, no
//   barrier), a block of 128 threads at 32 and of 256 past.  Each sweep
//   is V - 1 rounds of V / 2 disjoint rotations (the circle method: row 0
//   fixed, the others turning), a round two barriers: a thread a pair
//   computes its angle (NR's jacobi: negligible rotations skipped, no
//   division by a vanishing entry) and rotates its pair's own 2 x 2 block
//   in closed form; then each thread rotates 2 x 2 blocks of two pairs,
//   both sides at once, and their mirrors (the four entries read once
//   give all eight: the matrix stays exactly symmetric), and its share of
//   the eigenvector rows, in place.  Rows are padded by two floats: a
//   round's pairs (p, q) share one p + q, so with one float (bank p + q)
//   a warp's block entries would all fall in one bank.  The eigenvector
//   rows turn in the rotation's tau form (NR), whose small angles do not
//   inflate them.  Sweeps stop once the off-diagonal mass is at most V (4
//   eps)^2 of the total (the floor one sweep's rounding leaves), or after
//   16.  Given a start basis U0 (the step before's eigenvectors: the DR
//   reflection moves little from one step to the next), the sweeps run
//   on U0^T M U0, formed by two register-tiled products (the first into
//   the output's place in device memory), and rotate U0, so a nearly
//   diagonal start leaves a sweep or two.  Zero padded rows stay exactly
//   zero and their eigenvectors exact unit vectors.  Writes w (the
//   diagonal, unsorted), the eigenvectors as rows (the layout K12 reads
//   and the next call's U0) and, if asked, each matrix's sweeps.
//   Bound on an H100: operations, about 6 V^3 flops a sweep a matrix
//   (2 V^3 more to form U0^T M U0); this design is held by shared-memory
//   traffic, 6 V^2 accesses a round, and two barriers a round.
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

// out = X Y (kTrans: X Y^T) of V x V matrices with rows of ldx, ldy and
// ldo floats, each thread an R x R tile of rows kt + a S and columns lt +
// b S (S = V / R): R + R loads a step feed R^2 fused multiply-adds, and a
// warp's loads are broadcasts or distinct banks.
template <int R, bool kTrans>
__device__ __forceinline__ void tile_product(const float* X, int ldx,
                                             const float* Y, int ldy,
                                             float* out, int ldo, int V,
                                             int tid, int T) {
  const int S = V / R;
  for (int t = tid; t < S * S; t += T) {
    const int kt = t / S, lt = t - kt * S;
    float acc[R][R];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) acc[a][b] = 0.f;
    for (int i = 0; i < V; ++i) {
      float x[R], y[R];
#pragma unroll
      for (int a = 0; a < R; ++a) x[a] = X[(kt + a * S) * ldx + i];
#pragma unroll
      for (int b = 0; b < R; ++b)
        y[b] = kTrans ? Y[(lt + b * S) * ldy + i] : Y[i * ldy + lt + b * S];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b)
        out[(kt + a * S) * ldo + lt + b * S] = acc[a][b];
  }
}

// Floats of shared memory a matrix: the matrix and its eigenvector rows
// (V x (V + 2) each), the round's rotations (c, s, tau, t and the pair's
// rows p | q << 16, N = V / 2 of each) and the reduction's partial sums,
// rounded up to whole float4s.
__host__ __device__ __forceinline__ size_t jacobi_floats(int V, int nw) {
  const size_t f = 2 * (size_t)V * (V + 2) + 5 * (size_t)(V / 2) + 2 * nw;
  return (f + 3) & ~(size_t)3;
}

// K14.  kWarp: a warp a matrix, four a block (V <= 16); otherwise a block
// a matrix (128 threads at V = 32, 256 past: a multiple of V / 2).
template <bool kWarp>
__global__ void __launch_bounds__(kWarp ? 128 : 256)
lovasz_jacobi_eigh(const float* __restrict__ M, const float* __restrict__ U0,
                   float* __restrict__ w, float* Ut,
                   int* __restrict__ sweeps_out, int B, int V,
                   int max_sweeps, float tol2) {
  extern __shared__ float4 sm4[];
  // rows padded by two floats: the circle method's pairs (p, q) of a round
  // have one p + q, so with one float of padding (bank p + q) their
  // blocks' entries would all fall in one bank; with two (bank 2 p + q)
  // a warp's accesses spread over the banks
  const int ld = V + 2, N = V / 2, lane = threadIdx.x & 31;
  const int lv = __ffs(V) - 1;          // V is a power of two
  const int T = kWarp ? 32 : blockDim.x;
  const int tid = kWarp ? lane : threadIdx.x;
  const int nw = T >> 5;                // the matrix's warps
  const int g = kWarp ? blockIdx.x * 4 + (threadIdx.x >> 5) : blockIdx.x;
  if (g >= B) return;                   // whole warps (kWarp) or blocks
  float* A = reinterpret_cast<float*>(sm4)
             + (kWarp ? (threadIdx.x >> 5) * jacobi_floats(V, 1) : 0);
  float* Q = A + (size_t)V * ld;        // eigenvector rows
  float4* rot = reinterpret_cast<float4*>(Q + (size_t)V * ld);  // c s tau t
  int* pq = reinterpret_cast<int*>(rot + N);
  float* red = reinterpret_cast<float*>(pq + N);
  auto sync = [] {
    if (kWarp) __syncwarp(); else __syncthreads();
  };

  const float* Mg = M + (size_t)g * V * V;
  const float* Ug = U0 ? U0 + (size_t)g * V * V : nullptr;
  float* Tg = Ut + (size_t)g * V * V;   // the output, scratch till the end
  for (int e = tid; e < V * V; e += T) {
    const int i = e >> lv, j = e & (V - 1);
    A[i * ld + j] = i >= j ? Mg[e] : Mg[(size_t)j * V + i];
    Q[i * ld + j] = Ug ? Ug[e] : (i == j ? 1.f : 0.f);
  }
  sync();
  if (Ug) {
    // B = U0^T M U0 with U0's columns the start rows Q: Q M into the
    // output's place in device memory, then (Q M) Q^T into A, its lower
    // triangle mirrored, so the sweeps start exactly symmetric
    if (V >= 4) {
      tile_product<4, false>(Q, ld, A, ld, Tg, V, V, tid, T);
      sync();
      tile_product<4, true>(Tg, V, Q, ld, A, ld, V, tid, T);
    } else {
      tile_product<2, false>(Q, ld, A, ld, Tg, V, V, tid, T);
      sync();
      tile_product<2, true>(Tg, V, Q, ld, A, ld, V, tid, T);
    }
    sync();
    for (int e = tid; e < V * V; e += T) {
      const int i = e >> lv, j = e & (V - 1);
      if (i < j) A[i * ld + j] = A[j * ld + i];
    }
    sync();
  }

  const int ln = __ffs(N) - 1;
  int sweep = 0;
  for (; sweep < max_sweeps; ++sweep) {
    float off = 0.f, all = 0.f;
    for (int e = tid; e < V * V; e += T) {
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
    if (!kWarp) {
      if (lane == 0) {
        red[2 * (tid >> 5)] = off;
        red[2 * (tid >> 5) + 1] = all;
      }
      __syncthreads();
      off = 0.f;
      all = 0.f;
      for (int k = 0; k < nw; ++k) {
        off += red[2 * k];
        all += red[2 * k + 1];
      }
      __syncthreads();
    }
    if (off <= tol2 * all) break;       // the matrix's threads decide alike

    for (int r = 0; r < V - 1; ++r) {
      // the round's N rotations and their rows, a thread a pair, which
      // also rotates its pair's own 2 x 2 block in closed form, the (p, q)
      // entry zeroed (no other thread reads those four entries this round).
      // NR's jacobi: a rotation below the rounding of both diagonal
      // entries is skipped; t = apq / h where theta's square would lose
      // apq, so no division meets a vanishing divisor
      for (int i = tid; i < N; i += T) {
        int p, q;
        round_pair(r, i, V, p, q);
        const float apq = A[p * ld + q], app = A[p * ld + p];
        const float aqq = A[q * ld + q], gq = 100.f * fabsf(apq);
        float c = 1.f, sn = 0.f, tau = 0.f, t = 0.f;
        if (fabsf(app) + gq != fabsf(app) || fabsf(aqq) + gq != fabsf(aqq)) {
          const float h = aqq - app;
          if (fabsf(h) + gq == fabsf(h)) {
            t = apq / h;
          } else {
            const float th = 0.5f * h / apq;
            t = copysignf(1.f, th) / (fabsf(th) + sqrtf(th * th + 1.f));
          }
          c = 1.f / sqrtf(t * t + 1.f);
          sn = t * c;
          tau = sn / (1.f + c);
        }
        rot[i] = make_float4(c, sn, tau, t);
        pq[i] = p | (q << 16);
        A[p * ld + p] = app - t * apq;
        A[q * ld + q] = aqq + t * apq;
        A[p * ld + q] = 0.f;
        A[q * ld + p] = 0.f;
      }
      sync();
      // A <- J^T A J off the pairs' own blocks, in place: a 2 x 2 block of
      // pairs (i, j = i + d mod N), d = 1..N/2, and its mirror a thread
      // (the block's entries, read once, give both; at d = N/2 only i <
      // N/2, so each unordered pair of pairs once).  T is a multiple of
      // N, so a thread's i, and pair i's rotation, stay put
      {
        const int i = tid & (N - 1);
        const int pqi = pq[i], pi = pqi & 0xffff, qi = pqi >> 16;
        const float4 ri = rot[i];
        for (int e = tid; e < N * (N / 2); e += T) {
          const int d = 1 + (e >> ln);
          if (2 * d == N && 2 * i >= N) continue;
          const int j = (i + d) & (N - 1);
          const int pqj = pq[j], pj = pqj & 0xffff, qj = pqj >> 16;
          const float4 rj = rot[j];
          const float a = A[pi * ld + pj], b = A[pi * ld + qj];
          const float c = A[qi * ld + pj], dd = A[qi * ld + qj];
          const float a1 = rj.x * a - rj.y * b, b1 = rj.y * a + rj.x * b;
          const float c1 = rj.x * c - rj.y * dd, d1 = rj.y * c + rj.x * dd;
          const float a2 = ri.x * a1 - ri.y * c1, b2 = ri.x * b1 - ri.y * d1;
          const float c2 = ri.y * a1 + ri.x * c1, d2 = ri.y * b1 + ri.x * d1;
          A[pi * ld + pj] = a2;
          A[pi * ld + qj] = b2;
          A[qi * ld + pj] = c2;
          A[qi * ld + qj] = d2;
          A[pj * ld + pi] = a2;
          A[qj * ld + pi] = b2;
          A[pj * ld + qi] = c2;
          A[qj * ld + qi] = d2;
        }
      }
      // the eigenvector rows p, q of each pair: Q <- J^T Q, in the
      // rotation's tau form (p' = p - s (q + tau p), q' = q + s (p - tau
      // q)), whose small angles do not inflate the rows: U goes through
      // hundreds of calls' rotations and must stay orthogonal.  A thread
      // takes one pair's columns col0, col0 + 32, ...
      {
        const int lc = V < 32 ? lv : 5, C = 1 << lc;
        for (int e = tid; e < N * C; e += T) {
          const int i = e >> lc, col0 = e & (C - 1);
          const int pqi = pq[i];
          const float4 ri = rot[i];
          float* up = Q + (pqi & 0xffff) * ld;
          float* uq = Q + (pqi >> 16) * ld;
          for (int col = col0; col < V; col += 32) {
            const float x = up[col], y = uq[col];
            up[col] = fmaf(-ri.y, fmaf(ri.z, x, y), x);
            uq[col] = fmaf(ri.y, fmaf(-ri.z, y, x), y);
          }
        }
      }
      sync();
    }
  }
  for (int e = tid; e < V * V; e += T) {
    const int i = e >> lv, j = e & (V - 1);
    Tg[e] = Q[i * ld + j];
  }
  for (int k = tid; k < V; k += T) w[(size_t)g * V + k] = A[k * ld + k];
  if (sweeps_out && tid == 0) sweeps_out[g] = sweep;
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
// the rounding floor of a sweep) or `max_sweeps`.  U0 (null: the
// identity) is a start basis as rows [B, V, V], an earlier call's Ut: the
// sweeps run on U0 M U0^T and rotate U0.  sweeps (null: not written)
// takes each matrix's sweep count, int32 [B].  Launches ceil(B / 4)
// blocks of four warps (V <= 16) or B blocks of 128 (V = 32) or 256
// threads on `stream`; returns cudaGetLastError().
extern "C" int grakel_lovasz_jacobi_eigh(const float* M, const float* U0,
                                         float* w, float* Ut, int* sweeps,
                                         int B, int V, int max_sweeps,
                                         void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (V < 2 || V > 128 || (V & (V - 1))) return (int)cudaErrorInvalidValue;
  const bool warp = V <= 16;
  const int threads = V <= 32 ? 128 : 256;
  const size_t smem = (warp ? 4 * jacobi_floats(V, 1)
                            : jacobi_floats(V, threads / 32)) * sizeof(float);
  const float eps4 = 4.f * 1.1920929e-7f;
  const float tol2 = (float)V * eps4 * eps4;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (warp) {
    if ((e = prepare(lovasz_jacobi_eigh<true>, smem)) != cudaSuccess)
      return (int)e;
    lovasz_jacobi_eigh<true><<<(B + 3) / 4, 128, smem, st>>>(
        M, U0, w, Ut, sweeps, B, V, max_sweeps, tol2);
  } else {
    if ((e = prepare(lovasz_jacobi_eigh<false>, smem)) != cudaSuccess)
      return (int)e;
    lovasz_jacobi_eigh<false><<<B, threads, smem, st>>>(
        M, U0, w, Ut, sweeps, B, V, max_sweeps, tol2);
  }
  return (int)cudaGetLastError();
}
