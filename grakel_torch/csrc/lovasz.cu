// K12, K13 and K14: LovaszTheta's Douglas-Rachford step, its minimum
// enclosing cones and the DR loop's eigendecomposition.
//
// * K12 (lovasz_dr_step_*) replaces the DR body of the XLA program
//   grakel_tpu/ops/lovasz_sdp.py _theta_impl (:50; proj_affine :58-62
//   and the body :64-66 around _proj_psd :43), apart from the eigh:
//   given (w, U) = eigh(R) of the reflection R = 2X - Y, it rebuilds
//   Z = U diag(max(w, 0)) U^T, steps Y <- Y + Z - X, projects X <- the
//   support of Y + step J (edges and the valid diagonal) with its
//   diagonal shifted by (1 - trace) / n, and writes the next R = 2X - Y.
//   Y and X are updated in place; the edges come as bit rows (bit j % 32
//   of word j / 32 of row i, packed once a solve), V^2 / 8 bytes a graph
//   where a float a pair took 4 V^2.  One launch an iteration (300 a
//   solve, each after one K14).  The eigenvectors come as rows, Ut = U^T
//   (the layout K14 writes).  Each entry is summed as a thread an entry
//   summed it: Z[i, j] = fmaf(Ut[k, i] max(w_k, 0), Ut[k, j], z) in k
//   order from 0, so Z keeps its bits.
//   Bound on an H100: bytes, 6 V^2 + V^2 / 8 floats a graph (7 V^2 with
//   the edges as floats), against 2 V^3 flops.
//   Route "tile" (V a power of two, 4 <= V <= 128): each thread owns an
//   R x R tile of Z, Y and X (rows and columns tR .. tR + R - 1), a graph
//   takes (V / R)^2 threads and a block G graphs (128 threads up to V =
//   32: 32, 8, 8 and 2 graphs at V = 4, 8, 16, 32; a graph of 256 at 64
//   and 128).  The graph's Ut is staged in shared memory by cp.async
//   while its Y, X and edge tiles load into registers (at R = 8, V = 128,
//   they load after the product: 64 + 64 more registers would spill);
//   then a step of k reads R + R floats (two vector loads, broadcasts or
//   consecutive) and the clipped eigenvalue for R^2 fused multiply-adds.
//   Y' stays in registers across the graph's trace reduction (shuffles
//   within a warp, shared memory across warps), and Y', X' and R' are
//   written once, as vectors.  Route "global" (any V up to 4096, the only
//   one past 128): a block of 256 threads a graph walks 4 x 4 tiles of
//   the output, reading Ut where it lies, writes Y', and after the trace
//   writes X' and R' from Y' read back.
// * K13 (lovasz_min_cone) replaces the XLA program _min_cone_jit of
//   grakel_tpu/kernels/lovasz_theta.py (:48-81), which the JAX package
//   pins to XLA-CPU: for each subset A [d, m] (the labelling columns of
//   one sampled vertex subset, padded by repeating its first column),
//   `iters` (400) Badoiu-Clarkson steps c <- c + (far - c) / (k + 2)
//   from the first column, far the first column farthest from c, then
//   the smallest cosine of a column with c / |c|.  Every step in one
//   launch.  A subset takes a group of g lanes, g the next power of two
//   at or above m (32 / g subsets a warp: 4 at the path's m = 8), four
//   warps a block.  Lane j (< m) sums column j's squared distance over i
//   in order with one fused multiply-add a term (the order of the plain
//   version, ops/lovasz_sdp.py _sq_dist: the iteration meets exact ties,
//   so the far column is decided by the last bit of the distances); a
//   butterfly of shuffles within the group (xor offsets below g) takes
//   the argmax, larger value first and the smaller index on a tie (JAX's
//   argmax), lanes m .. g - 1 carrying -inf; then the group's lanes step
//   the centre, a stride of g rows each, by the IEEE quotient (`c + (far
//   - c) / (k + 2)`, as XLA-CPU divides; cone_quotient takes it without
//   the division's slow-path call, from the f32 reciprocal of k + 2 and
//   two fused corrections, and cone_quotient_check holds it equal to
//   __fdiv_rn on every f32 in [-2, 2]).  The centre lies in
//   the group's slot of shared memory, padded with zero rows to a
//   multiple of four floats and read four at a time.  Routes: "register"
//   (d <= 128): each lane holds its column in registers, padded with
//   zero rows to kD (8, 16, ..., 64, 96, 128; fmaf(0, 0, acc) leaves the
//   sum as it is), and the group's columns are staged in its slot, where
//   the centre update reads the far column; "shared": the columns are
//   read from the slot; "global": where they lie in device memory (g
//   grows till the centres fit a block).
//   Bound on an H100: operations, 3 d m + 3 d flops a step a subset; the
//   distance loop is a chain of d dependent fused multiply-adds, and the
//   kernel is held by its instruction rate and shared-memory reads (four
//   subsets a warp share each instruction of the distance loop, which a
//   warp a subset ran for one, 24 of 32 lanes idle).
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
               "memory");
}

// R consecutive floats (R = 2, 4, 8; aligned to R floats, at most 16
// bytes) as vector accesses
template <int R>
__device__ __forceinline__ void load_row(const float* p, float (&v)[R]) {
  if constexpr (R == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  }
}

template <int R>
__device__ __forceinline__ void store_row(float* p, const float (&v)[R]) {
  if constexpr (R == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < R / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = make_float4(
          v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// X' = proj_affine(Y' + step J) at entry (i, j) of a graph of n vertices:
// an edge or the valid diagonal keeps y (plus step inside the n x n
// block), the diagonal also takes the trace's shift; zero elsewhere.
__device__ __forceinline__ float dr_project(float y, bool edge, int i, int j,
                                           int n, float step, float shift) {
  const bool inside = i < n && j < n;
  const bool diag = inside && i == j;
  const float x = (edge || diag) ? y + (inside ? step : 0.f) : 0.f;
  return diag ? x + shift : x;
}

// K12, route "tile": a graph of V (a power of two, 4..128) rows takes (V
// / R)^2 threads, each an R x R tile (rows i0 .. i0 + R - 1, columns j0
// .. j0 + R - 1); a block holds blockDim.x / (V / R)^2 graphs, each with
// V^2 + V floats of shared memory (its Ut and max(w, 0)), then a float a
// warp for the trace.
template <int V, int R>
__global__ void __launch_bounds__(256)
lovasz_dr_step_tile(const unsigned* __restrict__ Eb,
                    const int* __restrict__ nsz, float* __restrict__ Y,
                    float* __restrict__ X, const float* __restrict__ w,
                    const float* __restrict__ Ut, float* __restrict__ Rn,
                    int B, float step) {
  constexpr int S = V / R, T = S * S, W = (V + 31) / 32, ld = V * V + V;
  // Y and X tiles in registers from the start, beside the product's R^2
  // sums, up to R = 4
  constexpr bool kPre = R <= 4;
  extern __shared__ float4 sm4[];
  float* const sm = reinterpret_cast<float*>(sm4);
  const int G = blockDim.x / T;
  const int lg = threadIdx.x / T, tid = threadIdx.x - lg * T;
  const int g = blockIdx.x * G + lg;
  const bool live = g < B;
  float* const us = sm + lg * ld;
  float* const wp = us + V * V;
  float* const red = sm + G * ld;
  const size_t base = (size_t)g * V * V;
  const int ti = tid / S, tj = tid - ti * S, i0 = ti * R, j0 = tj * R;

  if (live)
    for (int e = 4 * tid; e < V * V; e += 4 * T)
      cp_async16(us + e, Ut + base + e);
  int n = 0;
  unsigned eb[R];
  float yv[kPre ? R : 1][R], xv[kPre ? R : 1][R];
  if (live) {
    n = nsz[g];
#pragma unroll
    for (int a = 0; a < R; ++a)
      eb[a] = Eb[((size_t)g * V + i0 + a) * W + (j0 >> 5)] >> (j0 & 31);
    if constexpr (kPre) {
#pragma unroll
      for (int a = 0; a < R; ++a) {
        load_row<R>(Y + base + (size_t)(i0 + a) * V + j0, yv[a]);
        load_row<R>(X + base + (size_t)(i0 + a) * V + j0, xv[a]);
      }
    }
    for (int k = tid; k < V; k += T)
      wp[k] = fmaxf(w[(size_t)g * V + k], 0.f);
  }
  cp_async_wait_all();
  __syncthreads();

  // Z's tile in k order: fmaf(Ut[k, i] w+_k, Ut[k, j], z)
  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) acc[a][b] = 0.f;
#pragma unroll 4
  for (int k = 0; k < V; ++k) {
    float x[R], y[R];
    load_row<R>(us + k * V + i0, x);
    load_row<R>(us + k * V + j0, y);
    const float wk = wp[k];
#pragma unroll
    for (int a = 0; a < R; ++a) x[a] *= wk;
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
  }

  // Y' = Y + Z - X into acc, and the trace of Y' + step J
  float trp = 0.f;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    float yr[R], xr[R];
    if constexpr (kPre) {
#pragma unroll
      for (int b = 0; b < R; ++b) {
        yr[b] = yv[a][b];
        xr[b] = xv[a][b];
      }
    } else if (live) {
      load_row<R>(Y + base + (size_t)(i0 + a) * V + j0, yr);
      load_row<R>(X + base + (size_t)(i0 + a) * V + j0, xr);
    } else {
#pragma unroll
      for (int b = 0; b < R; ++b) yr[b] = xr[b] = 0.f;
    }
#pragma unroll
    for (int b = 0; b < R; ++b) acc[a][b] = (yr[b] + acc[a][b]) - xr[b];
    if (ti == tj && i0 + a < n) trp += acc[a][a] + step;
  }
  constexpr int L = T < 32 ? T : 32;
#pragma unroll
  for (int o = L / 2; o; o >>= 1)
    trp += __shfl_xor_sync(0xffffffffu, trp, o);
  if constexpr (T > 32) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = trp;
    __syncthreads();
    trp = 0.f;
#pragma unroll
    for (int q = 0; q < T / 32; ++q) trp += red[lg * (T / 32) + q];
  }
  if (!live) return;
  const float shift = (1.f - trp) / fmaxf((float)n, 1.f);

  // X' = proj_affine(Y' + step J), R' = 2 X' - Y', each written once
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = i0 + a;
    float xo[R], ro[R];
#pragma unroll
    for (int b = 0; b < R; ++b) {
      xo[b] = dr_project(acc[a][b], (eb[a] >> b) & 1u, i, j0 + b, n, step,
                         shift);
      ro[b] = 2.f * xo[b] - acc[a][b];
    }
    const size_t off = base + (size_t)i * V + j0;
    store_row<R>(Y + off, acc[a]);
    store_row<R>(X + off, xo);
    store_row<R>(Rn + off, ro);
  }
}

// K12, route "global": a block of 256 threads a graph of any V; 4 x 4
// tiles of the output a thread in turn, Ut read where it lies; Y' is
// written in the first pass and read back after the trace.  Shared
// memory: max(w, 0) (V floats) and a float a warp.
__global__ void __launch_bounds__(256)
lovasz_dr_step_global(const unsigned* __restrict__ Eb,
                      const int* __restrict__ nsz, float* __restrict__ Y,
                      float* __restrict__ X, const float* __restrict__ w,
                      const float* __restrict__ Ut, float* __restrict__ Rn,
                      int V, float step) {
  constexpr int R = 4;
  extern __shared__ float4 sm4[];
  float* const wp = reinterpret_cast<float*>(sm4);
  float* const red = wp + V;
  const int g = blockIdx.x, T = blockDim.x, W = (V + 31) >> 5;
  const int n = nsz[g];
  const size_t base = (size_t)g * V * V;
  const float* const Ub = Ut + base;
  for (int k = threadIdx.x; k < V; k += T)
    wp[k] = fmaxf(w[(size_t)g * V + k], 0.f);
  __syncthreads();

  const int S = (V + R - 1) / R;
  float trp = 0.f;
  for (int t = threadIdx.x; t < S * S; t += T) {
    const int ti = t / S, tj = t - ti * S, i0 = ti * R, j0 = tj * R;
    float acc[R][R];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) acc[a][b] = 0.f;
    for (int k = 0; k < V; ++k) {
      const float* row = Ub + (size_t)k * V;
      const float wk = wp[k];
      float x[R], y[R];
#pragma unroll
      for (int a = 0; a < R; ++a)
        x[a] = i0 + a < V ? __ldg(row + i0 + a) * wk : 0.f;
#pragma unroll
      for (int b = 0; b < R; ++b) y[b] = j0 + b < V ? __ldg(row + j0 + b) : 0.f;
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int i = i0 + a, j = j0 + b;
        if (i < V && j < V) {
          const size_t e = base + (size_t)i * V + j;
          const float y = (Y[e] + acc[a][b]) - X[e];
          Y[e] = y;
          if (i == j && i < n) trp += y + step;
        }
      }
  }
  const float shift = (1.f - block_sum(trp, red)) / fmaxf((float)n, 1.f);
  __syncthreads();      // every Y' written before any is read back

  for (int e = threadIdx.x; e < V * V; e += T) {
    const int i = e / V, j = e - i * V;
    const float y = Y[base + e];
    const float x = dr_project(
        y, (Eb[((size_t)g * V + i) * W + (j >> 5)] >> (j & 31)) & 1u, i, j,
        n, step, shift);
    X[base + e] = x;
    Rn[base + e] = 2.f * x - y;
  }
}

// x / den correctly rounded (as __fdiv_rn divides) for an integer den (2
// <= den <= 2^24) given r = 1 / den rounded to f32, with no call to the
// division's slow-path subroutine (around which K13's register columns
// would spill).  |x| >= 2^-100: the product by r and two fused
// corrections (Markstein's); the quotient is normal there, and no normal
// quotient by an integer lies on a rounding tie unless den is a power of
// two, where every step is exact.  0 < |x| < 2^-100: in f64 (r refined by
// two Newton steps), where the f64 error is far below the quotient's
// distance to the nearest f32 rounding tie, except at an exact tie of two
// subnormals, which the exact residual finds and rounds to even.
__device__ __forceinline__ float cone_quotient(float x, float den, float r) {
  if (fabsf(x) >= 0x1p-100f) {
    float q = __fmul_rn(x, r);
    q = __fmaf_rn(__fmaf_rn(-den, q, x), r, q);
    return __fmaf_rn(__fmaf_rn(-den, q, x), r, q);
  }
  if (x == 0.f) return __fmul_rn(x, r);       // +-0, as x / den
  const double xd = x, dd = den;
  double rd = r;
  rd = fma(rd, fma(-dd, rd, 1.0), rd);
  rd = fma(rd, fma(-dd, rd, 1.0), rd);
  double q = xd * rd;
  q = fma(fma(-dd, q, xd), rd, q);
  float qf = __double2float_rn(q);
  if (fabsf(qf) <= 0x1p-126f) {
    const double e = fma(-(double)qf, dd, xd);    // exact
    if (2.0 * fabs(e) == dd * 0x1p-149) {       // a tie: the even one
      const unsigned mq = __float_as_uint(qf) & 0x7fffffffu;
      const bool up = (e > 0.0) == (x > 0.f);   // |x / den| > |qf|
      if (mq & 1u) qf = copysignf(__uint_as_float(up ? mq + 1 : mq - 1), x);
    }
  }
  return qf;
}

// K13's slot of a subset in shared memory, in floats: its centre (cp
// floats, a multiple of four) and, when staged, its columns [m, d]
// column-major; padded so consecutive slots start g floats apart modulo
// the 32 banks (four at g < 4), so the group's lanes, reading
// consecutive rows of their slots, fall in distinct banks.
__host__ __device__ __forceinline__ size_t cone_slot(int d, int m, int g,
                                                     int cp, bool shared) {
  size_t s = cp + (shared ? (((size_t)d * m + 3) & ~(size_t)3) : 0);
  if (g < 32) {
    const size_t off = g < 4 ? 4 : g;
    s += (off + 32 - s % 32) % 32;
  }
  return s;
}

// K13.  kD > 0 (route "register"): each lane's column in registers,
// padded with zero rows to kD (d <= kD), the subset's columns staged in
// its slot (kShared); kD = 0: the columns read from the slot (kShared,
// route "shared") or from device memory (route "global").  A subset
// takes 2^lg lanes; its slot (cone_slot) holds the centre (cp floats,
// zero past d) and, with kShared, the columns.  rcp[k] = 1 / (k + 2)
// rounded to f32.
template <int kD, bool kShared>
__global__ void __launch_bounds__(32 * kConeWarps)
lovasz_min_cone(const float* __restrict__ A, const float* __restrict__ rcp,
                float* __restrict__ out, int S, int d, int m, int lg, int cp,
                int iters) {
  static_assert(kD % 4 == 0 && (kD == 0 || kShared), "K13 instantiation");
  extern __shared__ float4 sm4[];
  const int gw = 1 << lg, lane = threadIdx.x & 31, j = lane & (gw - 1);
  const int local = threadIdx.x >> lg;        // the block's subset slot
  const int s = blockIdx.x * (kConeWarps * 32 >> lg) + local;
  const bool live = s < S;
  const size_t per = (size_t)d * m;
  float* const c = reinterpret_cast<float*>(sm4)
                   + local * cone_slot(d, m, gw, cp, kShared);
  // column jj's row i at col[jj * cs + i * rs]: column-major in the slot,
  // row-major where the subset lies in device memory
  const float* col = A + (size_t)s * per;
  const size_t cs = kShared ? d : 1, rs = kShared ? 1 : m;
  if (kShared) {
    float* const a = c + cp;
    if (live)
      for (size_t e = j; e < per; e += gw) a[(e % m) * d + e / m] = col[e];
    col = a;
    __syncwarp();
  }
  for (int i = j; i < cp; i += gw) c[i] = live && i < d ? col[i * rs] : 0.f;
  float reg[kD > 0 ? kD : 1];
  if constexpr (kD > 0) {
#pragma unroll
    for (int i = 0; i < kD; ++i)
      reg[i] = live && j < m && i < d ? col[j * cs + i] : 0.f;
  }
  __syncwarp();

  for (int k = 0; k < iters; ++k) {
    float d2 = -INFINITY;
    if constexpr (kD > 0) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kD; i += 4) {
        const float4 cv = *reinterpret_cast<const float4*>(c + i);
        float df = reg[i] - cv.x;
        acc = __fmaf_rn(df, df, acc);
        df = reg[i + 1] - cv.y;
        acc = __fmaf_rn(df, df, acc);
        df = reg[i + 2] - cv.z;
        acc = __fmaf_rn(df, df, acc);
        df = reg[i + 3] - cv.w;
        acc = __fmaf_rn(df, df, acc);
      }
      if (j < m) d2 = acc;
    } else if (live && j < m) {
      d2 = 0.f;
      const float* cj = col + j * cs;
      for (int i = 0; i < d; ++i) {
        const float df = cj[i * rs] - c[i];
        d2 = __fmaf_rn(df, df, d2);
      }
    }
    __syncwarp();   // every lane has read c before any lane steps it
    float best = d2;
    int arg = j;
    for (int o = gw >> 1; o; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, arg, o);
      if (ov > best || (ov == best && oi < arg)) {
        best = ov;
        arg = oi;
      }
    }
    const float den = (float)(k + 2), r = __ldg(rcp + k);
    if (live) {
      const float* far = col + arg * cs;
      for (int i = j; i < d; i += gw) {
        const float ci = c[i];
        c[i] = ci + cone_quotient(far[i * rs] - ci, den, r);
      }
    }
    __syncwarp();
  }

  float q = 0.f;
  for (int i = j; i < d; i += gw) q += c[i] * c[i];
  for (int o = gw >> 1; o; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  const float nc = sqrtf(q);
  if (live)
    for (int i = j; i < d; i += gw)
      c[i] = nc > 0.f ? c[i] / fmaxf(nc, 1e-30f) : 0.f;
  __syncwarp();
  float dot = INFINITY;
  if constexpr (kD > 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kD; i += 4) {
      const float4 cv = *reinterpret_cast<const float4*>(c + i);
      t = fmaf(reg[i], cv.x, t);
      t = fmaf(reg[i + 1], cv.y, t);
      t = fmaf(reg[i + 2], cv.z, t);
      t = fmaf(reg[i + 3], cv.w, t);
    }
    if (j < m) dot = t;
  } else if (live && j < m) {
    dot = 0.f;
    const float* cj = col + j * cs;
    for (int i = 0; i < d; ++i) dot = fmaf(cj[i * rs], c[i], dot);
  }
  for (int o = gw >> 1; o; o >>= 1)
    dot = fminf(dot, __shfl_xor_sync(0xffffffffu, dot, o));
  if (live && j == 0) out[s] = dot;
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

// K12: one DR step of B graphs padded to V (Y, X, R [B, V, V] f32, the
// eigenvectors as rows Ut [B, V, V] f32, w [B, V] f32, sizes n [B]
// int32, the edges as bit rows Eb [B, V, ceil(V / 32)] int32); Y and X in
// place, R written.  tile_r > 0: route "tile" with R = tile_r (V, R one
// of (4, 2), (8, 2), (16, 4), (32, 4), (64, 4), (128, 8); Y, X, R and Ut
// 16-byte aligned), `graphs` graphs a block (a whole number of warps,
// at most 1024 threads); tile_r = 0: route "global" (1 <= V <= 4096), a
// block a graph.  Launches on `stream`; returns cudaGetLastError().
extern "C" int grakel_lovasz_dr_step(const int* Eb, const int* n, float* Y,
                                     float* X, const float* w,
                                     const float* Ut, float* R, int B, int V,
                                     float step, int tile_r, int graphs,
                                     void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const unsigned* E = reinterpret_cast<const unsigned*>(Eb);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (tile_r == 0) {
    if (V < 1 || V > 4096) return (int)cudaErrorInvalidValue;
    const size_t smem = ((size_t)V + kRed) * sizeof(float);
    if ((e = prepare(lovasz_dr_step_global, smem)) != cudaSuccess)
      return (int)e;
    lovasz_dr_step_global<<<B, 256, smem, st>>>(E, n, Y, X, w, Ut, R, V,
                                                step);
    return (int)cudaGetLastError();
  }
  void (*kern)(const unsigned*, const int*, float*, float*, const float*,
               const float*, float*, int, float) = nullptr;
  if (V == 4 && tile_r == 2) kern = lovasz_dr_step_tile<4, 2>;
  if (V == 8 && tile_r == 2) kern = lovasz_dr_step_tile<8, 2>;
  if (V == 16 && tile_r == 4) kern = lovasz_dr_step_tile<16, 4>;
  if (V == 32 && tile_r == 4) kern = lovasz_dr_step_tile<32, 4>;
  if (V == 64 && tile_r == 4) kern = lovasz_dr_step_tile<64, 4>;
  if (V == 128 && tile_r == 8) kern = lovasz_dr_step_tile<128, 8>;
  if (!kern || graphs < 1) return (int)cudaErrorInvalidValue;
  const long threads = (long)(V / tile_r) * (V / tile_r) * graphs;
  if (threads % 32 || threads > 256) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)graphs * (V * V + V) + threads / 32)
                      * sizeof(float);
  if ((e = prepare(kern, smem)) != cudaSuccess) return (int)e;
  kern<<<(B + graphs - 1) / graphs, (int)threads, smem, st>>>(
      E, n, Y, X, w, Ut, R, B, step);
  return (int)cudaGetLastError();
}

// K13: t [S] of the subsets A [S, d, m] f32 after `iters` Badoiu-Clarkson
// steps, rcp [iters] the f32 reciprocals 1 / (k + 2).  `group` (a power of
// two, m <= group <= 32) lanes a subset; reg_d > 0: route "register"
// (reg_d one of 8, 16, ..., 64, 96, 128 and d <= reg_d; `shared` must be
// 1); reg_d = 0: `shared` picks route "shared" or "global".  Launches
// ceil(S / (128 / group)) blocks of four warps on `stream`; returns
// cudaGetLastError().
extern "C" int grakel_lovasz_min_cone(const float* A, const float* rcp,
                                      float* out, int S, int d, int m,
                                      int iters, int group, int reg_d,
                                      int shared, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  if (d < 1 || m < 1 || iters < 0 || iters > (1 << 24) - 2 || group < m
      || group > 32 || (group & (group - 1))
      || (reg_d > 0 && (d > reg_d || !shared)))
    return (int)cudaErrorInvalidValue;
  const int lg = __builtin_ctz((unsigned)group);
  const int cp = reg_d > 0 ? reg_d : (d + 3) & ~3;
  const size_t slots = (size_t)kConeWarps * 32 / group;
  const size_t smem = slots * cone_slot(d, m, group, cp, shared != 0)
                      * sizeof(float);
  void (*kern)(const float*, const float*, float*, int, int, int, int, int,
               int) = nullptr;
  switch (reg_d) {
    case 0: kern = shared ? lovasz_min_cone<0, true>
                          : lovasz_min_cone<0, false>; break;
    case 8: kern = lovasz_min_cone<8, true>; break;
    case 16: kern = lovasz_min_cone<16, true>; break;
    case 24: kern = lovasz_min_cone<24, true>; break;
    case 32: kern = lovasz_min_cone<32, true>; break;
    case 40: kern = lovasz_min_cone<40, true>; break;
    case 48: kern = lovasz_min_cone<48, true>; break;
    case 56: kern = lovasz_min_cone<56, true>; break;
    case 64: kern = lovasz_min_cone<64, true>; break;
    case 96: kern = lovasz_min_cone<96, true>; break;
    case 128: kern = lovasz_min_cone<128, true>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = prepare(kern, smem)) != cudaSuccess) return (int)e;
  const size_t blocks = (S + slots - 1) / slots;
  kern<<<(unsigned)blocks, 32 * kConeWarps, smem, (cudaStream_t)stream>>>(
      A, rcp, out, S, d, m, lg, cp, iters);
  return (int)cudaGetLastError();
}

// K13's quotient (cone_quotient) against __fdiv_rn, bit for bit, for every
// f32 x in [-2, 2] (the differences of unit vectors' entries) and every
// divisor k + 2 of iters steps, with rcp [iters] the f32 reciprocals
// 1 / (k + 2) the kernel takes.  out [3] u64, zeroed by the caller: the
// pairs that differ, the pairs checked, and the first difference found as
// x's bits << 32 | the divisor.
__global__ void cone_quotient_check(const float* __restrict__ rcp, int iters,
                                    unsigned long long* __restrict__ out) {
  const unsigned long long n = 2ull * 0x40000001ull;   // +-[0, 2]
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  unsigned long long bad = 0, seen = 0;
  for (unsigned long long t = blockIdx.x * (unsigned long long)blockDim.x
                              + threadIdx.x; t < n; t += stride) {
    const unsigned bits = (unsigned)(t >> 1) | ((unsigned)(t & 1) << 31);
    const float x = __uint_as_float(bits);
    for (int k = 0; k < iters; ++k) {
      const float den = (float)(k + 2);
      const float got = cone_quotient(x, den, rcp[k]);
      const float want = __fdiv_rn(x, den);
      if (__float_as_uint(got) != __float_as_uint(want)) {
        ++bad;
        atomicCAS(out + 2, 0ull, ((unsigned long long)bits << 32)
                                     | (unsigned)(k + 2));
      }
    }
    seen += iters;
  }
  atomicAdd(out, bad);
  atomicAdd(out + 1, seen);
}

extern "C" int grakel_lovasz_cone_quotient_check(const float* rcp,
                                                 int iters,
                                                 unsigned long long* out,
                                                 void* stream) {
  if (iters < 1 || iters > (1 << 24) - 2) return (int)cudaErrorInvalidValue;
  cone_quotient_check<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(
      rcp, iters, out);
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
