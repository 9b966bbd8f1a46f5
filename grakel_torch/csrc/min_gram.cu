// K1: min-intersection Gram on the CUDA cores,
//   K[i, j] = alpha * sum_l min(A[i, l], B[j, l])   (or K += that).
//
// Replaces the Pallas TPU kernel grakel_tpu/ops/intersect.py
// _min_gram_kernel (launched by _pallas_min_gram), reached through
// min_intersection_gram for real values and counts above 2048; in the
// port PyramidMatch's unlabeled levels come here, fused: one call a Gram
// over the levels concatenated along L, each scaled by its integer weight
// (w min(a, b) = min(w a, w b) for w >= 0).
//
// What bounds it on an H100.  A (min, +) product: n m L min-adds on
// (n + m) L floats in and n m floats out.  At narrow L (PyramidMatch's
// unlabeled levels, L = 6..90) writing the n x m output is the bound; at
// wide L (the labeled widths, hundreds to ~1800) the CUDA cores are.
// Tensor cores only multiply, and there is no fused min-add: fminf and
// fadd are two instructions, so the reachable rate is half the
// FMA-counted fp32 peak, and every other instruction in the inner loop
// (shared-memory loads, addressing) comes out of the same issue slots.
//
// What the design does about each.
// * Work: when B is A (every fit_transform) only the tiles on or above
//   the block diagonal are launched (a 1-D grid over the triangle); an
//   off-diagonal tile is written twice, as computed and mirrored, from
//   the same accumulators, so the Gram is exactly symmetric.
// * Issue slots: each thread keeps a TT x TT tile of f32 accumulators in
//   registers (8 x 8 or 4 x 4), read as 4-wide groups SLAB apart; per
//   k step it loads its A and B values with 128-bit shared-memory reads
//   (TT / 2 LDS.128 for TT^2 min-adds: 4 for 64 at 8 x 8).  Staged tiles
//   are k-major with rows padded by 4 floats: the 128-bit reads stay
//   aligned and a quarter warp's reads hit distinct banks.
// * Latency: chunks of BK = 8 columns are double-buffered in shared
//   memory; the next chunk's global loads (coalesced along L, 16 or 8
//   bytes a thread where L and the pointers allow: four scalar loads
//   take four issue slots and their address arithmetic) go out into
//   registers before the current chunk's min-adds and are stored
//   transposed after them, one barrier a chunk.  The padded rows keep
//   those transposing stores free of bank conflicts.  Within a chunk the
//   next k step's operands load during this step's min-adds.
// * Narrow L: the last chunk's loop runs to L, not to BK: no min-add is
//   spent on padding columns.  The tile shape is chosen per call by the
//   caller (ops/intersect.k1_tile, from the smoke's sweep): 64 x 64 blocks
//   of 8 x 8 a thread where the grid fills the card, 32 x 32 blocks of
//   4 x 4 a thread where it would not.
// * Output: the direct tile is stored straight from registers, 16 bytes a
//   thread, a half warp covering 256 contiguous bytes of a row.  The
//   mirrored tile goes through shared memory one slab at a time (16-byte
//   chunks XOR-swizzled by row / 4, so both its writes and its column
//   reads are conflict-free) and leaves as 16-byte stores, 8 threads
//   covering 128 contiguous bytes of a row.  With accumulate the old
//   values are read in the same pattern (K += alpha * sum).
//
// The sum is f32 in L order; integer-valued histograms stay exact below
// 2^24.  Ragged n, m and L are masked here; the caller pads nothing.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 8;     // columns of L staged a chunk
constexpr int PAD = 4;    // floats of padding on each staged k-row

template <int BT, int TT>
struct Cfg {
  static constexpr int TD = BT / TT;              // threads along a side
  static constexpr int THREADS = TD * TD;
  static constexpr int SLABS = TT / 4;            // 4-wide groups a side
  static constexpr int SLAB = BT / SLABS;         // their distance, 4 TD
  static constexpr int SROW = BT + PAD;           // staged k-row, floats
  static constexpr int STAGE = 2 * BK * SROW;     // A and B of a chunk
  static constexpr int LOADS = BT * BK / THREADS; // staged values a thread
  static constexpr int EPI = SLAB * BT;           // mirrored slab, floats
  static constexpr int SMEM = 2 * STAGE > EPI ? 2 * STAGE : EPI;
  static_assert(SLAB == 4 * TD && SLAB % 32 == 0 && BT % 32 == 0, "tile");
  static_assert(BT * BK % (4 * THREADS) == 0, "staging");
};

// X[row0 + r, k0 + k .. k0 + k + VW) for this thread's LOADS staged
// values, VW floats a load (0 past the edges); consecutive threads read
// consecutive columns of a row.  VW divides L and the rows are VW * 4-byte
// aligned, so a vector is all in range or all out.
template <int BT, int TT, int VW>
__device__ __forceinline__ void fetch(float* v, const float* __restrict__ X,
                                      int rows, int L, int row0, int k0,
                                      int tid) {
  using C = Cfg<BT, TT>;
#pragma unroll
  for (int p = 0; p < C::LOADS / VW; ++p) {
    const int e = tid + p * C::THREADS;
    const int gr = row0 + e / (BK / VW);
    const int gk = k0 + e % (BK / VW) * VW;
    const bool in = gr < rows && gk < L;
    const float* x = X + (size_t)gr * L + gk;
    if (VW == 4) {
      const float4 q = in ? __ldg(reinterpret_cast<const float4*>(x))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * p] = q.x; v[4 * p + 1] = q.y; v[4 * p + 2] = q.z; v[4 * p + 3] = q.w;
    } else if (VW == 2) {
      const float2 q = in ? __ldg(reinterpret_cast<const float2*>(x))
                          : make_float2(0.f, 0.f);
      v[2 * p] = q.x; v[2 * p + 1] = q.y;
    } else {
      v[p] = in ? __ldg(x) : 0.f;
    }
  }
}

// the fetched values into a k-major staged tile S [BK][SROW]; a warp's
// stores of one vector lane fall in distinct banks (SROW = 4 mod 32)
template <int BT, int TT, int VW>
__device__ __forceinline__ void stash(float* S, const float* v, int tid) {
  using C = Cfg<BT, TT>;
#pragma unroll
  for (int p = 0; p < C::LOADS / VW; ++p) {
    const int e = tid + p * C::THREADS;
    const int r = e / (BK / VW);
    const int k = e % (BK / VW) * VW;
#pragma unroll
    for (int q = 0; q < VW; ++q) S[(k + q) * C::SROW + r] = v[VW * p + q];
  }
}

// this thread's A and B values of one staged k-row pair (a and b)
template <int BT, int TT>
__device__ __forceinline__ void operands(float (&a)[TT], float (&b)[TT],
                                         const float* as, const float* bs,
                                         int tx, int ty) {
  using C = Cfg<BT, TT>;
#pragma unroll
  for (int s = 0; s < C::SLABS; ++s) {
    const float4 x =
        *reinterpret_cast<const float4*>(as + ty * 4 + s * C::SLAB);
    const float4 y =
        *reinterpret_cast<const float4*>(bs + tx * 4 + s * C::SLAB);
    a[4 * s] = x.x; a[4 * s + 1] = x.y; a[4 * s + 2] = x.z; a[4 * s + 3] = x.w;
    b[4 * s] = y.x; b[4 * s + 1] = y.y; b[4 * s + 2] = y.z; b[4 * s + 3] = y.w;
  }
}

// acc[i][j] += min(a[i], b[j])
template <int TT>
__device__ __forceinline__ void min_add(float (&acc)[TT][TT],
                                        const float (&a)[TT],
                                        const float (&b)[TT]) {
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TT; ++j) acc[i][j] += fminf(a[i], b[j]);
}

// acc[i][j .. j + 3] (compile-time indices once unrolled)
template <int TT>
__device__ __forceinline__ float4 group(const float (&acc)[TT][TT], int i,
                                        int j) {
  return make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
}

// K[r, c .. c + 3] = alpha * v (+ the old values when accumulating),
// masked to rows < rlim and columns < clim; one 16-byte access when the
// four are in range and rows are 16-byte aligned (vec)
__device__ __forceinline__ void put4(float* K, int ld, int r, int c, int rlim,
                                     int clim, float4 v, float alpha,
                                     int accumulate, bool vec) {
  if (r >= rlim || c >= clim) return;
  float* p = K + (size_t)r * ld + c;
  float e[4] = {__fmul_rn(alpha, v.x), __fmul_rn(alpha, v.y),
                __fmul_rn(alpha, v.z), __fmul_rn(alpha, v.w)};
  if (vec && c + 4 <= clim) {
    if (accumulate) {
      const float4 o = *reinterpret_cast<const float4*>(p);
      e[0] = __fadd_rn(o.x, e[0]); e[1] = __fadd_rn(o.y, e[1]);
      e[2] = __fadd_rn(o.z, e[2]); e[3] = __fadd_rn(o.w, e[3]);
    }
    *reinterpret_cast<float4*>(p) = make_float4(e[0], e[1], e[2], e[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (c + q < clim) p[q] = accumulate ? __fadd_rn(p[q], e[q]) : e[q];
}

// a floor of one block a SM lets ptxas keep both k steps' operands and
// the staged loads in registers (168 at 64 x 8 with 16-byte loads, 6
// blocks a SM); without it ptxas aims at more blocks a SM and the
// kernel ran slower at every shape on an H100
template <int BT, int TT, int VW>
__global__ void __launch_bounds__(Cfg<BT, TT>::THREADS, 1)
min_gram_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ K, int n, int m, int L, float alpha,
                int accumulate, int symmetric, int tiles_m, int vec) {
  using C = Cfg<BT, TT>;
  __shared__ __align__(16) float smem[C::SMEM];
  const int tid = threadIdx.x;
  const int tx = tid % C::TD;
  const int ty = tid / C::TD;

  // block -> output tile (bi, bj); symmetric: the upper triangle in row
  // order, from the triangular root of the reversed index
  int bi, bj;
  if (symmetric) {
    const long long t = tiles_m;
    const long long rev = t * (t + 1) / 2 - 1 - blockIdx.x;
    long long r = (long long)((sqrt(8.0 * (double)rev + 1.0) - 1.0) / 2.0);
    while (r * (r + 1) / 2 > rev) --r;
    while ((r + 1) * (r + 2) / 2 <= rev) ++r;
    bi = (int)(t - 1 - r);
    bj = (int)(t - 1 - (rev - r * (r + 1) / 2));
  } else {
    bi = blockIdx.x / tiles_m;
    bj = blockIdx.x % tiles_m;
  }
  const int row0 = bi * BT;
  const int col0 = bj * BT;

  float acc[TT][TT];
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TT; ++j) acc[i][j] = 0.f;

  float ra[C::LOADS], rb[C::LOADS];
  const int nch = (L + BK - 1) / BK;
  if (nch > 0) {
    fetch<BT, TT, VW>(ra, A, n, L, row0, 0, tid);
    fetch<BT, TT, VW>(rb, B, m, L, col0, 0, tid);
    stash<BT, TT, VW>(smem, ra, tid);
    stash<BT, TT, VW>(smem + BK * C::SROW, rb, tid);
  }
  __syncthreads();
  for (int ch = 0; ch < nch; ++ch) {
    const float* as = smem + (ch & 1) * C::STAGE;
    const float* bs = as + BK * C::SROW;
    const bool more = ch + 1 < nch;
    if (more) {   // the next chunk's loads fly during this chunk's min-adds
      fetch<BT, TT, VW>(ra, A, n, L, row0, (ch + 1) * BK, tid);
      fetch<BT, TT, VW>(rb, B, m, L, col0, (ch + 1) * BK, tid);
    }
    const int kn = min(BK, L - ch * BK);
    float a[2][TT], b[2][TT];
    if (kn == BK) {   // k + 1's operands load during k's min-adds
      operands<BT, TT>(a[0], b[0], as, bs, tx, ty);
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        if (k + 1 < BK)
          operands<BT, TT>(a[(k + 1) & 1], b[(k + 1) & 1],
                           as + (k + 1) * C::SROW, bs + (k + 1) * C::SROW,
                           tx, ty);
        min_add<TT>(acc, a[k & 1], b[k & 1]);
      }
    } else {          // the last chunk: only its kn columns
#pragma unroll 1
      for (int k = 0; k < kn; ++k) {
        operands<BT, TT>(a[0], b[0], as + k * C::SROW, bs + k * C::SROW,
                         tx, ty);
        min_add<TT>(acc, a[0], b[0]);
      }
    }
    if (more) {
      float* nx = smem + ((ch + 1) & 1) * C::STAGE;
      stash<BT, TT, VW>(nx, ra, tid);
      stash<BT, TT, VW>(nx + BK * C::SROW, rb, tid);
    }
    __syncthreads();
  }

  const bool mirror = symmetric && bi != bj;
#pragma unroll
  for (int s = 0; s < C::SLABS; ++s) {
    // this thread's rows ty * 4 + s * SLAB + rr, columns tx * 4 + t * SLAB
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int t = 0; t < C::SLABS; ++t) {
        const float4 v = group(acc, 4 * s + rr, 4 * t);
        put4(K, m, row0 + ty * 4 + s * C::SLAB + rr,
             col0 + tx * 4 + t * C::SLAB, n, m, v, alpha, accumulate, vec);
      }
    if (!mirror) continue;
    // slab s of the tile into T [SLAB][BT], 16-byte chunk q of row r at
    // chunk q ^ (r / 4 % 8); the barrier before: the staged chunks (or
    // the last slab's reads) are done with the shared memory
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int t = 0; t < C::SLABS; ++t) {
        const int q = (tx + t * C::TD) ^ (ty & 7);
        *reinterpret_cast<float4*>(smem + (ty * 4 + rr) * BT + 4 * q) =
            group(acc, 4 * s + rr, 4 * t);
      }
    __syncthreads();
    // its transpose: K[col0 + c, row0 + s * SLAB + 4 g .. + 3] = T[4 g ..
    // 4 g + 3][c]; a warp takes 4 columns c and 8 row groups g
    constexpr int GH = C::SLAB / 32;
#pragma unroll 2
    for (int it = tid; it < BT * C::SLAB / 4; it += C::THREADS) {
      const int cc = it & 3;
      const int gl = (it >> 2) & 7;
      const int rest = it >> 5;
      const int ch4 = rest / GH;             // 16-byte column chunk
      const int g = (rest % GH) * 8 + gl;    // row group
      const float* col = smem + 4 * (ch4 ^ gl) + cc;
      const float4 v = make_float4(col[(4 * g) * BT], col[(4 * g + 1) * BT],
                                   col[(4 * g + 2) * BT],
                                   col[(4 * g + 3) * BT]);
      put4(K, m, col0 + 4 * ch4 + cc, row0 + s * C::SLAB + 4 * g, n, m, v,
           alpha, accumulate, vec);
    }
  }
}

template <int BT, int TT, int VW>
int launch(const float* A, const float* B, float* K, int n, int m, int L,
           float alpha, int accumulate, int symmetric, int vec,
           cudaStream_t stream) {
  const long long tn = (n + BT - 1) / BT;
  const long long tm = (m + BT - 1) / BT;
  const long long blocks = symmetric ? tm * (tm + 1) / 2 : tn * tm;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  min_gram_kernel<BT, TT, VW><<<(unsigned)blocks, Cfg<BT, TT>::THREADS, 0,
                                stream>>>(A, B, K, n, m, L, alpha,
                                          accumulate, symmetric, (int)tm,
                                          vec);
  return (int)cudaGetLastError();
}

template <int BT, int TT>
int launch_vw(const float* A, const float* B, float* K, int n, int m, int L,
              float alpha, int accumulate, int symmetric, int vec, int vw,
              cudaStream_t s) {
  if (vw == 4)
    return launch<BT, TT, 4>(A, B, K, n, m, L, alpha, accumulate, symmetric,
                             vec, s);
  if (vw == 2)
    return launch<BT, TT, 2>(A, B, K, n, m, L, alpha, accumulate, symmetric,
                             vec, s);
  return launch<BT, TT, 1>(A, B, K, n, m, L, alpha, accumulate, symmetric,
                           vec, s);
}

}  // namespace

// A [n, L], B [m, L], K [n, m]: f32, row-major, contiguous, on the
// current device.  K = alpha * Gram, or K += alpha * Gram when accumulate
// != 0.  symmetric != 0 requires B == A (n == m) and computes the upper
// block triangle only.  tile picks the instantiation (block side x thread
// tile side): 0 = 64 x 8, 1 = 32 x 4.  Global loads are 4 or 2 floats
// wide when L and the pointers allow it.  Launches on `stream`; returns
// cudaGetLastError() or cudaErrorInvalidValue.
extern "C" int grakel_min_gram(const float* A, const float* B, float* K,
                               int n, int m, int L, float alpha,
                               int accumulate, int symmetric, int tile,
                               void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaGetLastError();
  if (L < 0 || (symmetric && (A != B || n != m)))
    return (int)cudaErrorInvalidValue;
  const int vec = m % 4 == 0 && ((uintptr_t)K & 15) == 0;
  const uintptr_t ab = (uintptr_t)A | (uintptr_t)B;
  const int vw = L % 4 == 0 && (ab & 15) == 0 ? 4
               : L % 2 == 0 && (ab & 7) == 0  ? 2 : 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (tile == 0)
    return launch_vw<64, 8>(A, B, K, n, m, L, alpha, accumulate, symmetric,
                            vec, vw, s);
  if (tile == 1)
    return launch_vw<32, 4>(A, B, K, n, m, L, alpha, accumulate, symmetric,
                            vec, vw, s);
  return (int)cudaErrorInvalidValue;
}
