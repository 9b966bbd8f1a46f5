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
// What bounds it on an H100: memory bytes against a division and four
// adds an entry and round.  NeighborhoodHash's fit Gram folds counts of
// one symmetric min-intersection call (B is A, va is vb), so c_r[i, j]
// == c_r[j, i] bit for bit and, IEEE addition commuting, acc_ij ==
// acc_ji; then (x + x) * 0.5 == x exactly (x <= 1, far from overflow),
// and the upper triangle alone gives every entry: R n (n + 1) / 2 counts
// read and n^2 ratios written (4110^2 at R = 3: 169 MB, ~0.050 ms at
// 3.35 TB/s).
//
// Routes (picked by the wrapper from its flags; one launch each):
// * triangle: the caller promises those symmetric counts.  A 1-D grid
//   over the upper block triangle of 32 x 32 tiles (no block idles).  A
//   tile row is read by 8 lanes with 16-byte loads at aligned addresses
//   (rows of an n = 4110 stack are not 16-byte aligned): each lane loads
//   its aligned float4 and its neighbour's comes by a shuffle, lane 7
//   loading the ninth; all rounds' loads of a group of up to four rounds
//   are in flight before the first is used (template on the group size,
//   a loop over groups beyond).  The tile is written along rows with
//   aligned 16-byte stores (shuffles again), and its mirror through a
//   padded shared-memory transpose, along rows too;
// * rect: the same tiles and loads over a 1-D grid of all tiles, no
//   mirror;
// * pair: symmetrizing counts that need not be symmetric.  A block owns
//   a tile on or above the diagonal and its mirror, staged through
//   shared memory so both are read along rows; each thread folds both
//   entries of its pair (i, j), (j, i).
//
// A 16-byte aligned load that holds one element of a tensor stays inside
// its allocation (CUDA allocations are 256-byte aligned and whole 512-byte
// blocks under PyTorch's allocator); lanes ignore the elements outside
// their tile, and stores write only the tile's own elements.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kTile = 32;    // tile side
constexpr int kLanes = 8;    // lanes a tile row, 4 floats each
constexpr int kThreads = kTile * kLanes;
constexpr int kMaxGroup = 4; // rounds whose loads are in flight together
constexpr int kPairRows = 8; // pair route: the block's y extent

__device__ __forceinline__ float term(float c, float vi, float vj) {
  const float d = __fsub_rn(__fadd_rn(vi, vj), c);
  return d > 0.f ? __fdiv_rn(c, d) : 0.f;
}

// elements s .. s + 3 of the eight floats lo:hi
__device__ __forceinline__ float4 funnel(float4 lo, float4 hi, int s) {
  switch (s) {
    case 0: return lo;
    case 1: return make_float4(lo.y, lo.z, lo.w, hi.x);
    case 2: return make_float4(lo.z, lo.w, hi.x, hi.y);
    default: return make_float4(lo.w, hi.x, hi.y, hi.z);
  }
}

__device__ __forceinline__ float4 shfl_down4(float4 v) {
  return make_float4(__shfl_down_sync(kAll, v.x, 1, kLanes),
                     __shfl_down_sync(kAll, v.y, 1, kLanes),
                     __shfl_down_sync(kAll, v.z, 1, kLanes),
                     __shfl_down_sync(kAll, v.w, 1, kLanes));
}

__device__ __forceinline__ float4 shfl_up4(float4 v) {
  return make_float4(__shfl_up_sync(kAll, v.x, 1, kLanes),
                     __shfl_up_sync(kAll, v.y, 1, kLanes),
                     __shfl_up_sync(kAll, v.z, 1, kLanes),
                     __shfl_up_sync(kAll, v.w, 1, kLanes));
}

__device__ __forceinline__ int misalign(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The raw loads of a row segment p[0 .. 32), of which the first `valid`
// are real, by the 8 lanes g of a row: lane g's aligned float4 (elements
// 4g - s .. 4g - s + 3, s the misalignment of p) and lane 7's ninth.
struct Seg {
  float4 lo, ex;
};

__device__ __forceinline__ Seg seg_load(const float* p, int valid, int g) {
  const int s = misalign(p);
  const float4* a = reinterpret_cast<const float4*>(p - s);
  Seg r;
  r.lo = r.ex = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0 && 4 * g - s < valid) r.lo = __ldg(a + g);
  if (g == kLanes - 1 && s > 0 && kTile - s < valid) r.ex = __ldg(a + kLanes);
  return r;
}

// Lane g's elements p[4g .. 4g + 3] from the loads of seg_load; every
// lane of the warp calls it.
__device__ __forceinline__ float4 seg_value(const Seg& r, const float* p,
                                            int g) {
  float4 hi = shfl_down4(r.lo);
  if (g == kLanes - 1) hi = r.ex;
  return funnel(r.lo, hi, misalign(p));
}

// the elements e0 .. e0 + 3 of w at q, those in [0, valid) only
__device__ __forceinline__ void store_part(float4* q, float4 w, int e0,
                                           int valid) {
  if (e0 >= 0 && e0 + 3 < valid) {
    *q = w;
    return;
  }
  float* f = reinterpret_cast<float*>(q);
  const float x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (e0 + k >= 0 && e0 + k < valid) f[k] = x[k];
  }
}

// p[4g .. 4g + 3] = v for the lanes g of a row, p[0 .. valid) only, with
// stores at aligned addresses; every lane of the warp calls it.
__device__ __forceinline__ void seg_store(float* p, int valid, int g,
                                          float4 v) {
  const int s = misalign(p);
  float4* a = reinterpret_cast<float4*>(p - s);
  const float4 prev = shfl_up4(v);
  if (valid <= 0) return;
  store_part(a + g, s == 0 ? v : funnel(prev, v, 4 - s), 4 * g - s, valid);
  if (g == kLanes - 1 && s > 0)
    store_part(a + kLanes, funnel(v, v, 4 - s), kTile - s, valid);
}

// Lane g's four acc (columns j0 + 4g ..) of row i: rounds in order, the
// loads of up to kMaxGroup rounds in flight together.  c points at row i,
// column j0 of round 0; rv entries of the row are real.
template <int G>
__device__ __forceinline__ float4 fold_row(const float* c, size_t plane,
                                           int R, int rv, float vi,
                                           float4 vj, int g) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = 0; r0 < R; r0 += G) {
    Seg q[G];
#pragma unroll
    for (int k = 0; k < G; ++k)
      q[k] = seg_load(c + (size_t)(r0 + k) * plane, r0 + k < R ? rv : 0, g);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const float4 x = seg_value(q[k], c + (size_t)(r0 + k) * plane, g);
      if (r0 + k < R) {
        acc.x = __fadd_rn(acc.x, term(x.x, vi, vj.x));
        acc.y = __fadd_rn(acc.y, term(x.y, vi, vj.y));
        acc.z = __fadd_rn(acc.z, term(x.z, vi, vj.z));
        acc.w = __fadd_rn(acc.w, term(x.w, vi, vj.w));
      }
    }
  }
  return acc;
}

__device__ __forceinline__ float4 scale(float4 a, float inv_r) {
  return make_float4(__fmul_rn(a.x, inv_r), __fmul_rn(a.y, inv_r),
                     __fmul_rn(a.z, inv_r), __fmul_rn(a.w, inv_r));
}

// block -> tile (ti, tj), ti <= tj: the upper triangle in row order, from
// the triangular root of the reversed index (as K1)
__device__ __forceinline__ void tri_tile(int tiles, int& ti, int& tj) {
  const long long t = tiles;
  const long long rev = t * (t + 1) / 2 - 1 - blockIdx.x;
  long long r = (long long)((sqrt(8.0 * (double)rev + 1.0) - 1.0) / 2.0);
  while (r * (r + 1) / 2 > rev) --r;
  while ((r + 1) * (r + 2) / 2 <= rev) ++r;
  ti = (int)(t - 1 - r);
  tj = (int)(t - 1 - (rev - r * (r + 1) / 2));
}

template <int G>
__global__ void __launch_bounds__(kThreads)
jaccard_tri(const float* __restrict__ c, const float* __restrict__ v,
            float* __restrict__ K, int R, int n, float inv_r) {
  __shared__ float tile[kTile][kTile + 1];
  int ti, tj;
  tri_tile((n + kTile - 1) / kTile, ti, tj);
  const int g = threadIdx.x % kLanes, row = threadIdx.x / kLanes;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int i = i0 + row;
  const int cols = min(kTile, n - j0);
  const int rv = i < n ? cols : 0;
  const float vi = i < n ? __ldg(v + i) : 0.f;
  const float4 vj = seg_value(seg_load(v + j0, cols, g), v + j0, g);
  const float4 x = scale(
      fold_row<G>(c + (size_t)i * n + j0, (size_t)n * n, R, rv, vi, vj, g),
      inv_r);
  seg_store(K + (size_t)i * n + j0, rv, g, x);
  if (ti == tj) return;                         // block-uniform
  // the mirror: rows j0 + row of K, columns i0 .. i0 + 31 (a full tile:
  // ti < tj is not the last tile)
  tile[row][4 * g] = x.x;
  tile[row][4 * g + 1] = x.y;
  tile[row][4 * g + 2] = x.z;
  tile[row][4 * g + 3] = x.w;
  __syncthreads();
  const float4 y = make_float4(tile[4 * g][row], tile[4 * g + 1][row],
                               tile[4 * g + 2][row], tile[4 * g + 3][row]);
  const int jr = j0 + row;
  seg_store(K + (size_t)jr * n + i0, jr < n ? kTile : 0, g, y);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
jaccard_rect(const float* __restrict__ c, const float* __restrict__ va,
             const float* __restrict__ vb, float* __restrict__ K, int R,
             int n, int m, float inv_r) {
  const int g = threadIdx.x % kLanes, row = threadIdx.x / kLanes;
  const int tiles_m = (m + kTile - 1) / kTile;
  const int j0 = (int)(blockIdx.x % tiles_m) * kTile;
  const int i = (int)(blockIdx.x / tiles_m) * kTile + row;
  const int cols = min(kTile, m - j0);
  const int rv = i < n ? cols : 0;
  const float vi = i < n ? __ldg(va + i) : 0.f;
  const float4 vj = seg_value(seg_load(vb + j0, cols, g), vb + j0, g);
  const float4 x = scale(
      fold_row<G>(c + (size_t)i * m + j0, (size_t)n * m, R, rv, vi, vj, g),
      inv_r);
  seg_store(K + (size_t)i * m + j0, rv, g, x);
}

__global__ void __launch_bounds__(kTile * kPairRows)
jaccard_pair(const float* __restrict__ c, const float* __restrict__ va,
             const float* __restrict__ vb, float* __restrict__ K, int R,
             int n, float inv_r) {
  int ti, tj;
  tri_tile((n + kTile - 1) / kTile, ti, tj);
  __shared__ float mirror[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const size_t nn = (size_t)n * n;
  // this thread's entries (i, j) of tile (ti, tj): i = ti*32 + ty + 8k,
  // j = tj*32 + tx; their mirrors (j, i) sit at mirror[tx][ty + 8k]
  const int j = tj * kTile + tx;
  float up[kTile / kPairRows], dn[kTile / kPairRows];
#pragma unroll
  for (int k = 0; k < kTile / kPairRows; ++k) up[k] = dn[k] = 0.f;
  for (int r = 0; r < R; ++r) {
    const float* cr = c + r * nn;
#pragma unroll
    for (int k = 0; k < kTile / kPairRows; ++k) {
      const int row = tj * kTile + ty + kPairRows * k, col = ti * kTile + tx;
      mirror[ty + kPairRows * k][tx] =
          (row < n && col < n) ? __ldg(cr + (size_t)row * n + col) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTile / kPairRows; ++k) {
      const int i = ti * kTile + ty + kPairRows * k;
      if (i < n && j < n) {
        up[k] = __fadd_rn(up[k], term(__ldg(cr + (size_t)i * n + j),
                                      __ldg(va + i), __ldg(vb + j)));
        dn[k] = __fadd_rn(dn[k], term(mirror[tx][ty + kPairRows * k],
                                      __ldg(va + j), __ldg(vb + i)));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kTile / kPairRows; ++k) {
    const int i = ti * kTile + ty + kPairRows * k;
    const float v = __fmul_rn(
        __fadd_rn(__fmul_rn(up[k], inv_r), __fmul_rn(dn[k], inv_r)), 0.5f);
    if (i < n && j < n) K[(size_t)i * n + j] = v;
    mirror[tx][ty + kPairRows * k] = v;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kTile / kPairRows; ++k) {
    const int row = tj * kTile + ty + kPairRows * k, col = ti * kTile + tx;
    if (row < n && col < n)
      K[(size_t)row * n + col] = mirror[ty + kPairRows * k][tx];
  }
}

template <int G>
void launch_group(int route, const float* c, const float* va,
                  const float* vb, float* K, int R, int n, int m,
                  float inv_r, cudaStream_t s) {
  if (route == 2) {
    const long long t = (n + kTile - 1) / kTile;
    jaccard_tri<G><<<(unsigned)(t * (t + 1) / 2), kThreads, 0, s>>>(
        c, va, K, R, n, inv_r);
  } else {
    const long long tiles = (long long)((n + kTile - 1) / kTile)
                            * ((m + kTile - 1) / kTile);
    jaccard_rect<G><<<(unsigned)tiles, kThreads, 0, s>>>(c, va, vb, K, R, n,
                                                         m, inv_r);
  }
}

}  // namespace

// c [R, n, m] f32; va [n], vb [m] f32; K [n, m] f32 output, all
// contiguous; inv_r the f32 value of 1 / R.  route: 0 rect; 1 pair
// (n == m, K = (acc + acc^T) / 2 as above); 2 triangle (n == m, va ==
// vb, and each c_r symmetric bit for bit: the caller's promise, not
// checked).  Launches on `stream`; returns cudaGetLastError() or
// cudaErrorInvalidValue.
extern "C" int grakel_jaccard_fold(const float* c, const float* va,
                                   const float* vb, float* K, int R, int n,
                                   int m, float inv_r, int route,
                                   void* stream) {
  if (R < 1 || route < 0 || route > 2 || (route > 0 && n != m)
      || (route == 2 && va != vb))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && m > 0) {
    if (route == 1) {
      const long long t = (n + kTile - 1) / kTile;
      jaccard_pair<<<(unsigned)(t * (t + 1) / 2), dim3(kTile, kPairRows), 0,
                     s>>>(c, va, vb, K, R, n, inv_r);
    } else if (R >= kMaxGroup) {
      launch_group<kMaxGroup>(route, c, va, vb, K, R, n, m, inv_r, s);
    } else if (R == 3) {
      launch_group<3>(route, c, va, vb, K, R, n, m, inv_r, s);
    } else if (R == 2) {
      launch_group<2>(route, c, va, vb, K, R, n, m, inv_r, s);
    } else {
      launch_group<1>(route, c, va, vb, K, R, n, m, inv_r, s);
    }
  }
  return (int)cudaGetLastError();
}
