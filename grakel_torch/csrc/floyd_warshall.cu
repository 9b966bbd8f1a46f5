// K3: batched min-plus Floyd-Warshall (all-pairs shortest paths).
//
// Replaces the XLA program grakel_tpu/ops/floyd_warshall.py
// batched_floyd_warshall: for a padded batch adj [n, V, V] f32 (0 means
// "no edge") and mask [n, V] (1 = real vertex) it writes
//   S[g, i, j] = shortest distance, INF = 3.4e38 / 4 where unreachable
//                or where either endpoint is padding, 0 on the diagonal
//                of real vertices.
// The JAX program initialises S, then for k = 0 .. V-1 in order sets
// S[i, j] = min(S[i, j], S[i, k] + S[k, j]) with one round-to-nearest
// fadd and one min per update.  Routes "tile" and "per_k" keep exactly
// that sequence of updates for every cell and so are bit-identical to it
// for any weights (no fast math, no contraction, no flush to zero; the
// build never passes --use_fast_math).  Route "blocked" reorders the
// sums and is taken only for integral weights, where it is exact too.
//
// Row k and column k do not change in step k: for a real k S[k, k] = 0
// and x + 0 == x; for a padded k every entry of its row and column is
// INF and INF + x >= INF.  So the operands of step k may be read at any
// time after step k - 1, and in-place updates that write only where the
// new path is strictly shorter never touch what another thread reads.
//
// What bounds it on an H100: 2 V^3 operations per graph against 8 V^2
// bytes in and out of device memory, so operations (fp32 on the CUDA
// cores) for V above ~50 and bytes below.  A min-plus update is two
// instructions (fadd, fmin), not one FMA; the V steps are dependent.
//
// Route "tile" (V <= ROUTE_A_MAX_V = 128, chosen by the Python wrapper,
// which also picks T and the graphs per block G): each thread owns a
// fixed T x T micro-tile of one graph's cells, computed once, and keeps
// it in registers for all V steps; a block holds G graphs of the same V,
// stepping in lockstep.  Step k is a rank-1 (min, +) update: T values of
// column k and T of row k from shared memory as vector loads, then T^2
// fadd + fmin.  After its step-k update the owner of row k+1 (column
// k+1) publishes it to a double-buffered row (column) buffer in shared
// memory, then one barrier; step k+1 reads buffer (k+1) mod 2.  The k
// loop is unrolled by T, so which row of the micro-tile is published is
// a compile-time index.  Padded cells (index >= V, or a padded vertex)
// hold INF, which never wins a min.  adj and mask are read once and S
// written once.  Instantiated for T = 2, 4, 8; the wrapper takes T = 2
// up to V = 24, 4 up to 64 and 8 up to 128 (ops/floyd_warshall.py
// TILE_WIDTHS, from a sweep on an H100).
// Route "blocked" (V > 128, integral weights: the caller's promise,
// unchecked): one initialisation launch, then per round r of 32-wide
// tiles the pivot tile (fw_pivot), the pivot row and column tiles
// (fw_panel), then every other tile (fw_rest, a min-plus product of
// the two panels), each launch over the whole batch in device memory:
// 3 ceil(V / 32) + 1 launches.  In fw_rest S[i, k] may already hold
// paths through pivots after k, so sums are reassociated; with integral
// weights and (V - 1) max w < 2^24 every finite sum is exact and
// INF + w rounds back to INF, so the result is the exact APSP,
// bit-equal to the sequential order.
// Route "per_k" (V > 128, any weights): one initialisation launch, then
// one in-place update launch per k over the whole batch, so the update
// order stays the JAX program's.  A faster order-preserving route for
// float weights above V = 128 is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.4e38f / 4.0f;   // ops/floyd_warshall.py INF
constexpr int kB = 32;                    // route "blocked" tile width
constexpr int kBS = kB + 1;               // its shared-memory row stride
constexpr int kMaxGridY = 65535;

// route "tile" block size cap: T = 8 keeps 64 cells in registers and
// needs more than the 128 registers a thread that 512 allow
constexpr int tile_max_threads(int T) { return T == 8 ? 256 : 512; }

// The JAX program's four `where`s collapsed: a pair with a padded
// endpoint is INF, a real diagonal 0, an edge (adj > 0) its weight.
__device__ __forceinline__ float init_value(float a, bool mi, bool mj,
                                            bool diag) {
  if (!(mi && mj)) return kInf;
  if (diag) return 0.0f;
  return a > 0.0f ? a : kInf;
}

// T consecutive floats of shared memory as 16- or 8-byte accesses; the
// caller keeps p aligned to min(T, 4) floats
template <int T>
__device__ __forceinline__ void lds_vec(const float* p, float (&v)[T]) {
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int q = 0; q < T; q += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + q);
      v[q] = x.x; v[q + 1] = x.y; v[q + 2] = x.z; v[q + 3] = x.w;
    }
  } else {
    static_assert(T == 2, "tile width 2, 4 or 8");
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
}

template <int T>
__device__ __forceinline__ void sts_vec(float* p, const float (&v)[T]) {
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int q = 0; q < T; q += 4)
      *reinterpret_cast<float4*>(p + q) =
          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  } else {
    static_assert(T == 2, "tile width 2, 4 or 8");
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// Route "tile".  Block: G graphs (slots) x tpr^2 threads, tpr =
// ceil(V / T); thread (ti, tj) of a slot owns cells [ti T, ti T + T) x
// [tj T, tj T + T).  Shared memory: row buffers [2][G][Vp] then column
// buffers [2][G][Vp], Vp = tpr T.  vec: adj and S may be accessed as
// float4 (V % 4 == 0 and adj 16-byte aligned; T >= 4).
template <int T>
__global__ void __launch_bounds__(tile_max_threads(T))
fw_tile(const float* __restrict__ adj, const uint8_t* __restrict__ mask,
        float* __restrict__ out, int n, int V, int G, int vec) {
  extern __shared__ float4 fw_tile_smem[];
  float* const sm = reinterpret_cast<float*>(fw_tile_smem);
  const int tpr = (V + T - 1) / T;
  const int Vp = tpr * T;
  const int tpg = tpr * tpr;
  const int slot = threadIdx.x / tpg;
  const int r = threadIdx.x - slot * tpg;
  const int ti = r / tpr;
  const int i0 = ti * T, j0 = (r - ti * tpr) * T;
  const long long g = (long long)blockIdx.x * G + slot;
  // a slot past n keeps stepping through the barriers and stores nothing
  const bool live = g < n;
  const int pst = G * Vp;                   // one parity's buffers
  float* const rowb = sm + slot * Vp;
  float* const colb = sm + 2 * pst + slot * Vp;

  float c[T][T];
  if (live) {
    const float* A = adj + g * V * V;
    const uint8_t* m = mask + g * V;
    bool mj[T];
#pragma unroll
    for (int b = 0; b < T; ++b) mj[b] = j0 + b < V && m[j0 + b] != 0;
#pragma unroll
    for (int a = 0; a < T; ++a) {
      const int i = i0 + a;
      const bool mi = i < V && m[i] != 0;
      bool done = false;
      if constexpr (T % 4 == 0) {
        if (vec) {   // j0 % 4 == 0 and V % 4 == 0: a chunk is in or out
#pragma unroll
          for (int q = 0; q < T; q += 4) {
            const int j = j0 + q;
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (i < V && j < V)
              x = __ldg(reinterpret_cast<const float4*>(
                  A + (size_t)i * V + j));
            c[a][q] = init_value(x.x, mi, mj[q], i == j);
            c[a][q + 1] = init_value(x.y, mi, mj[q + 1], i == j + 1);
            c[a][q + 2] = init_value(x.z, mi, mj[q + 2], i == j + 2);
            c[a][q + 3] = init_value(x.w, mi, mj[q + 3], i == j + 3);
          }
          done = true;
        }
      }
      if (!done) {
#pragma unroll
        for (int b = 0; b < T; ++b) {
          const int j = j0 + b;
          const float x = i < V && j < V ? __ldg(A + (size_t)i * V + j) : 0.f;
          c[a][b] = init_value(x, mi, mj[b], i == j);
        }
      }
    }
  } else {
#pragma unroll
    for (int a = 0; a < T; ++a)
#pragma unroll
      for (int b = 0; b < T; ++b) c[a][b] = kInf;
  }

  // publish row 0 and column 0 into parity 0
  if (i0 == 0) {
    float v[T];
#pragma unroll
    for (int b = 0; b < T; ++b) v[b] = c[0][b];
    sts_vec<T>(rowb + j0, v);
  }
  if (j0 == 0) {
    float v[T];
#pragma unroll
    for (int a = 0; a < T; ++a) v[a] = c[a][0];
    sts_vec<T>(colb + i0, v);
  }
  __syncthreads();

  for (int kb = 0; kb < V; kb += T) {
#pragma unroll
    for (int kk = 0; kk < T; ++kk) {
      if (kb + kk < V) {   // uniform over the block
        const int p = kk & 1;   // T even and kb % T == 0: k's parity
        float cv[T], rv[T];
        lds_vec<T>(colb + p * pst + i0, cv);
        lds_vec<T>(rowb + p * pst + j0, rv);
#pragma unroll
        for (int a = 0; a < T; ++a)
#pragma unroll
          for (int b = 0; b < T; ++b)
            c[a][b] = fminf(c[a][b], cv[a] + rv[b]);
        // row and column k + 1: micro-tile index a1 of the tile at nxt
        const int a1 = (kk + 1) % T;
        const int nxt = kk + 1 < T ? kb : kb + T;
        if (i0 == nxt) {
          float v[T];
#pragma unroll
          for (int b = 0; b < T; ++b) v[b] = c[a1][b];
          sts_vec<T>(rowb + (p ^ 1) * pst + j0, v);
        }
        if (j0 == nxt) {
          float v[T];
#pragma unroll
          for (int a = 0; a < T; ++a) v[a] = c[a][a1];
          sts_vec<T>(colb + (p ^ 1) * pst + i0, v);
        }
        __syncthreads();
      }
    }
  }

  if (live) {
    float* O = out + g * V * V;
#pragma unroll
    for (int a = 0; a < T; ++a) {
      const int i = i0 + a;
      if (i >= V) continue;
      bool done = false;
      if constexpr (T % 4 == 0) {
        if (vec) {
#pragma unroll
          for (int q = 0; q < T; q += 4)
            if (j0 + q < V)
              *reinterpret_cast<float4*>(O + (size_t)i * V + j0 + q) =
                  make_float4(c[a][q], c[a][q + 1], c[a][q + 2],
                              c[a][q + 3]);
          done = true;
        }
      }
      if (!done) {
#pragma unroll
        for (int b = 0; b < T; ++b)
          if (j0 + b < V) O[(size_t)i * V + j0 + b] = c[a][b];
      }
    }
  }
}

__global__ void __launch_bounds__(256)
fw_init(const float* __restrict__ adj, const uint8_t* __restrict__ mask,
        float* __restrict__ S, long long total, int V) {
  const long long VV = (long long)V * V;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long g = e / VV;
    const int c = (int)(e - g * VV);
    const int i = c / V, j = c - i * V;
    const uint8_t* m = mask + g * V;
    S[e] = init_value(adj[e], m[i] != 0, m[j] != 0, i == j);
  }
}

__global__ void __launch_bounds__(256)
fw_step(float* __restrict__ S, long long total, int V, int k) {
  const long long VV = (long long)V * V;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long g = e / VV;
    const int c = (int)(e - g * VV);
    const int i = c / V, j = c - i * V;
    const float* Sg = S + g * VV;
    const float via = Sg[i * V + k] + Sg[k * V + j];
    if (via < S[e]) S[e] = via;
  }
}

// Route "blocked": 256 threads a block; thread (ty, tx) = (tid / 32,
// tid % 32) owns rows ty, ty + 8, ty + 16, ty + 24 of column tx of a
// 32 x 32 tile.  Tile (ti, tj) of graph g0 + blockIdx.y; entries past V
// read as INF and are not written.
__device__ __forceinline__ float* graph_of(float* S, int V, int g0) {
  return S + (size_t)(g0 + (int)blockIdx.y) * V * V;
}

__device__ __forceinline__ void load_tile(const float* Sg, int V, int ti,
                                          int tj, float* t) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j = tj * kB + tx;
#pragma unroll
  for (int a = 0; a < kB / 8; ++a) {
    const int rr = ty + 8 * a, i = ti * kB + rr;
    t[rr * kBS + tx] = i < V && j < V ? Sg[(size_t)i * V + j] : kInf;
  }
}

__device__ __forceinline__ void store_tile(float* Sg, int V, int ti, int tj,
                                           const float* t) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j = tj * kB + tx;
#pragma unroll
  for (int a = 0; a < kB / 8; ++a) {
    const int rr = ty + 8 * a, i = ti * kB + rr;
    if (i < V && j < V) Sg[(size_t)i * V + j] = t[rr * kBS + tx];
  }
}

// phase 1: the pivot tile (r, r), k over its 32 vertices in order
__global__ void __launch_bounds__(256)
fw_pivot(float* __restrict__ S, int V, int r, int g0) {
  __shared__ float P[kB * kBS];
  float* Sg = graph_of(S, V, g0);
  load_tile(Sg, V, r, r, P);
  __syncthreads();
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int kn = min(kB, V - r * kB);
  for (int k = 0; k < kn; ++k) {
    const float rk = P[k * kBS + tx];
#pragma unroll
    for (int a = 0; a < kB / 8; ++a) {
      const int i = ty + 8 * a;
      const float via = P[i * kBS + k] + rk;
      if (via < P[i * kBS + tx]) P[i * kBS + tx] = via;
    }
    __syncthreads();
  }
  store_tile(Sg, V, r, r, P);
}

// phase 2: blockIdx.x < nt - 1 the pivot-row tiles (r, j), then the
// pivot-column tiles (i, r); k over the pivot's vertices in order
__global__ void __launch_bounds__(256)
fw_panel(float* __restrict__ S, int V, int r, int nt, int g0) {
  __shared__ float P[kB * kBS];
  __shared__ float X[kB * kBS];
  float* Sg = graph_of(S, V, g0);
  const bool is_row = (int)blockIdx.x < nt - 1;
  int t = is_row ? blockIdx.x : blockIdx.x - (nt - 1);
  t += t >= r;   // skip the pivot
  const int ti = is_row ? r : t, tj = is_row ? t : r;
  load_tile(Sg, V, r, r, P);
  load_tile(Sg, V, ti, tj, X);
  __syncthreads();
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int kn = min(kB, V - r * kB);
  for (int k = 0; k < kn; ++k) {
    if (is_row) {   // X[i, j] = min(X[i, j], P[i, k] + X[k, j])
      const float xk = X[k * kBS + tx];
#pragma unroll
      for (int a = 0; a < kB / 8; ++a) {
        const int i = ty + 8 * a;
        const float via = P[i * kBS + k] + xk;
        if (via < X[i * kBS + tx]) X[i * kBS + tx] = via;
      }
    } else {        // X[i, j] = min(X[i, j], X[i, k] + P[k, j])
      const float pk = P[k * kBS + tx];
#pragma unroll
      for (int a = 0; a < kB / 8; ++a) {
        const int i = ty + 8 * a;
        const float via = X[i * kBS + k] + pk;
        if (via < X[i * kBS + tx]) X[i * kBS + tx] = via;
      }
    }
    __syncthreads();
  }
  store_tile(Sg, V, ti, tj, X);
}

// phase 3: every tile (i, j) off the pivot's row and column, a min-plus
// product of its column-panel tile (i, r) and row-panel tile (r, j)
__global__ void __launch_bounds__(256)
fw_rest(float* __restrict__ S, int V, int r, int nt, int g0) {
  __shared__ float C[kB * kBS];
  __shared__ float R[kB * kBS];
  float* Sg = graph_of(S, V, g0);
  const int per = nt - 1;
  int ti = (int)blockIdx.x / per, tj = (int)blockIdx.x - ti * per;
  ti += ti >= r;
  tj += tj >= r;
  load_tile(Sg, V, ti, r, C);
  load_tile(Sg, V, r, tj, R);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j = tj * kB + tx;
  float o[kB / 8];
#pragma unroll
  for (int a = 0; a < kB / 8; ++a) {
    const int i = ti * kB + ty + 8 * a;
    o[a] = i < V && j < V ? Sg[(size_t)i * V + j] : kInf;
  }
  __syncthreads();
  const int kn = min(kB, V - r * kB);
  for (int k = 0; k < kn; ++k) {
    const float rk = R[k * kBS + tx];
#pragma unroll
    for (int a = 0; a < kB / 8; ++a)
      o[a] = fminf(o[a], C[(ty + 8 * a) * kBS + k] + rk);
  }
#pragma unroll
  for (int a = 0; a < kB / 8; ++a) {
    const int i = ti * kB + ty + 8 * a;
    if (i < V && j < V) Sg[(size_t)i * V + j] = o[a];
  }
}

template <int T>
cudaError_t launch_tile(const float* adj, const uint8_t* mask, float* S,
                        int n, int V, int G, cudaStream_t st) {
  const int tpr = (V + T - 1) / T;
  const int threads = G * tpr * tpr;
  if (G < 1 || threads > tile_max_threads(T)) return cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)G * tpr * T * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fw_tile<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int vec = T % 4 == 0 && V % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(adj) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(S) % 16 == 0;
  fw_tile<T><<<(n + G - 1) / G, threads, smem, st>>>(adj, mask, S, n, V, G,
                                                     vec);
  return cudaGetLastError();
}

cudaError_t launch_init(const float* adj, const uint8_t* mask, float* S,
                        int n, int V, cudaStream_t st, long long* blocks) {
  const long long total = (long long)n * V * V;
  const int tpb = 256;
  *blocks = (total + tpb - 1) / tpb;
  if (*blocks > 132LL * 64) *blocks = 132LL * 64;   // grid-stride beyond
  fw_init<<<(int)*blocks, tpb, 0, st>>>(adj, mask, S, total, V);
  return cudaGetLastError();
}

cudaError_t launch_blocked(float* S, int n, int V, cudaStream_t st) {
  const int nt = (V + kB - 1) / kB;
  for (int r = 0; r < nt; ++r) {
    for (int g0 = 0; g0 < n; g0 += kMaxGridY) {
      const unsigned ng = (unsigned)(n - g0 < kMaxGridY ? n - g0
                                                        : kMaxGridY);
      fw_pivot<<<dim3(1, ng), 256, 0, st>>>(S, V, r, g0);
      if (nt > 1) {
        fw_panel<<<dim3(2 * (nt - 1), ng), 256, 0, st>>>(S, V, r, nt, g0);
        fw_rest<<<dim3((nt - 1) * (nt - 1), ng), 256, 0, st>>>(S, V, r, nt,
                                                             g0);
      }
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

// adj [n, V, V] f32, mask [n, V] u8 (0 or 1), S [n, V, V] f32 output,
// all contiguous on the current device.  route 0 = "tile" with tile
// width `tile` (2, 4 or 8) and `graphs` graphs per block (at most 512
// threads a block, 256 at T = 8), 1 = "blocked", 2 = "per_k"; the Python
// wrapper chooses (ops/floyd_warshall.py fw_route, fw_tile_config).
// Launches on `stream`; returns the first CUDA error, or
// cudaGetLastError() after the last launch.
extern "C" int grakel_floyd_warshall(const float* adj, const uint8_t* mask,
                                     float* S, int n, int V, int route,
                                     int tile, int graphs, void* stream) {
  if (n <= 0 || V <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 0) {
    switch (tile) {
      case 2: return (int)launch_tile<2>(adj, mask, S, n, V, graphs, st);
      case 4: return (int)launch_tile<4>(adj, mask, S, n, V, graphs, st);
      case 8: return (int)launch_tile<8>(adj, mask, S, n, V, graphs, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 1 && route != 2) return (int)cudaErrorInvalidValue;
  long long blocks = 0;
  cudaError_t err = launch_init(adj, mask, S, n, V, st, &blocks);
  if (err != cudaSuccess) return (int)err;
  if (route == 1) return (int)launch_blocked(S, n, V, st);
  const long long total = (long long)n * V * V;
  for (int k = 0; k < V; ++k) {
    fw_step<<<(int)blocks, 256, 0, st>>>(S, total, V, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
