// K17: the float64 normalization of a Gram, out = K / sqrt(dr_i dc_j).
//
// Replaces no TPU kernel: the JAX package normalizes on the host in
// numpy (grakel_tpu/ops/gram.py normalize_gram), and so does the port's
// host route (ops/gram.py normalize_gram on a numpy array or a CPU
// tensor).  On the card the Gram is normalized before its fetch, so the
// host receives the finished float64 Gram and no float64 pass runs over
// it there.
//
// Bit-equal to numpy: numpy computes np.outer(dr, dc) (one rounded f64
// product), np.sqrt (correctly rounded), the division (correctly
// rounded) and np.nan_to_num (NaN -> 0, +inf -> DBL_MAX, -inf ->
// -DBL_MAX).  Each entry here does the same three operations in the same
// order with the _rn intrinsics, which no flag or contraction can
// change, then the same mapping.  K's f32 entries widen to f64 exactly.
//
// What bounds it on an H100: bytes.  An entry reads 4 (f32 K) or 8 (f64
// K) bytes and writes 8; the diagonals are read once a row (dr) and
// stay in L2 (dc).  At 4110^2 f32 that is 203 MB, 0.061 ms at 3.35 TB/s,
// against one f64 square root and division an entry (FP64 at 67
// TFLOP/s leaves them far below the bytes' time).
//
// Design: one pass, a grid over rows (y, looping past 65535 rows) and
// column tiles of 4 x 256 entries (x).  A thread reads four entries of a
// row with one 16-byte load (f32; two for f64) and writes two 16-byte
// double2 stores, both streaming (__ldcs / __stcs: the Gram is touched
// once).  A row's first entries up to K's 16-byte boundary (at most 3)
// and its last ragged entries (at most 3) are done one at a time, so any
// width works; dr_i is held in a register for the row.
#include <cuda_runtime.h>
#include <cfloat>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                      // entries a thread
constexpr int kTile = kThreads * kVec;       // columns a block
constexpr int kMaxRowsGrid = 65535;

__device__ __forceinline__ double norm_entry(double k, double di,
                                             double dj) {
  const double q = __ddiv_rn(k, __dsqrt_rn(__dmul_rn(di, dj)));
  if (isnan(q)) return 0.0;
  if (isinf(q)) return q > 0.0 ? DBL_MAX : -DBL_MAX;
  return q;
}

__device__ __forceinline__ void load4(const float* p, double* v) {
  const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_normalize_kernel(const T* __restrict__ K, const double* __restrict__ dr,
                      const double* __restrict__ dc,
                      double* __restrict__ out, int m, int n) {
  for (int i = blockIdx.y; i < m; i += gridDim.y) {
    const long long row = (long long)i * n;
    const T* k = K + row;
    double* o = out + row;
    const double di = dr[i];
    // entries before K's 16-byte boundary in this row; K and out are
    // 16-byte aligned, so out is 16-byte aligned where K is
    const int head = min(
        n, (int)(((16u - ((uint32_t)(uintptr_t)k & 15u)) & 15u) / sizeof(T)));
    if (blockIdx.x == 0 && (int)threadIdx.x < head) {
      const int j = threadIdx.x;
      o[j] = norm_entry((double)k[j], di, __ldg(dc + j));
    }
    const int j = head + kVec * (blockIdx.x * kThreads + threadIdx.x);
    if (j + kVec <= n) {
      double v[kVec];
      load4(k + j, v);
      double2* o2 = reinterpret_cast<double2*>(o + j);
      __stcs(o2, make_double2(norm_entry(v[0], di, __ldg(dc + j)),
                              norm_entry(v[1], di, __ldg(dc + j + 1))));
      __stcs(o2 + 1, make_double2(norm_entry(v[2], di, __ldg(dc + j + 2)),
                                  norm_entry(v[3], di, __ldg(dc + j + 3))));
    } else {
      for (int t = j; t < n; ++t)    // the row's ragged end
        o[t] = norm_entry((double)k[t], di, __ldg(dc + t));
    }
  }
}

template <typename T>
int launch(const void* K, const double* dr, const double* dc, double* out,
           int m, int n, cudaStream_t st) {
  const dim3 grid((n + kTile - 1) / kTile, m < kMaxRowsGrid ? m
                                                            : kMaxRowsGrid);
  gram_normalize_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(K), dr, dc, out, m, n);
  return (int)cudaGetLastError();
}

}  // namespace

// K [m, n] (f32 when k_f64 == 0, else f64), row-major, contiguous and
// 16-byte aligned; dr [m], dc [n] f64; out [m, n] f64, contiguous and
// 16-byte aligned, every entry written.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int grakel_normalize_gram(const void* K, int k_f64,
                                     const double* dr, const double* dc,
                                     double* out, int m, int n,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  return k_f64 ? launch<double>(K, dr, dc, out, m, n, st)
               : launch<float>(K, dr, dc, out, m, n, st);
}
