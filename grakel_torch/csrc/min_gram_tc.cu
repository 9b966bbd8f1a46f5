// K1-tc: min-intersection Gram of count histograms on the tensor cores,
// K = E_A . E_B^T over int8 threshold indicators, and the expansion that
// writes those indicators.
//
// Replaces, for nonnegative integer inputs, the Pallas TPU kernel
// grakel_tpu/ops/intersect.py _min_gram_kernel; it is the counterpart of
// that package's threshold-indicator route _min_gram_gemm (:244), which
// uses
//   sum_l min(a_l, b_l) = sum_l sum_{t=1..T_l} [a_l >= t] [b_l >= t].
// The caller (ops/intersect.py) lists one expanded column w per (l, t),
// t = 1..T_l, T_l = min(max_i A[i, l], max_j B[j, l]), each with an int8
// value v_w (1, or a PyramidMatch level's integer weight <= 127), and
// grakel_threshold_expand writes E[r, i, w] = A[r, i, l_w] >= t_w ? v_w :
// 0 straight as int8 for every round or level of a call in one launch
// (no f32 intermediate).  Then K[r, i, j] = sum_w E_A[r, i, w] E_B[r, j,
// w]: with weights on E_A only, one product gives sum_p c_p I_p, a
// weighted sum of level Grams, exactly (s32 sums, f32 exact below 2^24).
//
// What bounds it on an H100: 2 n m W' int8 operations a round on (n +
// m) W' bytes in and 4 n m bytes out.  NeighborhoodHash's fit Gram (3
// rounds of 4110 x 4110, W' ~ 750) is bound by its 203 MB of stores;
// PyramidMatch's labeled Gram, its four levels in one call (4110 x 4110,
// W' ~ 9,000), by the tensor cores' 1,979 TOP/s.
//
// Design (Hopper, sm_90a).  wgmma.mma_async m64nNk32 s8 x s8 -> s32 with
// both operands K-major in shared memory, fed by TMA: a ring of stages,
// each a BM x 128-byte tile of E_A and a BN x 128-byte tile of E_B,
// loaded by one producer thread through cp.async.bulk.tensor into the
// 128-byte swizzled layout that the wgmma descriptors name, each stage
// behind a "full" mbarrier (TMA's transaction count) and an "empty" one
// (one arrival a consumer warp).  One or two consumer warpgroups each own
// 64 rows of the tile and all BN columns (BN / 2 s32 accumulators a
// thread).  The tensor maps are 3-D ([R, rows, W'p], W'p a multiple of
// 16), so one launch covers every round; TMA zero-fills rows past n or m
// and bytes past W'p, and the stores are masked.  The tensor maps are
// encoded through cudaGetDriverEntryPoint, so the library links only the
// CUDA runtime.  A consumer keeps one stage's products in flight while it
// waits for the next stage.  The grid is 1-D and sized to the call: a
// block a (round, tile) of the tiles that hold an entry on or above the
// diagonal when the Gram is symmetric (no block returns at once; the
// entries on or above the diagonal are written directly, those above it
// mirrored too, each once), else of the rectangle.  The tile shape
// (TC_TILES in ops/intersect.py: 128 x 128, 64 x 64, 64 x 128, 128 x
// 256) is picked so the grid fills the card; the wide ones read each
// operand byte from L2 for 170 products instead of 128.  The epilogue
// stages alpha * acc (f32) in the ring's shared memory and stores the
// tile rows and the mirror rows coalesced, into the stack (no zero fill
// before) or, when accumulating, K += alpha * acc.
#include <cuda.h>   // CUtensorMap and its enums; libcuda is not linked
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int KB = 128;   // bytes of W' a stage holds: one swizzle span

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of a K-major tile in the 128-byte swizzled layout TMA
// writes: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride
// byte offset); the leading byte offset is unused by this layout
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// D[64 x N] (+)= A[64 x 32] B[N x 32]^T, s8 x s8 -> s32; N / 2 registers
// of d a thread (scale_d 0: D = A B^T)
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int BM, int BN>
struct TcCfg {
  static constexpr int CW = BM / 64;              // consumer warpgroups
  static constexpr int NT = CW * 128;             // consumer threads
  static constexpr int THREADS = NT + 32;         // + the producer warp
  // stages: 2 blocks an SM for the 128 x 128 and 64 x N tiles, whose
  // epilogue then overlaps another block's products; 1 for 128 x 256
  static constexpr int STAGES = (BM == 128 && BN == 128) ? 3 : 4;
  static constexpr int MIN_BLOCKS = BN == 256 ? 1 : (BN == 64 ? 3 : 2);
  static constexpr int TILE_A = BM * KB;
  static constexpr int STAGE = (BM + BN) * KB;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SROW = BN + 1;             // f32 row of the staged tile
  static constexpr int STAGING = BM * SROW * 4;
  static constexpr int BODY = RING > STAGING ? RING : STAGING;
  // 1024 bytes of slack to align the ring to the swizzle's 1024-byte atom
  static constexpr int SMEM = 1024 + BODY + 2 * STAGES * 8;
};

// Write the staged tile S [BM][SROW] to K [n, m] at (row0, col0), or its
// transpose at (col0, row0), adding to K when accumulating.  A symmetric
// call writes each entry once: the entries on or above the diagonal
// directly, those strictly above it mirrored.  Each line (a tile row,
// or a tile column when transposed) is one segment of a row of K, which
// a warp writes in chunks of 32 consecutive floats shifted onto K's
// 32-byte sectors (one chunk more than the line needs): a row of K is
// 4 m bytes long, so unshifted chunks would start mid-sector and write
// partial sectors.  The odd row length of S keeps the column reads of
// the transpose free of bank conflicts.  A line loads its old values
// before its stores.
template <int BM, int BN, int NT, bool kTransposed>
__device__ __forceinline__ void write_tile(float* K, const float* S,
                                           int row0, int col0, int n, int m,
                                           int accumulate, int symmetric,
                                           int tid) {
  constexpr int SROW = BN + 1;
  constexpr int LINES = kTransposed ? BN : BM;
  constexpr int LEN = kTransposed ? BM : BN;   // floats a line
  constexpr int CHUNKS = LEN / 32 + 1;
  constexpr int WARPS = NT / 32;
  const int lane = tid & 31;
  const int grow0 = kTransposed ? col0 : row0;   // K's row of line 0
  const int gcol0 = kTransposed ? row0 : col0;   // K's column of element 0
#pragma unroll 1
  for (int line = tid >> 5; line < LINES; line += WARPS) {
    const int grow = grow0 + line;
    if (grow >= n) break;   // the warp's later lines lie past n too
    float* dst = K + (size_t)grow * m + gcol0;
    const int skew = (int)(((uintptr_t)dst >> 2) & 7);
    // the line's elements to write: [lo, hi)
    int lo = 0, hi = m - gcol0 < LEN ? m - gcol0 : LEN;
    if (symmetric) {
      if (kTransposed)
        hi = hi < grow - gcol0 ? hi : grow - gcol0;   // column < row
      else
        lo = grow - gcol0 > 0 ? grow - gcol0 : 0;     // column >= row
    }
    float v[CHUNKS];
    bool ok[CHUNKS];
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int j = 32 * k + lane - skew;
      ok[k] = j >= lo && j < hi;
      v[k] = ok[k] ? S[kTransposed ? j * SROW + line : line * SROW + j]
                   : 0.0f;
    }
    if (accumulate) {
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k)
        if (ok[k]) v[k] += dst[32 * k + lane - skew];
    }
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k)
      if (ok[k]) dst[32 * k + lane - skew] = v[k];
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(TcCfg<BM, BN>::THREADS,
                                  TcCfg<BM, BN>::MIN_BLOCKS)
min_gram_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   float* __restrict__ K, int n, int m, int nk, float alpha,
                   int accumulate, int symmetric, int tiles_n, int tiles_m,
                   long long per_round) {
  using C = TcCfg<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (sbase - raw);
  const uint32_t full0 = sbase + C::BODY;          // STAGES mbarriers
  const uint32_t empty0 = full0 + C::STAGES * 8;   // STAGES mbarriers

  // block -> (round, output tile (bi, bj)).  Symmetric: the tiles that
  // hold an entry on or above the diagonal, column block by column block
  // (F = BN / BM row blocks a column block more each time), from the
  // triangular root of the index; else the rectangle, row by row.
  constexpr int F = BN / BM;
  const int round = (int)(blockIdx.x / per_round);
  const long long q = blockIdx.x % per_round;
  int bi, bj;
  if (symmetric) {
    long long c = (long long)((sqrt(8.0 * (double)q / F + 1.0) - 1.0) / 2.0);
    while (F * c * (c + 1) / 2 > q) --c;
    while (F * (c + 1) * (c + 2) / 2 <= q) ++c;
    bj = (int)c;
    bi = (int)(q - F * c * (c + 1) / 2);
  } else {
    bi = (int)(q / tiles_m);
    bj = (int)(q % tiles_m);
  }
  const int row0 = bi * BM;
  const int col0 = bj * BN;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * C::CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= C::NT) {
    // producer: one thread keeps the ring's TMA loads in flight
    if (tid == C::NT) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % C::STAGES;
        if (kt >= C::STAGES)
          mbar_wait(empty0 + 8 * s, ((kt / C::STAGES) - 1) & 1);
        const uint32_t st = sbase + s * C::STAGE;
        mbar_expect_tx(full0 + 8 * s, C::STAGE);
        tma_load_3d(st, &map_a, full0 + 8 * s, kt * KB, row0, round);
        tma_load_3d(st + C::TILE_A, &map_b, full0 + 8 * s, kt * KB, col0,
                    round);
      }
    }
    return;
  }

  // consumers: warpgroup g owns rows g * 64 .. g * 64 + 63 of the tile
  const int g = tid >> 7;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;   // warp within the warpgroup
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  // one stage's products stay in flight while the next stage is waited
  // for; a stage is released once its products are done
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % C::STAGES;
    mbar_wait(full0 + 8 * s, (kt / C::STAGES) & 1);
    const uint32_t st = sbase + s * C::STAGE;
    const uint64_t da = sw128_desc(st + g * 64 * KB);
    const uint64_t db = sw128_desc(st + C::TILE_A);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 32; ++kk)   // 32 bytes a step: +2 in 16 B
      wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait_one();
    if (kt > 0 && lane == 0)
      mbar_arrive(empty0 + 8 * ((kt - 1) % C::STAGES));
  }
  wgmma_wait_all();

  // every consumer is done with the ring: it holds the staged tile.
  // Accumulator 4 c + e holds row warp * 16 + lane / 4 (+ 8 for e >= 2),
  // column 8 c + 2 (lane % 4) + e % 2 of the warpgroup's 64 x BN part.
  asm volatile("bar.sync 1, %0;\n" ::"n"(C::NT) : "memory");
  float* S = reinterpret_cast<float*>(smem);
  const int r0 = g * 64 + warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int c = 0; c < BN / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      S[(r0 + (e >> 1) * 8) * C::SROW + 8 * c + c0 + (e & 1)] =
          alpha * (float)acc[4 * c + e];
  asm volatile("bar.sync 1, %0;\n" ::"n"(C::NT) : "memory");
  float* Kr = K + (size_t)round * n * m;
  write_tile<BM, BN, C::NT, false>(Kr, S, row0, col0, n, m, accumulate,
                                   symmetric, tid);
  if (symmetric && row0 < col0 + BN - 1)   // entries strictly above
    write_tile<BM, BN, C::NT, true>(Kr, S, row0, col0, n, m, accumulate,
                                    symmetric, tid);
}

// the tensor-map encoder of the driver, found through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// [R, rows, k] int8 at X, boxes of 128 bytes x `box` rows x 1 round,
// 128-byte swizzle, out-of-bounds bytes read as zero
bool encode(CUtensorMap* map, const int8_t* X, int R, int rows, int k,
            int box) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)k, (cuuint64_t)rows, (cuuint64_t)R};
  const cuuint64_t strides[2] = {(cuuint64_t)k, (cuuint64_t)k * rows};
  const cuuint32_t boxes[3] = {(cuuint32_t)KB, (cuuint32_t)box, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, (void*)X, dims, strides,
            boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN>
int launch_tc(const int8_t* A, const int8_t* B, float* K, int R, int n,
              int m, int k, float alpha, int accumulate, int symmetric,
              cudaStream_t stream) {
  using C = TcCfg<BM, BN>;
  static_assert(BN % BM == 0 && BN / BM <= 2, "symmetric tiles: BN = BM "
                "or 2 BM");
  // above 48 KB of dynamic shared memory needs an opt-in, once per device
  static bool smem_set[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(min_gram_tc_kernel<BM, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) smem_set[dev] = true;
  }
  CUtensorMap ma, mb;
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  // k == 0: no stage is loaded and the maps are never read
  if (k > 0 && !(encode(&ma, A, R, n, k, BM) && encode(&mb, B, R, m, k, BN)))
    return (int)cudaErrorInvalidValue;
  const long long tn = (n + BM - 1) / BM, tm = (m + BN - 1) / BN;
  // symmetric: column block bj holds row blocks 0 .. F (bj + 1) - 1, but
  // for the last one, F tm - tn fewer (the last indices of the order)
  constexpr int F = BN / BM;
  const long long per = symmetric ? F * tm * (tm + 1) / 2 - (F * tm - tn)
                                  : tn * tm;
  if (per * R >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  min_gram_tc_kernel<BM, BN><<<(unsigned)(per * R), C::THREADS, C::SMEM,
                                stream>>>(ma, mb, K, n, m, (k + KB - 1) / KB,
                                          alpha, accumulate, symmetric,
                                          (int)tn, (int)tm, per);
  return (int)cudaGetLastError();
}

// E[r, i, w] = X[r, i, src_w] >= thr_w ? val_w : 0 (int8; val_w = 1
// unless use_val), and E01 the 0/1 indicators when given; cols [R,
// col_rows, w] int32 rows (src, thr, val).  A thread owns 4 columns and
// walks the rows of its round, its columns' (src, thr, val) in
// registers; X's row stays in L1.
__global__ void __launch_bounds__(256)
threshold_expand_kernel(const float* __restrict__ X,
                        const int* __restrict__ cols, int8_t* __restrict__ E,
                        int8_t* __restrict__ E01, int n, int L, int w,
                        int col_rows, int use_val) {
  const int r = blockIdx.z;
  const int w0 = (blockIdx.x * 256 + threadIdx.x) * 4;
  if (w0 >= w) return;
  const int* c = cols + (size_t)r * col_rows * w;
  int src[4], val[4];
  float thr[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    src[q] = c[w0 + q];
    thr[q] = (float)c[w + w0 + q];
    val[q] = use_val ? c[2 * w + w0 + q] : 1;
  }
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t row = (size_t)r * n + i;
    const float* x = X + row * L;
    uint32_t pack = 0u, pack01 = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool hit = __ldg(x + src[q]) >= thr[q];
      pack |= (hit ? ((uint32_t)val[q] & 0xFFu) : 0u) << (8 * q);
      pack01 |= (hit ? 1u : 0u) << (8 * q);
    }
    reinterpret_cast<uint32_t*>(E + row * w)[w0 >> 2] = pack;
    if (E01) reinterpret_cast<uint32_t*>(E01 + row * w)[w0 >> 2] = pack01;
  }
}

}  // namespace

// A [R, n, k] and B [R, m, k]: int8, row-major, contiguous, 16-byte
// aligned, k % 16 == 0, on the current device; K [R, n, m] f32.  K[r] =
// alpha * A[r] B[r]^T, or K[r] += alpha * A[r] B[r]^T when accumulate !=
// 0.  symmetric != 0 is the caller's promise that every A[r] B[r]^T is
// symmetric (B == A, or A carrying column weights of B's indicators) and
// needs n == m: the upper block triangle is computed and mirrored.  tile
// picks the instantiation (0: 128 x 128, 1: 64 x 64, 2: 64 x 128, 3: 128
// x 256).  Launches on `stream`; returns
// cudaGetLastError() or cudaErrorInvalidValue.
extern "C" int grakel_min_gram_tc(const int8_t* A, const int8_t* B, float* K,
                                  int R, int n, int m, int k, float alpha,
                                  int accumulate, int symmetric, int tile,
                                  void* stream) {
  if (R <= 0 || n <= 0 || m <= 0) return (int)cudaGetLastError();
  if (k < 0 || k % 16 != 0 || (symmetric && n != m) ||
      ((uintptr_t)A | (uintptr_t)B) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 0: return launch_tc<128, 128>(A, B, K, R, n, m, k, alpha, accumulate,
                                       symmetric, st);
    case 1: return launch_tc<64, 64>(A, B, K, R, n, m, k, alpha, accumulate,
                                     symmetric, st);
    case 2: return launch_tc<64, 128>(A, B, K, R, n, m, k, alpha, accumulate,
                                      symmetric, st);
    case 3: return launch_tc<128, 256>(A, B, K, R, n, m, k, alpha, accumulate,
                                       symmetric, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// X [R, n, L] f32, cols [R, col_rows, w] int32 (w % 4 == 0; col_rows 3
// when use_val), E and E01 (may be null) [R, n, w] int8, all contiguous
// on the current device.  Launches on `stream`; returns
// cudaGetLastError() or cudaErrorInvalidValue.
extern "C" int grakel_threshold_expand(const float* X, const int* cols,
                                       int8_t* E, int8_t* E01, int R, int n,
                                       int L, int w, int col_rows, int use_val,
                                       void* stream) {
  if (R <= 0 || n <= 0 || w <= 0) return (int)cudaGetLastError();
  if (w % 4 != 0 || L <= 0 || R > 65535 || col_rows < 2 + (use_val != 0) ||
      col_rows > 3)
    return (int)cudaErrorInvalidValue;
  const int gx = (w / 4 + 255) / 256;
  int gy = 4096 / gx;
  gy = gy < 1 ? 1 : (gy > n ? n : (gy > 65535 ? 65535 : gy));
  threshold_expand_kernel<<<dim3(gx, gy, R), 256, 0, (cudaStream_t)stream>>>(
      X, cols, E, E01, n, L, w, col_rows, use_val);
  return (int)cudaGetLastError();
}
