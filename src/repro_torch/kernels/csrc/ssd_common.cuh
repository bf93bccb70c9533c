// Building blocks shared by ssd_scan.cu and ssd_scan_bwd.cu: the tile
// sizes, split-TF32 products on mma.sync m16n8k8 (the split, the mma and
// the cp.async primitives in tf32.cuh), the chunk's cumulative decay, and
// cp.async copies of tiles into shared memory.
// repro_torch/kernels/build.py hashes this header into the build key of
// every source that includes it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr int kThreads = 256;      // 8 warps: 4 bands of 16 rows x 2 halves
constexpr int kRows = 64;          // rows of a block's product tile
constexpr int kCols = 64;          // columns of a block's product tile
constexpr int kMaxL = 128;         // chunk length
constexpr int kMaxN = 128;         // state size
constexpr int kMaxHeads = 16;      // heads an output block walks through

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Row strides, in floats, keep the fragment loads free of bank conflicts:
// kLdRow (== 8 mod 32) for arrays read down their columns, ld == 4 mod 8
// for arrays read along their rows.
constexpr int kLdRow = kCols + 8;

// Heads an output block walks through: the largest power of two <= 16 that
// divides H / G, so that they share one group's C B^T and C.
__host__ __device__ inline int heads_per_block(int H, int G) {
  const int rep = H / G;
  return min(rep & -rep, kMaxHeads);
}

// One warp: hi[t] + lo[t] += A[16 rows][k steps ks0..ks1) @ B[..][8
// columns from 8t], A(g + 8u, k) = a(u, k) and B(k, c) = b(k, c) read from
// shared memory, in split TF32: lo takes a_lo b_hi + a_hi b_lo, hi a_hi
// b_hi, two chains of dependent MMAs instead of one (hi and lo may be the
// same array: one chain).  The m16n8k8 fragments: lane = 4 g + q holds A
// rows g, g + 8 at columns q, q + 4, B rows q, q + 4 at column g, and the
// sums of rows g, g + 8 at columns 2q, 2q + 1.
template <class AFn, class BFn>
__device__ __forceinline__ void warp_mma(float (&hi)[4][4], float (&lo)[4][4],
                                         AFn a, BFn b, int ks0, int ks1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll 4
  for (int ks = ks0; ks < ks1; ++ks) {
    const int k = 8 * ks + q;
    uint32_t ah[4], al[4];
    split_tf32(a(0, k), ah[0], al[0]);
    split_tf32(a(1, k), ah[1], al[1]);
    split_tf32(a(0, k + 4), ah[2], al[2]);
    split_tf32(a(1, k + 4), ah[3], al[3]);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = 8 * t + g;
      uint32_t bh[2], bl[2];
      split_tf32(b(k, c), bh[0], bl[0]);
      split_tf32(b(k + 4, c), bh[1], bl[1]);
      mma_tf32(lo[t], al, bh);
      mma_tf32(lo[t], ah, bl);
      mma_tf32(hi[t], ah, bh);
    }
  }
}

// cum[i] = sum_{k <= i} negA dts[k] for i < LP <= 128: one warp, four
// entries a lane, then a shuffle scan of the lanes' totals.
__device__ void chunk_cum(const float* dts, float* cum, float negA, int LP) {
  const int lane = threadIdx.x & 31;
  float v[4], run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * lane + k;
    run += i < LP ? negA * dts[i] : 0.f;
    v[k] = run;
  }
  float incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (4 * lane + k < LP) cum[4 * lane + k] = excl + v[k];
}

// rows x cols (cols <= 128) of src (row stride lds, in global memory) into
// dst (row stride ld, a multiple of 4, 16-byte aligned), asynchronously, by
// the threads tid of 0..nthreads.
// Row r holds lim(r) <= cols elements of src, then zeros.  Where src and
// lds allow it, a lane copies 16 bytes (a warp two rows of <= 64 columns
// or one of <= 128), else 4.  A block issues every copy of its tiles
// before it waits, so their latencies overlap.
template <class Lim>
__device__ __forceinline__ void copy_tile(float* dst, int ld, const float* src,
                                          long long lds, int rows, int cols,
                                          Lim lim, int tid, int nthreads) {
  const int warp = tid >> 5, lane = tid & 31, kWarps = nthreads >> 5;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (lds & 3) == 0) {
    const int per_row = cols <= 64 ? 16 : 32;      // lanes a row
    const int sub = lane / per_row, c = 4 * (lane % per_row);
    const int step = kWarps * (32 / per_row);
    for (int r = warp * (32 / per_row) + sub; r < rows; r += step) {
      if (c >= cols) continue;
      const int n = min(max(lim(r) - c, 0), 4);
      cp_async16(dst + r * ld + c, n ? src + r * lds + c : src, 4 * n);
    }
  } else {
    for (int r = warp; r < rows; r += kWarps) {
      const int n = lim(r);
      for (int c = lane; c < cols; c += 32)
        cp_async4(dst + r * ld + c, c < n ? src + r * lds + c : src,
                  c < n ? 4 : 0);
    }
  }
}

// Split-TF32 sums hi + lo of rows g, g + 8 (r = 0, 1) of a warp's tile.
__device__ __forceinline__ float2 tile_sum(const float (&hi)[4][4],
                                           const float (&lo)[4][4], int t,
                                           int r) {
  return make_float2(hi[t][2 * r] + lo[t][2 * r],
                     hi[t][2 * r + 1] + lo[t][2 * r + 1]);
}

}  // namespace
