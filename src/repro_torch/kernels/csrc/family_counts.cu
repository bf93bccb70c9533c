// Joint-configuration counts of many discrete families (structure learning)
// for Hopper (sm_90a), built by repro_torch/kernels/build.py with nvcc into a
// shared library with a plain C interface and called through ctypes from
// repro_torch/kernels/family_counts.py.
//
// Replaces the Pallas TPU kernel of repro/kernels/family_counts.py:
//   family_counts  (family_counts.py:85)
//     counts[m, c] = sum_n w[n] [ sum_f strides[m, f] * xd[n, f] == c ]
// A code outside [0, C) counts nothing.
//
// What bounds it on this card: the (instance, family) updates, not the bytes.
// At the all-candidates shape of chip_smoke.py (N = 2^20 instances, Fd = 32
// columns, M = 15904 families, C = 64) xd is 128 MB, read in ~0.04 ms, while
// the 1.7e10 (instance, family) pairs each need a mixed-radix code (one
// multiply-add per family member) and one histogram update.
//
// Design (deterministic, no atomics anywhere):
//   * The wrapper compacts the dense [M, Fd] stride matrix into k (column,
//     stride) pairs per family (k = 1 + parents), so a code costs k
//     multiply-adds instead of an Fd-term dot; a thread keeps its family's
//     pairs in registers (KMAX is a template parameter).
//   * Thread = (family, instance slice).  A block owns G families and
//     S = 256 / G interleaved instance slices of one slab of instances; each
//     thread keeps a private histogram row of the block's C-range in shared
//     memory and walks the slab tile by tile (a tile of T instances of xd and
//     w is staged in shared memory once for all G families -- the loop inside
//     the block replaces the Pallas grid's sequential instance axis, and the
//     tile is read once for many families instead of once per family).
//     A private row needs no atomics and sees its instances in order.
//   * The block adds its S slice rows in slice order and writes
//     partial[slab, m, c]; a second kernel sums the slabs in a fixed order.
//     Two launches on one input give the same bits; with 0/1 weights every
//     sum is an exact integer below 2^24, so the counts equal the plain
//     version's bit for bit.
//   * The histogram rows bound G * C by shared memory, so the grid's third
//     axis splits C into ranges of at most Cb bins (a code outside the
//     block's range is skipped there and counted by another block); the
//     wrapper picks G, S, T, Cb and the slab count (partials in the tens of
//     MB).  Row stride is Cb rounded up to odd, spreading the 32 private rows
//     of a warp over the shared-memory banks.
//   * Codes are int32 with wrap-around arithmetic; they are exact while
//     |sum_f strides[m, f] * xd[n, f]| < 2^31, always so for categories in
//     range (their codes lie in [0, C)).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReduceEntries = 32;  // stage-2 block: 32 entries x 8 slab lanes
constexpr int kReduceLanes = 8;

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
    family_counts_slab(const int* __restrict__ xd,
                       const int* __restrict__ cols,
                       const int* __restrict__ svals,
                       const float* __restrict__ w,
                       float* __restrict__ partial, int N, int Fd, int M,
                       int k, int C, int Cb, int G, int T, int slab_len) {
  extern __shared__ float smem[];
  const int S = kThreads / G;
  const int hs = Cb | 1;                         // odd row stride
  float* hist = smem;                            // [kThreads, hs]
  float* s_w = hist + kThreads * hs;             // [T]
  int* s_x = reinterpret_cast<int*>(s_w + T);    // [T, Fd]

  const int t = threadIdx.x;
  const int gl = t % G;
  const int sl = t / G;
  const int m = blockIdx.x * G + gl;
  const bool live = m < M;
  const int slab = blockIdx.y;
  const int c0 = blockIdx.z * Cb;
  const int cw = min(Cb, C - c0);

  int col[KMAX];
  unsigned sv[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    const bool use = live && j < k;
    col[j] = use ? cols[(long)m * k + j] : 0;
    sv[j] = use ? (unsigned)svals[(long)m * k + j] : 0u;
  }
  for (int i = t; i < kThreads * hs; i += kThreads) hist[i] = 0.f;
  float* h = hist + t * hs;

  const long n_begin = (long)slab * slab_len;
  const long n_end = min((long)N, n_begin + slab_len);
  for (long n0 = n_begin; n0 < n_end; n0 += T) {
    const int cnt = (int)min((long)T, n_end - n0);
    __syncthreads();                             // the last tile is consumed
    const int* src = xd + n0 * Fd;
    for (int i = t; i < cnt * Fd; i += kThreads) s_x[i] = src[i];
    for (int i = t; i < cnt; i += kThreads) s_w[i] = w[n0 + i];
    __syncthreads();
    if (live) {
      for (int i = sl; i < cnt; i += S) {
        const int* x = s_x + i * Fd;
        unsigned code = 0u;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) code += sv[j] * (unsigned)x[col[j]];
        const unsigned c = code - (unsigned)c0;   // < cw iff in this range
        if (c < (unsigned)cw) h[c] += s_w[i];
      }
    }
  }
  __syncthreads();
  // slice rows of a family are rows gl, G + gl, 2G + gl, ...: add in order
  float* out = partial + (long)slab * M * C;
  for (int e = t; e < G * cw; e += kThreads) {
    const int g = e / cw;
    const int c = e % cw;
    const int mm = blockIdx.x * G + g;
    if (mm >= M) continue;
    float tot = 0.f;
    for (int s = 0; s < S; ++s) tot += hist[(s * G + g) * hs + c];
    out[(long)mm * C + c0 + c] = tot;
  }
}

__global__ void slab_reduce(const float* __restrict__ partial,
                            float* __restrict__ out, int n_slabs, long E) {
  __shared__ float s_lane[kReduceLanes][kReduceEntries];
  const long e = (long)blockIdx.x * kReduceEntries + threadIdx.x;
  float acc = 0.f;
  if (e < E)
    for (int s = threadIdx.y; s < n_slabs; s += kReduceLanes)
      acc += partial[(long)s * E + e];
  s_lane[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < E) {
    float tot = 0.f;
    for (int j = 0; j < kReduceLanes; ++j) tot += s_lane[j][threadIdx.x];
    out[e] = tot;
  }
}

template <int KMAX>
int launch_slab(dim3 grid, size_t smem, cudaStream_t s, const int* xd,
                const int* cols, const int* svals, const float* w,
                float* partial, int N, int Fd, int M, int k, int C, int Cb,
                int G, int T, int slab_len) {
  int err = (int)cudaFuncSetAttribute(
      family_counts_slab<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  family_counts_slab<KMAX><<<grid, kThreads, smem, s>>>(
      xd, cols, svals, w, partial, N, Fd, M, k, C, Cb, G, T, slab_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int family_counts_threads() { return kThreads; }

// The largest number of (column, stride) pairs a family may have.
int family_counts_max_k() { return 32; }

// counts [M, C] of xd [N, Fd] (int32) under the compacted families
// cols/svals [M, k] (int32) with weights w [N]; partial holds
// n_slabs * M * C floats (n_slabs = ceil(N / slab_len)).  G families per
// block (a power of two, 32..256), T instances per tile, C split into
// ranges of Cb bins.
int family_counts_launch(const void* xd, const void* cols, const void* svals,
                         const void* w, void* partial, void* out, int N,
                         int Fd, int M, int k, int C, int Cb, int G, int T,
                         int slab_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_slabs = (int)(((long)N + slab_len - 1) / slab_len);
  dim3 grid((M + G - 1) / G, n_slabs, (C + Cb - 1) / Cb);
  const size_t smem = sizeof(float) * ((size_t)kThreads * (Cb | 1) + T) +
                      sizeof(int) * (size_t)T * Fd;
  const int* x = static_cast<const int*>(xd);
  const int* c = static_cast<const int*>(cols);
  const int* v = static_cast<const int*>(svals);
  const float* ww = static_cast<const float*>(w);
  float* p = static_cast<float*>(partial);
  int err;
  if (k <= 1)
    err = launch_slab<1>(grid, smem, s, x, c, v, ww, p, N, Fd, M, k, C, Cb,
                         G, T, slab_len);
  else if (k <= 2)
    err = launch_slab<2>(grid, smem, s, x, c, v, ww, p, N, Fd, M, k, C, Cb,
                         G, T, slab_len);
  else if (k <= 3)
    err = launch_slab<3>(grid, smem, s, x, c, v, ww, p, N, Fd, M, k, C, Cb,
                         G, T, slab_len);
  else if (k <= 4)
    err = launch_slab<4>(grid, smem, s, x, c, v, ww, p, N, Fd, M, k, C, Cb,
                         G, T, slab_len);
  else if (k <= 8)
    err = launch_slab<8>(grid, smem, s, x, c, v, ww, p, N, Fd, M, k, C, Cb,
                         G, T, slab_len);
  else if (k <= 16)
    err = launch_slab<16>(grid, smem, s, x, c, v, ww, p, N, Fd, M, k, C, Cb,
                          G, T, slab_len);
  else if (k <= 32)
    err = launch_slab<32>(grid, smem, s, x, c, v, ww, p, N, Fd, M, k, C, Cb,
                          G, T, slab_len);
  else
    return (int)cudaErrorInvalidValue;
  if (err) return err;
  const long E = (long)M * C;
  dim3 block(kReduceEntries, kReduceLanes);
  slab_reduce<<<(unsigned)((E + kReduceEntries - 1) / kReduceEntries), block,
                0, s>>>(p, static_cast<float*>(out), n_slabs, E);
  return (int)cudaGetLastError();
}

}  // extern "C"
