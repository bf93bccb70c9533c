// Batched log-space factor algebra of the junction tree for Hopper (sm_90a),
// built by repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface and called through ctypes from
// repro_torch/kernels/factor_ops.py.  Compiled without --use_fast_math:
// expf/logf are the accurate versions.
//
// Replaces the Pallas TPU kernels of repro/kernels/factor_ops.py:
//   log_product      (factor_ops.py:60)   out = a[B,M,N] + b[B,N] over M
//   log_marginalize  (factor_ops.py:114)  logsumexp over N -> [B,M]
//   evidence_select  (factor_ops.py:154)  out[b,m] = x[b,m,idx[b]]
//   cg_weak_marg     (factor_ops.py:222)  moment-matched collapse of the
//                                         mixture axis N of a CG table
//
// What bounds them on this card: bytes.  Each is one pass over its inputs
// with at most a few float operations (one expf) per 4-byte element, far
// below the H100's ~20 float32 operations per byte of memory traffic.
//
// Design (deterministic, no atomics; every row is reduced by one thread or
// one group of lanes in a fixed order, so two launches give the same bits):
//   log_product      grid-stride loop over the output, four elements a
//                    thread (float4) when N % 4 == 0 and the pointers are
//                    16-byte aligned, one otherwise; 32-bit index arithmetic
//                    below 2^30 elements.  The same single float add as the
//                    plain version (same bits).
//   log_marginalize  one group of G lanes per (b, m) row, G the power of two
//                    >= N/4, at most 32 (a warp holds 32/G rows, so short
//                    rows still load contiguously and each lane sums about
//                    four elements or more).  Each lane keeps a running
//                    (max, sum) over its strided slice of N; the lanes merge
//                    by a fixed __shfl_down tree, one expf per merge.  -inf-safe:
//                    the sum is rescaled only against a finite max, and a
//                    row whose sum is 0 (all -inf) writes -inf.  Ragged M
//                    and N are masked here, not padded.
//   evidence_select  one thread per (b, m): reads idx[b] and gathers; an
//                    index outside [0, N) gives -inf, as the Pallas mask does.
//   cg_weak_marg     one thread per (b, m) row, templated on n <= kMaxN so
//                    the mean and covariance stay in registers.  Three passes
//                    over the row: the max of logw; the mass and the mean;
//                    then the centred second moment
//                      sum_i w_i (Sigma_i + (mu_i - mu^)(mu_i - mu^)^T) / sum w
//                    (the same function as second - mu^ mu^^T, better
//                    conditioned).  A row with no live weight writes
//                    (-inf, 0, I).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 8;          // cg_weak_marg: largest continuous dim n
constexpr int kMaxBlocks = 132 * 32;

template <typename I>
__global__ void log_product_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   float* __restrict__ out, I total, I MN,
                                   I N) {
  const I step = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step)
    out[i] = a[i] + b[(i / MN) * N + i % N];
}

// four consecutive outputs share their row of b (N % 4 == 0)
template <typename I>
__global__ void log_product_vec4_kernel(const float4* __restrict__ a,
                                        const float* __restrict__ b,
                                        float4* __restrict__ out, I total4,
                                        I MN, I N) {
  const I step = (I)gridDim.x * blockDim.x;
  for (I v = (I)blockIdx.x * blockDim.x + threadIdx.x; v < total4;
       v += step) {
    const I i = v * 4;
    const float4 x = a[v];
    const float4 y =
        *reinterpret_cast<const float4*>(b + (i / MN) * N + i % N);
    out[v] = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  }
}

// one element into a running (max, sum of exp(x - max))
__device__ __forceinline__ void lse_push(float& m, float& s, float x) {
  if (x > m) {                    // x > m >= -inf: x is finite
    s = (m == -INFINITY ? 0.f : s * expf(m - x)) + 1.f;
    m = x;
  } else if (x != -INFINITY) {    // m >= x > -inf: m is finite
    s += expf(x - m);
  }
}

// merge another lane's (max, sum): one expf, against the larger max
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  if (m2 == -INFINITY) return;    // the other lane saw no live element
  if (m == -INFINITY) {
    m = m2;
    s = s2;
  } else if (m >= m2) {
    s += s2 * expf(m2 - m);
  } else {
    s = s * expf(m - m2) + s2;
    m = m2;
  }
}

__global__ void log_marginalize_kernel(const float* __restrict__ x,
                                       float* __restrict__ out,
                                       long long rows, int N, int G) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = gid / G;
  const int sub = (int)(gid % G);
  const bool live = row < rows;
  float m = -INFINITY, s = 0.f;
  if (live) {
    const float* xr = x + row * N;
    for (int j = sub; j < N; j += G) lse_push(m, s, xr[j]);
  }
  // every lane of the warp reaches the shuffles (no early return above)
  for (int off = G / 2; off > 0; off >>= 1) {
    const float m2 = __shfl_down_sync(0xffffffffu, m, off, G);
    const float s2 = __shfl_down_sync(0xffffffffu, s, off, G);
    lse_merge(m, s, m2, s2);
  }
  if (live && sub == 0) out[row] = s > 0.f ? m + logf(s) : -INFINITY;
}

__global__ void evidence_select_kernel(const float* __restrict__ x,
                                       const int* __restrict__ idx,
                                       float* __restrict__ out,
                                       long long rows, int M, int N) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int i = idx[r / M];
  out[r] = (i >= 0 && i < N) ? x[r * N + i] : -INFINITY;
}

template <int n>
__global__ void cg_weak_marg_kernel(const float* __restrict__ lw,
                                    const float* __restrict__ mu,
                                    const float* __restrict__ sg,
                                    float* __restrict__ p,
                                    float* __restrict__ mh,
                                    float* __restrict__ sh, long long rows,
                                    int N) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* lwr = lw + r * N;
  const float* mur = mu + r * N * n;
  const float* sgr = sg + r * N * n * n;
  float m = -INFINITY;
  for (int j = 0; j < N; ++j) m = fmaxf(m, lwr[j]);
  const float ms = m == -INFINITY ? 0.f : m;
  float s = 0.f;
  float mean[n];
#pragma unroll
  for (int a = 0; a < n; ++a) mean[a] = 0.f;
  for (int j = 0; j < N; ++j) {
    const float w = expf(lwr[j] - ms);          // -inf weight -> 0
    s += w;
#pragma unroll
    for (int a = 0; a < n; ++a) mean[a] += w * mur[j * n + a];
  }
  float* mhr = mh + r * n;
  float* shr = sh + r * n * n;
  if (!(s > 0.f)) {                             // dead row: (-inf, 0, I)
    p[r] = -INFINITY;
#pragma unroll
    for (int a = 0; a < n; ++a) {
      mhr[a] = 0.f;
#pragma unroll
      for (int b = 0; b < n; ++b) shr[a * n + b] = a == b ? 1.f : 0.f;
    }
    return;
  }
  const float inv = 1.f / s;
#pragma unroll
  for (int a = 0; a < n; ++a) mean[a] *= inv;
  float cov[n][n];
#pragma unroll
  for (int a = 0; a < n; ++a)
#pragma unroll
    for (int b = 0; b < n; ++b) cov[a][b] = 0.f;
  for (int j = 0; j < N; ++j) {
    const float w = expf(lwr[j] - ms) * inv;
    float d[n];
#pragma unroll
    for (int a = 0; a < n; ++a) d[a] = mur[j * n + a] - mean[a];
#pragma unroll
    for (int a = 0; a < n; ++a)
#pragma unroll
      for (int b = 0; b < n; ++b)
        cov[a][b] += w * (sgr[(j * n + a) * n + b] + d[a] * d[b]);
  }
  p[r] = ms + logf(s);
#pragma unroll
  for (int a = 0; a < n; ++a) {
    mhr[a] = mean[a];
#pragma unroll
    for (int b = 0; b < n; ++b) shr[a * n + b] = cov[a][b];
  }
}

int blocks_for(long long threads) {
  return (int)((threads + kThreads - 1) / kThreads);
}

int grid_stride_blocks(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename I>
void launch_product(const float* a, const float* b, float* out,
                    long long total, long long MN, int N, bool vec4,
                    cudaStream_t s) {
  if (vec4) {
    log_product_vec4_kernel<I><<<grid_stride_blocks(total / 4), kThreads, 0,
                                 s>>>(
        reinterpret_cast<const float4*>(a), b, reinterpret_cast<float4*>(out),
        (I)(total / 4), (I)MN, (I)N);
  } else {
    log_product_kernel<I><<<grid_stride_blocks(total), kThreads, 0, s>>>(
        a, b, out, (I)total, (I)MN, (I)N);
  }
}

template <int n>
int launch_weak_marg(const float* lw, const float* mu, const float* sg,
                     float* p, float* mh, float* sh, long long rows, int N,
                     cudaStream_t s) {
  cg_weak_marg_kernel<n><<<blocks_for(rows), kThreads, 0, s>>>(
      lw, mu, sg, p, mh, sh, rows, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int factor_ops_max_n() { return kMaxN; }

// out [B, M, N] = a [B, M, N] + b [B, N] broadcast over M.
int log_product_launch(const void* a, const void* b, void* out, long long B,
                       long long M, int N, void* stream) {
  const long long total = B * M * N;
  if (total == 0) return 0;
  const bool vec4 =
      N % 4 == 0 &&
      ((reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b) |
        reinterpret_cast<size_t>(out)) % 16) == 0;
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fo = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 32-bit offsets while i + grid stride cannot pass 2^31
  if (total < (1LL << 30))
    launch_product<int>(fa, fb, fo, total, M * N, N, vec4, s);
  else
    launch_product<long long>(fa, fb, fo, total, M * N, N, vec4, s);
  return (int)cudaGetLastError();
}

// out [rows] = logsumexp of each row of x [rows, N]; G lanes per row
// (a power of two <= 32).
int log_marginalize_launch(const void* x, void* out, long long rows, int N,
                           int G, void* stream) {
  if (rows == 0) return 0;
  if (G < 1 || G > 32 || (G & (G - 1))) return (int)cudaErrorInvalidValue;
  log_marginalize_kernel<<<blocks_for(rows * G), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, N, G);
  return (int)cudaGetLastError();
}

// out [B, M] = x [B, M, N] at column idx[b] (int32), -inf out of range.
int evidence_select_launch(const void* x, const void* idx, void* out,
                           long long B, int M, int N, void* stream) {
  const long long rows = B * M;
  if (rows == 0) return 0;
  evidence_select_kernel<<<blocks_for(rows), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), rows, M, N);
  return (int)cudaGetLastError();
}

// Weak marginal of rows = B*M mixtures of N components in n dimensions:
// lw [rows, N], mu [rows, N, n], sg [rows, N, n, n] -> p [rows],
// mh [rows, n], sh [rows, n, n].
int cg_weak_marg_launch(const void* lw, const void* mu, const void* sg,
                        void* p, void* mh, void* sh, long long rows, int N,
                        int n, void* stream) {
  if (rows == 0) return 0;
  const float* a = static_cast<const float*>(lw);
  const float* b = static_cast<const float*>(mu);
  const float* c = static_cast<const float*>(sg);
  float* o1 = static_cast<float*>(p);
  float* o2 = static_cast<float*>(mh);
  float* o3 = static_cast<float*>(sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return launch_weak_marg<1>(a, b, c, o1, o2, o3, rows, N, s);
    case 2: return launch_weak_marg<2>(a, b, c, o1, o2, o3, rows, N, s);
    case 3: return launch_weak_marg<3>(a, b, c, o1, o2, o3, rows, N, s);
    case 4: return launch_weak_marg<4>(a, b, c, o1, o2, o3, rows, N, s);
    case 5: return launch_weak_marg<5>(a, b, c, o1, o2, o3, rows, N, s);
    case 6: return launch_weak_marg<6>(a, b, c, o1, o2, o3, rows, N, s);
    case 7: return launch_weak_marg<7>(a, b, c, o1, o2, o3, rows, N, s);
    case 8: return launch_weak_marg<8>(a, b, c, o1, o2, o3, rows, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
