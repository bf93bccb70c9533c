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
//   evidence_select  bound by the 32-byte sectors of x the gather must
//                    fetch (all of x while 4N <= 32).  A grid of 8 blocks
//                    per SM; each warp strides over chunks of 128
//                    consecutive units of x, lane l taking units l, l + 32,
//                    l + 64, l + 96, so every load and store instruction of
//                    a warp covers contiguous bytes.  For N in {1, 2, 4} a
//                    unit is a 16-byte load holding 4/N rows, written as
//                    one 4/N-float store; else a unit is a row and only its
//                    selected element is loaded.  b from one 32-bit
//                    division per chunk (64-bit only past 2^31 elements),
//                    the chunk's one or two indices read once.  idx is read
//                    in its own dtype (int32 or int64) through its stride;
//                    an index outside [0, N) gives -inf, as the Pallas mask
//                    does.  A copy: the plain version's bits.
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

__device__ __forceinline__ float pick(float4 w, int c) {
  return c == 0 ? w.x : c == 1 ? w.y : c == 2 ? w.z : w.w;
}

template <int R> struct Rows;           // R consecutive outputs, one store
template <> struct Rows<1> {
  using T = float;
  static __device__ __forceinline__ T make(const float* v) { return v[0]; }
};
template <> struct Rows<2> {
  using T = float2;
  static __device__ __forceinline__ T make(const float* v) {
    return make_float2(v[0], v[1]);
  }
};
template <> struct Rows<4> {
  using T = float4;
  static __device__ __forceinline__ T make(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <typename T>
__device__ __forceinline__ long long load_idx(const T* idx, long long b,
                                              long long stride) {
  return (long long)__ldg(idx + b * stride);
}

// x [rows = B*M, N] seen as units: NV = N in {1, 2, 4} -> a unit is one
// float4 of x holding the candidates of R = 4 / NV consecutive rows;
// NV = 0 (any N) -> a unit is one row, of which only the selected element
// is read.  A warp takes chunks of 32 * kUnits consecutive units, lane l
// the units l, l + 32, ...: every load and store instruction of a warp
// covers contiguous bytes.  b comes from one division per chunk: while
// M >= the chunk's rows, a chunk spans at most b0 and b0 + 1, and their
// two indices are read once; else one division per row.  The rows past
// the last whole unit (fewer than R) go one a thread.
template <typename I, typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    evidence_select_kernel(const float* __restrict__ x,
                           const T* __restrict__ idx, long long idx_stride,
                           float* __restrict__ out, I rows, I M, I N) {
  constexpr int R = NV ? 4 / NV : 1, kUnits = 4;
  constexpr I kChunk = 32 * kUnits;
  using Out = typename Rows<R>::T;
  const I units = NV ? rows * NV / 4 : rows;
  const I chunks = (units + kChunk - 1) / kChunk;
  const int lane = threadIdx.x & 31;
  const I first = ((I)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const I warps = ((I)gridDim.x * blockDim.x) >> 5;
  const bool wide = M >= kChunk * R;
  for (I c = first; c < chunks; c += warps) {
    const I u0 = c * kChunk, r0 = u0 * R;
    const I b0 = r0 / M, m0 = r0 - b0 * M;
    long long i0 = 0, i1 = 0;
    if (wide) {
      i0 = load_idx(idx, b0, idx_stride);
      if (r0 - m0 + M < rows) i1 = load_idx(idx, b0 + 1, idx_stride);
    }
    float4 w[kUnits];
    if constexpr (NV > 0) {
#pragma unroll
      for (int j = 0; j < kUnits; ++j) {
        const I u = u0 + 32 * j + lane;
        w[j] = u < units ? __ldcs(reinterpret_cast<const float4*>(x) + u)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const I u = u0 + 32 * j + lane;
      if (u >= units) continue;
      float v[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const I d = (32 * j + lane) * R + k;       // row r0 + d
        const I b = wide ? b0 + (m0 + d >= M) : (r0 + d) / M;
        const long long i =
            wide ? (b == b0 ? i0 : i1) : load_idx(idx, b, idx_stride);
        const bool ok = i >= 0 && i < N;
        if constexpr (NV > 0)
          v[k] = ok ? pick(w[j], k * NV + (int)i) : -INFINITY;
        else
          v[k] = ok ? __ldcs(x + (r0 + d) * N + (I)i) : -INFINITY;
      }
      reinterpret_cast<Out*>(out)[u] = Rows<R>::make(v);
    }
  }
  const I r = units * R + (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (r < rows) {
    const long long i = load_idx(idx, r / M, idx_stride);
    out[r] = (i >= 0 && i < N) ? x[r * N + (I)i] : -INFINITY;
  }
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

// Blocks of kThreads that fill the card: 8 per SM (2048 threads).
int sm_blocks() {
  static int n = 0;
  if (!n) {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
    n = 8 * sms;
  }
  return n;
}

template <typename I, typename T>
int launch_select(const void* x, const void* idx, long long idx_stride,
                  void* out, long long rows, long long M, long long N,
                  bool vec, void* stream) {
  const int nv = vec && (N == 1 || N == 2 || N == 4) ? (int)N : 0;
  const long long units = nv ? rows * nv / 4 : rows;
  const long long want = (units + 4 * kThreads - 1) / (4 * kThreads);
  const int blocks = (int)(want < 1 ? 1 : want < sm_blocks() ? want
                                                             : sm_blocks());
  const float* fx = static_cast<const float*>(x);
  const T* ti = static_cast<const T*>(idx);
  float* fo = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nv) {
    case 1:
      evidence_select_kernel<I, T, 1><<<blocks, kThreads, 0, s>>>(
          fx, ti, idx_stride, fo, (I)rows, (I)M, (I)N);
      break;
    case 2:
      evidence_select_kernel<I, T, 2><<<blocks, kThreads, 0, s>>>(
          fx, ti, idx_stride, fo, (I)rows, (I)M, (I)N);
      break;
    case 4:
      evidence_select_kernel<I, T, 4><<<blocks, kThreads, 0, s>>>(
          fx, ti, idx_stride, fo, (I)rows, (I)M, (I)N);
      break;
    default:
      evidence_select_kernel<I, T, 0><<<blocks, kThreads, 0, s>>>(
          fx, ti, idx_stride, fo, (I)rows, (I)M, (I)N);
  }
  return (int)cudaGetLastError();
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

// out [B, M] = x [B, M, N] at column idx[b * idx_stride], -inf out of
// range; idx int32 (idx_bytes 4) or int64 (8).  out 16-byte aligned; x
// is read in 16-byte loads where it is.
int evidence_select_launch(const void* x, const void* idx, int idx_bytes,
                           long long idx_stride, void* out, long long B,
                           long long M, long long N, void* stream) {
  const long long rows = B * M;
  if (rows == 0) return 0;
  if ((idx_bytes != 4 && idx_bytes != 8) || M < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(out) % 16)
    return (int)cudaErrorMisalignedAddress;
  const bool vec = reinterpret_cast<size_t>(x) % 16 == 0;
  const bool small = rows * N < (1LL << 31) - 4 * (long long)kThreads *
                                                    sm_blocks();
  if (idx_bytes == 8)
    return small ? launch_select<int, long long>(x, idx, idx_stride, out,
                                                 rows, M, N, vec, stream)
                 : launch_select<long long, long long>(
                       x, idx, idx_stride, out, rows, M, N, vec, stream);
  return small ? launch_select<int, int>(x, idx, idx_stride, out, rows, M, N,
                                         vec, stream)
               : launch_select<long long, int>(x, idx, idx_stride, out, rows,
                                               M, N, vec, stream);
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
