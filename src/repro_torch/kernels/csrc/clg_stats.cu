// Expected sufficient statistics of the CLG plate (the VMP E-step reduction)
// for Hopper (sm_90a), built by repro_torch/kernels/build.py with nvcc into a
// shared library with a plain C interface and called through ctypes from
// repro_torch/kernels/clg_stats.py.
//
// Replaces the Pallas TPU kernels of repro/kernels/clg_stats.py:
//   clg_suffstats         (clg_stats.py:84)   sxx/sxy/syy of design rows d
//   clg_suffstats_latent  (clg_stats.py:176)  the same over u = [obs, E[h|z=k]]
//                                             plus rsum_k * S_k in the latent
//                                             block
//   clg_disc_counts       (clg_stats.py:264)  one-hot counts sum_n r[n,k][x==c]
//
// What bounds them on this card: bytes.  Each instance row (d, y, r; or xd, r)
// is read once and turned into a few hundred multiply-adds at most, far below
// the H100's ~20 float32 operations per byte of memory traffic.
//
// Design (deterministic, no float atomics anywhere):
//   stage 1  one block per tile of T instances (the wrapper pads N to a
//            multiple of T: zero r for the moments, category -1 for the
//            counts).  The block copies its tile of every input into shared
//            memory with coalesced loads -- each byte once, for all leaves and
//            all components -- then every thread owns output entries and sums
//            them over the tile in a fixed order.  When there are fewer
//            entries than threads the tile is split into S interleaved
//            instance slices whose partials are added in slice order.
//            Writes partial[tile, E].
//   stage 2  a fixed-order reduction of partial over tiles: 8 lanes per entry
//            each sum a strided set of tiles in order, then lane 0 adds the 8
//            in order.  Two launches on the same input give the same bits.
//   stage 3  (latent only) sxx[f,k,Do:,Do:] += rsum_k * S_k, as the Pallas
//            kernel's _final does (clg_stats.py:163-173).
//
// Partial / output layout of the moments (E entries, all float32):
//   [ sxx F*K*D*D | sxy F*K*D | syy F*K | rsum K ]
// so the output buffer splits into views of the three result arrays.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReduceEntries = 32;  // stage-2 block: 32 entries x 8 tile lanes
constexpr int kReduceLanes = 8;

template <typename V>
__device__ __forceinline__ void copy_tile(V* dst, const V* src, long count) {
  for (long i = threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
}

// u(n, f, k)[a] for the design [obs[n, f, :Do], hm[n, k, :L]]
__device__ __forceinline__ float design(const float* s_obs, const float* s_hm,
                                        int n, int f, int k, int a, int F,
                                        int Do, int K, int L) {
  return a < Do ? s_obs[(n * F + f) * Do + a]
                : s_hm[(n * K + k) * L + (a - Do)];
}

__global__ void clg_moments_tile(const float* __restrict__ obs,
                                 const float* __restrict__ hm,
                                 const float* __restrict__ y,
                                 const float* __restrict__ r,
                                 float* __restrict__ partial, int T, int F,
                                 int Do, int K, int L) {
  extern __shared__ float smem[];
  const int D = Do + L;
  const long n0 = (long)blockIdx.x * T;
  float* s_obs = smem;                  // [T, F, Do]
  float* s_hm = s_obs + T * F * Do;     // [T, K, L]
  float* s_y = s_hm + T * K * L;        // [T, F]
  float* s_r = s_y + T * F;             // [T, K]
  float* s_red = s_r + T * K;           // [S, kThreads / S] slice partials

  copy_tile(s_obs, obs + n0 * F * Do, (long)T * F * Do);
  if (L > 0) copy_tile(s_hm, hm + n0 * K * L, (long)T * K * L);
  copy_tile(s_y, y + n0 * F, (long)T * F);
  copy_tile(s_r, r + n0 * K, (long)T * K);
  __syncthreads();

  const int e_sxx = F * K * D * D;
  const int e_sxy = e_sxx + F * K * D;
  const int e_syy = e_sxy + F * K;
  const int E = e_syy + K;
  const int S = E >= kThreads ? 1 : kThreads / E;  // instance slices
  float* out = partial + (long)blockIdx.x * E;

  for (int base = 0; base < E; base += kThreads / S) {
    const int e = base + threadIdx.x % (kThreads / S);
    const int s = threadIdx.x / (kThreads / S);
    float acc = 0.f;
    const bool live = e < E && s < S;
    if (live) {
      if (e < e_sxx) {
        int i = e;
        const int b = i % D; i /= D;
        const int a = i % D; i /= D;
        const int k = i % K;
        const int f = i / K;
        for (int n = s; n < T; n += S)
          acc += s_r[n * K + k] *
                 design(s_obs, s_hm, n, f, k, a, F, Do, K, L) *
                 design(s_obs, s_hm, n, f, k, b, F, Do, K, L);
      } else if (e < e_sxy) {
        int i = e - e_sxx;
        const int a = i % D; i /= D;
        const int k = i % K;
        const int f = i / K;
        for (int n = s; n < T; n += S)
          acc += s_r[n * K + k] *
                 design(s_obs, s_hm, n, f, k, a, F, Do, K, L) * s_y[n * F + f];
      } else if (e < e_syy) {
        const int i = e - e_sxy;
        const int k = i % K;
        const int f = i / K;
        for (int n = s; n < T; n += S) {
          const float yv = s_y[n * F + f];
          acc += s_r[n * K + k] * yv * yv;
        }
      } else {
        const int k = e - e_syy;
        for (int n = s; n < T; n += S) acc += s_r[n * K + k];
      }
    }
    if (S == 1) {
      if (live) out[e] = acc;
    } else {
      // E < kThreads: one pass covers every entry; add slices in order
      s_red[threadIdx.x] = acc;
      __syncthreads();
      if (threadIdx.x < E) {
        float tot = 0.f;
        for (int j = 0; j < S; ++j)
          tot += s_red[j * (kThreads / S) + threadIdx.x];
        out[threadIdx.x] = tot;
      }
    }
  }
}

__global__ void disc_counts_tile(const int* __restrict__ xd,
                                 const float* __restrict__ r,
                                 float* __restrict__ partial, int T, int Fd,
                                 int K, int C) {
  extern __shared__ float smem[];
  const long n0 = (long)blockIdx.x * T;
  float* s_r = smem;                                  // [T, K]
  float* s_red = s_r + T * K;                         // [kThreads]
  int* s_x = reinterpret_cast<int*>(s_red + kThreads);  // [T, Fd]

  copy_tile(s_x, xd + n0 * Fd, (long)T * Fd);
  copy_tile(s_r, r + n0 * K, (long)T * K);
  __syncthreads();

  const int E = Fd * K * C;
  const int S = E >= kThreads ? 1 : kThreads / E;
  float* out = partial + (long)blockIdx.x * E;

  for (int base = 0; base < E; base += kThreads / S) {
    const int e = base + threadIdx.x % (kThreads / S);
    const int s = threadIdx.x / (kThreads / S);
    float acc = 0.f;
    const bool live = e < E && s < S;
    if (live) {
      const int c = e % C;
      const int k = (e / C) % K;
      const int f = e / (C * K);
      // category -1 (padding) or out of range matches no c: counts nothing
      for (int n = s; n < T; n += S)
        if (s_x[n * Fd + f] == c) acc += s_r[n * K + k];
    }
    if (S == 1) {
      if (live) out[e] = acc;
    } else {
      s_red[threadIdx.x] = acc;
      __syncthreads();
      if (threadIdx.x < E) {
        float tot = 0.f;
        for (int j = 0; j < S; ++j)
          tot += s_red[j * (kThreads / S) + threadIdx.x];
        out[threadIdx.x] = tot;
      }
    }
  }
}

__global__ void tile_reduce(const float* __restrict__ partial,
                            float* __restrict__ out, int n_tiles, int E) {
  __shared__ float s_lane[kReduceLanes][kReduceEntries];
  const int e = blockIdx.x * kReduceEntries + threadIdx.x;
  float acc = 0.f;
  if (e < E)
    for (int t = threadIdx.y; t < n_tiles; t += kReduceLanes)
      acc += partial[(long)t * E + e];
  s_lane[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < E) {
    float tot = 0.f;
    for (int j = 0; j < kReduceLanes; ++j) tot += s_lane[j][threadIdx.x];
    out[e] = tot;
  }
}

__global__ void latent_correct(float* __restrict__ out,
                               const float* __restrict__ shh, int F, int Do,
                               int K, int L) {
  const int D = Do + L;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F * K * L * L) return;
  const int m = i % L;
  const int l = (i / L) % L;
  const int k = (i / (L * L)) % K;
  const int f = i / (L * L * K);
  const float* rsum = out + F * K * D * D + F * K * D + F * K;
  out[((f * K + k) * D + Do + l) * D + Do + m] +=
      rsum[k] * shh[(k * L + l) * L + m];
}

int reduce_tiles(const float* partial, float* out, int n_tiles, int E,
                 cudaStream_t stream) {
  dim3 block(kReduceEntries, kReduceLanes);
  tile_reduce<<<(E + kReduceEntries - 1) / kReduceEntries, block, 0,
                stream>>>(partial, out, n_tiles, E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int clg_stats_threads() { return kThreads; }

// Moments of the design [obs, hm] (hm may be null when L == 0: then this is
// clg_suffstats with d = obs).  N = n_tiles * T instances; partial holds
// n_tiles * E floats and out E floats (layout above); shh is [K, L, L].
int clg_moments_launch(const void* obs, const void* hm, const void* y,
                       const void* r, const void* shh, void* partial,
                       void* out, int n_tiles, int T, int F, int Do, int K,
                       int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = Do + L;
  const int E = F * K * D * D + F * K * D + F * K + K;
  const size_t smem =
      sizeof(float) * ((size_t)T * (F * Do + K * L + F + K) + kThreads);
  clg_moments_tile<<<n_tiles, kThreads, smem, s>>>(
      static_cast<const float*>(obs), static_cast<const float*>(hm),
      static_cast<const float*>(y), static_cast<const float*>(r),
      static_cast<float*>(partial), T, F, Do, K, L);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = reduce_tiles(static_cast<const float*>(partial),
                     static_cast<float*>(out), n_tiles, E, s);
  if (err || L == 0) return err;
  const int n = F * K * L * L;
  latent_correct<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<float*>(out), static_cast<const float*>(shh), F, Do, K, L);
  return (int)cudaGetLastError();
}

// One-hot counts of xd [N, Fd] (int32) weighted by r [N, K]: out [Fd, K, C].
int clg_disc_counts_launch(const void* xd, const void* r, void* partial,
                           void* out, int n_tiles, int T, int Fd, int K,
                           int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      sizeof(float) * ((size_t)T * K + kThreads) + sizeof(int) * (size_t)T * Fd;
  disc_counts_tile<<<n_tiles, kThreads, smem, s>>>(
      static_cast<const int*>(xd), static_cast<const float*>(r),
      static_cast<float*>(partial), T, Fd, K, C);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_tiles(static_cast<const float*>(partial),
                      static_cast<float*>(out), n_tiles, Fd * K * C, s);
}

}  // extern "C"
