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
// clg_suffstats (clg_suffstats_launch; also many equal instance chunks of one
// array in one launch, each chunk's moments apart):
//   stage 1  moments_tile: a thread owns one leaf f and a group of KG
//            components (D <= 8, a template), or one leaf, component, row a
//            of sxx and block of 32 columns of that row (moments_rows, any
//            D), and keeps that unit's upper
//            triangle of sxx, sxy and syy in registers over a fixed instance
//            range, reading d, y and r straight from device memory with 8- or
//            16-byte loads where the base and row stride allow (a warp reads
//            32 neighbouring leaves of a row, or neighbouring rows).  A block
//            is FT leaves x UB units x NL instance lanes; lane l of a range
//            takes instances l, l + NL, ... in order, and the lanes are added
//            in lane order through shared memory.  The ranges are a fixed
//            partition of a chunk that depends only on the shapes, and the
//            leaf range is a pointer and a row stride: any F, one launch, no
//            copy.  Writes partial[chunk, range, F*K*U] with U = D(D+1)/2 +
//            D + 1 entries per (leaf, component).
//   stage 2  moments_reduce: 32 entries x 32 range lanes a block; each lane
//            sums a strided set of ranges in order, then a fixed tree adds the
//            32 lanes; the upper triangle is mirrored into sxx.
//
// clg_suffstats_latent and clg_disc_counts (clg_moments_launch,
// clg_disc_counts_launch):
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
//            in order.
//   stage 3  (latent only) sxx[f,k,Do:,Do:] += rsum_k * S_k, as the Pallas
//            kernel's _final does (clg_stats.py:163-173).
//
// Deterministic everywhere, no float atomics: two launches on the same input
// give the same bits.
//
// Partial / output layout of clg_moments_launch (E entries, all float32):
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
  copy_tile(s_hm, hm + n0 * K * L, (long)T * K * L);
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

// -- clg_suffstats: register-blocked moments straight from device memory ----

constexpr int kRowsBlock = 32;      // columns of a row that moments_rows
constexpr int kRowsSlots = kRowsBlock + 2;   // sums in one unit
constexpr int kRangeLanes = 32;     // stage 2: 32 entries x 32 range lanes

struct MomentArgs {
  const float* d;        // [n_total, *]: leaf f's row at d + n*d_row + f*D
  const float* y;        // y + n*y_row + f
  const float* r;        // r + n*r_row + k
  float* partial;        // [n_chunks, R_max, F*K*U]
  float* sxx;            // [n_chunks, F, K, D, D]
  float* sxy;            // [n_chunks, F, K, D]
  float* syy;            // [n_chunks, F, K]
  long d_row, y_row, r_row;
  long chunk_len, n_total;   // chunk c is [c*chunk_len, min(n_total, ...))
  int F, K, D;
  int FT, UB, NL, n_ublocks, W;   // W units a leaf
  int R_full, len_full, R_last, len_last, R_max;
  int vec, rvec;         // float widths of the d and r loads
};

__host__ __device__ __forceinline__ int entries_per_unit(int D) {
  return D * (D + 1) / 2 + D + 1;
}

// The instance range [n0, n1) of block (., range, chunk); false when the
// chunk has fewer ranges than the grid.
__device__ __forceinline__ bool block_range(const MomentArgs& a, long& n0,
                                            long& n1) {
  const bool last = blockIdx.z == gridDim.z - 1;
  const int R = last ? a.R_last : a.R_full;
  const long len = last ? a.len_last : a.len_full;
  if ((int)blockIdx.y >= R) return false;
  const long c0 = (long)blockIdx.z * a.chunk_len;
  const long c1 = min(a.n_total, c0 + a.chunk_len);
  n0 = c0 + (long)blockIdx.y * len;
  n1 = min(c1, n0 + len);
  return true;
}

template <int V>
struct VecOf;
template <>
struct VecOf<2> {
  using T = float2;
};
template <>
struct VecOf<4> {
  using T = float4;
};

// n floats from p: V-wide loads where `wide` (p aligned to V floats)
template <int n, int V>
__device__ __forceinline__ void load_floats(float* out, const float* p,
                                            bool wide) {
  if constexpr (n % V == 0) {
    if (wide) {
#pragma unroll
      for (int i = 0; i < n; i += V) {
        const typename VecOf<V>::T v =
            __ldg(reinterpret_cast<const typename VecOf<V>::T*>(p + i));
        const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
        for (int j = 0; j < V; ++j) out[i + j] = f[j];
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < n; ++i) out[i] = __ldg(p + i);
}

// The block's lanes added in lane order, each entry written to partial:
// red is [A][NL][P] (P = FT * UB); slot_entry(p, s) is the compact entry of
// the unit of block position p and slot s, or -1.
template <typename SlotEntry>
__device__ __forceinline__ void reduce_lanes(const MomentArgs& a, float* red,
                                             int A, float* part,
                                             SlotEntry slot_entry) {
  const int P = a.FT * a.UB;
  __syncthreads();
  for (int e = threadIdx.x; e < A * P; e += kThreads) {
    const int s = e / P;
    const int p = e - s * P;
    const long dst = slot_entry(p, s);
    if (dst < 0) continue;
    float tot = 0.f;
    for (int l = 0; l < a.NL; ++l) tot += red[(s * a.NL + l) * P + p];
    part[dst] = tot;
  }
}

// Stage 1, D <= 8: a thread owns leaf f and components k0 .. k0 + KG - 1.
template <int D, int KG>
__global__ void __launch_bounds__(kThreads)
    moments_tile(const MomentArgs a) {
  constexpr int U = D * (D + 1) / 2 + D + 1;
  constexpr int A = KG * U;
  extern __shared__ float red[];              // [A][NL][FT * UB]
  long n0, n1;
  if (!block_range(a, n0, n1)) return;
  const int P = a.FT * a.UB;
  const int t = threadIdx.x;
  const int p = t % P;
  const int lane = t / P;
  const int ft = blockIdx.x / a.n_ublocks;
  const int ub = blockIdx.x - ft * a.n_ublocks;
  const int f = ft * a.FT + p % a.FT;
  const int unit = ub * a.UB + p / a.FT;
  const int k0 = unit * KG;
  const bool live = lane < a.NL && f < a.F && unit < a.W;

  float acc[A];
#pragma unroll
  for (int s = 0; s < A; ++s) acc[s] = 0.f;
  if (live) {
    const float* dp = a.d + (long)f * D;
    const float* yp = a.y + f;
    const float* rp = a.r + k0;
    const bool dwide = a.vec > 1;
    const bool rwide = a.rvec == KG && k0 + KG <= a.K;
    const int kn = min(KG, a.K - k0);
    // one instance at a time: unrolling by 2 or 4 measured slower
#pragma unroll 1
    for (long n = n0 + lane; n < n1; n += a.NL) {
      float dv[D];
      if (a.vec == 4)
        load_floats<D, 4>(dv, dp + n * a.d_row, dwide);
      else
        load_floats<D, 2>(dv, dp + n * a.d_row, dwide);
      const float yv = __ldg(yp + n * a.y_row);
      float rv[KG];
      if (rwide) {
        load_floats<KG, KG == 4 ? 4 : 2>(rv, rp + n * a.r_row, KG > 1);
      } else {
#pragma unroll
        for (int j = 0; j < KG; ++j)
          rv[j] = j < kn ? __ldg(rp + n * a.r_row + j) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        float* q = acc + j * U;
        int s = 0;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const float ri = rv[j] * dv[i];
#pragma unroll
          for (int b = i; b < D; ++b) q[s++] += ri * dv[b];
          q[D * (D + 1) / 2 + i] += ri * yv;
        }
        q[U - 1] += rv[j] * yv * yv;
      }
    }
  }
  if (lane < a.NL)
#pragma unroll
    for (int s = 0; s < A; ++s) red[(s * a.NL + lane) * P + p] = acc[s];
  float* part = a.partial +
                ((long)blockIdx.z * a.R_max + blockIdx.y) * a.F * a.K * U;
  reduce_lanes(a, red, A, part, [&](int pp, int s) -> long {
    const int ff = ft * a.FT + pp % a.FT;
    const int uu = ub * a.UB + pp / a.FT;
    const int k = uu * KG + s / U;
    if (ff >= a.F || uu >= a.W || k >= a.K) return -1;
    return ((long)ff * a.K + k) * U + s % U;
  });
}

// Stage 1, any D: a thread owns leaf f, component k, row i of sxx and the
// block of columns b0 = kRowsBlock * j ... b0 + kRowsBlock - 1 of that row:
// sxx[i][b0 + s] (b0 + s >= i) in slots s, sxy[i] in slot kRowsBlock (the
// block that holds column i), and syy in slot kRowsBlock + 1 (row 0, block
// 0).  A unit whose block lies left of the diagonal has nothing to sum.
__global__ void __launch_bounds__(kThreads) moments_rows(const MomentArgs a) {
  extern __shared__ float red[];              // [kRowsSlots][NL][FT * UB]
  long n0, n1;
  if (!block_range(a, n0, n1)) return;
  const int D = a.D;
  const int U = entries_per_unit(D);
  const int P = a.FT * a.UB;
  const int t = threadIdx.x;
  const int p = t % P;
  const int lane = t / P;
  const int ft = blockIdx.x / a.n_ublocks;
  const int ub = blockIdx.x - ft * a.n_ublocks;
  const int f = ft * a.FT + p % a.FT;
  const int NB = (D + kRowsBlock - 1) / kRowsBlock;
  const int unit = ub * a.UB + p / a.FT;       // (k * D + i) * NB + j
  const int k = unit / (D * NB);
  const int i = unit / NB - k * D;
  const int b0 = (unit - unit / NB * NB) * kRowsBlock;
  const bool live = lane < a.NL && f < a.F && unit < a.W &&
                    b0 + kRowsBlock > i;

  float acc[kRowsSlots];
#pragma unroll
  for (int s = 0; s < kRowsSlots; ++s) acc[s] = 0.f;
  if (live) {
    const float* dp = a.d + (long)f * D;
    for (long n = n0 + lane; n < n1; n += a.NL) {
      const float* row = dp + n * a.d_row;
      const float yv = __ldg(a.y + n * a.y_row + f);
      const float rv = __ldg(a.r + n * a.r_row + k);
      const float ri = rv * __ldg(row + i);
#pragma unroll
      for (int s = 0; s < kRowsBlock; ++s)
        if (b0 + s >= i && b0 + s < D) acc[s] += ri * __ldg(row + b0 + s);
      acc[kRowsBlock] += ri * yv;
      acc[kRowsBlock + 1] += rv * yv * yv;
    }
  }
  if (lane < a.NL)
#pragma unroll
    for (int s = 0; s < kRowsSlots; ++s)
      red[(s * a.NL + lane) * P + p] = acc[s];
  float* part = a.partial +
                ((long)blockIdx.z * a.R_max + blockIdx.y) * a.F * a.K * U;
  reduce_lanes(a, red, kRowsSlots, part, [&](int pp, int s) -> long {
    const int ff = ft * a.FT + pp % a.FT;
    const int uu = ub * a.UB + pp / a.FT;
    const int kk = uu / (D * NB);
    const int ii = uu / NB - kk * D;
    const int jb = (uu - uu / NB * NB) * kRowsBlock;
    if (ff >= a.F || uu >= a.W) return -1;
    const long base = ((long)ff * a.K + kk) * U;
    const int tri = D * (D + 1) / 2;
    const int b = jb + s;
    if (s < kRowsBlock)
      return b >= ii && b < D ? base + ii * D - ii * (ii - 1) / 2 + b - ii
                              : -1;
    if (s == kRowsBlock) return ii / kRowsBlock * kRowsBlock == jb
                                    ? base + tri + ii : -1;
    if (ii == 0 && jb == 0) return base + tri + D;
    return -1;
  });
}

// Stage 2: entry e of chunk blockIdx.y summed over that chunk's ranges.
__global__ void moments_reduce(const MomentArgs a) {
  __shared__ float s_lane[kRangeLanes][kRangeLanes + 1];
  const int D = a.D;
  const int U = entries_per_unit(D);
  const long E = (long)a.F * a.K * U;
  const long e = (long)blockIdx.x * kRangeLanes + threadIdx.x;
  const int c = blockIdx.y;
  const int R = c == (int)gridDim.y - 1 ? a.R_last : a.R_full;
  const float* part = a.partial + (long)c * a.R_max * E;
  float acc = 0.f;
  if (e < E)
    for (int i = threadIdx.y; i < R; i += kRangeLanes)
      acc += part[(long)i * E + e];
  s_lane[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  for (int h = kRangeLanes / 2; h > 0; h /= 2) {
    if ((int)threadIdx.y < h)
      s_lane[threadIdx.y][threadIdx.x] += s_lane[threadIdx.y + h][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y != 0 || e >= E) return;
  const float tot = s_lane[0][threadIdx.x];
  const long fk = e / U;
  int u = (int)(e - fk * U);
  const long FK = (long)a.F * a.K;
  const int tri = D * (D + 1) / 2;
  if (u < tri) {
    int i = 0;
    while (u >= D - i) u -= D - i++;
    const int b = i + u;
    float* out = a.sxx + ((long)c * FK + fk) * D * D;
    out[i * D + b] = tot;
    out[b * D + i] = tot;
  } else if (u < tri + D) {
    a.sxy[((long)c * FK + fk) * D + u - tri] = tot;
  } else {
    a.syy[(long)c * FK + fk] = tot;
  }
}

template <int D, int KG>
int launch_tile(const MomentArgs& a, dim3 grid, cudaStream_t s) {
  const size_t smem = sizeof(float) * KG * (D * (D + 1) / 2 + D + 1) *
                      kThreads;
  moments_tile<D, KG><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// KG * U accumulators of a thread stay within kMaxSlots registers (and
// their lanes within 48 KB of shared memory).
constexpr int kMaxSlots = 48;

template <int D>
int launch_tile_kg(const MomentArgs& a, int KG, dim3 grid, cudaStream_t s) {
  constexpr int U = D * (D + 1) / 2 + D + 1;
  if (KG == 1) return launch_tile<D, 1>(a, grid, s);
  if constexpr (2 * U <= kMaxSlots)
    if (KG == 2) return launch_tile<D, 2>(a, grid, s);
  if constexpr (4 * U <= kMaxSlots)
    if (KG == 4) return launch_tile<D, 4>(a, grid, s);
  return (int)cudaErrorInvalidValue;
}

int launch_moments(const MomentArgs& a, int KG, dim3 grid, cudaStream_t s) {
  switch (a.D) {
    case 1: return launch_tile_kg<1>(a, KG, grid, s);
    case 2: return launch_tile_kg<2>(a, KG, grid, s);
    case 3: return launch_tile_kg<3>(a, KG, grid, s);
    case 4: return launch_tile_kg<4>(a, KG, grid, s);
    case 5: return launch_tile_kg<5>(a, KG, grid, s);
    case 6: return launch_tile_kg<6>(a, KG, grid, s);
    case 7: return launch_tile_kg<7>(a, KG, grid, s);
    case 8: return launch_tile_kg<8>(a, KG, grid, s);
    default:
      if (KG != 1) return (int)cudaErrorInvalidValue;
      moments_rows<<<grid, kThreads, sizeof(float) * kRowsSlots * kThreads,
                     s>>>(a);
      return (int)cudaGetLastError();
  }
}

}  // namespace

extern "C" {

int clg_stats_threads() { return kThreads; }

// clg_suffstats of n_chunks chunks of chunk_len instances (the last one
// n_total - (n_chunks - 1) * chunk_len): d, y, r are read at the row strides
// d_row, y_row, r_row (floats); partial holds n_chunks * max(R_full, R_last)
// * F*K*U floats; sxx/sxy/syy are [n_chunks, F, K, D, D] / [.., D] / [..].
// The block is FT leaves x UB units (a unit: KG components, or for D > 8 a
// component, a row of sxx and a block of 32 of its columns) x NL instance
// lanes; each chunk is split into
// R ranges of len instances (the full chunks' R_full/len_full, the last
// chunk's R_last/len_last).
int clg_suffstats_launch(const void* d, const void* y, const void* r,
                         void* partial, void* sxx, void* sxy, void* syy,
                         long d_row, long y_row, long r_row, long chunk_len,
                         long n_total, int n_chunks, int F, int D, int K,
                         int KG, int FT, int UB, int NL, int R_full,
                         int len_full, int R_last, int len_last, int vec,
                         int rvec, void* stream) {
  MomentArgs a;
  a.d = static_cast<const float*>(d);
  a.y = static_cast<const float*>(y);
  a.r = static_cast<const float*>(r);
  a.partial = static_cast<float*>(partial);
  a.sxx = static_cast<float*>(sxx);
  a.sxy = static_cast<float*>(sxy);
  a.syy = static_cast<float*>(syy);
  a.d_row = d_row;
  a.y_row = y_row;
  a.r_row = r_row;
  a.chunk_len = chunk_len;
  a.n_total = n_total;
  a.F = F;
  a.K = K;
  a.D = D;
  a.FT = FT;
  a.UB = UB;
  a.NL = NL;
  a.W = D <= 8 ? (K + KG - 1) / KG
              : K * D * ((D + kRowsBlock - 1) / kRowsBlock);
  a.n_ublocks = (a.W + UB - 1) / UB;
  a.R_full = R_full;
  a.len_full = len_full;
  a.R_last = R_last;
  a.len_last = len_last;
  a.R_max = max(R_full, R_last);
  a.vec = vec;
  a.rvec = rvec;
  if (FT * UB * NL > kThreads || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(((F + FT - 1) / FT) * a.n_ublocks, a.R_max, n_chunks);
  int err = launch_moments(a, KG, grid, s);
  if (err) return err;
  const long E = (long)F * K * entries_per_unit(D);
  dim3 g2((unsigned)((E + kRangeLanes - 1) / kRangeLanes), n_chunks);
  moments_reduce<<<g2, dim3(kRangeLanes, kRangeLanes), 0, s>>>(a);
  return (int)cudaGetLastError();
}


// clg_suffstats_latent: moments of the design [obs, hm] with L >= 1 latent
// columns.  N = n_tiles * T instances; partial holds n_tiles * E floats and
// out E floats (layout above); shh is [K, L, L].
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
  if (err) return err;
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
