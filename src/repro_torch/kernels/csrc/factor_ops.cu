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
// one team of lanes in a fixed order, so two launches give the same bits):
//   log_product      grid-stride loop over the output, four elements a
//                    thread (float4) when N % 4 == 0 and the pointers are
//                    16-byte aligned, one otherwise; 32-bit index arithmetic
//                    below 2^30 elements.  The same single float add as the
//                    plain version (same bits).
//   log_marginalize  bound by bytes: a warp keeps enough loads in flight
//                    to cover HBM's latency, and its arithmetic (one expf an
//                    element) hides behind them.  The plan (lse_plan in
//                    factor_ops.py, mirrored here and checked against it
//                    when the library loads) reads a row in chunks of
//                    V floats (V = 4, one 16-byte load, where N % 4 == 0 and
//                    x is 16-byte aligned; else V = 1, same kernel family):
//                    short rows (N <= 128) take a group of G lanes, a
//                    lane C chunks of each of RPG = 4 rows (1 row where
//                    the rows would not fill a block on every SM), so a
//                    warp's load instruction covers 32 / G neighbouring
//                    rows (512 contiguous bytes where G * V = N) and a
//                    thread holds 64 bytes in flight; long rows take W warps (1-8, so
//                    that few long rows still fill the card's 64 warps an
//                    SM, from the device's SM count), a lane C
//                    chunks a round (64 bytes), rounds until the row ends.
//                    A round's loads all issue before any arithmetic; then
//                    two passes in registers: the team's max (fmaxf over
//                    the lane's elements, then a shuffle butterfly), then
//                    sum expf(x - max), one expf an element and a rescale
//                    only when a later round raises the max.  The lanes'
//                    sums share that max and add by a fixed __shfl_down
//                    tree; warps of a row merge (lse_merge, one expf) in
//                    warp order through shared memory.
//                    -inf-safe: centred on the max only where it is finite,
//                    and a row whose sum is 0 (all -inf) writes -inf.
//                    Ragged N and rows are masked, not padded.
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
//   cg_weak_marg     bound by bytes: each row's sigma (N n^2 floats) is
//                    read once; at the serving shapes (a few components a
//                    row) by the latency of a row's trips to device memory
//                    and by the card's occupancy.  A group of G lanes a row
//                    (G the power of two >= min(n^2, 32), 32 / G rows a
//                    warp; weak_plan in factor_ops.py, mirrored here and
//                    checked against it when the library loads), lane sub
//                    owning entries sub, sub + G, ... of each block of G *
//                    EPL covariance entries (EPL <= 8 a lane, so any n loops
//                    over blocks), neighbouring lanes on neighbouring floats
//                    of sigma[row, j].  Components go in batches whose loads
//                    issue together, the first batch's before any
//                    arithmetic: a row of few components makes one trip and
//                    stays in registers.  Every lane takes the row's max,
//                    mass and weights itself from logw (one broadcast load
//                    of a few floats; the same bits in every lane, where
//                    shuffle trees would add their latency to every row),
//                    then the mean at its entries' dims and the centred
//                    second moment
//                      sum_j w_j (Sigma_j + (mu_j - mu^)(mu_j - mu^)^T) / sum w
//                    in one pass over sigma (the same function as second -
//                    mu^ mu^^T, better conditioned).  Blocks of 256 threads,
//                    halved down to 32 while the grid would not give every
//                    SM a block.  A row with no live weight writes (-inf,
//                    0, I).

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxEpl = 8;        // cg_weak_marg: entries a lane a block
constexpr int kShortN = 128;      // log_marginalize: longest row of a group
constexpr int kWarpsPerSm = 64;

// SMs of the current device, asked once a device; 0 where the runtime
// cannot say (the launch then fails on its own).
int sm_count() {
  static int count[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!count[dev] &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    count[dev] = 0;
  return count[dev];
}

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

// The centre of a (max, sum) pair: its max where finite, else 0 (as the
// plain version: an all -inf row sums expf(-inf) = 0).
__device__ __forceinline__ float lse_centre(float m) {
  return isfinite(m) ? m : 0.f;
}

// merge another warp's (max, sum): one expf, against the larger max
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  if (m2 == -INFINITY) return;    // the other lane saw no live element
  if (m == -INFINITY) {
    m = m2;
    s = s2;
  } else if (m >= m2) {
    s += m2 == m ? s2 : s2 * expf(m2 - m);
  } else {
    s = s * expf(m - m2) + s2;
    m = m2;
  }
}

// logsumexp of rows of x [rows, N] (plan in the header; lse_plan in
// factor_ops.py).  Block: 8 warps; a row team is W warps x G lanes (W > 1
// only with G = 32 and RPG = 1).  Lane sub of team warp w takes, in round
// q, chunks ((q * C + j) * W + w) * G + sub, j < C, of each of its RPG
// rows; a chunk is V floats.  A warp's team shares its running max m (a
// butterfly of fmaxf, exact in any order); each lane sums expf(x - m) over
// its own elements, and the lanes' sums are added by a __shfl_down tree.
template <int V, int C, int RPG>
__global__ void __launch_bounds__(kThreads)
    log_marginalize_kernel(const float* __restrict__ x,
                           float* __restrict__ out, long long rows, int N,
                           int G, int W, int rounds) {
  constexpr int KV = C * V;
  const int lane = threadIdx.x & 31;
  const int wi = threadIdx.x >> 5;
  const int sub = lane & (G - 1);
  const int per = 32 / G;                      // row groups a warp
  const int w = wi % W;
  const long long row0 =
      (long long)blockIdx.x * ((kThreads / 32 / W) * RPG * per) +
      (wi / W) * (RPG * per) + lane / G;
  const int chunks = N / V;                    // V = 4: N % 4 == 0
  float m[RPG], s[RPG];                        // the team's max, my sum
#pragma unroll
  for (int r = 0; r < RPG; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.f;
  }
  for (int q = 0; q < rounds; ++q) {
    float v[RPG][KV];
    // every load of the round first ...
#pragma unroll
    for (int r = 0; r < RPG; ++r) {
      const long long row = row0 + r * per;
      const float* xr = x + row * N;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int c = ((q * C + j) * W + w) * G + sub;
        const bool ok = row < rows && c < chunks;
        if constexpr (V == 4) {
          const float4 t =
              ok ? __ldg(reinterpret_cast<const float4*>(xr) + c)
                 : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
          v[r][4 * j] = t.x;
          v[r][4 * j + 1] = t.y;
          v[r][4 * j + 2] = t.z;
          v[r][4 * j + 3] = t.w;
        } else {
          v[r][j] = ok ? __ldg(xr + c) : -INFINITY;
        }
      }
    }
    // ... then the team's max and my sum, in registers
#pragma unroll
    for (int r = 0; r < RPG; ++r) {
      float mr = v[r][0];
#pragma unroll
      for (int t = 1; t < KV; ++t) mr = fmaxf(mr, v[r][t]);
      for (int off = 1; off < G; off <<= 1)
        mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, off, G));
      if (mr > m[r]) {            // rescale only when a later round raises it
        s[r] = m[r] == -INFINITY ? 0.f : s[r] * expf(m[r] - mr);
        m[r] = mr;
      }
      const float cen = lse_centre(m[r]);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < KV; ++t) sum += expf(v[r][t] - cen);
      s[r] += sum;
    }
  }
  // every lane of the warp reaches the shuffles (no early return above)
#pragma unroll
  for (int r = 0; r < RPG; ++r)
    for (int off = G / 2; off > 0; off >>= 1)
      s[r] += __shfl_down_sync(0xffffffffu, s[r], off, G);
  if (W > 1) {                     // the team's warps, in warp order
    __shared__ float sh_m[kThreads / 32], sh_s[kThreads / 32];
    if (lane == 0) {
      sh_m[wi] = m[0];
      sh_s[wi] = s[0];
    }
    __syncthreads();
    if (w == 0 && lane == 0)
      for (int t = 1; t < W; ++t) lse_merge(m[0], s[0], sh_m[wi + t],
                                            sh_s[wi + t]);
  }
  if (w != 0 || sub != 0) return;
#pragma unroll
  for (int r = 0; r < RPG; ++r) {
    const long long row = row0 + r * per;
    if (row < rows)
      out[row] = s[r] > 0.f ? lse_centre(m[r]) + logf(s[r]) : -INFINITY;
  }
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

// Weak marginal of rows of a CG mixture (plan in the header; weak_plan in
// factor_ops.py): a group of G lanes a row, lane sub, with the entries e =
// e0 + sub + G t (t < EPL) of each block of G * EPL covariance entries.
// Components go in batches of JB, a batch's loads issued together; the
// first batch's logw, mu and sigma loads go out before any arithmetic, so
// a row of N <= JB components and at most G * EPL entries makes one trip
// to device memory and keeps everything in registers.  Every lane takes
// the row's max, mass and weights w_j = expf(logw_j - max) in component
// order (the same bits in every lane, no shuffle), then the mean at its
// entries' row and column dims and the centred covariance, one pass over
// sigma a block; the lanes holding row 0's entries write the mean.  I
// indexes within a row (int where a row's sigma has fewer than 2^31
// floats): the kernel is bound by its instructions as much as by its
// bytes, and 64-bit offsets cost two or three a load.
template <int EPL, typename I>
__global__ void __launch_bounds__(kThreads, EPL == 1 ? 4 : 1)
    cg_weak_marg_kernel(const float* __restrict__ lw,
                        const float* __restrict__ mu,
                        const float* __restrict__ sg, float* __restrict__ p,
                        float* __restrict__ mh, float* __restrict__ sh,
                        long long rows, int N, int n, int log2G) {
  constexpr int JB = EPL == 1 ? 4 : 16 / EPL;  // components a batch
  const int G = 1 << log2G;
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> log2G;
  if (row >= rows) return;
  const int sub = threadIdx.x & (G - 1);
  const I nn = (I)n * n;
  const float* lwr = lw + row * N;
  const float* mur = mu + row * N * n;
  const float* sgr = sg + row * N * nn;
  float* mhr = mh + row * n;
  float* shr = sh + row * nn;

  // the lane's entries of the block from e0: eb + G t = ia n + ib
  I eb = 0;
  int ia[EPL], ib[EPL];
  bool ok[EPL];
  auto entries = [&](I e0) {
    eb = e0 + sub;
#pragma unroll
    for (int t = 0; t < EPL; ++t) {
      const I e = eb + G * t;
      ok[t] = e < nn;
      using U = std::make_unsigned_t<I>;     // unsigned: fewer steps
      const I q = ok[t] ? (I)((U)e / (U)n) : 0;
      ia[t] = (int)q;
      ib[t] = (int)(e - q * n);
    }
  };
  // a batch of components j0 .. j0 + JB - 1 (past the row: logw -inf, the
  // rest 0): logw, mu at the entries' dims, sigma at the entries
  float lv[JB], w[JB], bs[JB][EPL], ba[JB][EPL], bb[JB][EPL];
  auto load_lw = [&](int j0) {
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
      lv[jj] = j0 + jj < N ? __ldg(lwr + j0 + jj) : -INFINITY;
  };
  auto load_mu = [&](int j0) {
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const I j = j0 + jj;
#pragma unroll
      for (int t = 0; t < EPL; ++t) {
        const bool live = j < N && ok[t];
        ba[jj][t] = live ? __ldg(mur + j * n + ia[t]) : 0.f;
        bb[jj][t] = live ? __ldg(mur + j * n + ib[t]) : 0.f;
      }
    }
  };
  auto load_sg = [&](int j0) {
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
#pragma unroll
      for (int t = 0; t < EPL; ++t)
        bs[jj][t] = j0 + jj < N && ok[t]
                        ? __ldg(sgr + (I)(j0 + jj) * nn + eb + G * t)
                        : 0.f;
  };
  entries(0);
  load_lw(0);
  load_mu(0);
  load_sg(0);
  const bool one = N <= JB;                    // one batch: all in registers

  float m = -INFINITY;
  for (int j0 = 0; j0 < N; j0 += JB) {
    if (j0) load_lw(j0);
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) m = fmaxf(m, lv[jj]);
  }
  const float ms = m == -INFINITY ? 0.f : m;
  auto weights = [&](int j0) {                 // 0 past the row
    if (!one) load_lw(j0);
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
      w[jj] = j0 + jj < N ? expf(lv[jj] - ms) : 0.f;
  };
  float s = 0.f;
  for (int j0 = 0; j0 < N; j0 += JB) {
    weights(j0);
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
      if (j0 + jj < N) s += w[jj];
  }
  if (!(s > 0.f)) {                            // dead row: (-inf, 0, I)
    if (sub == 0) p[row] = -INFINITY;
    for (int a = sub; a < n; a += G) mhr[a] = 0.f;
    for (I e = sub; e < nn; e += G)       // the diagonal: e = a (n + 1)
      shr[e] = e % (n + 1) == 0;
    return;
  }
  const float inv = __frcp_rn(s);              // 1.f / s, no slow-path call
  for (I e0 = 0; e0 < nn; e0 += G * EPL) {
    if (e0) entries(e0);
    // the mean at the entries' dims: sum_j w_j mu_j in j order, times 1/s
    float ma[EPL], mb[EPL], acc[EPL];
#pragma unroll
    for (int t = 0; t < EPL; ++t) ma[t] = mb[t] = acc[t] = 0.f;
    for (int j0 = 0; j0 < N; j0 += JB) {
      if (!one) weights(j0);
      if (e0 || !one) load_mu(j0);
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
#pragma unroll
        for (int t = 0; t < EPL; ++t) {
          ma[t] += w[jj] * ba[jj][t];
          mb[t] += w[jj] * bb[jj][t];
        }
    }
#pragma unroll
    for (int t = 0; t < EPL; ++t) {
      ma[t] *= inv;
      mb[t] *= inv;
      if (ok[t] && ia[t] == 0) mhr[ib[t]] = mb[t];
    }
    for (int j0 = 0; j0 < N; j0 += JB) {
      if (!one) {
        weights(j0);
        load_mu(j0);
      }
      if (e0 || !one) load_sg(j0);
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        const float wi = w[jj] * inv;
#pragma unroll
        for (int t = 0; t < EPL; ++t)
          acc[t] += wi * (bs[jj][t] + (ba[jj][t] - ma[t]) * (bb[jj][t] - mb[t]));
      }
    }
#pragma unroll
    for (int t = 0; t < EPL; ++t)
      if (ok[t]) shr[eb + G * t] = acc[t];
  }
  if (sub == 0) p[row] = ms + logf(s);
}

int grid_stride_blocks(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  const long long most = 32LL * max(1, sm_count());
  return (int)(blocks < most ? blocks : most);
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
int sm_blocks() { return 8 * max(1, sm_count()); }

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

struct LsePlan {
  int V, G, W, C, RPG, rounds;
};

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// lse_plan of factor_ops.py: the plan of rows rows of N >= 1 floats, the
// base 16-byte aligned or not, on a card of sms SMs.
LsePlan lse_plan(long long rows, int N, bool aligned, int sms) {
  LsePlan p;
  p.V = aligned && N % 4 == 0 ? 4 : 1;
  if (N <= kShortN) {
    p.G = pow2_at_least((N + 3) / 4);
    p.W = 1;
    p.C = p.V == 4 ? 1 : pow2_at_least((N + p.G - 1) / p.G);
    const long long rows_per_block = (kThreads / p.G) * 4LL;
    p.RPG = rows >= rows_per_block * sms ? 4 : 1;
    p.rounds = 1;
    return p;
  }
  p.G = 32;
  p.C = p.V == 4 ? min(4, pow2_at_least((N + 127) / 128))
                 : min(16, pow2_at_least((N + 31) / 32));
  p.W = 1;
  while (p.W < 8 && rows * p.W < (long long)sms * kWarpsPerSm &&
         p.W * 32 * p.C * p.V < N)
    p.W *= 2;
  p.RPG = 1;
  const int round = 32 * p.W * p.C * p.V;
  p.rounds = (N + round - 1) / round;
  return p;
}

struct WeakPlan {
  int G, EPL, threads;
};

// fn(kernel) for cg_weak_marg_kernel<EPL, int or long long offsets>
template <typename I, typename Fn>
int with_weak_epl(int EPL, Fn fn) {
  switch (EPL) {
    case 1: return fn(cg_weak_marg_kernel<1, I>);
    case 2: return fn(cg_weak_marg_kernel<2, I>);
    case 4: return fn(cg_weak_marg_kernel<4, I>);
    case 8: return fn(cg_weak_marg_kernel<8, I>);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Fn>
int with_weak_kernel(int EPL, bool narrow, Fn fn) {
  return narrow ? with_weak_epl<int>(EPL, fn)
                : with_weak_epl<long long>(EPL, fn);
}

// weak_plan of factor_ops.py: the plan of rows rows of n dimensions on a
// card of sms SMs.
WeakPlan weak_plan(long long rows, int n, int sms) {
  WeakPlan p;
  const long long nn = (long long)n * n;
  p.G = pow2_at_least((int)(nn < 32 ? nn : 32));
  const long long per_lane = (nn + p.G - 1) / p.G;
  p.EPL = per_lane >= kMaxEpl ? kMaxEpl : pow2_at_least((int)per_lane);
  p.threads = kThreads;
  while (p.threads > 32 &&
         (rows * p.G + p.threads - 1) / p.threads < (long long)sms)
    p.threads /= 2;
  return p;
}

// fn(kernel) for the instantiation of (V, C, RPG) that lse_plan can
// choose: short rows (V, C) in {(4, 1), (1, 1), (1, 2), (1, 4)} with
// RPG = 4 or 1, long rows in {(4, 2), (4, 4), (1, 8), (1, 16)} with
// RPG = 1.
template <int RPG, typename Fn>
int with_short_lse_kernel(int V, int C, Fn fn) {
  if (V == 4 && C == 1) return fn(log_marginalize_kernel<4, 1, RPG>);
  if (V == 1 && C == 1) return fn(log_marginalize_kernel<1, 1, RPG>);
  if (V == 1 && C == 2) return fn(log_marginalize_kernel<1, 2, RPG>);
  if (V == 1 && C == 4) return fn(log_marginalize_kernel<1, 4, RPG>);
  return (int)cudaErrorInvalidValue;
}

template <typename Fn>
int with_lse_kernel(int V, int C, int RPG, Fn fn) {
  if (RPG == 4) return with_short_lse_kernel<4>(V, C, fn);
  if (RPG != 1) return (int)cudaErrorInvalidValue;
  if (V == 4 && C == 2) return fn(log_marginalize_kernel<4, 2, 1>);
  if (V == 4 && C == 4) return fn(log_marginalize_kernel<4, 4, 1>);
  if (V == 1 && C == 8) return fn(log_marginalize_kernel<1, 8, 1>);
  if (V == 1 && C == 16) return fn(log_marginalize_kernel<1, 16, 1>);
  return with_short_lse_kernel<1>(V, C, fn);
}

}  // namespace

extern "C" {

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

// The plan that log_marginalize_launch takes (for the wrapper's check of
// its mirror): out = {V, G, W, C, RPG, rounds}.
int log_marginalize_plan(long long rows, int N, int aligned, int sms,
                         int* out) {
  const LsePlan p = lse_plan(rows, N, aligned != 0, sms);
  const int v[6] = {p.V, p.G, p.W, p.C, p.RPG, p.rounds};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// out [rows] = logsumexp of each row of x [rows, N], under lse_plan for
// x's alignment and the current device's SM count.
int log_marginalize_launch(const void* x, void* out, long long rows, int N,
                           void* stream) {
  if (rows == 0) return 0;
  const int sms = sm_count();
  if (N < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  const LsePlan p =
      lse_plan(rows, N, reinterpret_cast<size_t>(x) % 16 == 0, sms);
  const long long per_block =
      (long long)(kThreads / 32 / p.W) * p.RPG * (32 / p.G);
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return with_lse_kernel(p.V, p.C, p.RPG, [&](auto kernel) {
    kernel<<<(unsigned)blocks, kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), rows, N, p.G,
        p.W, p.rounds);
    return (int)cudaGetLastError();
  });
}

// Resident blocks an SM of the log_marginalize kernel of (V, C, RPG).
int log_marginalize_blocks_per_sm(int V, int C, int RPG) {
  return with_lse_kernel(V, C, RPG, [](auto kernel) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                      0) != cudaSuccess)
      return -1;
    return n;
  });
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

// The plan that cg_weak_marg_launch takes (for the wrapper's check of its
// mirror): out = {G, EPL, threads}.
int cg_weak_marg_plan(long long rows, int n, int sms, int* out) {
  const WeakPlan p = weak_plan(rows, n, sms);
  out[0] = p.G;
  out[1] = p.EPL;
  out[2] = p.threads;
  return 0;
}

// Weak marginal of rows = B*M mixtures of N components in n dimensions:
// lw [rows, N], mu [rows, N, n], sg [rows, N, n, n] -> p [rows],
// mh [rows, n], sh [rows, n, n], under weak_plan for the current device's
// SM count.
int cg_weak_marg_launch(const void* lw, const void* mu, const void* sg,
                        void* p, void* mh, void* sh, long long rows, int N,
                        int n, void* stream) {
  if (rows == 0) return 0;
  const int sms = sm_count();
  if (N < 0 || n < 0 || sms < 1) return (int)cudaErrorInvalidValue;
  const WeakPlan q = weak_plan(rows, n, sms);
  const long long blocks = (rows * q.G + q.threads - 1) / q.threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(lw);
  const float* b = static_cast<const float*>(mu);
  const float* c = static_cast<const float*>(sg);
  float* o1 = static_cast<float*>(p);
  float* o2 = static_cast<float*>(mh);
  float* o3 = static_cast<float*>(sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int log2G = 0;
  while ((1 << log2G) < q.G) ++log2G;
  // int offsets within a row while its sigma, and an entry block's reach
  // past it, stay below 2^31 floats
  const bool narrow =
      (long long)(N + 1) * n * n + (long long)q.G * q.EPL < (1LL << 31);
  return with_weak_kernel(q.EPL, narrow, [&](auto kernel) {
    kernel<<<(unsigned)blocks, q.threads, 0, s>>>(a, b, c, o1, o2, o3, rows,
                                                  N, n, log2G);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
