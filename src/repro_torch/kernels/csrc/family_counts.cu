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
// What bounds it on this card: shared-memory round trips and issue slots of
// the (instance, family) updates, not the bytes.  At the all-candidates
// shape of chip_smoke.py (N = 2^20 instances, Fd = 32 columns, M = 15904
// families, C = 64) xd is 128 MB, read in ~0.04 ms, while the 1.7e10
// (instance, family) pairs each need a mixed-radix code (one multiply-add
// per family member) and one read-modify-write of a histogram bin.
//
// Design (deterministic, no atomics anywhere):
//   * The wrapper compacts the dense [M, Fd] stride matrix into k (column,
//     stride) pairs per family (k = 1 + parents), so a code costs k
//     multiply-adds instead of an Fd-term dot; a thread keeps its family's
//     pairs in registers (KMAX is a template parameter; pairs beyond the
//     family's own have stride 0).
//   * Thread = (family, instance slice).  A block owns G families and
//     S = 256 / G instance slices of one slab of instances; each thread keeps
//     a private histogram of the block's C-range in shared memory and walks
//     the slab tile by tile.  A warp is 32 families of one slice.
//   * The histograms are bin-major, hist[c * 256 + thread]: lane t of a warp
//     always hits bank t, so a warp's bin loads and stores never conflict
//     whatever its 32 codes are.  A spill bin past the block's Cb bins takes
//     every code outside its range, so no update is predicated.
//   * A tile of T instances of xd and w is copied with 16-byte cp.async
//     (4-byte where the base is not 16-byte aligned) into a double buffer:
//     the next tile's copy runs while this one is counted.
//   * Narrow staging: where every value of the tile lies in [0, 255], the
//     block also writes the tile as bytes, transposed (word [col][q] holds
//     instances 4q..4q+3 of column col; odd row stride, so the 32 columns a
//     warp reads sit in 32 banks).  A family whose largest code of such a
//     tile fits 16 bits counts from there: one 32-bit load gives a lane 4
//     instances of a column, and the 4 codes are computed as two pairs of
//     packed 16-bit lanes (two multiply-adds per column for 4 instances).
//     The decision is per tile (__syncthreads_or while staging); any other
//     tile, and any family whose codes need more than 16 bits, is counted
//     from the int32 copy with wrap-around int32 arithmetic, so negative and
//     out-of-range values keep their meaning exactly.
//   * Instances go to slices by quads: slice s takes the quads s, s + S, ...
//     of a tile, in order.  A quad's 4 bins are loaded at once, each update
//     takes the newest value of an equal earlier bin of the quad, and the 4
//     stores go in instance order: the same sums, in the same order, as 4
//     updates one after the other, with one shared-memory round trip.  The
//     next quad's codes are computed before this quad's bins are touched,
//     and the loop keeps shared memory in 32-bit window addresses.
//   * The block adds its S slice histograms in slice order and writes
//     partial[slab, c, m]; a second kernel sums the slabs in a fixed order
//     (32 slab lanes, then a fixed tree) into counts[m, c].  Two launches on
//     one input give the same bits; with 0/1 weights every sum is an exact
//     integer below 2^24, so the counts equal the plain version's bit for
//     bit.
//   * The histograms bound G * C by shared memory, so the grid's third axis
//     splits C into ranges of at most Cb bins.  SPLIT, a template
//     parameter, is true for more than one range: one range skips the
//     range offset, 4 integer adds a quad (probes/family_counts_split.py
//     times what that saves).  The wrapper weighs a split that leaves two
//     blocks an SM against one block with fewer ranges.
//   * Codes are int32 with wrap-around arithmetic; they are exact while
//     |sum_f strides[m, f] * xd[n, f]| < 2^31, always so for categories in
//     range (their codes lie in [0, C)).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;          // xd tiles: a double buffer
constexpr int kReduceEntries = 32;  // stage-2 block: 32 entries x 32 slab
constexpr int kReduceLanes = 32;    // lanes

// Shared memory by 32-bit shared-window addresses: the counting loop keeps
// one address per column and per histogram instead of recomputing them.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Copy `words` 4-byte words from src to dst: 16 bytes a thread where
// `vec` (both 16-byte aligned), the tail and everything else 4 bytes.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src,
                                      int words, bool vec) {
  int i0 = 0;
  if (vec) {
    const int v = words >> 2;
    for (int i = threadIdx.x; i < v; i += kThreads)
      cp_async16(dst + 4 * i, src + 4 * i);
    i0 = 4 * v;
  }
  for (int i = i0 + threadIdx.x; i < words; i += kThreads)
    cp_async4(dst + i, src + i);
}

__device__ __forceinline__ unsigned ld_shared_u32(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ float ld_shared_f32(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ float4 ld_shared_f32x4(unsigned a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ void st_shared_f32(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}

// A quad's 4 bins of the thread's histogram column at shared address hb
// (bin c at hb + c * 4 * kThreads bytes): their addresses and values.
struct Quad {
  unsigned a[4];
  float h[4];
};

__device__ __forceinline__ Quad load_quad(unsigned hb, const unsigned idx[4]) {
  Quad b;
#pragma unroll
  for (int i = 0; i < 4; ++i) b.a[i] = hb + (idx[i] << 10);
#pragma unroll
  for (int i = 0; i < 4; ++i) b.h[i] = ld_shared_f32(b.a[i]);
  return b;
}

// The quad's 4 updates, stored in instance order: each takes the newest
// value of an equal earlier bin of the quad, so the result equals four
// updates one after the other.
__device__ __forceinline__ void store_quad(const Quad& b, float4 w) {
  const unsigned* a = b.a;
  float s1 = b.h[1], s2 = b.h[2], s3 = b.h[3];
  const float v0 = b.h[0] + w.x;
  s1 = a[1] == a[0] ? v0 : s1;
  s2 = a[2] == a[0] ? v0 : s2;
  s3 = a[3] == a[0] ? v0 : s3;
  const float v1 = s1 + w.y;
  s2 = a[2] == a[1] ? v1 : s2;
  s3 = a[3] == a[1] ? v1 : s3;
  const float v2 = s2 + w.z;
  s3 = a[3] == a[2] ? v2 : s3;
  const float v3 = s3 + w.w;
  st_shared_f32(a[0], v0);
  st_shared_f32(a[1], v1);
  st_shared_f32(a[2], v2);
  st_shared_f32(a[3], v3);
}

// Shared memory of a block, in 4-byte words: the histograms (Cb bins and a
// spill bin), kStages weight and int32 tiles and the byte tile (QS words a
// column).
__host__ __device__ __forceinline__ int quad_stride(int T) {
  return (T / 4) | 1;
}

__host__ __device__ __forceinline__ long smem_words(int Fd, int Cb, int T) {
  return (long)kThreads * (Cb + 1) + (long)kStages * T * (1 + Fd) +
         (long)Fd * quad_stride(T);
}

// The 4 codes of quad q of the thread's family: sv[j] * value of column
// col[j], summed (pairs j >= k have stride 0 and read column 0), from the
// byte tile as two pairs of packed 16-bit lanes (PACKED) or from the int32
// tile.  colb[j] is the shared address of column col[j] of the byte tile.
template <int KMAX, bool PACKED>
__device__ __forceinline__ void quad_codes(unsigned code[4], int q,
                                           const int col[KMAX],
                                           const unsigned sv[KMAX],
                                           const unsigned colb[KMAX],
                                           const int* x, int Fd) {
  code[0] = code[1] = code[2] = code[3] = 0u;
  if (PACKED) {
    unsigned lo = 0u, hi = 0u;             // 16-bit lanes (0, 2) and (1, 3)
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      const unsigned v = ld_shared_u32(colb[j] + 4 * q);
      lo += sv[j] * __byte_perm(v, 0u, 0x4240);
      hi += sv[j] * __byte_perm(v, 0u, 0x4341);
    }
    code[0] = lo & 0xffffu;
    code[1] = hi & 0xffffu;
    code[2] = lo >> 16;
    code[3] = hi >> 16;
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int* xi = x + (4 * q + b) * Fd;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) code[b] += sv[j] * (unsigned)xi[col[j]];
    }
  }
}

// The thread's quads q0, q0 + S, ... (< nq) of a tile into its histogram
// column hb: a code outside [c0, c0 + Cb) goes to the spill bin Cb, never
// read (SPLIT: C has more than one range; else c0 = 0).  The weights of a
// ragged tile's last quad beyond its instances are 0.  A quad's bins are
// loaded, then the next quad's codes computed while the loads are in
// flight, then the quad's sums stored (shared memory accesses stay in
// program order); two code buffers take turns.
template <int KMAX, bool PACKED, bool SPLIT>
__device__ __forceinline__ void count_quads(unsigned hb, int q0, int S, int nq,
                                            const int col[KMAX],
                                            const unsigned sv[KMAX],
                                            const unsigned colb[KMAX],
                                            unsigned c0, unsigned Cb,
                                            const int* x, int Fd,
                                            unsigned ws) {
  auto bins = [&](const unsigned code[4]) {
    unsigned idx[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      idx[b] = min(SPLIT ? code[b] - c0 : code[b], Cb);
    return load_quad(hb, idx);
  };
  if (q0 >= nq) return;
  unsigned ca[4], cb[4];
  quad_codes<KMAX, PACKED>(ca, q0, col, sv, colb, x, Fd);
  for (int q = q0;;) {
    const int q1 = q + S;
    Quad b = bins(ca);
    if (q1 < nq) quad_codes<KMAX, PACKED>(cb, q1, col, sv, colb, x, Fd);
    store_quad(b, ld_shared_f32x4(ws + 16 * q));
    if (q1 >= nq) break;
    const int q2 = q1 + S;
    b = bins(cb);
    if (q2 < nq) quad_codes<KMAX, PACKED>(ca, q2, col, sv, colb, x, Fd);
    store_quad(b, ld_shared_f32x4(ws + 16 * q1));
    if (q2 >= nq) break;
    q = q2;
  }
}

template <int KMAX, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
    family_counts_slab(const int* __restrict__ xd,
                       const int* __restrict__ cols,
                       const int* __restrict__ svals,
                       const float* __restrict__ w,
                       float* __restrict__ partial, int N, int Fd, int M,
                       int k, int C, int Cb, int G, int T, int slab_len) {
  extern __shared__ __align__(16) float smem[];
  const int S = kThreads / G;
  const int QS = quad_stride(T);
  float* hist = smem;                                // [Cb + 1, kThreads]
  float* s_w = hist + kThreads * (Cb + 1);           // [kStages, T]
  uint32_t* s_x =                                    // [kStages, T, Fd]
      reinterpret_cast<uint32_t*>(s_w + kStages * T);
  uint32_t* s_b = s_x + kStages * T * Fd;            // [Fd, QS]

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
  unsigned top = 0u;          // the largest code of a byte tile, if sv >= 0
  bool nonneg = true;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    const bool use = live && j < k;
    col[j] = use ? cols[(long)m * k + j] : 0;
    sv[j] = use ? (unsigned)svals[(long)m * k + j] : 0u;
    nonneg = nonneg && (int)sv[j] >= 0;
    top += min(sv[j], 65536u) * 255u;
  }
  // 4 codes of a byte tile as two pairs of 16-bit lanes, no carry between
  const bool packed = nonneg && top <= 65535u;
  for (int c = 0; c < Cb; ++c) hist[c * kThreads + t] = 0.f;
  const unsigned hb = shared_addr(hist + t);
  unsigned colb[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) colb[j] = shared_addr(s_b + col[j] * QS);

  const long n_begin = (long)slab * slab_len;
  const long n_end = min((long)N, n_begin + slab_len);
  const int n_tiles = (int)((n_end - n_begin + T - 1) / T);
  const bool vx = (reinterpret_cast<uintptr_t>(xd) & 15) == 0;
  const bool vw = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  auto issue = [&](int ti) {
    const long n0 = n_begin + (long)ti * T;
    const int cnt = (int)min((long)T, n_end - n0);
    const int buf = ti % kStages;
    stage(s_x + buf * T * Fd, reinterpret_cast<const uint32_t*>(xd) + n0 * Fd,
          cnt * Fd, vx);
    stage(reinterpret_cast<uint32_t*>(s_w + buf * T),
          reinterpret_cast<const uint32_t*>(w) + n0, cnt, vw);
  };

  // double buffer: tile ti + 1 is copied while tile ti is counted, issued
  // after the barrier that ends every thread's reads of its buffer
  issue(0);
  cp_async_commit();
  for (int ti = 0; ti < n_tiles; ++ti) {
    cp_async_wait_all();
    __syncthreads();                   // tile ti landed; tile ti - 1 done
    if (ti + 1 < n_tiles) {
      issue(ti + 1);
      cp_async_commit();
    }
    const int cnt = (int)min((long)T, n_end - (n_begin + (long)ti * T));
    const int nq = (cnt + 3) >> 2;
    const int* x =
        reinterpret_cast<const int*>(s_x + (ti % kStages) * T * Fd);
    float* ws = s_w + (ti % kStages) * T;
    if (t < 4 * nq - cnt) ws[cnt + t] = 0.f;    // the last quad's tail
    // byte tile, transposed; any value outside [0, 255] keeps the int32 path
    bool wide = false;
    for (int e = t; e < Fd * nq; e += kThreads) {
      const int q = e / Fd;
      const int c = e - q * Fd;
      unsigned word = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * q + b;
        if (i < cnt) {
          const unsigned v = (unsigned)x[i * Fd + c];
          wide = wide || v > 255u;
          word |= (v & 255u) << (8 * b);
        }
      }
      s_b[c * QS + q] = word;
    }
    const bool narrow = !__syncthreads_or(wide);
    if (live) {
      const unsigned wa = shared_addr(ws);
      if (narrow && packed)
        count_quads<KMAX, true, SPLIT>(hb, sl, S, nq, col, sv, colb, c0, Cb,
                                       x, Fd, wa);
      else
        count_quads<KMAX, false, SPLIT>(hb, sl, S, nq, col, sv, colb, c0, Cb,
                                        x, Fd, wa);
    }
  }
  __syncthreads();                     // every histogram is complete
  // slice histograms of a family are columns gl, G + gl, ...: add in order
  float* out = partial + (long)slab * C * M;
  for (int e = t; e < G * cw; e += kThreads) {
    const int c = e / G;
    const int g = e - c * G;
    const int mm = blockIdx.x * G + g;
    if (mm >= M) continue;
    float tot = 0.f;
    for (int s = 0; s < S; ++s) tot += hist[c * kThreads + s * G + g];
    out[(long)(c0 + c) * M + mm] = tot;
  }
}

// counts[m, c] = sum over slabs of partial[slab, c, m]: 32 entries x 32
// slab lanes a block, each lane a strided set of slabs in order, then a
// fixed tree over the lanes.
__global__ void slab_reduce(const float* __restrict__ partial,
                            float* __restrict__ out, int n_slabs, int M,
                            int C) {
  __shared__ float s_lane[kReduceLanes][kReduceEntries + 1];
  const long E = (long)M * C;
  const long e = (long)blockIdx.x * kReduceEntries + threadIdx.x;
  float acc = 0.f;
  if (e < E)
    for (int s = threadIdx.y; s < n_slabs; s += kReduceLanes)
      acc += partial[(long)s * E + e];
  s_lane[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  for (int h = kReduceLanes / 2; h > 0; h /= 2) {
    if ((int)threadIdx.y < h)
      s_lane[threadIdx.y][threadIdx.x] += s_lane[threadIdx.y + h][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && e < E) {
    const long c = e / M;
    out[(e - c * M) * C + c] = s_lane[0][threadIdx.x];
  }
}

template <int KMAX, bool SPLIT>
int launch_slab(dim3 grid, size_t smem, cudaStream_t s, const int* xd,
                const int* cols, const int* svals, const float* w,
                float* partial, int N, int Fd, int M, int k, int C, int Cb,
                int G, int T, int slab_len) {
  int err = (int)cudaFuncSetAttribute(
      family_counts_slab<KMAX, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  family_counts_slab<KMAX, SPLIT><<<grid, kThreads, smem, s>>>(
      xd, cols, svals, w, partial, N, Fd, M, k, C, Cb, G, T, slab_len);
  return (int)cudaGetLastError();
}

template <int KMAX, bool SPLIT>
int occupancy(size_t smem) {
  int blocks = 0;
  if (cudaFuncSetAttribute(family_counts_slab<KMAX, SPLIT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, family_counts_slab<KMAX, SPLIT>, kThreads, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

// f(KMAX, SPLIT) for the instantiation that takes families of k pairs and
// C in one range or more (-1 where there is none).
template <typename F>
int by_k(int k, bool split, F&& f) {
  auto with = [&](auto K) {
    return split ? f(K, std::true_type{}) : f(K, std::false_type{});
  };
  if (k <= 1) return with(std::integral_constant<int, 1>{});
  if (k <= 2) return with(std::integral_constant<int, 2>{});
  if (k <= 3) return with(std::integral_constant<int, 3>{});
  if (k <= 4) return with(std::integral_constant<int, 4>{});
  if (k <= 8) return with(std::integral_constant<int, 8>{});
  if (k <= 16) return with(std::integral_constant<int, 16>{});
  if (k <= 32) return with(std::integral_constant<int, 32>{});
  return -1;
}

}  // namespace

extern "C" {

int family_counts_threads() { return kThreads; }

// The largest number of (column, stride) pairs a family may have.
int family_counts_max_k() { return 32; }

// Shared memory of a block in bytes, as family_counts.plan computes it.
long family_counts_smem_bytes(int Fd, int Cb, int T) {
  return 4 * smem_words(Fd, Cb, T);
}

// Blocks of the counting kernel for families of k pairs that an SM holds at
// once with smem bytes of shared memory each (-1 on error).
int family_counts_blocks_per_sm(int k, int smem) {
  return by_k(k, false, [&](auto K, auto SPLIT) {
    return occupancy<decltype(K)::value, decltype(SPLIT)::value>(smem);
  });
}

// counts [M, C] of xd [N, Fd] (int32) under the compacted families
// cols/svals [M, k] (int32) with weights w [N]; partial holds
// n_slabs * C * M floats (n_slabs = ceil(N / slab_len)).  G families per
// block (a power of two, 32..256), T instances per tile (a multiple of 4;
// slab_len a multiple of T), C split into ranges of Cb bins.
int family_counts_launch(const void* xd, const void* cols, const void* svals,
                         const void* w, void* partial, void* out, int N,
                         int Fd, int M, int k, int C, int Cb, int G, int T,
                         int slab_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T % 4 || slab_len % T || k > 32) return (int)cudaErrorInvalidValue;
  const int n_slabs = (int)(((long)N + slab_len - 1) / slab_len);
  dim3 grid((M + G - 1) / G, n_slabs, (C + Cb - 1) / Cb);
  const size_t smem = 4 * (size_t)smem_words(Fd, Cb, T);
  float* p = static_cast<float*>(partial);
  int err = by_k(k, C > Cb, [&](auto K, auto SPLIT) {
    return launch_slab<decltype(K)::value, decltype(SPLIT)::value>(
        grid, smem, s, static_cast<const int*>(xd),
        static_cast<const int*>(cols), static_cast<const int*>(svals),
        static_cast<const float*>(w), p, N, Fd, M, k, C, Cb, G, T, slab_len);
  });
  if (err) return err;
  const long E = (long)M * C;
  dim3 block(kReduceEntries, kReduceLanes);
  slab_reduce<<<(unsigned)((E + kReduceEntries - 1) / kReduceEntries), block,
                0, s>>>(p, static_cast<float*>(out), n_slabs, M, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
