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
//                                             (pallas_call at clg_stats.py:289)
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
// clg_suffstats_latent (clg_latent_launch): the same scheme over the design
// [obs[n, f, :Do], h_mean[n, k, :L]], each part read in place through its
// own row stride; no padding (ranges are masked), no copy, any F in one
// launch.  The latent-latent block sum_n r_k h h^T is the same for every
// leaf, so the units split (LatentLayout): leaf units of a (leaf f,
// component k) sum the observed rows of sxx's upper triangle, sxy and syy;
// latent units of a component k, in blocks of their own after the leaf
// blocks, sum the latent rows and rsum_k.
//   D <= 8   latent_tile<D, Do>: one unit of each kind a (f, k) and a k,
//            all its sums in registers.  A thread issues the loads of 4
//            instances before adding them in order (one instance's few
//            loads in flight leave HBM idle).
//   D > 8    latent_rows: moments_rows' units of one row and one block of
//            up to 32 columns, the columns blocked by source array
//            (observed, then latent; ColBlocks).  A leaf unit is a block of
//            the y row (sxy; syy beside block 0) or a live block of an
//            observed row; a latent unit a live block of a latent row.
//   stage 2  latent_reduce sums each entry over the ranges as
//            moments_reduce does; a latent entry then adds rsum_k * S_k
//            (sum, then add, as the Pallas kernel's _final does,
//            clg_stats.py:163-173) and goes to every leaf.
//
// clg_disc_counts (clg_disc_counts_launch): moments_tile's scheme with one-
// hot bins for moments.  Its bytes are 4 (Fd + K) an instance, read once:
// a copy, a pad or a shared-memory tile only adds traffic, and one block
// for the whole of stage 2 leaves 131 SMs idle.
//   stage 1  disc_tile<KG, CB>: a unit is a leaf x KG components x CB bins
//            (a power of two), KG * CB <= 48 sums in registers, each indexed
//            by a constant: per instance the unit loads xd[n, f] and r[n, k]
//            once a component, straight from device memory through the row
//            strides, and adds r into the bin that x matches by an unrolled
//            compare-select (x outside [0, C), -1 included, matches none).
//            At nb_mixed (Fd = 2, K = 3, C = 4) a unit holds a leaf's 12
//            entries and a warp reads 16 neighbouring rows (the two leaves'
//            units share each r row through L1; a unit of both leaves'
//            entries holds twice the sums and so fewer blocks an SM); a
//            wide row takes 32 neighbouring leaves a warp.  A
//            block is PU unit positions x NL instance lanes over a
//            fixed range partition (disc_plan in clg_stats.py, from the
//            shapes and the card's SM count: 32 or more instances a lane,
//            since a lane's loads are a chain of trips to device memory and
//            fewer, longer ranges spend less on the lanes' sums and stage
//            2; up to 4 blocks an SM); lanes add by a shuffle tree,
//            warps in order; writes partial[range, Fd*K*C].  No padding (the
//            ranges are masked), no copy, no limit on Fd + K; C > 16 takes
//            C / 16 bin blocks, each unit 16 compare-selects an instance.
//   stage 2  disc_reduce: moments_reduce's shape, 32 entries x 32 range
//            lanes a block (sum_ranges).
//
// Deterministic everywhere, no float atomics: two launches on the same input
// give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// -- clg_suffstats: register-blocked moments straight from device memory ----

constexpr int kRowsBlock = 32;      // columns of a row that moments_rows
constexpr int kRowsSlots = kRowsBlock + 2;   // sums in one unit
constexpr int kRangeLanes = 32;     // stage 2: 32 entries x 32 range lanes

struct MomentArgs {
  const float* d;        // [n_total, *]: leaf f's row at d + n*d_row + f*Dd
                         // (Dd = D, or Do for the latent obs)
  const float* hm;       // latent: component k's E[h] at hm + n*h_row + k*L
  const float* shh;      // latent: S_k [K, L, L]
  const float* y;        // y + n*y_row + f
  const float* r;        // r + n*r_row + k
  float* partial;        // [n_chunks, R_max, F*K*U]
  float* sxx;            // [n_chunks, F, K, D, D]
  float* sxy;            // [n_chunks, F, K, D]
  float* syy;            // [n_chunks, F, K]
  long d_row, y_row, r_row, h_row;
  long chunk_len, n_total;   // chunk c is [c*chunk_len, min(n_total, ...))
  int F, K, D;
  int Do, L;             // latent: D = Do + L
  int FT, UB, NL, n_ublocks, W;   // W units a leaf (latent: leaf units)
  int n_leaf, UBh, NLh, Wh;  // latent: n_leaf leaf blocks, then latent
                             // blocks of UBh of the Wh latent units x NLh
                             // instance lanes
  int R_full, len_full, R_last, len_last, R_max;
  int vec, rvec;         // float widths of the d (latent: h_mean) and r loads
};

// sxx's upper triangle, sxy and syy of one (leaf, component)
__host__ __device__ constexpr int entries_per_unit(int D) {
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
// red is [A][NL][P] (P = FT * UB, or UBh); slot_entry(p, s) is the compact
// entry of the unit of block position p and slot s, or -1.
template <typename SlotEntry>
__device__ __forceinline__ void reduce_lanes(int P, int NL, float* red,
                                             int A, float* part,
                                             SlotEntry slot_entry) {
  __syncthreads();
  for (int e = threadIdx.x; e < A * P; e += kThreads) {
    const int s = e / P;
    const int p = e - s * P;
    const long dst = slot_entry(p, s);
    if (dst < 0) continue;
    float tot = 0.f;
    for (int l = 0; l < NL; ++l) tot += red[(s * NL + l) * P + p];
    part[dst] = tot;
  }
}

// Stage 1, D <= 8: a thread owns leaf f and components k0 .. k0 + KG - 1.
template <int D, int KG>
__global__ void __launch_bounds__(kThreads)
    moments_tile(const MomentArgs a) {
  constexpr int U = entries_per_unit(D);
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
  reduce_lanes(P, a.NL, red, A, part, [&](int pp, int s) -> long {
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
  reduce_lanes(P, a.NL, red, kRowsSlots, part, [&](int pp, int s) -> long {
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

// Column blocks of a D > 8 latent design row: NBo blocks of up to 32 of
// its Dp = D - L observed columns, then the blocks of its L latent columns,
// so that a block reads one array.  Block j starts at column col0(j) and
// holds width(j) columns.  Row i sums the blocks right of the diagonal,
// block_of(i) .. NB - 1: the live units of a component, row by row.
__host__ __device__ __forceinline__ int imin(int x, int y) {
  return x < y ? x : y;
}

struct ColBlocks {
  int D, Dp, NBo, NB;
  __host__ __device__ __forceinline__ ColBlocks(int D_, int L) {
    D = D_;
    Dp = D - L;
    NBo = (Dp + kRowsBlock - 1) / kRowsBlock;
    NB = NBo + (L + kRowsBlock - 1) / kRowsBlock;
  }
  __host__ __device__ __forceinline__ int col0(int j) const {
    return j < NBo ? kRowsBlock * j : Dp + kRowsBlock * (j - NBo);
  }
  __host__ __device__ __forceinline__ int width(int j) const {
    return j < NBo ? imin(kRowsBlock, Dp - kRowsBlock * j)
                   : imin(kRowsBlock, D - col0(j));
  }
  __host__ __device__ __forceinline__ int block_of(int b) const {
    return b < Dp ? b / kRowsBlock : NBo + (b - Dp) / kRowsBlock;
  }
  // the rows from i0 on that lie in the same block as row i0
  __host__ __device__ __forceinline__ int run_end(int i0) const {
    const int j = block_of(i0);
    return imin(j < NBo ? Dp : D, col0(j) + kRowsBlock);
  }
  // live unit w of a component -> (row i, block j); w >= units(D) -> i = D
  __host__ __device__ __forceinline__ void unit(int w, int& i, int& j) const {
    int i0 = 0;
    while (i0 < D) {
      const int c = NB - block_of(i0), span = (run_end(i0) - i0) * c;
      if (w < span) {
        i = i0 + w / c;
        j = block_of(i0) + w % c;
        return;
      }
      w -= span;
      i0 = run_end(i0);
    }
    i = D;
    j = 0;
  }
  // live units of the rows below `rows` (Dp or D) of a component
  __host__ __device__ __forceinline__ int units(int rows) const {
    int n = 0;
    for (int i0 = 0; i0 < rows; i0 = run_end(i0))
      n += (run_end(i0) - i0) * (NB - block_of(i0));
    return n;
  }
};

// Entries in partial of a leaf unit's (f, k): the Do observed rows of sxx's
// upper triangle (row by row), sxy, syy; and of a component k's latent
// units: the L latent rows of the triangle, rsum_k.
__host__ __device__ constexpr int latent_leaf_entries(int D, int Do) {
  return Do * D - Do * (Do - 1) / 2 + D + 1;
}
__host__ __device__ constexpr int latent_hh_entries(int L) {
  return L * (L + 1) / 2 + 1;
}

// The units of the latent moments: UO/UH entries a (f, k)/a k, and Wo leaf
// units a (f, k), Wh latent units a k: one each for D <= 8 (latent_tile);
// for D > 8 (latent_rows) the NB blocks of the y row and the n_obs live
// ColBlocks units of the observed rows, then the latent rows' live units.
struct LatentLayout {
  int UO, UH, Wo, Wh, n_obs;
  __host__ __device__ LatentLayout(int Do, int L) {
    const int D = Do + L;
    UO = latent_leaf_entries(D, Do);
    UH = latent_hh_entries(L);
    Wo = Wh = 1;
    n_obs = 0;
    if (D > 8) {
      const ColBlocks cb(D, L);
      n_obs = cb.units(Do);
      Wo = cb.NB + n_obs;
      Wh = cb.units(D) - n_obs;
    }
  }
};

// Unit `unit` of a latent_rows block, latent (hh) or leaf: its component
// k, its index w among the component's units, the row i of sxx it sums
// (-1: the y row) and its column block j.
struct RowUnit {
  int k, w, i, j;
  __device__ __forceinline__ RowUnit(const ColBlocks& cb,
                                     const LatentLayout& lay, bool hh,
                                     int unit) {
    const int Wk = hh ? lay.Wh : lay.Wo;
    k = unit / Wk;
    w = unit - k * Wk;
    if (hh) {
      cb.unit(lay.n_obs + w, i, j);
    } else if (w < cb.NB) {
      i = -1;
      j = w;
    } else {
      cb.unit(w - cb.NB, i, j);
    }
  }
};

// Stage 1 of the latent moments, D <= 8 (DO = Do observed columns, L =
// D - DO latent ones).  The latent-latent block sum_n r_k h h^T is the same
// for every leaf, so it is summed once per component: grid.x holds the
// leaf blocks (FT leaves x UB components x NL instance lanes) and then the
// latent blocks (UBh components x NLh lanes).  A leaf unit (f, k) keeps UO
// slots: the DO observed rows of sxx's upper triangle (row by row), sxy and
// syy; a latent unit k keeps UH: the latent rows of the triangle and rsum.
// A thread issues the loads of UN instances (l, l + NL, ...) before adding
// them in that order.  partial is [R][F*K*UO | K*UH].
template <int D, int DO>
__global__ void __launch_bounds__(kThreads) latent_tile(const MomentArgs a) {
  constexpr int L = D - DO;
  constexpr int UO = latent_leaf_entries(D, DO);
  constexpr int UH = latent_hh_entries(L);
  constexpr int A = UO > UH ? UO : UH;
  constexpr int UN = 4;                      // instances in flight a thread
  extern __shared__ float red[];             // [A][NL][P]
  long n0, n1;
  if (!block_range(a, n0, n1)) return;
  const int t = threadIdx.x;
  const bool hh = (int)blockIdx.x >= a.n_leaf;
  const int P = hh ? a.UBh : a.FT * a.UB;
  const int NL = hh ? a.NLh : a.NL;
  const int p = t % P;
  const int lane = t / P;
  int f = 0, k;
  if (hh) {
    k = ((int)blockIdx.x - a.n_leaf) * a.UBh + p;
  } else {
    const int ft = blockIdx.x / a.n_ublocks;
    f = ft * a.FT + p % a.FT;
    k = (blockIdx.x - ft * a.n_ublocks) * a.UB + p / a.FT;
  }
  const bool live = lane < NL && f < a.F && k < a.K;

  float acc[A];
#pragma unroll
  for (int s = 0; s < A; ++s) acc[s] = 0.f;
  if (live) {
    const float* op = a.d + (long)f * DO;
    const float* hp = a.hm + (long)k * L;
    const float* yp = a.y + f;
    const float* rp = a.r + k;
#pragma unroll 1
    for (long n = n0 + lane; n < n1; n += UN * NL) {
      float u[UN][D], yv[UN], rv[UN];
      bool in[UN];
#pragma unroll
      for (int q = 0; q < UN; ++q) {
        const long nn = n + q * NL;
        in[q] = q == 0 || nn < n1;
        const long m = in[q] ? nn : n;       // a past-the-range lane reads
        if (!hh) {                           // n and adds nothing
#pragma unroll
          for (int i = 0; i < DO; ++i) u[q][i] = __ldg(op + m * a.d_row + i);
          yv[q] = __ldg(yp + m * a.y_row);
        }
        if (a.vec == 4)
          load_floats<L, 4>(u[q] + DO, hp + m * a.h_row, true);
        else
          load_floats<L, 2>(u[q] + DO, hp + m * a.h_row, a.vec == 2);
        rv[q] = __ldg(rp + m * a.r_row);
      }
#pragma unroll
      for (int q = 0; q < UN; ++q) {
        if (!in[q]) break;
        int s = 0;
        if (hh) {
#pragma unroll
          for (int l = DO; l < D; ++l) {
            const float rl = rv[q] * u[q][l];
#pragma unroll
            for (int b = l; b < D; ++b) acc[s++] += rl * u[q][b];
          }
          acc[UH - 1] += rv[q];
        } else {
#pragma unroll
          for (int i = 0; i < D; ++i) {
            const float ri = rv[q] * u[q][i];
            if (i < DO)
#pragma unroll
              for (int b = i; b < D; ++b) acc[s++] += ri * u[q][b];
            acc[UO - 1 - D + i] += ri * yv[q];
          }
          acc[UO - 1] += rv[q] * yv[q] * yv[q];
        }
      }
    }
  }
  if (lane < NL)
#pragma unroll
    for (int s = 0; s < A; ++s) red[(s * NL + lane) * P + p] = acc[s];
  float* part = a.partial + (long)blockIdx.y * ((long)a.F * a.K * UO +
                                                 (long)a.K * UH);
  if (hh) {
    const int k0 = ((int)blockIdx.x - a.n_leaf) * a.UBh;
    reduce_lanes(P, NL, red, UH, part, [&](int pp, int s) -> long {
      const int kk = k0 + pp;
      return kk < a.K ? (long)a.F * a.K * UO + (long)kk * UH + s : -1;
    });
  } else {
    const int ft = blockIdx.x / a.n_ublocks;
    const int ub = blockIdx.x - ft * a.n_ublocks;
    reduce_lanes(P, NL, red, UO, part, [&](int pp, int s) -> long {
      const int ff = ft * a.FT + pp % a.FT;
      const int kk = ub * a.UB + pp / a.FT;
      return ff < a.F && kk < a.K ? ((long)ff * a.K + kk) * UO + s : -1;
    });
  }
}

// Stage 1 of the latent moments, D > 8: latent_tile's leaf and latent
// blocks with moments_rows' units (RowUnit): a thread owns one row and one
// column block of a component k (and a leaf f, in a leaf block); slot s <
// kRowsBlock sums r_k u_i u_b (the y row: r_k y u_b) for column b = col0 +
// s on or right of the diagonal, slot kRowsBlock r_k y y (the y row's block
// 0) or rsum_k (a component's first latent unit).  partial is as
// latent_tile's, [R][F*K*UO | K*UH].
__global__ void __launch_bounds__(kThreads) latent_rows(const MomentArgs a) {
  constexpr int S = kRowsBlock + 1;
  extern __shared__ float red[];             // [S][NL][P]
  long n0, n1;
  if (!block_range(a, n0, n1)) return;
  const ColBlocks cb(a.D, a.L);
  const LatentLayout lay(a.Do, a.L);
  const int t = threadIdx.x;
  const bool hh = (int)blockIdx.x >= a.n_leaf;
  const int P = hh ? a.UBh : a.FT * a.UB;
  const int NL = hh ? a.NLh : a.NL;
  const int units = hh ? a.Wh : a.W;
  const int ft = hh ? 0 : (int)blockIdx.x / a.n_ublocks;
  const int u0 = hh ? ((int)blockIdx.x - a.n_leaf) * a.UBh
                    : ((int)blockIdx.x - ft * a.n_ublocks) * a.UB;
  // block position -> (leaf, unit)
  auto leaf_of = [&](int pp) { return hh ? 0 : ft * a.FT + pp % a.FT; };
  auto unit_of = [&](int pp) { return u0 + (hh ? pp : pp / a.FT); };
  const int p = t % P;
  const int lane = t / P;
  const int f = leaf_of(p), unit = unit_of(p);
  const bool live = lane < NL && f < a.F && unit < units;

  float acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = 0.f;
  if (live) {
    const RowUnit u(cb, lay, hh, unit);
    // row n of obs and of the latent tail, both indexed by design column:
    // the row's value and the block's columns each come from one of them
    const float* dp = a.d + (long)f * a.Do;
    const float* hp = a.hm + (long)u.k * a.L - a.Do;
    const int c0 = cb.col0(u.j), wd = cb.width(u.j);
    const int lo = u.i > c0 ? u.i - c0 : 0;
    const bool i_tail = u.i >= a.Do, j_tail = u.j >= cb.NBo;
    for (long n = n0 + lane; n < n1; n += NL) {
      const float* head = dp + n * a.d_row;
      const float* tail = hp + n * a.h_row;
      const float rv = __ldg(a.r + n * a.r_row + u.k);
      const float yv = hh ? 0.f : __ldg(a.y + n * a.y_row + f);
      const float ri =
          rv * (u.i < 0 ? yv : __ldg((i_tail ? tail : head) + u.i));
      const float* cols = (j_tail ? tail : head) + c0;
#pragma unroll
      for (int s = 0; s < kRowsBlock; ++s)
        if (s >= lo && s < wd) acc[s] += ri * __ldg(cols + s);
      acc[kRowsBlock] += hh ? rv : ri * yv;
    }
  }
  if (lane < NL)
#pragma unroll
    for (int s = 0; s < S; ++s) red[(s * NL + lane) * P + p] = acc[s];
  const long EO = (long)a.F * a.K * lay.UO;
  float* part = a.partial + (long)blockIdx.y * (EO + (long)a.K * lay.UH);
  reduce_lanes(P, NL, red, S, part, [&](int pp, int s) -> long {
    const int ff = leaf_of(pp), uu = unit_of(pp);
    if (ff >= a.F || uu >= units) return -1;
    const RowUnit v(cb, lay, hh, uu);
    const long leaf = ((long)ff * a.K + v.k) * lay.UO;
    const long lat = EO + (long)v.k * lay.UH;
    if (s == kRowsBlock) {
      if (hh) return v.w == 0 ? lat + lay.UH - 1 : -1;
      return v.i < 0 && v.j == 0 ? leaf + lay.UO - 1 : -1;
    }
    const int b = cb.col0(v.j) + s;
    if (s >= cb.width(v.j) || b < v.i) return -1;
    if (v.i < 0) return leaf + lay.UO - 1 - a.D + b;       // sxy[b]
    if (!hh) return leaf + v.i * a.D - v.i * (v.i - 1) / 2 + b - v.i;
    const int l = v.i - a.Do, m = b - a.Do;
    return lat + l * a.L - l * (l - 1) / 2 + m - l;
  });
}

// Stage 2 of the latent moments: entry e of [F*K*UO | K*UH] summed
// over the ranges as moments_reduce sums them; a latent-latent entry then
// adds rsum_k * S_k (sum, then add) and is written to every leaf.
__global__ void latent_reduce(const MomentArgs a) {
  __shared__ float s_lane[2][kRangeLanes][kRangeLanes + 1];
  const int D = a.D, Do = a.Do, L = a.L;
  const int UO = latent_leaf_entries(D, Do), UH = latent_hh_entries(L);
  const long EO = (long)a.F * a.K * UO;
  const long E = EO + (long)a.K * UH;
  const long e = (long)blockIdx.x * kRangeLanes + threadIdx.x;
  const bool leaf = e < EO;
  const long unit = leaf ? e / UO : (e - EO) / UH;       // (f, k) or k
  const int s = (int)(leaf ? e - unit * UO : e - EO - unit * UH);
  const bool fold = !leaf && e < E && s < UH - 1;
  float acc = 0.f, acc_r = 0.f;
  if (e < E)
    for (int q = threadIdx.y; q < a.R_full; q += kRangeLanes) {
      const float* part = a.partial + (long)q * E;
      acc += part[e];
      if (fold) acc_r += part[EO + unit * UH + UH - 1];
    }
  s_lane[0][threadIdx.y][threadIdx.x] = acc;
  s_lane[1][threadIdx.y][threadIdx.x] = acc_r;
  __syncthreads();
  for (int h = kRangeLanes / 2; h > 0; h /= 2) {
    if ((int)threadIdx.y < h)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        s_lane[v][threadIdx.y][threadIdx.x] +=
            s_lane[v][threadIdx.y + h][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y != 0 || e >= E) return;
  float tot = s_lane[0][0][threadIdx.x];
  const int tri_o = UO - D - 1;
  if (leaf) {
    if (s < tri_o) {                           // observed row i, column b
      int i = 0, u = s;
      while (u >= D - i) u -= D - i++;
      float* out = a.sxx + unit * D * D;
      out[i * D + i + u] = tot;
      out[(i + u) * D + i] = tot;
    } else if (s < tri_o + D) {
      a.sxy[unit * D + s - tri_o] = tot;
    } else {
      a.syy[unit] = tot;
    }
    return;
  }
  if (!fold) return;                           // rsum: not an output
  int l = 0, u = s;                            // latent row l, column l + u
  while (u >= L - l) u -= L - l++;
  const int m = l + u;
  tot += s_lane[1][0][threadIdx.x] * a.shh[(unit * L + l) * L + m];
  for (int f = 0; f < a.F; ++f) {
    float* out = a.sxx + ((long)f * a.K + unit) * D * D;
    out[(Do + l) * D + Do + m] = tot;
    out[(Do + m) * D + Do + l] = tot;
  }
}

// Entry e of part [R][E] summed over its R ranges in a fixed order (a
// kRangeLanes x kRangeLanes block): lane threadIdx.y sums ranges y, y + 32,
// ... in order, then a tree adds the lanes.  Valid in threadIdx.y == 0.
__device__ __forceinline__ float sum_ranges(
    const float* __restrict__ part, int R, long E, long e,
    float (*s_lane)[kRangeLanes + 1]) {
  constexpr int kLoads = 16;          // ranges a lane loads at once
  float acc = 0.f;
  if (e < E)
    for (int i0 = threadIdx.y; i0 < R; i0 += kLoads * kRangeLanes) {
      float v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int i = i0 + k * kRangeLanes;
        v[k] = i < R ? part[(long)i * E + e] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k)
        if (i0 + k * kRangeLanes < R) acc += v[k];
    }
  s_lane[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  for (int h = kRangeLanes / 2; h > 0; h /= 2) {
    if ((int)threadIdx.y < h)
      s_lane[threadIdx.y][threadIdx.x] += s_lane[threadIdx.y + h][threadIdx.x];
    __syncthreads();
  }
  return s_lane[0][threadIdx.x];
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
  const float tot =
      sum_ranges(a.partial + (long)c * a.R_max * E, R, E, e, s_lane);
  if (threadIdx.y != 0 || e >= E) return;
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
  const size_t smem = sizeof(float) * KG * entries_per_unit(D) * kThreads;
  moments_tile<D, KG><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// KG * U accumulators of a thread (disc_tile: KG * CB) stay within
// kMaxSlots registers (and their lanes within 48 KB of shared memory).
constexpr int kMaxSlots = 48;

template <int D>
int launch_tile_kg(const MomentArgs& a, int KG, dim3 grid, cudaStream_t s) {
  constexpr int U = entries_per_unit(D);
  if (KG == 1) return launch_tile<D, 1>(a, grid, s);
  if constexpr (2 * U <= kMaxSlots)
    if (KG == 2) return launch_tile<D, 2>(a, grid, s);
  if constexpr (4 * U <= kMaxSlots)
    if (KG == 4) return launch_tile<D, 4>(a, grid, s);
  return (int)cudaErrorInvalidValue;
}

// Stage 1 then stage 2 of n_chunks chunks under the plan in a:
// moments_tile (D <= 8) or moments_rows units.
int run_moments(MomentArgs& a, int KG, int n_chunks, cudaStream_t s) {
  a.W = a.D <= 8 ? (a.K + KG - 1) / KG
                 : a.K * a.D * ((a.D + kRowsBlock - 1) / kRowsBlock);
  a.n_ublocks = (a.W + a.UB - 1) / a.UB;
  a.R_max = max(a.R_full, a.R_last);
  if (a.FT * a.UB * a.NL > kThreads || n_chunks < 1 || a.D < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid(((a.F + a.FT - 1) / a.FT) * a.n_ublocks, a.R_max, n_chunks);
  int err;
  switch (a.D) {
    case 1: err = launch_tile_kg<1>(a, KG, grid, s); break;
    case 2: err = launch_tile_kg<2>(a, KG, grid, s); break;
    case 3: err = launch_tile_kg<3>(a, KG, grid, s); break;
    case 4: err = launch_tile_kg<4>(a, KG, grid, s); break;
    case 5: err = launch_tile_kg<5>(a, KG, grid, s); break;
    case 6: err = launch_tile_kg<6>(a, KG, grid, s); break;
    case 7: err = launch_tile_kg<7>(a, KG, grid, s); break;
    case 8: err = launch_tile_kg<8>(a, KG, grid, s); break;
    default:
      if (KG != 1) return (int)cudaErrorInvalidValue;
      moments_rows<<<grid, kThreads, sizeof(float) * kRowsSlots * kThreads,
                     s>>>(a);
      err = (int)cudaGetLastError();
  }
  if (err) return err;
  const long E = (long)a.F * a.K * entries_per_unit(a.D);
  dim3 g2((unsigned)((E + kRangeLanes - 1) / kRangeLanes), n_chunks);
  moments_reduce<<<g2, dim3(kRangeLanes, kRangeLanes), 0, s>>>(a);
  return (int)cudaGetLastError();
}

// latent_tile<D, DO> for the a.Do of the call (1 <= Do < D).
template <int D, int DO = 1>
int launch_latent_tile(const MomentArgs& a, dim3 grid, cudaStream_t s) {
  if (a.Do == DO) {
    constexpr int UO = latent_leaf_entries(D, DO);
    constexpr int UH = latent_hh_entries(D - DO);
    const size_t smem = sizeof(float) * (UO > UH ? UO : UH) * kThreads;
    latent_tile<D, DO><<<grid, kThreads, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  if constexpr (DO + 1 < D) return launch_latent_tile<D, DO + 1>(a, grid, s);
  return (int)cudaErrorInvalidValue;
}

// The latent moments: latent_tile (D <= 8) or latent_rows over the leaf
// and latent blocks, then latent_reduce.
int run_latent(MomentArgs& a, cudaStream_t s) {
  if (a.Do < 1 || a.L < 1) return (int)cudaErrorInvalidValue;
  const LatentLayout lay(a.Do, a.L);
  a.W = a.K * lay.Wo;
  a.Wh = a.K * lay.Wh;
  a.n_ublocks = (a.W + a.UB - 1) / a.UB;
  a.n_leaf = ((a.F + a.FT - 1) / a.FT) * a.n_ublocks;
  const int n_hh = (a.Wh + a.UBh - 1) / a.UBh;
  a.R_max = a.R_full;
  if (a.FT * a.UB * a.NL > kThreads || a.UBh * a.NLh > kThreads ||
      a.NL < 1 || a.NLh < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid(a.n_leaf + n_hh, a.R_full, 1);
  int err;
  switch (a.D) {
    case 2: err = launch_latent_tile<2>(a, grid, s); break;
    case 3: err = launch_latent_tile<3>(a, grid, s); break;
    case 4: err = launch_latent_tile<4>(a, grid, s); break;
    case 5: err = launch_latent_tile<5>(a, grid, s); break;
    case 6: err = launch_latent_tile<6>(a, grid, s); break;
    case 7: err = launch_latent_tile<7>(a, grid, s); break;
    case 8: err = launch_latent_tile<8>(a, grid, s); break;
    default:
      latent_rows<<<grid, kThreads,
                    sizeof(float) * (kRowsBlock + 1) * kThreads, s>>>(a);
      err = (int)cudaGetLastError();
  }
  if (err) return err;
  const long E = (long)a.F * a.K * lay.UO + (long)a.K * lay.UH;
  latent_reduce<<<(unsigned)((E + kRangeLanes - 1) / kRangeLanes),
                  dim3(kRangeLanes, kRangeLanes), 0, s>>>(a);
  return (int)cudaGetLastError();
}

// -- clg_disc_counts: bins in registers, read in place ------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kDiscInFlight = 4;    // instances a thread loads before adding

struct DiscArgs {
  const int* xd;         // [n, Fd] int32, read in place
  const float* r;        // [n, K]
  float* partial;        // [R, Fd*K*C]
  float* out;            // [Fd, K, C]
  long n, len;           // range q is [q*len, min(n, (q+1)*len))
  int Fd, K, C, R;
  int n_kg, n_cb, PU, NL;
};

// Stage 1.  A unit is a leaf f, KG components from k0 and CB bins from c0
// (CB a power of two): its KG*CB sums sit in registers, each indexed by a
// constant (an unrolled compare-select per bin, no dynamic register
// index).  A block is PU unit positions x NL = 256 / PU instance lanes:
// thread t takes position t % PU and lane t / PU, so a warp reads PU
// neighbouring leaves of 32 / PU neighbouring instances (one instance
// row's leaves, or neighbouring rows; the units of a row share its r
// through L1).  Lane l of range q takes instances l, l + NL, ... in order,
// loading kDiscInFlight of them before adding.  The lanes of a position
// add by a fixed shuffle tree within each warp, then in warp order
// through shared memory; partial[q] gets every entry of the block's units.
template <int KG, int CB>
__global__ void __launch_bounds__(kThreads, KG * CB <= 24 ? 4 : 1)
    disc_tile(const DiscArgs a) {
  constexpr int A = KG * CB;
  constexpr int UN = kDiscInFlight;
  extern __shared__ float red[];             // [A][kWarps][PU]
  const int PU = a.PU, NL = a.NL;
  const int t = threadIdx.x;
  const int p = t % PU;
  const int ln = t / PU;
  // unit u = (kg * n_cb + cb) * Fd + f: a block's positions are
  // neighbouring leaves of one component group and bin block
  const int U = a.Fd * a.n_kg * a.n_cb;
  const int u = blockIdx.x * PU + p;
  const int f = u % a.Fd, cb = u / a.Fd % a.n_cb, kg = u / (a.Fd * a.n_cb);
  const int k0 = kg * KG, c0 = cb * CB;
  const int nk = min(KG, a.K - k0);
  const unsigned nc = (unsigned)min(CB, a.C - c0);
  const long n0 = (long)blockIdx.y * a.len;
  const long n1 = min(a.n, n0 + a.len);

  float acc[A];
#pragma unroll
  for (int s = 0; s < A; ++s) acc[s] = 0.f;
  if (u < U) {
    const int* xp = a.xd + f;
    const float* rp = a.r + k0;
#pragma unroll 1
    for (long n = n0 + ln; n < n1; n += UN * NL) {
      int bin[UN];                            // x - c0, or -1: no bin here
      float rv[UN][KG];
      bool in[UN];
#pragma unroll
      for (int q = 0; q < UN; ++q) {
        const long nn = n + q * NL;
        in[q] = q == 0 || nn < n1;
        const long m = in[q] ? nn : n;        // past the range: read n,
        // add nothing; unsigned: -1, x >= C and x < c0 fall outside nc
        const unsigned d = (unsigned)__ldg(xp + m * a.Fd) - (unsigned)c0;
        bin[q] = d < nc ? (int)d : -1;
#pragma unroll
        for (int j = 0; j < KG; ++j)
          rv[q][j] = j < nk ? __ldg(rp + m * a.K + j) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < UN; ++q) {
        if (!in[q]) break;
#pragma unroll
        for (int b = 0; b < CB; ++b)
          if (bin[q] == b)
#pragma unroll
            for (int j = 0; j < KG; ++j) acc[j * CB + b] += rv[q][j];
      }
    }
  }
  // lanes t, t + PU, ... of a warp hold one position: a fixed tree
  const int lane = t & 31, w = t >> 5;
#pragma unroll
  for (int s = 0; s < A; ++s) {
    float v = acc[s];
    for (int off = 16; off >= PU; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane < PU) red[(s * kWarps + w) * PU + lane] = v;
  }
  __syncthreads();
  // red[s][w][pp]: position pp's sum over warp w's lanes of it (for PU =
  // 32, warp w holds lane w of every position); added in warp order
  float* part = a.partial + (long)blockIdx.y * a.Fd * a.K * a.C;
  for (int e = t; e < A * PU; e += kThreads) {
    const int pp = e % PU, s = e / PU;
    const int uu = blockIdx.x * PU + pp;
    const int ff = uu % a.Fd, k = uu / (a.Fd * a.n_cb) * KG + s / CB,
              c = uu / a.Fd % a.n_cb * CB + s % CB;
    if (uu >= U || k >= a.K || c >= a.C) continue;
    float tot = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) tot += red[(s * kWarps + v) * PU + pp];
    part[((long)ff * a.K + k) * a.C + c] = tot;
  }
}

// Stage 2: entry e of out summed over the R ranges (sum_ranges).
__global__ void disc_reduce(const DiscArgs a) {
  __shared__ float s_lane[kRangeLanes][kRangeLanes + 1];
  const long E = (long)a.Fd * a.K * a.C;
  const long e = (long)blockIdx.x * kRangeLanes + threadIdx.x;
  const float tot = sum_ranges(a.partial, a.R, E, e, s_lane);
  if (threadIdx.y == 0 && e < E) a.out[e] = tot;
}

template <int KG, int CB>
int launch_disc(const DiscArgs& a, dim3 grid, cudaStream_t s) {
  if constexpr (KG * CB <= kMaxSlots) {
    const size_t smem = sizeof(float) * KG * CB * kWarps * a.PU;
    disc_tile<KG, CB><<<grid, kThreads, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

template <int CB>
int launch_disc_kg(const DiscArgs& a, int KG, dim3 grid, cudaStream_t s) {
  switch (KG) {
    case 1: return launch_disc<1, CB>(a, grid, s);
    case 2: return launch_disc<2, CB>(a, grid, s);
    case 3: return launch_disc<3, CB>(a, grid, s);
    case 4: return launch_disc<4, CB>(a, grid, s);
    default: return (int)cudaErrorInvalidValue;
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
  MomentArgs a{};
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
  a.R_full = R_full;
  a.len_full = len_full;
  a.R_last = R_last;
  a.len_last = len_last;
  a.vec = vec;
  a.rvec = rvec;
  return run_moments(a, KG, n_chunks, static_cast<cudaStream_t>(stream));
}

// The latent moments' layout for Do observed and L latent columns (the
// wrapper's mirror is checked against it): out = {UO, UH, Wo, Wh}.
int clg_latent_units(int Do, int L, int* out) {
  const LatentLayout lay(Do, L);
  out[0] = lay.UO;
  out[1] = lay.UH;
  out[2] = lay.Wo;
  out[3] = lay.Wh;
  return 0;
}

// clg_suffstats_latent over n instances of obs [n, F, Do], hm [n, K, L],
// y [n, F], r [n, K] (contiguous, read in place), shh [K, L, L]; sxx/sxy/syy
// are [F, K, D, D] / [F, K, D] / [F, K] with D = Do + L; the n instances are
// R ranges of len.  Leaf blocks of FT leaves x UB of the K*Wo leaf units x
// NL lanes, then latent blocks of UBh of the K*Wh latent units x NLh lanes
// (LatentLayout); partial holds R * (F*K*UO + K*UH) floats; vec is the
// float width of the h_mean loads (D <= 8).
int clg_latent_launch(const void* obs, const void* hm, const void* y,
                      const void* r, const void* shh, void* partial,
                      void* sxx, void* sxy, void* syy, long n, int F, int Do,
                      int K, int L, int FT, int UB, int NL, int UBh, int NLh,
                      int R, int len, int vec, void* stream) {
  if (Do < 1 || L < 1) return (int)cudaErrorInvalidValue;
  MomentArgs a{};
  a.d = static_cast<const float*>(obs);
  a.hm = static_cast<const float*>(hm);
  a.shh = static_cast<const float*>(shh);
  a.y = static_cast<const float*>(y);
  a.r = static_cast<const float*>(r);
  a.partial = static_cast<float*>(partial);
  a.sxx = static_cast<float*>(sxx);
  a.sxy = static_cast<float*>(sxy);
  a.syy = static_cast<float*>(syy);
  a.d_row = (long)F * Do;
  a.h_row = (long)K * L;
  a.y_row = F;
  a.r_row = K;
  a.chunk_len = n;
  a.n_total = n;
  a.F = F;
  a.K = K;
  a.D = Do + L;
  a.Do = Do;
  a.L = L;
  a.FT = FT;
  a.UB = UB;
  a.NL = NL;
  a.UBh = UBh;
  a.NLh = NLh;
  a.R_full = a.R_last = R;
  a.len_full = a.len_last = len;
  a.vec = vec;
  a.rvec = 1;
  return run_latent(a, static_cast<cudaStream_t>(stream));
}

// One-hot counts of xd [n, Fd] (int32, read in place) weighted by r [n, K]:
// out [Fd, K, C], under disc_plan of clg_stats.py: units of a leaf x KG
// components x CB bins, PU unit positions x NL instance lanes a block, R
// ranges of len instances; partial holds R * Fd*K*C floats.
int clg_disc_counts_launch(const void* xd, const void* r, void* partial,
                           void* out, long n, int Fd, int K, int C, int KG,
                           int CB, int PU, int R, long len, void* stream) {
  DiscArgs a{};
  a.xd = static_cast<const int*>(xd);
  a.r = static_cast<const float*>(r);
  a.partial = static_cast<float*>(partial);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.len = len;
  a.Fd = Fd;
  a.K = K;
  a.C = C;
  a.R = R;
  a.n_kg = (K + KG - 1) / KG;
  a.n_cb = (C + CB - 1) / CB;
  a.PU = PU;
  a.NL = kThreads / PU;
  if (n < 1 || Fd < 1 || K < 1 || C < 1 || R < 1 || PU < 1 || PU > 32 ||
      (PU & (PU - 1)) || (long)(R - 1) * len >= n || (long)R * len < n)
    return (int)cudaErrorInvalidValue;
  const long U = (long)Fd * a.n_kg * a.n_cb;
  dim3 grid((unsigned)((U + PU - 1) / PU), R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (CB) {
    case 2: err = launch_disc_kg<2>(a, KG, grid, s); break;
    case 4: err = launch_disc_kg<4>(a, KG, grid, s); break;
    case 8: err = launch_disc_kg<8>(a, KG, grid, s); break;
    case 16: err = launch_disc_kg<16>(a, KG, grid, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  const long E = (long)Fd * K * C;
  disc_reduce<<<(unsigned)((E + kRangeLanes - 1) / kRangeLanes),
                dim3(kRangeLanes, kRangeLanes), 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
