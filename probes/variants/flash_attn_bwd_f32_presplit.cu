// A variant of the fp32 attention backward of
// src/repro_torch/kernels/csrc/flash_attn_bwd.cu, kept for
// probes/flash_bwd_f32_presplit.py: the design that splits each operand
// once as it lands in shared memory.  Tiles of 64 q rows by 64 keys stream
// in d-chunks of 32 columns of two tensors through a ring of four stages
// (cp.async, each thread splitting the pieces it copied into hi and lo
// slabs, row strides 40 and 36), S then dP a warp, P and dS split into
// fragment order, dK/dV blocks split over (q head, q tile) steps as in the
// repository's kernels.  Same C interface as flash_attn_bwd.cu (its fp32
// route only).  Built by the probe with nvcc and -I the csrc directory.

#include <math.h>

#include <cuda_runtime.h>
#include <stdint.h>
#include "tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNoRow = 1e30f;   // L of a row past Sq or with no live key


struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;               // [B, Hq, Sq]
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, Hq, Hkv, D;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
  long long o_b, o_s, o_h, do_b, do_s, do_h;
  float scale;
  int causal, window;             // window <= 0: none
  int qoff;                       // q row i sits at position qoff + i
  int vec;                        // fp32: every row of q, k, v, dout 16-byte aligned
};

// The kv tiles [begin, end) (of BK keys) q tile qt (of BQ rows, row i at
// position qoff + i) reads: not wholly above the diagonal of its last row
// (rows past Sq do not count) nor wholly below the window of its first.
__host__ __device__ inline void dq_kv_range(int qt, int BQ, int BK, int Sq,
                                            int Sk, int causal, int window,
                                            int qoff, int* begin, int* end) {
  const int q0 = qoff + qt * BQ;
  const int q_last = qoff + (qt * BQ + BQ < Sq ? qt * BQ + BQ : Sq) - 1;
  int e = (Sk + BK - 1) / BK;
  if (causal && q_last / BK + 1 < e) e = q_last / BK + 1;
  int bg = 0;
  if (window > 0) {
    const int lo = q0 - window - BK + 2;    // k0 + BK - 1 > q0 - window
    if (lo > 0) bg = (lo + BK - 1) / BK;
  }
  *begin = bg;
  *end = e > bg ? e : bg;
}

// The q tiles [begin, end) (of BQ rows, row i at position qoff + i) that
// read kv tile kt (of BK keys; keys past Sk do not count).
__host__ __device__ inline void q_range(int kt, int BQ, int BK, int Sq,
                                        int Sk, int causal, int window,
                                        int qoff, int* begin, int* end) {
  const int k0 = kt * BK;
  const int k_last = (k0 + BK < Sk ? k0 + BK : Sk) - 1;
  int e = (Sq + BQ - 1) / BQ;
  if (window > 0) {                   // qoff + q0 < k_last + window
    const int last = k_last + window - 1 - qoff;   // the last row reading it
    const int hi = last < 0 ? 0 : last / BQ + 1;
    if (hi < e) e = hi;
  }
  // qoff + q0 + BQ - 1 >= k0
  const int bg = causal && k0 > qoff ? (k0 - qoff) / BQ : 0;
  *begin = bg;
  *end = e > bg ? e : bg;
}

__device__ __forceinline__ bool live_pair(int qpos, int kpos, int causal,
                                          int window) {
  return (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

constexpr int kPadRows = 128;     // L and delta rows padded to a multiple

int pad_rows(int Sq) { return (Sq + kPadRows - 1) / kPadRows * kPadRows; }

// ---------------------------------------------------------------------------
// fp32: split TF32 on mma.sync m16n8k8, d-chunks through a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kF32MaxD = 256;
constexpr int kT = 64;             // q rows of a q tile; keys of a kv tile
constexpr int kDC = 32;            // columns of a d-chunk
constexpr int kLdP = 40;           // row stride of a product chunk (== 8 mod 32)
constexpr int kLdA = 36;           // of an accumulate chunk (== 4 mod 32)
constexpr int kSlab = kT * kLdP;   // one tensor's chunk, hi or lo (floats)
constexpr int kStage = 4 * kSlab;  // a ring stage: two tensors, hi and lo
constexpr int kStages = 4;         // the ring: three chunks in flight
constexpr int kFrag = kT * kT;     // a 64 x 64 operand in fragment order
constexpr int kMaxWaves = 4;       // dK/dV blocks after the split, in waves

// The slot of accumulator element e (rows g, g + 8; columns 2q, 2q + 1) in
// an A fragment (rows g, g + 8 at k = q, then at k = q + 4): 0, 2, 1, 3.
__device__ __forceinline__ constexpr int slot_of(int e) {
  return e == 1 ? 2 : e == 2 ? 1 : e;
}

// Shared memory of a block: the ring; the rows' L and delta (dQ: its one
// q tile; dK/dV: two slots, a step's in slot step % 2); dQ's dS (hi, lo),
// dK/dV's P^T and dS^T (hi, lo), in fragment order.
constexpr size_t dq_f32_smem() {
  return 4 * ((size_t)kStages * kStage + 2 * kT + 2 * kFrag);
}
constexpr size_t dkdv_f32_smem() {
  return 4 * ((size_t)kStages * kStage + 4 * kT + 4 * kFrag);
}

// The dK/dV blocks of a kv head's kv tile take its (q head, q tile) steps
// (G heads in order g = 0 .. G - 1, each its q tiles in order) in `splits`
// contiguous ranges, split s holding steps [s n / splits, (s + 1) n /
// splits).  One range each when the (kv tile, kv head, batch) grid fills
// two waves of `sms` SMs (one block an SM); else as many ranges as bring
// the longest block's steps down to the mean steps an SM, at most
// kMaxWaves waves of blocks and at most one step a range.
int dkdv_splits(int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                int window, int qoff, int sms) {
  const int nkt = (Sk + kT - 1) / kT;
  const long long blocks = (long long)B * Hkv * nkt;
  if (blocks >= 2LL * sms) return 1;
  const int G = Hq / Hkv;
  long long total = 0, longest = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    int b0, e0;
    q_range(kt, kT, kT, Sq, Sk, causal, window, qoff, &b0, &e0);
    const long long n = (long long)G * (e0 - b0);
    total += n;
    if (n > longest) longest = n;
  }
  total *= (long long)B * Hkv;
  if (total == 0) return 1;
  long long s = (longest * sms + total - 1) / total;
  const long long cap = kMaxWaves * (long long)sms / blocks;
  if (s > cap) s = cap;
  if (s > longest) s = longest;
  return s < 1 ? 1 : (int)s;
}

// A tensor's tile for a chunk copy: row r at p + r s (the chunk's first
// column included), rows r < n real (zeros past them)
struct Rows {
  const float* p;
  long long s;
  int n;
};

// The chunk of NT tensors (stage slots 0 .. NT - 1; kDC columns, cols of
// them real, zeros past) lands raw in each slot's lo slab, row stride ld.
// Thread tid copies the 16-byte pieces tid + 256 i (slot i / 2, row tid / 8
// + 32 (i % 2), piece tid % 8): one cp.async each (vec: 16-byte aligned
// rows) or four of 4 bytes, so that it splits exactly what it copied.
template <int NT>
__device__ __forceinline__ void copy_chunk(float* stage, const Rows* src,
                                           int ld, int cols, bool vec) {
  const int tid = threadIdx.x, c = (tid & 7) * 4;
#pragma unroll
  for (int i = 0; i < 2 * NT; ++i) {
    const Rows& t = src[i >> 1];
    const int r = (tid >> 3) + 32 * (i & 1);
    float* dst = stage + (2 * (i >> 1) + 1) * kSlab + r * ld + c;
    const bool ok = r < t.n && c < cols;
    const float* g = ok ? t.p + r * t.s + c : t.p;
    if (vec) {
      cp_async16(dst, g, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        cp_async4(dst + k, ok ? g + k : g, ok ? 4 : 0);
    }
  }
}

// What this thread copied of the chunk, split in place: hi = the value cut
// to TF32 into the slot's hi slab, lo = the rest into its lo slab.
template <int NT>
__device__ __forceinline__ void split_chunk(float* stage, int ld) {
  const int tid = threadIdx.x, c = (tid & 7) * 4;
#pragma unroll
  for (int i = 0; i < 2 * NT; ++i) {
    const int r = (tid >> 3) + 32 * (i & 1);
    float* lo = stage + (2 * (i >> 1) + 1) * kSlab + r * ld + c;
    const float4 v = *reinterpret_cast<const float4*>(lo);
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(lo - kSlab) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// 64 rows of L, then of delta, from row `row` of the prep kernel's [B, Hq,
// Sp] arrays into dst (threads 0 .. 31, one 16-byte piece each)
__device__ __forceinline__ void copy_rows(float* dst, const float* Lp,
                                          const float* Dp, long long row) {
  const int tid = threadIdx.x;
  if (tid < 32)
    cp_async16(dst + 4 * tid, (tid < 16 ? Lp : Dp - 64) + row + 4 * tid, 16);
}

__device__ __forceinline__ void frag4(const float* p, uint32_t (&a)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&x)[M][N][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[m][n][e] = 0.f;
}

// acc[nt] += X Y^T over the chunk's first kst k8 steps, X the 16 rows at
// x, Y the rows 8 nt .. of y (slabs: hi, then lo kSlab later; row stride
// kLdP).  In a k8 step thread q holds columns 2q and 2q + 1 as k = q and
// q + 4 of both operands (a0, a2 and b0, b1 are one 8-byte load each), so
// the sum over the step is the same.  The chunk sums into a fresh
// accumulator, added to acc in fp32: the tensor cores truncate as they
// accumulate, so their chains stay at 3 kst products.  Each k8 step takes
// the lo hi products of the four n8 tiles, then hi lo, then hi hi.
__device__ __forceinline__ void product_chunk(float (&acc)[1][4][4],
                                              const float* x, const float* y,
                                              int kst) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float part[1][4][4];
  zero(part);
#pragma unroll
  for (int ks = 0; ks < kDC / 8; ++ks) {
    if (ks >= kst) break;
    const float* r = x + g * kLdP + 8 * ks + 2 * q;
    const uint2 h0 = *reinterpret_cast<const uint2*>(r);
    const uint2 h1 = *reinterpret_cast<const uint2*>(r + 8 * kLdP);
    const uint2 l0 = *reinterpret_cast<const uint2*>(r + kSlab);
    const uint2 l1 = *reinterpret_cast<const uint2*>(r + kSlab + 8 * kLdP);
    const uint32_t ah[4] = {h0.x, h1.x, h0.y, h1.y};
    const uint32_t al[4] = {l0.x, l1.x, l0.y, l1.y};
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* c = y + (8 * nt + g) * kLdP + 8 * ks + 2 * q;
      const uint2 h = *reinterpret_cast<const uint2*>(c);
      const uint2 l = *reinterpret_cast<const uint2*>(c + kSlab);
      bh[nt][0] = h.x;
      bh[nt][1] = h.y;
      bl[nt][0] = l.x;
      bl[nt][1] = l.y;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_tf32(part[0][nt], al, bh[nt]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_tf32(part[0][nt], ah, bl[nt]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_tf32(part[0][nt], ah, bh[nt]);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][nt][e] += part[0][nt][e];
}

// acc[mt][tt] += A Y over k = 0 .. 63: A the rows 16 (mb + mt) .. of a
// 64 x 64 operand in fragment order (fh hi, fl lo), Y the chunk slab y
// (hi, then lo kSlab later; row stride kLdA) from this warp's first column.
// A's fragments are the product accumulators, so that k step ks holds rows
// 8 ks + 2q, 8 ks + 2q + 1 of Y as k = q, q + 4; the two n8 tiles tt take
// the columns 2g + tt (b0 and b1 of both tiles: two 8-byte loads).  A
// step's sums go to a fresh accumulator, added to acc in fp32.
template <int MT>
__device__ __forceinline__ void accum_chunk(float (&acc)[MT][2][4],
                                            const float* fh, const float* fl,
                                            int mb, const float* y) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float part[MT][2][4];
  zero(part);
#pragma unroll
  for (int ks = 0; ks < kT / 8; ++ks) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int f = (((mb + mt) * (kT / 8) + ks) * 32 + lane) * 4;
      frag4(fh + f, ah[mt]);
      frag4(fl + f, al[mt]);
    }
    const float* r = y + (8 * ks + 2 * q) * kLdA + 2 * g;
    const uint2 h0 = *reinterpret_cast<const uint2*>(r);
    const uint2 h1 = *reinterpret_cast<const uint2*>(r + kLdA);
    const uint2 l0 = *reinterpret_cast<const uint2*>(r + kSlab);
    const uint2 l1 = *reinterpret_cast<const uint2*>(r + kSlab + kLdA);
    const uint32_t bh[2][2] = {{h0.x, h1.x}, {h0.y, h1.y}};
    const uint32_t bl[2][2] = {{l0.x, l1.x}, {l0.y, l1.y}};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) mma_tf32(part[mt][tt], al[mt], bh[tt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) mma_tf32(part[mt][tt], ah[mt], bl[tt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) mma_tf32(part[mt][tt], ah[mt], bh[tt]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int tt = 0; tt < 2; ++tt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][tt][e] += part[mt][tt][e];
}

// v split and stored as one A fragment: hi at fh + f, lo at fl + f
__device__ __forceinline__ void store_frag(float* fh, float* fl, int f,
                                           const float (&v)[4]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], h[e], l[e]);
  *reinterpret_cast<uint4*>(fh + f) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(fl + f) = make_uint4(l[0], l[1], l[2], l[3]);
}

// L = lse log2(e) (kNoRow past Sq or for a row with no live key) and delta
// = rowsum(dO o O), each [B, Hq, Sp] fp32: one warp a row, a fixed shuffle
// tree
__global__ void __launch_bounds__(kThreads)
    flash_bwd_prep_f32_kernel(const BwdArgs a, float* Lp, float* Dp,
                              int Sp) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.Hq * Sp) return;
  const int i = (int)(row % Sp);
  const long long bh = row / Sp;
  const int h = (int)(bh % a.Hq), b = (int)(bh / a.Hq);
  float s = 0.f, L = kNoRow;
  if (i < a.Sq) {
    const float* o =
        static_cast<const float*>(a.o) + b * a.o_b + i * a.o_s + h * a.o_h;
    const float* g = static_cast<const float*>(a.dout) + b * a.do_b +
                     i * a.do_s + h * a.do_h;
    for (int d = lane; d < a.D; d += 32) s = fmaf(g[d], o[d], s);
    const float lse = a.lse[bh * a.Sq + i];
    L = lse > -1e29f ? lse * kLog2e : kNoRow;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    Lp[row] = L;
    Dp[row] = s;
  }
}

// One block of the dQ (KV = false) or dK/dV (KV = true) kernel: 8 warps,
// steps over kv tiles (dQ: its q tile against each) or (q head, q tile)
// pairs (dK/dV: its kv tile against each).  A step is n1 = ceil(D / 32)
// S chunks, n1 dP chunks, then n1 accumulate chunks, each a d-chunk of 32
// columns of two tensors (dQ's accumulate chunks: one) through a ring of
// kStages stages: chunk t + 3 is copied (cp.async) while chunk t is
// computed, then split in place by the threads that copied it.
//   S chunks hold X1, Y1, dP chunks X2, Y2 (dQ: X = Q, dO, Y = K, V;
//   dK/dV: X = K, V, Y = Q, dO), row stride kLdP.  Warp w sums S = X1
//   Y1^T, then dP = X2 Y2^T, over rows 16 (w / 2), columns 32 (w % 2) of
//   the 64 x 64 step (dQ's S has q rows and key columns, dK/dV's S^T the
//   reverse), forms P = exp2(S scale log2(e) - L) (masked) and dS = P o
//   (dP - delta), and stores them split in fragment order.
//   Accumulate chunks hold Y1 (and Y2), row stride kLdA.  dQ: warp w adds
//   dS Y1 for rows 16 (w / 2), columns 16 (w % 2) of the chunk; dK/dV:
//   warps 0-3 dK += dS^T Q, warps 4-7 dV += P^T dO, rows 32 ((w / 2) % 2),
//   columns 16 (w % 2).  Accumulators stay in registers over all steps.
template <int DMAX, bool KV>
__device__ __forceinline__ void f32_block(const BwdArgs& a, const float* Lp,
                                          const float* Dp, int Sp, float* pdk,
                                          float* pdv, int splits) {
  constexpr int NC = DMAX / kDC;          // accumulate chunks at most
  constexpr int NA = KV ? 2 : 1;          // tensors of an accumulate chunk
  constexpr int MT = KV ? 2 : 1;          // accumulate row bands a warp
  extern __shared__ __align__(16) float sm[];
  float* ring = sm;
  float* rows = ring + kStages * kStage;  // L then delta: dQ one, dK/dV two
  float* fPh = rows + (KV ? 4 : 2) * kT;  // P hi (dK/dV)
  float* fPl = fPh + kFrag;
  float* fSh = KV ? fPl + kFrag : fPh;    // dS hi
  float* fSl = fSh + kFrag;

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int D = a.D, n1 = (D + kDC - 1) / kDC;
  const float* Q = static_cast<const float*>(a.q);
  const float* K = static_cast<const float*>(a.k);
  const float* V = static_cast<const float*>(a.v);
  const float* dO = static_cast<const float*>(a.dout);

  // the block: dQ (q head h, q tile q0) over kv tiles j0 + j; dK/dV (kv
  // head hk, kv tile k0, split s) over steps j0 + j
  int h = 0, hk, b, q0 = 0, k0 = 0, j0 = 0, n_steps, nq = 1, qt_begin = 0;
  const int G = a.Hq / a.Hkv;
  if (KV) {
    const int pairs = a.Hkv * a.B, pair = blockIdx.x % pairs;
    const int s = blockIdx.x / pairs;
    hk = pair % a.Hkv;
    b = pair / a.Hkv;
    k0 = blockIdx.y * kT;
    int e;
    q_range(blockIdx.y, kT, kT, a.Sq, a.Sk, a.causal, a.window, a.qoff,
            &qt_begin, &e);
    nq = e - qt_begin;
    const int n = G * nq;
    j0 = (int)((long long)s * n / splits);
    n_steps = (int)((long long)(s + 1) * n / splits) - j0;
  } else {
    h = blockIdx.x % a.Hq;
    b = blockIdx.x / a.Hq;
    hk = h % a.Hkv;
    const int nqt = (a.Sq + kT - 1) / kT;
    const int qt = a.causal ? nqt - 1 - (int)blockIdx.y : (int)blockIdx.y;
    q0 = qt * kT;
    dq_kv_range(qt, kT, kT, a.Sq, a.Sk, a.causal, a.window, a.qoff, &j0,
                &n_steps);
    n_steps -= j0;
  }
  const bool vec = a.vec != 0;
  const float* kbase = K + b * a.k_b + hk * a.k_h;
  const float* vbase = V + b * a.v_b + hk * a.v_h;

  // the chunks, in order, into ring stage t % kStages (every thread its
  // pieces): step ij's chunk ic, the step's tiles set up at its chunk 0
  int it = 0, ij = 0, ic = 0, ir = 0, kr = 0;
  const float *pq = Q, *pg = dO, *pk = kbase, *pv = vbase;
  long long lrow = 0;
  auto issue = [&]() {
    if (ic == 0) {
      int hh = h, qq0 = q0, kk0 = k0;
      if (KV) {
        const int js = j0 + ij, gi = js / nq;
        hh = gi * a.Hkv + hk;
        qq0 = (qt_begin + js - gi * nq) * kT;
      } else {
        kk0 = (j0 + ij) * kT;
      }
      pq = Q + b * a.q_b + hh * a.q_h + qq0 * a.q_s;
      pg = dO + b * a.do_b + hh * a.do_h + qq0 * a.do_s;
      pk = kbase + kk0 * a.k_s;
      pv = vbase + kk0 * a.v_s;
      ir = a.Sq - qq0;
      kr = a.Sk - kk0;
      lrow = ((long long)b * a.Hq + hh) * Sp + qq0;
    }
    const int part = ic / n1, c0 = (ic - part * n1) * kDC;
    const int cols = min(kDC, D - c0);
    const Rows rq{pq + c0, a.q_s, ir}, rg{pg + c0, a.do_s, ir};
    const Rows rk{pk + c0, a.k_s, kr}, rv{pv + c0, a.v_s, kr};
    float* st = ring + (it % kStages) * kStage;
    if (part < 2) {                      // S (X1, Y1) or dP (X2, Y2)
      const Rows src[2] = {part ? (KV ? rv : rg) : (KV ? rk : rq),
                           part ? (KV ? rg : rv) : (KV ? rq : rk)};
      copy_chunk<2>(st, src, kLdP, cols, vec);
      if (KV && ic == 0) copy_rows(rows + (ij & 1) * 2 * kT, Lp, Dp, lrow);
      if (!KV && it == 0) copy_rows(rows, Lp, Dp, lrow);
    } else {                             // accumulate: Y1 (and Y2)
      const Rows src[2] = {KV ? rq : rk, rg};
      copy_chunk<NA>(st, src, kLdA, cols, vec);
    }
    ++it;
    if (++ic == 3 * n1) {
      ic = 0;
      ++ij;
    }
  };
  // chunk t has landed: split what this thread copied and publish it
  const int T = n_steps * 3 * n1;
  auto land = [&](int t, int nt, int ld) {
    cp_async_wait<kStages - 2>();
    float* st = ring + (t % kStages) * kStage;
    if (nt == 2) split_chunk<2>(st, ld);
    else split_chunk<1>(st, ld);
    __syncthreads();
  };
  // after chunk t's products: chunk t + kStages - 1 into the stage that
  // chunk t - 1 held (every thread has left it: land(t)'s barrier)
  auto refill = [&]() {
    if (it < T) issue();
    cp_async_commit();
  };

  float acc3[NC][MT][2][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) zero(acc3[c]);

  const int rb = w >> 1, ch = w & 1;      // products: rows 16 rb, cols 32 ch
  const float sl2 = a.scale * kLog2e;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) refill();
  int t = 0;
  for (int j = 0; j < n_steps; ++j) {
    int sq0 = q0, sk0 = k0;            // this step's q tile and kv tile
    if (KV) {
      const int js = j0 + j, gi = js / nq;
      sq0 = (qt_begin + js - gi * nq) * kT;
    } else {
      sk0 = (j0 + j) * kT;
    }
    float S[1][4][4], dP[1][4][4];
    zero(S);
    zero(dP);
    for (int c = 0; c < 2 * n1; ++c, ++t) {
      land(t, 2, kLdP);
      const float* st = ring + (t % kStages) * kStage;
      const int cc = c < n1 ? c : c - n1;
      const int kst = min(kDC, D - cc * kDC) / 8;
      if (c < n1)
        product_chunk(S, st + 16 * rb * kLdP, st + 2 * kSlab + 32 * ch * kLdP,
                      kst);
      else
        product_chunk(dP, st + 16 * rb * kLdP,
                      st + 2 * kSlab + 32 * ch * kLdP, kst);
      refill();
    }

    // P and dS into fragment order: element (nt, e) of the warp's tile is
    // row 16 rb + g + 8 (e / 2), column 32 ch + 8 nt + 2q + e % 2; its
    // fragment (band rb, k step 4 ch + nt) holds elements 0, 2, 1, 3
    const float* Ls = rows + (KV ? (j & 1) * 2 * kT : 0);
    const float* Ds = Ls + kT;
    const int p0 = a.qoff + sq0;     // the position of the step's q row 0
    const bool edge = sk0 + kT > a.Sk || (a.causal && sk0 + kT - 1 > p0) ||
                      (a.window > 0 && sk0 <= p0 + kT - 1 - a.window);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int f = ((rb * (kT / 8) + 4 * ch + nt) * 32 + lane) * 4;
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * rb + g + 8 * (e >> 1);
        const int cl = 32 * ch + 8 * nt + 2 * q + (e & 1);
        const int qi = KV ? cl : r, kj = KV ? r : cl;   // q row, key
        float pe = exp2f(fmaf(S[0][nt][e], sl2, -Ls[qi]));
        if (edge && (sk0 + kj >= a.Sk ||
                     !live_pair(p0 + qi, sk0 + kj, a.causal, a.window)))
          pe = 0.f;
        p[slot_of(e)] = pe;
        ds[slot_of(e)] = pe * (dP[0][nt][e] - Ds[qi]);
      }
      if (KV) store_frag(fPh, fPl, f, p);
      store_frag(fSh, fSl, f, ds);
    }
    __syncthreads();

    // accumulate chunks: dQ += dS K; dK += dS^T Q, dV += P^T dO
    const int which = w >> 2, rh = (w >> 1) & 1;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < n1) {
        land(t, NA, kLdA);
        const float* st = ring + (t % kStages) * kStage;
        if (c * kDC + 16 * ch < D) {
          if (KV)
            accum_chunk<MT>(acc3[c], which ? fPh : fSh, which ? fPl : fSl,
                            2 * rh, st + 2 * which * kSlab + 16 * ch);
          else
            accum_chunk<MT>(acc3[c], fSh, fSl, rb, st + 16 * ch);
        }
        refill();
        ++t;
      }
    }
  }

  // rows 16 (mb + mt) + g + 8 hf of the block's tile, columns 32 c + 16 ch
  // + 4q .. + 3 (tiles 0, 1 alternate)
  const int which = w >> 2;
  const int mb = KV ? 2 * ((w >> 1) & 1) : rb;
  const int S_out = KV ? a.Sk : a.Sq, r_base = KV ? k0 : q0;
  const int H_out = KV ? a.Hkv : a.Hq, hh = KV ? hk : h;
  float* out;
  float mul = KV && which == 1 ? 1.f : a.scale;
  if (KV && splits > 1) {
    out = (which ? pdv : pdk) +
          (long long)(blockIdx.x / (a.Hkv * a.B)) * a.B * a.Sk * a.Hkv * D;
    mul = 1.f;
  } else {
    out = static_cast<float*>(KV ? (which ? a.dv : a.dk) : a.dq);
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = c * kDC + 16 * ch + 4 * q;
    if (c >= n1 || c * kDC + 16 * ch >= D) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r_base + 16 * (mb + mt) + g + 8 * hf;
        if (r >= S_out) continue;
        *reinterpret_cast<float4*>(
            out + (((long long)b * S_out + r) * H_out + hh) * D + col) =
            make_float4(acc3[c][mt][0][2 * hf] * mul,
                        acc3[c][mt][1][2 * hf] * mul,
                        acc3[c][mt][0][2 * hf + 1] * mul,
                        acc3[c][mt][1][2 * hf + 1] * mul);
      }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_f32_kernel(const BwdArgs a, const float* Lp,
                            const float* Dp, int Sp) {
  f32_block<DMAX, false>(a, Lp, Dp, Sp, nullptr, nullptr, 1);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_f32_kernel(const BwdArgs a, const float* Lp,
                              const float* Dp, int Sp, float* pdk,
                              float* pdv, int splits) {
  f32_block<DMAX, true>(a, Lp, Dp, Sp, pdk, pdv, splits);
}

// dK = scale sum_s pdk[s], dV = sum_s pdv[s] in split order, float4s
__global__ void __launch_bounds__(kThreads)
    flash_bwd_finish_f32_kernel(const float4* pdk, const float4* pdv,
                                float4* dk, float4* dv, long long n4,
                                int splits, float scale) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  float4 sk = pdk[i], sv = pdv[i];
  for (int s = 1; s < splits; ++s) {
    const float4 x = pdk[s * n4 + i], y = pdv[s * n4 + i];
    sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
    sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
  }
  dk[i] = make_float4(sk.x * scale, sk.y * scale, sk.z * scale, sk.w * scale);
  dv[i] = sv;
}

// Floats of the fp32 scratch: L and delta [B, Hq, pad_rows(Sq)] each, then
// with splits > 1 the partial dK and dV [splits, B, Sk, Hkv, D] each.
long long f32_scratch(int B, int Sq, int Sk, int Hq, int Hkv, int D,
                      int splits) {
  return 2LL * B * Hq * pad_rows(Sq) +
         (splits > 1 ? 2LL * splits * B * Sk * Hkv * D : 0);
}

template <int DMAX>
cudaError_t launch_f32(const BwdArgs& a, float* scratch, int sms,
                       cudaStream_t stream) {
  const int Sp = pad_rows(a.Sq);
  float* Lp = scratch;
  float* Dp = scratch + (long long)a.B * a.Hq * Sp;
  const long long rows = (long long)a.B * a.Hq * Sp;
  flash_bwd_prep_f32_kernel<<<(unsigned)((rows + 7) / 8), kThreads, 0,
                              stream>>>(a, Lp, Dp, Sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t dq_smem = dq_f32_smem();
  err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(a.Hq * a.B, (a.Sq + kT - 1) / kT);
  flash_bwd_dq_f32_kernel<DMAX><<<dq_grid, kThreads, dq_smem, stream>>>(
      a, Lp, Dp, Sp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int splits = dkdv_splits(a.B, a.Sq, a.Sk, a.Hq, a.Hkv, a.causal,
                                 a.window, a.qoff, sms);
  float* pdk = Dp + rows;
  float* pdv = pdk + (long long)splits * a.B * a.Sk * a.Hkv * a.D;
  constexpr size_t kv_smem = dkdv_f32_smem();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_f32_kernel<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_smem);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(splits * a.Hkv * a.B, (a.Sk + kT - 1) / kT);
  flash_bwd_dkdv_f32_kernel<DMAX><<<kv_grid, kThreads, kv_smem, stream>>>(
      a, Lp, Dp, Sp, pdk, pdv, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n4 = (long long)a.B * a.Sk * a.Hkv * a.D / 4;
  flash_bwd_finish_f32_kernel<<<(unsigned)((n4 + kThreads - 1) / kThreads),
                                kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(pdk),
      reinterpret_cast<const float4*>(pdv), static_cast<float4*>(a.dk),
      static_cast<float4*>(a.dv), n4, splits, a.scale);
  return cudaGetLastError();
}

int dp_of(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }

}  // namespace

extern "C" {

// q, o, dout [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (strides in elements, D
// contiguous), all of one dtype (bf16 != 0: bf16, else fp32); lse [B, Hq,
// Sq] fp32 from the forward; scratch fp32 of flash_bwd_scratch_floats
// floats (splits from flash_bwd_dkdv_splits at `sms`).  Writes dq [B, Sq,
// Hq, D] and dk, dv [B, Sk, Hkv, D], contiguous, in the inputs' dtype.  q
// row i sits at position q_offset + i (as in the forward).  Launches on
// `stream`: the prep kernel (L, delta), dQ, dK/dV, and on the fp32 route
// with splits > 1 the finish kernel.  bf16: base pointers 16-byte aligned
// and the B, S and H strides multiples of 8.  Returns a cudaError_t.
int flash_attn_bwd_launch(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const float* lse,
                          float* scratch, void* dq, void* dk, void* dv, int B,
                          int Sq, int Sk, int Hq, int Hkv, int D,
                          long long q_b, long long q_s, long long q_h,
                          long long k_b, long long k_s, long long k_h,
                          long long v_b, long long v_s, long long v_h,
                          long long o_b, long long o_s, long long o_h,
                          long long do_b, long long do_s, long long do_h,
                          float scale, int causal, int window, int q_offset,
                          int bf16, int sms, void* stream) {
  if (D <= 0 || D % 16 || D > kF32MaxD || Hkv <= 0 ||
      Hq % Hkv || B <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{q,   k,    v,    o,    dout, lse,  dq,  dk,  dv,  B,
                  Sq,  Sk,   Hq,   Hkv,  D,    q_b,  q_s, q_h, k_b, k_s,
                  k_h, v_b,  v_s,  v_h,  o_b,  o_s,  o_h, do_b, do_s,
                  do_h, scale, causal, window, q_offset, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    if (sms <= 0) return (int)cudaErrorInvalidValue;
    // the fp32 kernels copy 16-byte pieces where every row allows it
    a.vec = ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(k) |
              reinterpret_cast<size_t>(v) | reinterpret_cast<size_t>(dout)) %
                 16 == 0 &&
             (q_b | q_s | q_h | k_b | k_s | k_h | v_b | v_s | v_h | do_b |
              do_s | do_h) % 4 == 0);
    switch (dp_of(D)) {
      case 64: return (int)launch_f32<64>(a, scratch, sms, st);
      case 128: return (int)launch_f32<128>(a, scratch, sms, st);
      default: return (int)launch_f32<256>(a, scratch, sms, st);
    }
  }
  return (int)cudaErrorNotSupported;   // bf16: not in this variant
}

}  // extern "C"
