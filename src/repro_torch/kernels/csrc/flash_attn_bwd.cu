// The backward of the GQA softmax attention of flash_attn.cu for Hopper
// (sm_90a), built by repro_torch/kernels/build.py with nvcc into a shared
// library with a plain C interface and called through ctypes from
// repro_torch/kernels/flash_attn.py (flash_attention_backward, the backward
// of its torch.autograd.Function).  Compiled without --use_fast_math.
//
// Replaces no Pallas kernel: the JAX package defines no custom_vjp for
// repro/kernels/flash_attn.py::flash_attention (pallas_call at
// flash_attn.py:117); its training gradients come from XLA's autodiff of
// repro/nn/attention.py::attention_blockwise.  These kernels give the
// port's forward kernels a gradient on the card.
//
// With P = exp(S scale - lse) (S = Q K^T, lse the forward's row
// log-sum-exp, fp32 [B, Hq, Sq]) and dO the output's gradient:
//   delta_i = sum_d dO_id O_id                               (prep kernel)
//   dS = P o (dO V^T - delta)
//   dQ = scale dS K                                          (dQ kernel)
//   dV = P^T dO,  dK = scale dS^T Q                          (dK/dV kernel)
// Pairs outside the mask (causal, window, past Sq or Sk) have P = 0.  Query
// row i sits at position q_offset + i for the causal and window tests, as
// in the forward (context-parallel attention); q_offset = 0 is the same
// arithmetic, and the same bits, as a kernel without it.  A row with no
// live key (lse = -1e30 from the forward) gets no gradient: its P is 0
// everywhere.  No path of the port reaches such a row: a causal or
// windowed row always sees its own key when q_offset + Sq <= Sk.
//
// What bounds it on this card: operations.  Per (batch, q head) the
// gradient needs 10 D flops a live pair (five products) on (4 Sq + 4 Sk) D
// inputs and outputs, ~600 flops a byte at granite's Sq = Sk = 4096,
// D = 64, so the bound is the tensor cores' bf16 rate.
//
// bf16 inputs (flash_bwd_{prep,dq,dkdv}_bf16_kernel): every product on the
// tensor cores (wgmma, bf16 operands, fp32 accumulators), tiles loaded by
// TMA (hopper.cuh).  Two kernels, so that no sum needs atomics:
//   * prep: L = lse log2(e) and delta a row, padded to a multiple of 128
//     rows, so that each tile's rows load with one bulk copy each.
//   * dQ: one block of two warpgroups a (q tile of 128 rows, q head,
//     batch), each warpgroup 64 rows.  Q, dO and the rows' L and delta
//     stay in shared memory; the kv tiles the mask lets through
//     (dq_kv_range) stream through a ring of STAGES stages with "full" and
//     "empty" mbarriers, thread 0 refilling a stage once all eight warps
//     have released it.  S = Q K^T and dP = dO V^T are ss-wgmmas (both
//     operands K-major); P = exp2(S scale log2(e) - L) and dS = P o (dP -
//     delta) in fp32 registers, then packed in the accumulator's layout,
//     which is the register layout of a wgmma A operand (as the forward
//     reuses it for P V); dQ += dS K is an rs-wgmma with K read MN-major.
//     8 D flops a pair (dS as two operands, below).
//   * dK/dV: one block a (kv tile, kv head, batch).  K and V load once;
//     for each of the G q heads h = g Hkv + hk in order g = 0 .. G - 1, the
//     q tiles the mask lets through (q_range) in order stream through the
//     ring with their L and delta rows.  S^T = K Q^T and dP^T = V dO^T are
//     ss-wgmmas; P^T and dS^T are formed in fp32 and packed as A
//     fragments; dV += P^T dO and dK += dS^T Q are rs-wgmmas with dO and Q
//     read MN-major.  10 D flops a pair; dK and dV stay in fp32 registers
//     across all G heads, so the sum over G needs no atomics.
//   * Warpgroups: at D <= 128 (DP = 64, 128) each warpgroup of a dK/dV
//     block owns 64 keys and all columns (BK = 128).  At DP = 256, dK and
//     dV of 64 keys would need 256 registers a thread, so the two
//     warpgroups share the block's 64 keys and each owns 128 of the
//     columns; each forms S^T and dP^T itself (14 D flops a pair there
//     instead of 10: no exchange through shared memory, no barrier between
//     the warpgroups).  The dQ kernel's K/V tiles are 32 keys at DP = 256
//     so that Q, dO and two stages fit in 227 KB.  No instantiation
//     spills (ptxas: dQ 129 / 156 / 187 registers, dK/dV 174 / 238 / 235
//     at DP = 64 / 128 / 256).
//   * Rounding: P is rounded to bf16 (to nearest) for dV's product, as
//     FlashAttention-2/3 do.  dS is carried as a bf16 pair, hi = bf16(ds)
//     and lo = bf16(ds - hi) (~16 bits), two wgmmas a k16 step, as the
//     forward carries P: a row of dS sums to zero, so dQ = dS K cancels
//     K's common part, and plain bf16 dS broke chip_smoke.py's 2^-7 bar on
//     whisper's decoder (1.035 of it).  Sums in fp32; the outputs rounded
//     to bf16.  tests/test_torch_flash_bwd.py emulates these points.
//   * Masks: tiles no mask edge crosses skip the per-element test.  Rows
//     past Sq and rows with no live key carry L = 1e30, so their P is 0;
//     keys past Sk are zeros from TMA and are masked where they would
//     reach a stored row (dQ), and are never stored (dK/dV).
//   * Order: dQ blocks longest first (causal: the last q tile first);
//     dK/dV blocks kv tile 0 first.  No atomics, a fixed order of every
//     sum: two launches give the same bits.
//   Inputs: base pointers 16-byte aligned and the B, S and H strides
//   multiples of 8 elements (TMA's 16-byte rule); D contiguous, a multiple
//   of 16 up to 256, padded to DP in {64, 128, 256} by zero columns.
//
// fp32 inputs (flash_bwd_{preprocess,dq,dkdv}_kernel): fp32 FMAs on the
// CUDA cores (bf16 tensor cores cannot meet the fp32 bar), D <= 256.
// Instantiated at DMAX = 64, 128, 256 (the accumulators' width).  Tiles of
// 64 q rows and BK keys, 256 threads: BK = 64 at DMAX <= 128; BK = 32 at
// DMAX = 256, where 64 x 64 tiles of [rows][D + 1] floats would not fit a
// block (F32Tiles).  Thread (ty, tx) of a 16 x 16 grid owns a 4 x BK/16
// (dQ) or BK/16 x 4 (dK/dV) patch of the score tile, rows ty-major and
// columns tx + 16c, and of each [rows, D] accumulator the columns tx +
// 16c: dQ 4 x DMAX/16 registers a thread, dK and dV BK/16 x DMAX/16 each.
// S and dP are computed in both kernels (14 D flops a pair).  Read through
// any B, S and H strides.
//
// Plans (tiles, stages, shared memory, tile ranges, scratch rows) are
// mirrored by repro_torch.kernels.flash_attn (bwd_tile_plan,
// bwd_smem_bytes, dq_kv_tile_range, q_tile_range, bwd_scratch_rows) and
// checked against this library when it is loaded.  Outputs: dQ
// [B, Sq, Hq, D] and dK, dV [B, Sk, Hkv, D], contiguous, in the inputs'
// dtype.

#include <math.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA ring
// ---------------------------------------------------------------------------

constexpr int kDqBQ = 128;        // q rows a dQ block: two warpgroups of 64
constexpr int kPadRows = 128;     // L and delta rows padded to a multiple

// Tiles and stages by DP: dQ's kv tile (DQ_BK keys) and ring; dK/dV's kv
// tile (KV_BK keys), q tile (KV_BQ rows) and ring; CW column groups
// (dK/dV's two warpgroups split the columns when CW = 2, else the keys).
template <int DP> struct BwdPlan;
template <> struct BwdPlan<64> {
  static constexpr int DQ_BK = 64, DQ_ST = 4, KV_BK = 128, KV_BQ = 64,
                       KV_ST = 4, CW = 1;
};
template <> struct BwdPlan<128> {
  static constexpr int DQ_BK = 64, DQ_ST = 4, KV_BK = 128, KV_BQ = 64,
                       KV_ST = 4, CW = 1;
};
template <> struct BwdPlan<256> {
  static constexpr int DQ_BK = 32, DQ_ST = 2, KV_BK = 64, KV_BQ = 64,
                       KV_ST = 2, CW = 2;
};

template <int DP>
constexpr size_t dq_bf16_smem() {
  using P = BwdPlan<DP>;
  return 1024 + 4 * (size_t)kDqBQ * DP + 4 * (size_t)P::DQ_ST * P::DQ_BK * DP +
         8 * kDqBQ + 8 * (2 * P::DQ_ST + 1);
}

template <int DP>
constexpr size_t dkdv_bf16_smem() {
  using P = BwdPlan<DP>;
  return 1024 + 4 * (size_t)P::KV_BK * DP +
         (size_t)P::KV_ST * (4 * (size_t)P::KV_BQ * DP + 8 * P::KV_BQ) +
         8 * (2 * P::KV_ST + 1);
}

int pad_rows(int Sq) { return (Sq + kPadRows - 1) / kPadRows * kPadRows; }

// x0, x1 as two bf16 pairs: hi = bf16(x), lo = bf16(x - hi) (~16 bits)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// L = lse log2(e) (kNoRow past Sq or for a row with no live key) and
// delta = rowsum(dO o O), each [B, Hq, Sp] fp32: one warp a row, bf16 pairs,
// a fixed shuffle tree
__global__ void __launch_bounds__(kThreads)
    flash_bwd_prep_bf16_kernel(const BwdArgs a, float* Lp, float* Dp,
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
    const __nv_bfloat162* o = reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(a.o) + b * a.o_b + i * a.o_s +
        h * a.o_h);
    const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(a.dout) + b * a.do_b +
        i * a.do_s + h * a.do_h);
    for (int d = lane; d < a.D / 2; d += 32) {
      const float2 x = __bfloat1622float2(o[d]);
      const float2 y = __bfloat1622float2(g[d]);
      s = fmaf(y.x, x.x, s);
      s = fmaf(y.y, x.y, s);
    }
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

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const BwdArgs a, const float* Lp,
                             const float* Dp, int Sp) {
  using P = BwdPlan<DP>;
  constexpr int BQ = kDqBQ, BK = P::DQ_BK, ST = P::DQ_ST, NB = DP / 64;
  constexpr uint32_t kQBytes = BQ * DP * 2, kTileBytes = BK * DP * 2;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t sQ = (base + 1023u) & ~1023u;      // swizzle atoms
  const uint32_t sdO = sQ + kQBytes;
  const uint32_t sKV = sdO + kQBytes;               // stage s: K, then V
  const uint32_t sLD = sKV + ST * 2 * kTileBytes;   // L [BQ], delta [BQ]
  const uint32_t full = sLD + 8 * BQ;               // ST mbarriers: landed
  const uint32_t empty = full + 8 * ST;             // ST mbarriers: read
  const uint32_t qbar = empty + 8 * ST;
  const float* Ls = reinterpret_cast<const float*>(smem + (sLD - base));

  const int pair = blockIdx.x, h = pair % a.Hq, b = pair / a.Hq;
  const int nq = (a.Sq + BQ - 1) / BQ;
  const int qt = a.causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * BQ, hk = h % a.Hkv;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  int kt_begin, kt_end;
  dq_kv_range(qt, BQ, BK, a.Sq, a.Sk, a.causal, a.window, a.qoff, &kt_begin,
              &kt_end);
  const int n_tiles = kt_end - kt_begin;
  // this thread's rows (absolute q positions) and first column in an n8 group
  const int row0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dq);
  if (n_tiles <= 0) {                 // no live key: no gradient
    for (int r = 0; r < 2; ++r) {
      const int s_ = row0 + 8 * r;
      if (s_ >= a.Sq) continue;
      __nv_bfloat16* row =
          out + (((long long)b * a.Sq + s_) * a.Hq + h) * a.D;
      for (int c = col0; c < a.D; c += 8)
        *reinterpret_cast<__nv_bfloat162*>(row + c) =
            __floats2bfloat162_rn(0.f, 0.f);
    }
    return;
  }

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);            // lane 0 of each of 8 warps
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // kv tile t of this block into stage t % ST (thread 0 only)
  auto load_kv = [&](int t) {
    const uint32_t st = sKV + (t % ST) * 2 * kTileBytes;
    const uint32_t bar = full + 8 * (t % ST);
    const int k0 = (kt_begin + t) * BK;
    mbar_expect_tx(bar, 2 * kTileBytes);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load(st + c * BK * 128, &tk, bar, 64 * c, k0, hk, b);
      tma_load(st + kTileBytes + c * BK * 128, &tv, bar, 64 * c, k0, hk, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, 2 * kQBytes + 8 * BQ);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load(sQ + c * BQ * 128, &tq, qbar, 64 * c, q0, h, b);
      tma_load(sdO + c * BQ * 128, &tdo, qbar, 64 * c, q0, h, b);
    }
    const long long row = ((long long)b * a.Hq + h) * Sp + q0;
    bulk_load(sLD, Lp + row, 4 * BQ, qbar);
    bulk_load(sLD + 4 * BQ, Dp + row, 4 * BQ, qbar);
    for (int t = 0; t < ST && t < n_tiles; ++t) load_kv(t);
  }

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const uint32_t qa = sQ + wg * 64 * 128, ga = sdO + wg * 64 * 128;
  const int qw0 = a.qoff + q0 + wg * 64;   // its first row's position

  mbar_wait(qbar, 0);
  float L[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row0 - q0 + 8 * r;
    L[r] = Ls[rr];
    delta[r] = Ls[BQ + rr];
  }
  for (int j = 0; j < n_tiles; ++j) {
    // tile j + ST - 1 into the stage tile j - 1 has released
    if (tid == 0 && j >= 1 && j + ST - 1 < n_tiles) {
      mbar_wait(empty + 8 * ((j - 1) % ST), ((j - 1) / ST) & 1);
      load_kv(j + ST - 1);
    }
    __syncwarp();
    const int st = j % ST;
    mbar_wait(full + 8 * st, (j / ST) & 1);
    const uint32_t sK = sKV + st * 2 * kTileBytes, sV = sK + kTileBytes;

    // S = Q K^T and dP = dO V^T
    float s[BK / 2], dp[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < DP / 16; ++t)
      Mma<BK>::ss(s, sdesc(qa + (t >> 2) * (BQ * 128) + (t & 3) * 32, 16, 1024),
                  sdesc(sK + (t >> 2) * (BK * 128) + (t & 3) * 32, 16, 1024),
                  t > 0);
    wgmma_commit();
#pragma unroll
    for (int t = 0; t < DP / 16; ++t)
      Mma<BK>::ss(dp,
                  sdesc(ga + (t >> 2) * (BQ * 128) + (t & 3) * 32, 16, 1024),
                  sdesc(sV + (t >> 2) * (BK * 128) + (t & 3) * 32, 16, 1024),
                  t > 0);
    wgmma_commit();

    // P while dP runs
    wgmma_wait<1>();
    fence_regs(s);
    const int k0 = (kt_begin + j) * BK;
    const bool edge = k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > qw0) ||
                      (a.window > 0 && k0 <= qw0 + 63 - a.window);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      s[i] = ex2(fmaf(s[i], sl2, -L[(i >> 1) & 1]));
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int kpos = k0 + 8 * (i >> 2) + col0 + (i & 1);
        const int qpos = a.qoff + row0 + ((i & 2) ? 8 : 0);
        if (kpos >= a.Sk || !live_pair(qpos, kpos, a.causal, a.window))
          s[i] = 0.f;
      }
    }

    // dS = P o (dP - delta) as A fragments, split hi = bf16(ds), lo =
    // bf16(ds - hi): k16 step t holds elements 8t .. 8t + 7
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t dh[BK / 16][4], dl[BK / 16][4];
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * t + 2 * r;
        split_bf16(s[i] * (dp[i] - delta[r & 1]),
                   s[i + 1] * (dp[i + 1] - delta[r & 1]), dh[t][r], dl[t][r]);
      }

    // dQ += dS K (K read MN-major)
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint64_t kb = sdesc(sK + t * 16 * 128, BK * 128, 1024);
      Mma<DP>::rs(dq, dh[t], kb);
      Mma<DP>::rs(dq, dl[t], kb);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    hold_regs(dh);
    hold_regs(dl);
    if (lane == 0) mbar_arrive(empty + 8 * st);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s_ = row0 + 8 * r;
    if (s_ >= a.Sq) continue;
    __nv_bfloat16* row = out + (((long long)b * a.Sq + s_) * a.Hq + h) * a.D;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      const int c = 8 * jj + col0;
      if (c < a.D)
        *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(
            dq[4 * jj + 2 * r] * a.scale, dq[4 * jj + 2 * r + 1] * a.scale);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const BwdArgs a, const float* Lp,
                               const float* Dp, int Sp) {
  using P = BwdPlan<DP>;
  constexpr int BK = P::KV_BK, BQ = P::KV_BQ, ST = P::KV_ST, CW = P::CW;
  constexpr int NB = DP / 64, NC = DP / CW;   // NC: columns a warpgroup owns
  constexpr uint32_t kKVBytes = BK * DP * 2, kTileBytes = BQ * DP * 2;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t sK = (base + 1023u) & ~1023u;      // swizzle atoms
  const uint32_t sV = sK + kKVBytes;
  const uint32_t sQG = sV + kKVBytes;               // stage s: Q, then dO
  const uint32_t sLD = sQG + ST * 2 * kTileBytes;   // stage s: L, delta
  const uint32_t full = sLD + ST * 8 * BQ;          // ST mbarriers: landed
  const uint32_t empty = full + 8 * ST;             // ST mbarriers: read
  const uint32_t kvbar = empty + 8 * ST;

  const int pair = blockIdx.x, hk = pair % a.Hkv, b = pair / a.Hkv;
  const int kt = blockIdx.y, k0 = kt * BK;
  const int G = a.Hq / a.Hkv;
  int qt_begin, qt_end;
  q_range(kt, BQ, BK, a.Sq, a.Sk, a.causal, a.window, a.qoff, &qt_begin,
          &qt_end);
  const int nq = qt_end - qt_begin, n_steps = G * nq;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int kw = CW == 1 ? wg : 0;    // this warpgroup's 64 keys
  const int cw = CW == 1 ? 0 : wg;    // and its NC columns
  const int kk0 = k0 + kw * 64;
  // this thread's keys (rows of S^T) and first q column in an n8 group
  const int key0 = kk0 + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  __nv_bfloat16* odk = static_cast<__nv_bfloat16*>(a.dk);
  __nv_bfloat16* odv = static_cast<__nv_bfloat16*>(a.dv);
  if (n_steps <= 0) {                 // no live query: no gradient
    for (int r = 0; r < 2; ++r) {
      const int s_ = key0 + 8 * r;
      if (s_ >= a.Sk) continue;
      const long long off = (((long long)b * a.Sk + s_) * a.Hkv + hk) * a.D;
      for (int c = cw * NC + col0; c < cw * NC + NC && c < a.D; c += 8) {
        *reinterpret_cast<__nv_bfloat162*>(odk + off + c) =
            __floats2bfloat162_rn(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(odv + off + c) =
            __floats2bfloat162_rn(0.f, 0.f);
      }
    }
    return;
  }

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);            // lane 0 of each of 8 warps
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step j (q head g Hkv + hk, q tile qt_begin + j % nq) into stage j % ST,
  // with its L and delta rows (thread 0 only)
  auto load_step = [&](int j) {
    const int s = j % ST, g = j / nq, qt = qt_begin + j - g * nq;
    const int h = g * a.Hkv + hk;
    const uint32_t dst = sQG + s * 2 * kTileBytes, bar = full + 8 * s;
    mbar_expect_tx(bar, 2 * kTileBytes + 8 * BQ);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load(dst + c * BQ * 128, &tq, bar, 64 * c, qt * BQ, h, b);
      tma_load(dst + kTileBytes + c * BQ * 128, &tdo, bar, 64 * c, qt * BQ,
               h, b);
    }
    const long long row = ((long long)b * a.Hq + h) * Sp + qt * BQ;
    bulk_load(sLD + s * 8 * BQ, Lp + row, 4 * BQ, bar);
    bulk_load(sLD + s * 8 * BQ + 4 * BQ, Dp + row, 4 * BQ, bar);
  };
  if (tid == 0) {
    mbar_expect_tx(kvbar, 2 * kKVBytes);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load(sK + c * BK * 128, &tk, kvbar, 64 * c, k0, hk, b);
      tma_load(sV + c * BK * 128, &tv, kvbar, 64 * c, k0, hk, b);
    }
    for (int j = 0; j < ST && j < n_steps; ++j) load_step(j);
  }

  float dk[NC / 2], dv[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) dk[i] = dv[i] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const uint32_t ka = sK + kw * 64 * 128, va = sV + kw * 64 * 128;
  const uint32_t cb = cw * (NC / 64) * (BQ * 128);  // this warpgroup's columns

  mbar_wait(kvbar, 0);
  for (int j = 0; j < n_steps; ++j) {
    // step j + ST - 1 into the stage step j - 1 has released
    if (tid == 0 && j >= 1 && j + ST - 1 < n_steps) {
      mbar_wait(empty + 8 * ((j - 1) % ST), ((j - 1) / ST) & 1);
      load_step(j + ST - 1);
    }
    __syncwarp();
    const int s = j % ST;
    mbar_wait(full + 8 * s, (j / ST) & 1);
    const int q0 = (qt_begin + j % nq) * BQ;
    const uint32_t sQ = sQG + s * 2 * kTileBytes, sG = sQ + kTileBytes;
    const float* Ls =
        reinterpret_cast<const float*>(smem + (sLD + s * 8 * BQ - base));
    const float* Ds = Ls + BQ;

    // S^T = K Q^T and dP^T = V dO^T
    float p[BQ / 2], dp[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < DP / 16; ++t)
      Mma<BQ>::ss(p, sdesc(ka + (t >> 2) * (BK * 128) + (t & 3) * 32, 16, 1024),
                  sdesc(sQ + (t >> 2) * (BQ * 128) + (t & 3) * 32, 16, 1024),
                  t > 0);
    wgmma_commit();
#pragma unroll
    for (int t = 0; t < DP / 16; ++t)
      Mma<BQ>::ss(dp,
                  sdesc(va + (t >> 2) * (BK * 128) + (t & 3) * 32, 16, 1024),
                  sdesc(sG + (t >> 2) * (BQ * 128) + (t & 3) * 32, 16, 1024),
                  t > 0);
    wgmma_commit();

    // P^T while dP^T runs; column c of element i is q row q0 + c
    wgmma_wait<1>();
    fence_regs(p);
    const int p0 = a.qoff + q0;       // the position of row q0
    const bool edge = (a.causal && kk0 + 63 > p0) ||
                      (a.window > 0 && kk0 <= p0 + BQ - 1 - a.window);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i)
      p[i] = ex2(fmaf(p[i], sl2, -Ls[8 * (i >> 2) + col0 + (i & 1)]));
    if (edge) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int qpos = p0 + 8 * (i >> 2) + col0 + (i & 1);
        const int kpos = key0 + ((i & 2) ? 8 : 0);
        if (!live_pair(qpos, kpos, a.causal, a.window)) p[i] = 0.f;
      }
    }
    uint32_t pf[BQ / 16][4];
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pf[t][r] = pack_bf16(
            __floats2bfloat162_rn(p[8 * t + 2 * r], p[8 * t + 2 * r + 1]));

    // dV += P^T dO (dO read MN-major, this warpgroup's columns)
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t)
      Mma<NC>::rs(dv, pf[t], sdesc(sG + cb + t * 16 * 128, BQ * 128, 1024));
    wgmma_commit();

    // dS^T = P^T o (dP^T - delta), split hi + lo, once dV has released P's
    // fragments (their registers hold dS's)
    wgmma_wait<0>();
    fence_regs(dp);
    fence_regs(dv);
    hold_regs(pf);
    uint32_t dh[BQ / 16][4], dl[BQ / 16][4];
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * t + 2 * r;
        const int c = 8 * (i >> 2) + col0;
        split_bf16(p[i] * (dp[i] - Ds[c]), p[i + 1] * (dp[i + 1] - Ds[c + 1]),
                   dh[t][r], dl[t][r]);
      }

    // dK += dS^T Q (Q read MN-major)
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t) {
      const uint64_t qb = sdesc(sQ + cb + t * 16 * 128, BQ * 128, 1024);
      Mma<NC>::rs(dk, dh[t], qb);
      Mma<NC>::rs(dk, dl[t], qb);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    hold_regs(dh);
    hold_regs(dl);
    if (lane == 0) mbar_arrive(empty + 8 * s);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s_ = key0 + 8 * r;
    if (s_ >= a.Sk) continue;
    const long long off = (((long long)b * a.Sk + s_) * a.Hkv + hk) * a.D;
#pragma unroll
    for (int jj = 0; jj < NC / 8; ++jj) {
      const int c = cw * NC + 8 * jj + col0;
      if (c < a.D) {
        *reinterpret_cast<__nv_bfloat162*>(odk + off + c) =
            __floats2bfloat162_rn(dk[4 * jj + 2 * r] * a.scale,
                                  dk[4 * jj + 2 * r + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(odv + off + c) =
            __floats2bfloat162_rn(dv[4 * jj + 2 * r], dv[4 * jj + 2 * r + 1]);
      }
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const BwdArgs& a, float* scratch,
                        cudaStream_t stream) {
  using P = BwdPlan<DP>;
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const int Sp = pad_rows(a.Sq);
  float* Lp = scratch;
  float* Dp = scratch + (long long)a.B * a.Hq * Sp;
  const long long rows = (long long)a.B * a.Hq * Sp;
  flash_bwd_prep_bf16_kernel<<<(unsigned)((rows + 7) / 8), kThreads, 0,
                               stream>>>(a, Lp, Dp, Sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap tq, tk, tv, tdo;
  auto maps = [&](int q_rows, int k_rows) {
    return tensor_map(enc, &tq, a.q, a.D, a.Sq, a.Hq, a.B, a.q_s, a.q_h,
                      a.q_b, q_rows) &&
           tensor_map(enc, &tdo, a.dout, a.D, a.Sq, a.Hq, a.B, a.do_s,
                      a.do_h, a.do_b, q_rows) &&
           tensor_map(enc, &tk, a.k, a.D, a.Sk, a.Hkv, a.B, a.k_s, a.k_h,
                      a.k_b, k_rows) &&
           tensor_map(enc, &tv, a.v, a.D, a.Sk, a.Hkv, a.B, a.v_s, a.v_h,
                      a.v_b, k_rows);
  };
  if (!maps(kDqBQ, P::DQ_BK)) return cudaErrorInvalidValue;
  constexpr size_t dq_smem = dq_bf16_smem<DP>();
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(a.Hq * a.B, (a.Sq + kDqBQ - 1) / kDqBQ);
  flash_bwd_dq_bf16_kernel<DP><<<dq_grid, kThreads, dq_smem, stream>>>(
      tq, tk, tv, tdo, a, Lp, Dp, Sp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (!maps(P::KV_BQ, P::KV_BK)) return cudaErrorInvalidValue;
  constexpr size_t kv_smem = dkdv_bf16_smem<DP>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_smem);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(a.Hkv * a.B, (a.Sk + P::KV_BK - 1) / P::KV_BK);
  flash_bwd_dkdv_bf16_kernel<DP><<<kv_grid, kThreads, kv_smem, stream>>>(
      tq, tk, tv, tdo, a, Lp, Dp, Sp);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32BQ = 64;        // q rows a tile
constexpr int kF32MaxD = 256;

// Keys a kv tile by DMAX (the accumulators' width): 64 at DMAX <= 128; 32
// at DMAX = 256, so that the four [rows][D + 1] tiles fit a block (a
// 64 x 64 plan would need 280 / 297 KB at D = 256) and dK / dV of a
// thread's keys stay in 64 registers.
template <int DMAX> struct F32Tiles {
  static constexpr int BK = DMAX > 128 ? 32 : 64;
};

__device__ __forceinline__ bool live(int qpos, int kpos, const BwdArgs& a) {
  return qpos < a.Sq && kpos < a.Sk && live_pair(a.qoff + qpos, kpos,
                                                 a.causal, a.window);
}

// rows [r0, r0 + R) of one head of x (S rows, strides s_s) into an fp32
// tile [R][ld] in shared memory, zeros past S
template <int R>
__device__ __forceinline__ void load_tile(float* dst, int ldd, const float* x,
                                          long long s_s, int r0, int S,
                                          int D) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, d = e - r * D, s = r0 + r;
    dst[r * ldd + d] = s < S ? x[s * s_s + d] : 0.f;
  }
}

// delta [B, Hq, Sq]: one warp a row, a fixed shuffle tree
__global__ void __launch_bounds__(kThreads)
    flash_bwd_preprocess_kernel(const BwdArgs a, float* delta) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.Hq * a.Sq) return;
  const int i = (int)(row % a.Sq);
  const int h = (int)(row / a.Sq % a.Hq);
  const int b = (int)(row / ((long long)a.Sq * a.Hq));
  const float* o =
      static_cast<const float*>(a.o) + b * a.o_b + i * a.o_s + h * a.o_h;
  const float* g = static_cast<const float*>(a.dout) + b * a.do_b +
                   i * a.do_s + h * a.do_h;
  float s = 0.f;
  for (int d = lane; d < a.D; d += 32) s = fmaf(g[d], o[d], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <int DMAX>
size_t dq_smem_bytes(int D) {
  constexpr int BK = F32Tiles<DMAX>::BK;
  return sizeof(float) * (2 * (size_t)(kF32BQ + BK) * (D + 1) +
                          (size_t)kF32BQ * (BK + 1) + 2 * kF32BQ);
}

// Thread (ty, tx) of a 16 x 16 grid owns rows 4ty .. 4ty + 3 of the [64, BK]
// score tile and its columns tx + 16c, c < BK / 16, and of dQ [64, D] the
// columns tx + 16c.
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const BwdArgs a, const float* delta) {
  extern __shared__ __align__(16) float sm[];
  constexpr int BK = F32Tiles<DMAX>::BK, CK = BK / 16, ldp = BK + 1;
  const int D = a.D, ldt = D + 1;
  float* Qs = sm;                         // [64][D+1]
  float* Gs = Qs + kF32BQ * ldt;          // dO [64][D+1]
  float* Ks = Gs + kF32BQ * ldt;          // [BK][D+1]
  float* Vs = Ks + BK * ldt;              // [BK][D+1]
  float* dSs = Vs + BK * ldt;             // [64][BK+1]
  float* Ls = dSs + kF32BQ * ldp;         // lse * log2(e) of the rows
  float* Dl = Ls + kF32BQ;                // delta of the rows

  const int pair = blockIdx.x, h = pair % a.Hq, b = pair / a.Hq;
  const int nq = (a.Sq + kF32BQ - 1) / kF32BQ;
  const int qt = a.causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kF32BQ, hk = h % a.Hkv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* q = static_cast<const float*>(a.q) + b * a.q_b + h * a.q_h;
  const float* g =
      static_cast<const float*>(a.dout) + b * a.do_b + h * a.do_h;
  const float* k = static_cast<const float*>(a.k) + b * a.k_b + hk * a.k_h;
  const float* v = static_cast<const float*>(a.v) + b * a.v_b + hk * a.v_h;
  const long long lrow = ((long long)b * a.Hq + h) * a.Sq;

  load_tile<kF32BQ>(Qs, ldt, q, a.q_s, q0, a.Sq, D);
  load_tile<kF32BQ>(Gs, ldt, g, a.do_s, q0, a.Sq, D);
  if (tid < kF32BQ) {
    const int s = q0 + tid;
    Ls[tid] = s < a.Sq ? a.lse[lrow + s] * kLog2e : 0.f;
    Dl[tid] = s < a.Sq ? delta[lrow + s] : 0.f;
  }
  int kt_begin, kt_end;
  dq_kv_range(qt, kF32BQ, BK, a.Sq, a.Sk, a.causal, a.window, a.qoff,
              &kt_begin, &kt_end);

  constexpr int NC = DMAX / 16;
  const int nc = D / 16;
  const float sl2 = a.scale * kLog2e;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                      // the last tile's readers are done
    load_tile<BK>(Ks, ldt, k, a.k_s, k0, a.Sk, D);
    load_tile<BK>(Vs, ldt, v, a.v_s, k0, a.Sk, D);
    __syncthreads();

    float s[4][CK], dp[4][CK];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[i][c] = dp[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[CK], vv[CK];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(4 * ty + i) * ldt + d];
        gv[i] = Gs[(4 * ty + i) * ldt + d];
      }
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        kv[c] = Ks[(tx + 16 * c) * ldt + d];
        vv[c] = Vs[(tx + 16 * c) * ldt + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(gv[i], vv[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float p = live(q0 + r, k0 + tx + 16 * c, a)
                            ? exp2f(fmaf(s[i][c], sl2, -Ls[r]))
                            : 0.f;
        dSs[r * ldp + tx + 16 * c] = p * (dp[i][c] - Dl[r]);
      }
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(4 * ty + i) * ldp + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nc) {
          const float kk = Ks[j * ldt + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kk, acc[i][c]);
        }
      }
    }
  }

  float* out = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * ty + i;
    if (s >= a.Sq) continue;
    float* row = out + (((long long)b * a.Sq + s) * a.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < nc) row[tx + 16 * c] = acc[i][c] * a.scale;
  }
}

template <int DMAX>
size_t dkdv_smem_bytes(int D) {
  constexpr int BK = F32Tiles<DMAX>::BK;
  return sizeof(float) * (2 * (size_t)(kF32BQ + BK) * (D + 1) +
                          2 * (size_t)BK * (kF32BQ + 1) + 2 * kF32BQ);
}

// Thread (ty, tx) owns keys RK ty .. RK ty + RK - 1 (RK = BK / 16) of the
// [BK, 64] tile S^T and its q columns tx + 16c, and of dK, dV [BK, D] the
// columns tx + 16c.
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const BwdArgs a, const float* delta) {
  extern __shared__ __align__(16) float sm[];
  constexpr int BK = F32Tiles<DMAX>::BK, RK = BK / 16, ldp = kF32BQ + 1;
  const int D = a.D, ldt = D + 1;
  float* Ks = sm;                         // [BK][D+1]
  float* Vs = Ks + BK * ldt;              // [BK][D+1]
  float* Qs = Vs + BK * ldt;              // [64][D+1]
  float* Gs = Qs + kF32BQ * ldt;          // dO [64][D+1]
  float* Ps = Gs + kF32BQ * ldt;          // P^T [BK keys][65]
  float* dSs = Ps + BK * ldp;             // dS^T [BK keys][65]
  float* Ls = dSs + BK * ldp;
  float* Dl = Ls + kF32BQ;

  const int pair = blockIdx.x, hk = pair % a.Hkv, b = pair / a.Hkv;
  const int kt = blockIdx.y, k0 = kt * BK;
  const int G = a.Hq / a.Hkv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* k = static_cast<const float*>(a.k) + b * a.k_b + hk * a.k_h;
  const float* v = static_cast<const float*>(a.v) + b * a.v_b + hk * a.v_h;

  load_tile<BK>(Ks, ldt, k, a.k_s, k0, a.Sk, D);
  load_tile<BK>(Vs, ldt, v, a.v_s, k0, a.Sk, D);
  int qt_begin, qt_end;
  q_range(kt, kF32BQ, BK, a.Sq, a.Sk, a.causal, a.window, a.qoff, &qt_begin,
          &qt_end);

  constexpr int NC = DMAX / 16;
  const int nc = D / 16;
  const float sl2 = a.scale * kLog2e;
  float dk[RK][NC], dv[RK][NC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = gi * a.Hkv + hk;        // q head h reads kv head h % Hkv
    const float* q = static_cast<const float*>(a.q) + b * a.q_b + h * a.q_h;
    const float* g =
        static_cast<const float*>(a.dout) + b * a.do_b + h * a.do_h;
    const long long lrow = ((long long)b * a.Hq + h) * a.Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kF32BQ;
      __syncthreads();                    // the last tile's readers are done
      load_tile<kF32BQ>(Qs, ldt, q, a.q_s, q0, a.Sq, D);
      load_tile<kF32BQ>(Gs, ldt, g, a.do_s, q0, a.Sq, D);
      if (tid < kF32BQ) {
        const int s = q0 + tid;
        Ls[tid] = s < a.Sq ? a.lse[lrow + s] * kLog2e : 0.f;
        Dl[tid] = s < a.Sq ? delta[lrow + s] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: rows are this block's keys RK ty + i, columns q rows
      float s[RK][4], dp[RK][4];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[RK], vv[RK], qv[4], gv[4];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          kv[i] = Ks[(RK * ty + i) * ldt + d];
          vv[i] = Vs[(RK * ty + i) * ldt + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qv[c] = Qs[(tx + 16 * c) * ldt + d];
          gv[c] = Gs[(tx + 16 * c) * ldt + d];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[i][c] = fmaf(kv[i], qv[c], s[i][c]);
            dp[i][c] = fmaf(vv[i], gv[c], dp[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int r = RK * ty + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          const float p = live(q0 + col, k0 + r, a)
                              ? exp2f(fmaf(s[i][c], sl2, -Ls[col]))
                              : 0.f;
          Ps[r * ldp + col] = p;
          dSs[r * ldp + col] = p * (dp[i][c] - Dl[col]);
        }
      }
      __syncthreads();

      for (int j = 0; j < kF32BQ; ++j) {
        float p[RK], ds[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          p[i] = Ps[(RK * ty + i) * ldp + j];
          ds[i] = dSs[(RK * ty + i) * ldp + j];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (c < nc) {
            const float gg = Gs[j * ldt + tx + 16 * c];
            const float qq = Qs[j * ldt + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < RK; ++i) {
              dv[i][c] = fmaf(p[i], gg, dv[i][c]);
              dk[i][c] = fmaf(ds[i], qq, dk[i][c]);
            }
          }
        }
      }
    }
  }

  float* ok = static_cast<float*>(a.dk);
  float* ov = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int s = k0 + RK * ty + i;
    if (s >= a.Sk) continue;
    const long long off = (((long long)b * a.Sk + s) * a.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < nc) {
        ok[off + tx + 16 * c] = dk[i][c] * a.scale;
        ov[off + tx + 16 * c] = dv[i][c];
      }
  }
}

template <int DMAX>
cudaError_t launch_f32(const BwdArgs& a, float* delta, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.Hq * a.Sq;
  flash_bwd_preprocess_kernel<<<(unsigned)((rows + 7) / 8), kThreads, 0,
                                stream>>>(a, delta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dq_smem = dq_smem_bytes<DMAX>(a.D);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(a.Hq * a.B, (a.Sq + kF32BQ - 1) / kF32BQ);
  flash_bwd_dq_kernel<DMAX><<<dq_grid, kThreads, dq_smem, stream>>>(a, delta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t kv_smem = dkdv_smem_bytes<DMAX>(a.D);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_smem);
  if (err != cudaSuccess) return err;
  constexpr int BK = F32Tiles<DMAX>::BK;
  const dim3 kv_grid(a.Hkv * a.B, (a.Sk + BK - 1) / BK);
  flash_bwd_dkdv_kernel<DMAX><<<kv_grid, kThreads, kv_smem, stream>>>(a,
                                                                      delta);
  return cudaGetLastError();
}

int dp_of(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }

template <int DMAX>
void f32_plan(int* plan) {
  constexpr int BK = F32Tiles<DMAX>::BK;
  const int v[8] = {DMAX, kF32BQ, BK, 1, kF32BQ, BK, 1, 1};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
}

template <int DP>
void bf16_plan(int* plan) {
  using P = BwdPlan<DP>;
  const int v[8] = {DP, kDqBQ, P::DQ_BK, P::DQ_ST, P::KV_BQ, P::KV_BK,
                    P::KV_ST, P::CW};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
}

}  // namespace

extern "C" {

// The largest head dimension of the bf16 (bf16 != 0) or fp32 kernels.
int flash_bwd_max_d(int bf16) { return bf16 ? 256 : kF32MaxD; }

// The tile plan at head dimension D: {DP, dQ's BQ, BK, STAGES, dK/dV's BQ,
// BK, STAGES, column groups}; the fp32 kernels (no ring) give STAGES 1 and
// DP the accumulators' width.
void flash_bwd_plan(int D, int bf16, int* plan) {
  if (!bf16) {
    switch (dp_of(D)) {
      case 64: f32_plan<64>(plan); break;
      case 128: f32_plan<128>(plan); break;
      default: f32_plan<256>(plan);
    }
  } else if (dp_of(D) == 64) {
    bf16_plan<64>(plan);
  } else if (dp_of(D) == 128) {
    bf16_plan<128>(plan);
  } else {
    bf16_plan<256>(plan);
  }
}

// The kv tiles [range[0], range[1]) (of BK keys) that q tile qt (of BQ
// rows, row i at position q_offset + i) of a dQ kernel reads.
void flash_bwd_dq_kv_range(int qt, int BQ, int BK, int Sq, int Sk, int causal,
                           int window, int q_offset, int* range) {
  dq_kv_range(qt, BQ, BK, Sq, Sk, causal, window, q_offset, range,
              range + 1);
}

// The q tiles [range[0], range[1]) (of BQ rows, row i at position
// q_offset + i) a dK/dV kernel visits for kv tile kt (of BK keys).
void flash_bwd_q_range(int kt, int BQ, int BK, int Sq, int Sk, int causal,
                       int window, int q_offset, int* range) {
  q_range(kt, BQ, BK, Sq, Sk, causal, window, q_offset, range, range + 1);
}

// Shared-memory bytes of a block of the dQ (kernel 0) or dK/dV (kernel 1)
// kernel at head dimension D.
long long flash_bwd_smem(int kernel, int D, int bf16) {
  if (!bf16) {
    switch (dp_of(D)) {
      case 64: return (long long)(kernel == 0 ? dq_smem_bytes<64>(D)
                                              : dkdv_smem_bytes<64>(D));
      case 128: return (long long)(kernel == 0 ? dq_smem_bytes<128>(D)
                                               : dkdv_smem_bytes<128>(D));
      default: return (long long)(kernel == 0 ? dq_smem_bytes<256>(D)
                                              : dkdv_smem_bytes<256>(D));
    }
  }
  switch (dp_of(D)) {
    case 64: return (long long)(kernel == 0 ? dq_bf16_smem<64>()
                                            : dkdv_bf16_smem<64>());
    case 128: return (long long)(kernel == 0 ? dq_bf16_smem<128>()
                                             : dkdv_bf16_smem<128>());
    default: return (long long)(kernel == 0 ? dq_bf16_smem<256>()
                                            : dkdv_bf16_smem<256>());
  }
}

// Rows of the scratch: fp32 [B, Hq, rows] delta (fp32), or [2, B, Hq,
// rows] L then delta (bf16).
int flash_bwd_scratch_rows(int Sq, int bf16) {
  return bf16 ? pad_rows(Sq) : Sq;
}

// q, o, dout [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (strides in elements, D
// contiguous), all of one dtype (bf16 != 0: bf16, else fp32); lse [B, Hq,
// Sq] fp32 from the forward; scratch fp32 of flash_bwd_scratch_rows rows.
// Writes dq [B, Sq, Hq, D] and dk, dv [B, Sk, Hkv, D], contiguous, in the
// inputs' dtype.  q row i sits at position q_offset + i (as in the
// forward).  Three launches on `stream`: the prep (delta) kernel, dQ,
// dK/dV.  bf16: base pointers 16-byte aligned and the B, S and H strides
// multiples of 8.  Returns a cudaError_t.
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
                          int bf16, void* stream) {
  if (D <= 0 || D % 16 || D > flash_bwd_max_d(bf16) || Hkv <= 0 ||
      Hq % Hkv || B <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q,   k,    v,    o,    dout, lse,  dq,  dk,  dv,  B,
                  Sq,  Sk,   Hq,   Hkv,  D,    q_b,  q_s, q_h, k_b, k_s,
                  k_h, v_b,  v_s,  v_h,  o_b,  o_s,  o_h, do_b, do_s,
                  do_h, scale, causal, window, q_offset};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    switch (dp_of(D)) {
      case 64: return (int)launch_f32<64>(a, scratch, st);
      case 128: return (int)launch_f32<128>(a, scratch, st);
      default: return (int)launch_f32<256>(a, scratch, st);
    }
  }
  const size_t ptrs = reinterpret_cast<size_t>(q) |
                      reinterpret_cast<size_t>(k) |
                      reinterpret_cast<size_t>(v) |
                      reinterpret_cast<size_t>(o) |
                      reinterpret_cast<size_t>(dout) |
                      reinterpret_cast<size_t>(scratch);
  if (ptrs % 16 || (q_b | q_s | q_h | k_b | k_s | k_h | v_b | v_s | v_h |
                    o_b | o_s | o_h | do_b | do_s | do_h) % 8)
    return (int)cudaErrorMisalignedAddress;
  switch (dp_of(D)) {
    case 64: return (int)launch_bf16<64>(a, scratch, st);
    case 128: return (int)launch_bf16<128>(a, scratch, st);
    default: return (int)launch_bf16<256>(a, scratch, st);
  }
}

}  // extern "C"
