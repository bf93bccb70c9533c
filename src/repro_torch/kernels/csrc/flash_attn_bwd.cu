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
// fp32 inputs (flash_bwd_{prep,dq,dkdv,finish}_f32_kernel): every product
// on the tensor cores in split TF32 (tf32.cuh): x = hi + lo, hi the top 19
// bits, and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, three mma.sync m16n8k8
// (the lo lo term and the tensor cores' reading of lo's top 19 bits leave
// ~2^-22 of each product), as SDPA's fp32 backward does.  The tensor cores
// truncate as they accumulate, a bias that grows with the chain: one chain
// over a block's kv tiles put dK over the fp32 bar at D = 256.  So
// each chunk's products (24 mma.sync at most) and each step's accumulate
// products (24) sum into a fresh accumulator, added to the running sums in
// fp32.  Instantiated at DMAX = 64, 128, 256 (the accumulators' width),
// D <= 256.  Tiles of 64 q rows by 64 keys, 256 threads.  At D = 256 a
// 64-row fp32 tile is 64 KB: the dQ block keeps its own Q and dO whole,
// everything else streams in d-chunks of 64 columns, each two TMA boxes
// of 32 columns (128-byte swizzled), through a ring of four stages;
// thread 0 copies a chunk three ahead once every warp has released its
// stage (full / empty mbarriers: no block-wide barrier a chunk).  A step
// (a q tile against a kv tile) is ceil(D / 64) chunks of Q and K, as many
// of dO and V, then as many accumulate chunks (dQ: K; dK/dV: Q and dO):
//   * prep: L = lse log2(e) (1e30 past Sq or for a row with no live key)
//     and delta a row, padded to a multiple of 128 rows.
//   * products: warp w sums S = Q K^T, then dP = dO V^T, over rows 16
//     (w / 2), columns 32 (w % 2) of the 64 x 64 step (the dK/dV kernel
//     forms S^T = K Q^T and dP^T = V dO^T: its accumulate rows are keys);
//     fragments by ldmatrix, conflict-free on the swizzle.
//   * P = exp2(S scale log2(e) - L), masked, and dS = P o (dP - delta),
//     split once and stored in the A fragments' order (the accumulators'
//     layout, one 16-byte store each): dQ dS, dK/dV P^T and dS^T.
//   * accumulates: dQ += dS K (warp w: rows 16 (w / 2), columns 32 (w % 2)
//     of the chunk); dK += dS^T Q (warps 0-3) and dV += P^T dO (warps
//     4-7), rows 32 ((w / 2) % 2).  k step ks reads rows 8 ks + 2q, + 1
//     (the fragments' k order) and two n8 tiles columns 2g, 2g + 1: 8-byte
//     loads, conflict-free on the swizzle; a chunk's last 16 columns take
//     one pair of n8 tiles.  The accumulators stay in registers (dK and dV
//     DMAX / 2 a thread).
//   * The chunks stay fp32 in shared memory and each operand register is
//     split as it loads (two instructions a value): a hi and lo copy of
//     every chunk, split once as it landed, doubles the shared memory each
//     fragment load moves and the room a chunk takes, and costs a pass over
//     every chunk; that design is kept in
//     probes/variants/flash_attn_bwd_f32_presplit.cu and timed against this
//     one by probes/flash_bwd_f32_presplit.py.  P and dS, which the kernel
//     forms itself, are split once as they are stored.
//   * The grid: dQ a (q tile, q head, batch), the last q tile first when
//     causal.  dK/dV a (split, kv head, batch) x kv tile, kv tile 0 first;
//     each block takes a contiguous range of its kv tile's (q head, q tile)
//     steps (heads g = 0 .. G - 1, each its q tiles in order): one range
//     when the grid fills two waves, else dkdv_splits ranges (the SM count
//     from the wrapper), each writing partial dK and dV in fp32, which the
//     finish kernel sums in split order and scales.  No atomics, a fixed
//     order of every sum: two launches give the same bits.
//   Inputs: D contiguous, q, k, v and dout 16-byte aligned with B, S and H
//   strides multiples of 4 elements (TMA's rules; the wrapper copies any
//   other layout once).  Shared memory: dQ 132,680 / 165,448 / 230,984 B
//   at DMAX = 64 / 128 / 256, dK/dV 198,728 B.
//   Why mma.sync and not wgmma: TF32 wgmma reads both operands K-major from
//   shared memory.  S and dP are, but dQ += dS K, dK += dS^T Q and dV +=
//   P^T dO read K, Q and dO MN-major, so wgmma would need transposed
//   copies of them beside the ones the products read, and its 64-row
//   accumulator fragments a warpgroup, while dK and dV of 64 keys at D =
//   256 already take half the register file.  mma.sync reads both orders
//   from one copy without bank conflicts.
//   What bounds it: operations, 10 D flops a live pair counted once (14 D
//   done: both kernels form S and dP) at split TF32's 165 TFLOP/s.
//
// Plans (tiles, stages, shared memory, tile ranges, scratch rows and
// floats, the dK/dV splits) are mirrored by repro_torch.kernels.flash_attn
// (bwd_tile_plan, bwd_smem_bytes, dq_kv_tile_range, q_tile_range,
// bwd_scratch_rows, bwd_scratch_floats, dkdv_splits, dkdv_steps) and
// checked against this library when it is loaded.  Outputs: dQ
// [B, Sq, Hq, D] and dK, dV [B, Sk, Hkv, D], contiguous, in the inputs'
// dtype.

#include <math.h>

#include "hopper.cuh"
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
// fp32: split TF32 on mma.sync m16n8k8, d-chunks through a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kF32MaxD = 256;
constexpr int kT = 64;             // q rows of a q tile; keys of a kv tile
constexpr int kBox = 32;           // columns of a TMA box (128 bytes)
constexpr int kDC = 2 * kBox;      // columns of a d-chunk: two boxes
constexpr int kBoxF = kT * kBox;   // floats of a box: [64 rows][32]
// a ring stage: dK/dV two tensors' chunks (four boxes), dQ one tensor's
template <bool KV>
__host__ __device__ constexpr int stage_floats() {
  return (KV ? 4 : 2) * kBoxF;
}
// dQ keeps its q tile's Q and dO whole (DMAX / 32 boxes each)
template <bool KV, int DMAX>
__host__ __device__ constexpr int resident_floats() {
  return KV ? 0 : 2 * (DMAX / kBox) * kBoxF;
}
constexpr int kFrag = kT * kT;     // a 64 x 64 operand in fragment order
constexpr int kMaxWaves = 4;       // dK/dV blocks after the split, in waves
constexpr int kStages = 4;         // the ring: three chunks in flight

// The slot of accumulator element e (rows g, g + 8; columns 2q, 2q + 1) in
// an A fragment (rows g, g + 8 at k = q, then at k = q + 4): 0, 2, 1, 3.
__device__ __forceinline__ constexpr int slot_of(int e) {
  return e == 1 ? 2 : e == 2 ? 1 : e;
}

// Shared memory of a block: 1 KB to align the boxes to the swizzle's 1024
// bytes; dQ's resident Q and dO; the ring; the rows' L and delta (dQ: its
// one q tile; dK/dV: two slots, a step's in slot step % 2); dQ's dS (hi,
// lo), dK/dV's P^T and dS^T (hi, lo), in fragment order; the ring's full
// and empty mbarriers and dQ's resident tiles' one.
template <bool KV, int DMAX>
constexpr size_t f32_smem() {
  return 1024 +
         4 * ((size_t)resident_floats<KV, DMAX>() +
              kStages * stage_floats<KV>() + (KV ? 4 : 2) * kT +
              (KV ? 4 : 2) * kFrag) +
         16 * kStages + 8;
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

// acc[nt] += X Y^T over the chunk's first kst k8 steps: X the 16 rows from
// xr of the chunk's X tile, Y the rows 8 nt .. from yr of its Y tile
// (shared addresses of the two boxes of each: box 1 kBoxF floats later).
// Fragments load with ldmatrix (k in its natural order) and are split as
// they load: the chunk stays fp32 in shared memory.  The chunk sums into
// a fresh accumulator, added to acc in fp32: the tensor cores truncate as
// they accumulate, so their chains stay at 3 kst products.  Each k8 step
// takes the lo hi products of the four n8 tiles, then hi lo, then hi hi.
__device__ __forceinline__ void product_chunk(float (&acc)[1][4][4],
                                              uint32_t x, uint32_t y, int xr,
                                              int yr, int kst) {
  const int lane = threadIdx.x & 31, m = lane >> 3, i = lane & 7;
  float part[1][4][4];
  zero(part);
#pragma unroll
  for (int ks = 0; ks < kDC / 8; ++ks) {
    if (ks >= kst) break;
    const uint32_t xb = x + (ks >> 2) * kBoxF * 4;
    const uint32_t yb = y + (ks >> 2) * kBoxF * 4;
    const int c = 8 * (ks & 3);
    uint32_t ar[4], ah[4], al[4];
    ldsm4(xb + swz(xr + i + 8 * (m & 1), c + 4 * (m >> 1)), ar);
#pragma unroll
    for (int e = 0; e < 4; ++e) split1(ar[e], ah[e], al[e]);
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t br[4];
      ldsm4(yb + swz(yr + 16 * p + 8 * (m >> 1) + i, c + 4 * (m & 1)), br);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split1(br[e], bh[2 * p + (e >> 1)][e & 1], bl[2 * p + (e >> 1)][e & 1]);
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

// acc[mt][nt] += A Y over k = 0 .. 63: A the rows 16 (mb + mt) .. of a
// 64 x 64 operand in fragment order (fh hi, fl lo), Y the box at shared
// address y (this warp's 32 columns of the chunk) as two pairs of n8
// tiles.  A's fragments are the product accumulators, so that k step ks
// holds rows 8 ks + 2q, 8 ks + 2q + 1 of Y as k = q, q + 4; tiles 2p + tt
// of pair p take the columns 16 p + 2g + tt (b0 and b1 of both tiles: two
// 8-byte loads, split as they load); NP = 1 takes pair 0 alone (pair 1 is
// past D).  A step's sums go to a fresh accumulator, added to acc in fp32.
template <int MT, int NP>
__device__ __forceinline__ void accum_chunk(float (&acc)[MT][4][4],
                                            const float* fh, const float* fl,
                                            int mb, uint32_t y) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float part[MT][4][4];
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
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint2 v;
        asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                     : "=r"(v.x), "=r"(v.y)
                     : "r"(y + swz(8 * ks + 2 * q + kk, 16 * p + 2 * g)));
        split1(v.x, bh[2 * p][kk], bl[2 * p][kk]);
        split1(v.y, bh[2 * p + 1][kk], bl[2 * p + 1][kk]);
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2 * NP; ++nt)
        mma_tf32(part[mt][nt], al[mt], bh[nt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2 * NP; ++nt)
        mma_tf32(part[mt][nt], ah[mt], bl[nt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2 * NP; ++nt)
        mma_tf32(part[mt][nt], ah[mt], bh[nt]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
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

// The tensors' TMA maps (fp32 [B, S, H, D] as boxes of 32 columns x 64
// rows of one head, 128-byte swizzled, zeros out of range)
struct F32Maps {
  CUtensorMap q, dout, k, v;
};

// One block of the dQ (KV = false) or dK/dV (KV = true) kernel: 8 warps,
// steps over kv tiles (dQ: its q tile against each) or (q head, q tile)
// pairs (dK/dV: its kv tile against each).  A step is n1 = ceil(D / 64)
// S chunks, n1 dP chunks, then n1 accumulate chunks, each a d-chunk of 64
// columns (two TMA boxes): dK/dV's of two tensors, dQ's of one (its own Q
// and dO stay whole in shared memory, copied once).  They pass through a
// ring of kStages stages: thread 0 copies chunk t + ST - 1 (TMA,
// completing on the stage's full mbarrier) into the stage chunk t - 1 held
// once every warp has released it (its empty mbarrier), so copies run
// three chunks ahead and the warps never wait for one another there.
//   S chunks hold X1, Y1, dP chunks X2, Y2 (dQ: X = Q, dO resident, Y = K,
//   V; dK/dV: X = K, V, Y = Q, dO).  Warp w sums S = X1 Y1^T, then dP = X2
//   Y2^T, over rows 16 (w / 2), columns 32 (w % 2) of the 64 x 64 step
//   (dQ's S has q rows and key columns, dK/dV's S^T the reverse), forms
//   P = exp2(S scale log2(e) - L) (masked) and dS = P o (dP - delta), and
//   stores them split in fragment order.
//   Accumulate chunks hold Y1 (and Y2).  dQ: warp w adds dS Y1 for rows 16
//   (w / 2), columns 32 (w % 2) of the chunk; dK/dV: warps 0-3 dK += dS^T
//   Q, warps 4-7 dV += P^T dO, rows 32 ((w / 2) % 2), columns 32 (w % 2).
//   Accumulators stay in registers over all steps.
template <int DMAX, bool KV>
__device__ __forceinline__ void f32_block(const BwdArgs& a, const F32Maps& m,
                                          const float* Lp, const float* Dp,
                                          int Sp, float* pdk, float* pdv,
                                          int splits) {
  constexpr int NC = (DMAX + kDC - 1) / kDC;   // accumulate chunks at most
  constexpr int MT = KV ? 2 : 1;          // accumulate row bands a warp
  constexpr int ST = kStages;
  constexpr int SF = stage_floats<KV>();  // floats a stage
  constexpr int NB = DMAX / kBox;         // dQ: boxes of a resident tile
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  float* res = reinterpret_cast<float*>(smem + (base - smem_u32(smem)));
  float* ring = res + resident_floats<KV, DMAX>();   // dQ: Q, then dO
  float* rows = ring + ST * SF;           // L then delta: dQ one, dK/dV two
  float* fPh = rows + (KV ? 4 : 2) * kT;  // P hi (dK/dV)
  float* fPl = fPh + kFrag;
  float* fSh = KV ? fPl + kFrag : fPh;    // dS hi
  float* fSl = fSh + kFrag;
  const uint32_t full = smem_u32(fSl + kFrag);   // ST mbarriers: landed
  const uint32_t empty = full + 8 * ST;          // ST mbarriers: released
  const uint32_t resbar = empty + 8 * ST;        // dQ's resident tiles

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int D = a.D, n1 = (D + kDC - 1) / kDC;

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
  // a step's q head and its tiles' first rows
  auto step_of = [&](int j, int& hh, int& qq0, int& kk0) {
    hh = h;
    qq0 = q0;
    kk0 = k0;
    if (KV) {
      const int js = j0 + j, gi = js / nq;
      hh = gi * a.Hkv + hk;
      qq0 = (qt_begin + js - gi * nq) * kT;
    } else {
      kk0 = (j0 + j) * kT;
    }
  };

  // chunk t into ring stage t % ST (thread 0): the boxes of its tensors
  // that hold columns below D (dK/dV: K and Q, V and dO, or Q and dO; dQ:
  // K, V or K), and with a dK/dV step's first chunk its rows' L and delta
  const int T = n_steps * 3 * n1;
  auto issue = [&](int t) {
    const int j = t / (3 * n1), c = t - j * 3 * n1, part = c / n1;
    const int c0 = (c - part * n1) * kDC;
    int hh, qq0, kk0;
    step_of(j, hh, qq0, kk0);
    const uint32_t st = smem_u32(ring + (t % ST) * SF);
    const uint32_t bar = full + 8 * (t % ST);
    const int boxes = c0 + kBox < D ? 2 : 1;
    const CUtensorMap* maps[2];
    int r[2], hd[2];
    if (!KV) {                           // K, V or K
      maps[0] = maps[1] = part == 1 ? &m.v : &m.k;
      r[0] = r[1] = kk0;
      hd[0] = hd[1] = hk;
    } else if (part < 2) {               // S (K, Q) or dP (V, dO)
      maps[0] = part ? &m.v : &m.k;
      maps[1] = part ? &m.dout : &m.q;
      r[0] = k0;
      r[1] = qq0;
      hd[0] = hk;
      hd[1] = hh;
    } else {                             // accumulate: Q and dO
      maps[0] = &m.q;
      maps[1] = &m.dout;
      r[0] = r[1] = qq0;
      hd[0] = hd[1] = hh;
    }
    constexpr int nt = KV ? 2 : 1;
    const bool with_rows = KV && c == 0;
    mbar_expect_tx(bar, nt * boxes * kBoxF * 4 + (with_rows ? 8 * kT : 0));
#pragma unroll
    for (int s = 0; s < nt; ++s)
#pragma unroll
      for (int x = 0; x < 2; ++x)
        if (x < boxes)
          tma_load(st + (s * 2 + x) * kBoxF * 4, maps[s], bar,
                   c0 + x * kBox, r[s], hd[s], b);
    if (with_rows) {
      const long long row = ((long long)b * a.Hq + hh) * Sp + qq0;
      const uint32_t dst = smem_u32(rows + (j & 1) * 2 * kT);
      bulk_load(dst, Lp + row, 4 * kT, bar);
      bulk_load(dst + 4 * kT, Dp + row, 4 * kT, bar);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads / 32);   // lane 0 of each warp
    }
    mbar_init(resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && !KV && T > 0) {       // dQ's Q and dO, and their L, delta
    const int nb = (D + kBox - 1) / kBox;
    mbar_expect_tx(resbar, 2 * nb * kBoxF * 4 + 8 * kT);
    for (int x = 0; x < nb; ++x) {
      tma_load(smem_u32(res + x * kBoxF), &m.q, resbar, x * kBox, q0, h, b);
      tma_load(smem_u32(res + (NB + x) * kBoxF), &m.dout, resbar, x * kBox,
               q0, h, b);
    }
    const long long row = ((long long)b * a.Hq + h) * Sp + q0;
    bulk_load(smem_u32(rows), Lp + row, 4 * kT, resbar);
    bulk_load(smem_u32(rows) + 4 * kT, Dp + row, 4 * kT, resbar);
  }
  if (tid == 0)
    for (int t = 0; t < ST - 1 && t < T; ++t) issue(t);
  if (!KV && T > 0) mbar_wait(resbar, 0);

  // before chunk t: thread 0 copies chunk t + ST - 1 into the stage chunk
  // t - 1 held, once every warp has released it; then every thread waits
  // for chunk t
  auto land = [&](int t) {
    if (tid == 0 && t + ST - 1 < T) {
      if (t >= 1) mbar_wait(empty + 8 * ((t - 1) % ST), ((t - 1) / ST) & 1);
      issue(t + ST - 1);
    }
    __syncwarp();
    mbar_wait(full + 8 * (t % ST), (t / ST) & 1);
  };
  // after chunk t: this warp has released its stage
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (t % ST));
  };

  float acc3[NC][MT][4][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) zero(acc3[c]);

  const int rb = w >> 1, ch = w & 1;      // products: rows 16 rb, cols 32 ch
  const float sl2 = a.scale * kLog2e;
  int t = 0;
  for (int j = 0; j < n_steps; ++j) {
    int hs, sq0, sk0;                     // this step's q tile and kv tile
    step_of(j, hs, sq0, sk0);
    float S[1][4][4], dP[1][4][4];
    zero(S);
    zero(dP);
    for (int c = 0; c < 2 * n1; ++c, ++t) {
      land(t);
      const uint32_t st = smem_u32(ring + (t % ST) * SF);
      const int cc = c < n1 ? c : c - n1;
      const int kst = min(kDC, D - cc * kDC) / 8;
      // X: dQ's resident Q or dO at the chunk's boxes; dK/dV's slot 0
      const uint32_t x =
          KV ? st : smem_u32(res + ((c < n1 ? 0 : NB) + 2 * cc) * kBoxF);
      const uint32_t y = KV ? st + 2 * kBoxF * 4 : st;
      if (c < n1)
        product_chunk(S, x, y, 16 * rb, 32 * ch, kst);
      else
        product_chunk(dP, x, y, 16 * rb, 32 * ch, kst);
      release(t);
    }

    // P and dS into fragment order, once every warp has left the last
    // step's: element (nt, e) of the warp's tile is row 16 rb + g + 8 (e /
    // 2), column 32 ch + 8 nt + 2q + e % 2; its fragment (band rb, k step
    // 4 ch + nt) holds elements 0, 2, 1, 3
    const float* Ls = rows + (KV ? (j & 1) * 2 * kT : 0);
    const float* Ds = Ls + kT;
    const int p0 = a.qoff + sq0;     // the position of the step's q row 0
    const bool edge = sk0 + kT > a.Sk || (a.causal && sk0 + kT - 1 > p0) ||
                      (a.window > 0 && sk0 <= p0 + kT - 1 - a.window);
    float pv[4][4], dsv[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * rb + g + 8 * (e >> 1);
        const int cl = 32 * ch + 8 * nt + 2 * q + (e & 1);
        const int qi = KV ? cl : r, kj = KV ? r : cl;   // q row, key
        float pe = exp2f(fmaf(S[0][nt][e], sl2, -Ls[qi]));
        if (edge && (sk0 + kj >= a.Sk ||
                     !live_pair(p0 + qi, sk0 + kj, a.causal, a.window)))
          pe = 0.f;
        pv[nt][slot_of(e)] = pe;
        dsv[nt][slot_of(e)] = pe * (dP[0][nt][e] - Ds[qi]);
      }
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int f = ((rb * (kT / 8) + 4 * ch + nt) * 32 + lane) * 4;
      if (KV) store_frag(fPh, fPl, f, pv[nt]);
      store_frag(fSh, fSl, f, dsv[nt]);
    }
    __syncthreads();

    // accumulate chunks: dQ += dS K; dK += dS^T Q, dV += P^T dO
    const int which = w >> 2, rh = (w >> 1) & 1;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < n1) {
        land(t);
        const uint32_t st = smem_u32(ring + (t % ST) * SF);
        // this warp's columns of the chunk: 32, or 16 at a chunk's end
        const int left = D - c * kDC - 32 * ch;
        const float* fh = KV && which ? fPh : fSh;
        const float* fl = KV && which ? fPl : fSl;
        const uint32_t y = st + ((KV ? 2 * which : 0) + ch) * kBoxF * 4;
        const int mb = KV ? 2 * rh : rb;
        if (left >= 32)
          accum_chunk<MT, 2>(acc3[c], fh, fl, mb, y);
        else if (left > 0)
          accum_chunk<MT, 1>(acc3[c], fh, fl, mb, y);
        release(t);
        ++t;
      }
    }
  }

  // rows 16 (mb + mt) + g + 8 hf of the block's tile, columns 64 c + 32 ch
  // + 16 p + 4q .. + 3 (tiles 2p, 2p + 1 alternate)
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
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int col = c * kDC + 32 * ch + 16 * p + 4 * q;
      if (c >= n1 || col - 4 * q >= D) continue;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r_base + 16 * (mb + mt) + g + 8 * hf;
          if (r >= S_out) continue;
          *reinterpret_cast<float4*>(
              out + (((long long)b * S_out + r) * H_out + hh) * D + col) =
              make_float4(acc3[c][mt][2 * p][2 * hf] * mul,
                          acc3[c][mt][2 * p + 1][2 * hf] * mul,
                          acc3[c][mt][2 * p][2 * hf + 1] * mul,
                          acc3[c][mt][2 * p + 1][2 * hf + 1] * mul);
        }
    }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_f32_kernel(const BwdArgs a,
                            const __grid_constant__ F32Maps m,
                            const float* Lp, const float* Dp, int Sp) {
  f32_block<DMAX, false>(a, m, Lp, Dp, Sp, nullptr, nullptr, 1);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_f32_kernel(const BwdArgs a,
                              const __grid_constant__ F32Maps m,
                              const float* Lp, const float* Dp, int Sp,
                              float* pdk, float* pdv, int splits) {
  f32_block<DMAX, true>(a, m, Lp, Dp, Sp, pdk, pdv, splits);
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
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const int Sp = pad_rows(a.Sq);
  float* Lp = scratch;
  float* Dp = scratch + (long long)a.B * a.Hq * Sp;
  const long long rows = (long long)a.B * a.Hq * Sp;
  // the runtime's first call in this thread before the driver's (the tensor
  // maps), as launch_bf16 orders them: on a thread new to this library (the
  // autograd engine's) the other order failed the first launch
  flash_bwd_prep_f32_kernel<<<(unsigned)((rows + 7) / 8), kThreads, 0,
                              stream>>>(a, Lp, Dp, Sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  F32Maps m;
  if (!tensor_map_f32(enc, &m.q, a.q, a.D, a.Sq, a.Hq, a.B, a.q_s, a.q_h,
                      a.q_b, kT) ||
      !tensor_map_f32(enc, &m.dout, a.dout, a.D, a.Sq, a.Hq, a.B, a.do_s,
                      a.do_h, a.do_b, kT) ||
      !tensor_map_f32(enc, &m.k, a.k, a.D, a.Sk, a.Hkv, a.B, a.k_s, a.k_h,
                      a.k_b, kT) ||
      !tensor_map_f32(enc, &m.v, a.v, a.D, a.Sk, a.Hkv, a.B, a.v_s, a.v_h,
                      a.v_b, kT))
    return cudaErrorInvalidValue;

  constexpr size_t dq_smem = f32_smem<false, DMAX>();
  err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(a.Hq * a.B, (a.Sq + kT - 1) / kT);
  flash_bwd_dq_f32_kernel<DMAX><<<dq_grid, kThreads, dq_smem, stream>>>(
      a, m, Lp, Dp, Sp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int splits = dkdv_splits(a.B, a.Sq, a.Sk, a.Hq, a.Hkv, a.causal,
                                 a.window, a.qoff, sms);
  float* pdk = Dp + rows;
  float* pdv = pdk + (long long)splits * a.B * a.Sk * a.Hkv * a.D;
  constexpr size_t kv_smem = f32_smem<true, DMAX>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_f32_kernel<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_smem);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(splits * a.Hkv * a.B, (a.Sk + kT - 1) / kT);
  flash_bwd_dkdv_f32_kernel<DMAX><<<kv_grid, kThreads, kv_smem, stream>>>(
      a, m, Lp, Dp, Sp, pdk, pdv, splits);
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

template <int DP>
void bf16_plan(int* plan) {
  using P = BwdPlan<DP>;
  const int v[9] = {DP, kDqBQ, P::DQ_BK, P::DQ_ST, P::KV_BQ, P::KV_BK,
                    P::KV_ST, P::CW, DP};
  for (int i = 0; i < 9; ++i) plan[i] = v[i];
}

}  // namespace

extern "C" {

// The largest head dimension of the bf16 (bf16 != 0) or fp32 kernels.
int flash_bwd_max_d(int bf16) { return bf16 ? 256 : kF32MaxD; }

// The tile plan at head dimension D: {DP, dQ's BQ, BK, STAGES, dK/dV's BQ,
// BK, STAGES, column groups, columns a copy holds}.  bf16: the TMA ring's
// tiles, whole rows of DP columns.  fp32: DP the accumulators' width, 64 x
// 64 tiles in d-chunks of 32 columns through a ring of four stages, the
// accumulate warps two column groups of a chunk.
void flash_bwd_plan(int D, int bf16, int* plan) {
  if (!bf16) {
    const int v[9] = {dp_of(D), kT, kT, kStages, kT, kT, kStages, 2, kDC};
    for (int i = 0; i < 9; ++i) plan[i] = v[i];
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
      case 64: return (long long)(kernel == 0 ? f32_smem<false, 64>()
                                              : f32_smem<true, 64>());
      case 128: return (long long)(kernel == 0 ? f32_smem<false, 128>()
                                               : f32_smem<true, 128>());
      default: return (long long)(kernel == 0 ? f32_smem<false, 256>()
                                              : f32_smem<true, 256>());
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

// Rows of the scratch's L and delta arrays [B, Hq, rows], both routes.
int flash_bwd_scratch_rows(int Sq, int bf16) {
  (void)bf16;
  return pad_rows(Sq);
}

// The dK/dV kernel's splits of a block's steps on a card of `sms` SMs
// (fp32; the bf16 kernels take none).
int flash_bwd_dkdv_splits(int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                          int window, int q_offset, int sms) {
  return dkdv_splits(B, Sq, Sk, Hq, Hkv, causal, window, q_offset, sms);
}

// Floats of the scratch: [2, B, Hq, rows] L then delta, and on the fp32
// route with splits > 1 the partial dK and dV [splits, B, Sk, Hkv, D] each.
long long flash_bwd_scratch_floats(int B, int Sq, int Sk, int Hq, int Hkv,
                                   int D, int bf16, int splits) {
  return f32_scratch(B, Sq, Sk, Hq, Hkv, D, bf16 ? 1 : splits);
}

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
  if (D <= 0 || D % 16 || D > flash_bwd_max_d(bf16) || Hkv <= 0 ||
      Hq % Hkv || B <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q,   k,    v,    o,    dout, lse,  dq,  dk,  dv,  B,
                  Sq,  Sk,   Hq,   Hkv,  D,    q_b,  q_s, q_h, k_b, k_s,
                  k_h, v_b,  v_s,  v_h,  o_b,  o_s,  o_h, do_b, do_s,
                  do_h, scale, causal, window, q_offset};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    // TMA: 16-byte aligned bases, strides multiples of 4 elements
    if (sms <= 0) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(k) |
         reinterpret_cast<size_t>(v) | reinterpret_cast<size_t>(dout) |
         reinterpret_cast<size_t>(scratch)) % 16 ||
        (q_b | q_s | q_h | k_b | k_s | k_h | v_b | v_s | v_h | do_b | do_s |
         do_h) % 4)
      return (int)cudaErrorMisalignedAddress;
    switch (dp_of(D)) {
      case 64: return (int)launch_f32<64>(a, scratch, sms, st);
      case 128: return (int)launch_f32<128>(a, scratch, sms, st);
      default: return (int)launch_f32<256>(a, scratch, sms, st);
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
