// Causal / sliding-window GQA softmax attention for Hopper (sm_90a), built by
// repro_torch/kernels/build.py with nvcc into a shared library with a plain C
// interface and called through ctypes from repro_torch/kernels/flash_attn.py.
// Compiled without --use_fast_math.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn.py::flash_attention
// (pallas_call at flash_attn.py:117): an online softmax over kv tiles,
// fully masked kv tiles skipped, q head h reading kv head h % Hkv.  Query
// row i sits at position q_offset + i for the causal and window tests (k
// and v at 0 .. Sk - 1): context-parallel attention runs a rank's block of
// the sequence against the whole K and V.  Every mask test adds q_offset to
// the row, so q_offset = 0 is the same arithmetic, and the same bits, as a
// kernel without it.
//
// What bounds it on this card: operations.  Per head it does 4·Sq·Sk_eff·D
// flops on (Sq + 2·Sk)·D inputs, ~2000 flops per byte at the path's
// Sq = Sk = 8192, D = 64, window 4096, so the bound is the tensor cores'
// bf16 rate.  Two kernels, picked by the wrapper by dtype (fp32 with a
// finish kernel for its split plan):
//
// flash_attn_bf16_kernel (bf16 inputs): both products on the tensor cores.
//   * One block of two warpgroups (256 threads) per (q tile of 128 rows, q
//     head, batch); each warpgroup owns 64 q rows, the height of a wgmma.
//     The Pallas grid's sequential kv axis is a loop inside the block.
//   * Loads: TMA (cuTensorMapEncodeTiled, found through
//     cudaGetDriverEntryPoint, so no -lcuda), one thread issuing: the Q
//     tile once; K and V tiles of BK keys into a ring of STAGES
//     shared-memory stages, each with a "full" mbarrier (bytes landed) and
//     an "empty" one (both warpgroups done reading), refilled two tiles
//     behind the reader, so later tiles land while this one is computed.
//     The 4-d maps read [B, S, H, D] through its strides; rows past S and
//     columns past D come back as zeros.
//   * Layout: 128-byte swizzle (TMA's and wgmma's layout type 1): a tile is
//     stored in 64-column blocks of 128-byte rows, 16-byte chunk c of row r
//     at chunk c ^ (r % 8); no bank conflicts.
//   * S = Q Kᵀ: wgmma m64nBKk16 with Q (A) and K (B) from shared memory,
//     both K-major, fp32 accumulators; scale * log2(e) is applied to the
//     fp32 scores, fused with the max into the exponent (one FFMA), so the
//     products are exact.  Masked scores are -1e30, as in the Pallas
//     kernel; tiles that no mask edge crosses skip the per-element test.
//   * O += P V: wgmma m64nDPk16 with P from registers (the accumulator
//     layout of S is the register layout of an A operand, as in
//     FlashAttention-3) and V (B) from shared memory, MN-major (trans-b).
//     P is split as hi = bf16(p), lo = bf16(p - hi), two wgmmas per 16
//     keys: p carries ~16 bits into the product; plain bf16 p, as the plain
//     attention_blockwise rounds it, would break the fp32 bar of
//     chip_smoke.py (tests/test_torch_flash_plan.py).  l sums the fp32 p.
//   * Overlap: a warpgroup issues S_j and P_{j-1} V_{j-1} together, then
//     runs the softmax of S_j (row max over the quad of lanes that holds a
//     row, exp2, partial sums merged once at the end in a fixed order)
//     while P_{j-1} V_{j-1} is still on the tensor cores.  The two
//     warpgroups take turns to issue (named barriers 1 and 2), so one's
//     softmax runs while the other's products do.
//   * Tile plan, templated on D padded to DP in {64, 128, 256}: BK = 128
//     keys at DP = 64, 64 above it, so S [64, BK], O [64, DP] and the last
//     P fit in registers at DP = 256; STAGES = 4, 2 at DP = 256 (shared
//     memory).  Mirrored by repro_torch.kernels.flash_attn.tile_plan.
//   * Kv tiles wholly above the diagonal or below the window are not
//     visited.  Launch order: groups of (head, batch) pairs whose K and V
//     fit in 24 MB of L2 in turn, so each kv tile comes from device memory
//     about once; inside a group the q tiles longest first (causal: the
//     last q tile first), so the short tiles fill the tail.
//   * No atomics, fixed order: two launches give the same bits.
//   Inputs: base pointers 16-byte aligned and the B, S and H strides
//   multiples of 8 elements (TMA's 16-byte rule); the wrapper raises on
//   anything else.
//
// flash_attn_f32_kernel (fp32 inputs): both products on the tensor cores in
//   split TF32 (tf32.cuh): x = hi + lo, hi the top 19 bits, and a b = a_lo
//   b_hi + a_hi b_lo + a_hi b_hi, three mma.sync m16n8k8 (the lo lo term
//   and the tensor cores' reading of lo's top 19 bits leave ~2^-22 of each
//   product); plain TF32 would miss the fp32 bar.  Instantiated at DMAX =
//   64, 128, 256 (O's width), D <= 256.
//   * One block of 8 warps a (split, q tile of 128 rows, q head, batch).
//     The long plan: warp w owns rows 16 w .. 16 w + 15, every key of a
//     step and every column of O (DMAX / 2 registers a thread); row max
//     and sum stay in the quad of lanes that holds a row, with no
//     exchange between warps and no barrier but the ring's.  A step is 64
//     keys, 32 at DMAX = 256 so that O, S and a pass of P V fit in 255
//     registers.  The short plan (Sq <= 16, a decode step): one warp's
//     rows would leave seven warps idle, so every warp takes rows 0 .. 15
//     and warp w the keys 8 w .. 8 w + 7 of each 64-key step; the warps
//     exchange their rows' maxima once a step through shared memory
//     (named barrier 1) and sum their O and l in warp order at the end.
//   * Loads: TMA, fp32 boxes of 32 columns (128-byte swizzle).  Q once, the
//     kv steps as d-chunks of 64 columns (two boxes), a step's K chunks
//     then its V chunks, through a 64 KB ring (4 stages of 64 keys or 8 of
//     32) with "full" and "empty" mbarriers, thread 0 copying up to a ring
//     less one ahead once every warp has released a stage.  Fragments
//     load with ldmatrix (S) or 8-byte loads (V), conflict-free on the
//     swizzle, and each operand register is split as it loads.  Q is
//     read by every step: in the long plan at DMAX = 64 each warp splits
//     its Q fragments once into registers (64 a thread) for the whole
//     block, 1-3% faster at whisper's shapes than splitting them as they
//     load (probes/flash_fwd_f32_qsplit.py); at DMAX = 128 and 256 they do
//     not fit beside O, and hi and lo copies in shared memory would not
//     fit beside the ring at 256, so there Q stays fp32 and is split as
//     it loads.
//   * S = Q K^T: each 64-column chunk sums into a fresh accumulator, added
//     to S in fp32 (the tensor cores truncate as they accumulate; their
//     chains stay at 24 products).  The scale times log2(e) is applied to
//     the fp32 scores, fused with the max into the exponent, as in the
//     bf16 kernel.
//   * O += P V: P stays in registers, the m16n8 accumulator of S read in
//     place as the A operand (columns 2t, 2t + 1 of an n8 group as k = t,
//     t + 4), V's keys read in that order; no shuffle, no shared memory.
//     Each chunk's P V sums into a fresh accumulator (in passes of four
//     n8 tiles at DMAX = 256), added to O in fp32 after O's rescale.
//   * Split-KV for short queries: when the (q tile, q head, batch) grid
//     fills less than two waves of the card's SMs (the SM count from the
//     wrapper), each of those cuts its 64-key kv tiles into `splits`
//     contiguous ranges (enough for kF32SplitBlocks blocks an SM, at most
//     the longest range's tiles).  Each split writes its rows'
//     unnormalised O, m and l to scratch, and the finish kernel merges a
//     row's splits in split order: their largest m, then each rescaled to
//     it and added.  A split in which a row has no live key holds m =
//     -1e30 and l its visited keys: its weight is 0 beside a split with a
//     live key, 1 when no split has one, so the merge gives the unsplit
//     plan's result.  At whisper's decode step (Sq = 1, 128 (head, batch)
//     pairs) that is 8 splits, 1024 blocks of three tiles on 132 SMs.
//   * Order: blocks q tile rank-major, the last q tile first when causal;
//     no atomics, a fixed order of every sum: two launches give the same
//     bits.
//   What bounds it: operations, 4 D flops a live pair at split TF32's 165
//   TFLOP/s (495 / 3); a decode step's K and V bytes (the short plan).
//   Inputs: q, k and v 16-byte aligned with B, S and H strides multiples
//   of 4 elements (TMA's rules; the wrapper copies any other layout once).
//   Plans (tiles, steps, stages, shared memory, kv-tile ranges, splits,
//   scratch, the short plan's rows) are mirrored by
//   repro_torch.kernels.flash_attn (f32_tile_plan, f32_smem_bytes,
//   f32_splits, f32_split_range, f32_scratch_floats, F32_SHORT) and
//   checked against this library when it is loaded.
//
// Both: a row wholly masked in a tile that runs gets exp(0) = 1 for every
// key while its max is still -1e30, and the first tile with a real key
// multiplies that away by exp(-1e30 - m) = 0, as in Pallas (keys past Sk
// count, with zero values).  The output is acc / max(l, 1e-30),
// contiguous [B, Sq, Hq, D] in the inputs' dtype.  With a non-null `lse`
// (training: the backward kernels of flash_attn_bwd.cu read it) each row's
// log-sum-exp of its scaled scores, m + log l in natural-log units, goes
// to lse [B, Hq, Sq] fp32 (the kernels' m and l are in exp2 units: (m +
// log2 l) ln 2); a row with no live key keeps the -1e30 fill's m (bf16:
// about -1e30 ln 2; fp32: -1e30).  A null `lse` (serving) writes nothing
// more, and the output's bits do not change.

#include <math.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                     // [B, Hq, Sq] or null
  int B, Sq, Sk, Hq, Hkv, D;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
  float scale;
  int causal, window;             // window <= 0: none
  int qoff;                       // q row i sits at position qoff + i
};

// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma, two warpgroups in turns
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;          // q rows per block: two warpgroups of 64
constexpr long long kHeadGroupBytes = 24ll << 20;   // K + V kept in L2

template <int DP> struct Plan;
template <> struct Plan<64> { static constexpr int BK = 128, STAGES = 4; };
template <> struct Plan<128> { static constexpr int BK = 64, STAGES = 4; };
template <> struct Plan<256> { static constexpr int BK = 64, STAGES = 2; };

template <int DP>
constexpr size_t bf16_smem_bytes() {
  return 1024 + 2 * (size_t)DP * (kBQ + 2 * Plan<DP>::BK * Plan<DP>::STAGES) +
         8 * (2 * Plan<DP>::STAGES + 1);
}

// (q, head) pairs whose K and V fit in kHeadGroupBytes of L2: the blocks
// of a group run together, so every kv tile comes from device memory once.
int head_group(int Sk, int D, int pairs) {
  const long long per = 4ll * Sk * D;      // K + V of one head, bf16
  const long long g = per > 0 ? kHeadGroupBytes / per : pairs;
  return (int)(g < 1 ? 1 : g < pairs ? g : pairs);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const Args a, int group) {
  constexpr int BK = Plan<DP>::BK, ST = Plan<DP>::STAGES, NB = DP / 64;
  constexpr uint32_t kQBytes = kBQ * DP * 2, kTileBytes = BK * DP * 2;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t sKV = sQ + kQBytes;                // stage s: K, then V
  const uint32_t full = sKV + ST * 2 * kTileBytes;  // ST mbarriers: landed
  const uint32_t empty = full + 8 * ST;             // ST mbarriers: read
  const uint32_t qbar = empty + 8 * ST;

  // block -> (q tile, head, batch): groups of `group` (head, batch) pairs
  // in turn, and inside a group the q tiles longest first
  const int nq = (a.Sq + kBQ - 1) / kBQ, pairs = a.Hq * a.B;
  const int g0 = blockIdx.x / (group * nq) * group;
  const int gsize = min(group, pairs - g0);
  const int within = blockIdx.x - g0 * nq;
  const int rank = within / gsize, pair = g0 + within - rank * gsize;
  const int qt = a.causal ? nq - 1 - rank : rank;
  const int h = pair % a.Hq, b = pair / a.Hq, hk = h % a.Hkv;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3;

  // the kv tiles not wholly above the diagonal nor wholly below the window
  // (at the rows' positions, qoff + row)
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  const int p0 = a.qoff + q0;
  int kt_end = (a.Sk + BK - 1) / BK;
  if (a.causal) kt_end = min(kt_end, (a.qoff + q_last) / BK + 1);
  int kt_begin = 0;
  if (a.window > 0) {
    const int lo = p0 - a.window - BK + 2;   // k0 + BK - 1 > p0 - window
    if (lo > 0) kt_begin = (lo + BK - 1) / BK;
  }
  const int n_tiles = kt_end - kt_begin;
  // this thread's rows (absolute q positions) and first column in an n8 group
  const int row0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
  if (n_tiles <= 0) {                 // no key: l = 0, the output is 0
    for (int r = 0; r < 2; ++r) {
      const int s_ = row0 + 8 * r;
      if (s_ >= a.Sq) continue;
      if (a.lse && (lane & 3) == 0)
        a.lse[((long long)b * a.Hq + h) * a.Sq + s_] = kNegInf;
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

  // tile t of this block into stage t % ST (thread 0 only)
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
  // at step j, tile j + ST - 2 into the stage tile j - 2 has released
  auto refill = [&](int j) {
    const int t = j + ST - 2;
    if (tid == 0 && j >= 2 && t < n_tiles) {
      mbar_wait(empty + 8 * (t % ST), (t / ST - 1) & 1);
      load_kv(t);
    }
    __syncwarp();
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, kQBytes);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tma_load(sQ + c * kBQ * 128, &tq, qbar, 64 * c, q0, h, b);
    for (int t = 0; t < ST && t < n_tiles; ++t) load_kv(t);
  }

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // the last tile's weights; 0 before the first, so that step 0 can issue
  // its (null) P V like every other step: no wgmma behind a branch
  uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) ph[t][r] = pl[t][r] = 0u;
  const float sl2 = a.scale * 1.4426950408889634f;   // scale * log2(e)
  const uint32_t q_base = sQ + wg * 64 * 128;

  mbar_wait(qbar, 0);
  if (wg == 1) bar_arrive(1);                 // warpgroup 0 goes first
  for (int j = 0; j < n_tiles; ++j) {
    if constexpr (ST == 2) refill(j);
    const int st = j % ST;
    mbar_wait(full + 8 * st, (j / ST) & 1);

    // my turn: issue S = Q K_j^T, then O += P_{j-1} V_{j-1}
    bar_sync(1 + wg);
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < DP / 16; ++t)
      Mma<BK>::ss(s,
                  sdesc(q_base + (t >> 2) * (kBQ * 128) + (t & 3) * 32, 16,
                        1024),
                  sdesc(sKV + st * 2 * kTileBytes + (t >> 2) * (BK * 128) +
                            (t & 3) * 32,
                        16, 1024),
                  t > 0);
    wgmma_commit();
    {
      const uint32_t sV =
          sKV + ((j + ST - 1) % ST) * (j > 0) * 2 * kTileBytes + kTileBytes;
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {
        const uint64_t dv = sdesc(sV + t * 16 * 128, BK * 128, 1024);
        Mma<DP>::rs(o, ph[t], dv);
        Mma<DP>::rs(o, pl[t], dv);
      }
    }
    wgmma_commit();
    if (wg == 0 || j + 1 < n_tiles) bar_arrive(2 - wg);   // the other's turn
    if constexpr (ST > 2) refill(j);

    // softmax of S_j while P_{j-1} V_{j-1} runs: scale, mask, running max
    // over the quad that holds a row
    wgmma_wait<1>();
    fence_regs(s);
    const int k0 = (kt_begin + j) * BK;
    const bool edge = k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > p0) ||
                      (a.window > 0 && k0 <= p0 + kBQ - 1 - a.window);
    float mx[2] = {-INFINITY, -INFINITY};
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int kpos = k0 + 8 * (i >> 2) + col0 + (i & 1);
        const int qpos = a.qoff + row0 + ((i & 2) ? 8 : 0);
        const bool ok = kpos < a.Sk && (!a.causal || kpos <= qpos) &&
                        (a.window <= 0 || kpos > qpos - a.window);
        s[i] = ok ? s[i] : -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float corr[2], negm[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // scaled; a row with no live key here keeps the -1e30 of the mask
      const float mt = mx[r] == -INFINITY ? kNegInf : mx[r] * sl2;
      const float m_new = fmaxf(m[r], mt);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      negm[r] = -m_new;
      l[r] *= corr[r];
    }
    if (edge) {         // a masked score is -1e30: exp2(0) = 1 while the
                        // row has no live key yet, as in Pallas, else 0
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = s[i] == -INFINITY ? ex2(kNegInf + negm[r])
                                 : ex2(fmaf(s[i], sl2, negm[r]));
        l[r] += s[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = ex2(fmaf(s[i], sl2, negm[r]));
        l[r] += s[i];
      }
    }

    wgmma_wait<0>();                  // P_{j-1} V_{j-1} done: stage free
    fence_regs(o);
    hold_regs(ph);
    hold_regs(pl);
    if (j > 0 && lane == 0) mbar_arrive(empty + 8 * ((j - 1) % ST));
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // P_j as A fragments: k16 step t holds s[8t .. 8t + 7], split hi + lo
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = s[8 * t + 2 * r], x1 = s[8 * t + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        ph[t][r] = pack_bf16(hi);
        pl[t][r] = pack_bf16(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
      }
  }
  {                                   // O += P_last V_last
    const uint32_t sV =
        sKV + ((n_tiles - 1) % ST) * 2 * kTileBytes + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint64_t dv = sdesc(sV + t * 16 * 128, BK * 128, 1024);
      Mma<DP>::rs(o, ph[t], dv);
      Mma<DP>::rs(o, pl[t], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    hold_regs(ph);
    hold_regs(pl);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s_ = row0 + 8 * r;
    if (s_ >= a.Sq) continue;
    if (a.lse && (lane & 3) == 0)     // exp2 units back to natural log
      a.lse[((long long)b * a.Hq + h) * a.Sq + s_] =
          (m[r] + log2f(l[r])) * 0.6931471805599453f;
    __nv_bfloat16* row = out + (((long long)b * a.Sq + s_) * a.Hq + h) * a.D;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      const int c = 8 * jj + col0;
      if (c < a.D)
        *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(
            o[4 * jj + 2 * r] / l[r], o[4 * jj + 2 * r + 1] / l[r]);
    }
  }
}


template <int DP>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(enc, &tq, a.q, a.D, a.Sq, a.Hq, a.B, a.q_s, a.q_h, a.q_b,
                  kBQ) ||
      !tensor_map(enc, &tk, a.k, a.D, a.Sk, a.Hkv, a.B, a.k_s, a.k_h, a.k_b,
                  Plan<DP>::BK) ||
      !tensor_map(enc, &tv, a.v, a.D, a.Sk, a.Hkv, a.B, a.v_s, a.v_h, a.v_b,
                  Plan<DP>::BK))
    return cudaErrorInvalidValue;
  constexpr size_t smem = bf16_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int pairs = a.Hq * a.B;
  const long long blocks = (long long)((a.Sq + kBQ - 1) / kBQ) * pairs;
  flash_attn_bf16_kernel<DP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      tq, tk, tv, a, head_group(a.Sk, a.D, pairs));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: split TF32 on mma.sync m16n8k8, K and V through a TMA ring
// ---------------------------------------------------------------------------

constexpr int kF32BQ = 128;            // q rows a block: 8 warps of 16
constexpr int kF32BK = 64;             // keys a kv tile (the plan's ranges)
constexpr int kF32Box = 32;            // columns of a TMA box (128 bytes)
constexpr int kF32DC = 2 * kF32Box;    // columns of a d-chunk: two boxes
constexpr int kF32Short = 16;          // Sq at most this: the short plan
constexpr int kF32SplitBlocks = 8;     // blocks an SM the split plan aims at
constexpr uint32_t kF32QBox = kF32BQ * 128;    // bytes of a Q box
// floats of the short plan's exchange: row maxima of two steps, the
// warps' l, the rows' m
constexpr int kF32Red = 2 * 8 * 16 + 8 * 16 + 16;
constexpr float kLn2 = 0.6931471805599453f;

// The accumulators' width, D rounded up to 64, 128 or 256.
__host__ __device__ constexpr int f32_dmax(int D) {
  return D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// The plan by DMAX and by plan.  Long (Sq > kF32Short): warp w the rows 16
// w .. 16 w + 15, every key of a step.  Short: every warp rows 0 .. 15,
// warp w the keys 8 w .. 8 w + 7 of a step.  KH keys a step: 64, or 32 in
// the long plan at DMAX = 256, so that O (128 registers a thread), S and a
// pass fit in 255; ST stages of two [KH][32] boxes, 64 KB of ring either
// way; NP n8 tiles a pass of P V (a chunk's 64 columns in 8 / NP passes).
template <int DMAX, bool SHORT>
struct F32Plan {
  static constexpr int KH = DMAX == 256 && !SHORT ? 32 : 64;
  static constexpr int ST = 4 * kF32BK / KH;
  static constexpr int NP = DMAX == 256 ? 4 : 8;
};

// Shared memory of a block: 1 KB to align the boxes to the swizzle's 1024
// bytes; Q, DMAX / 32 boxes of [128][32] (the short plan's warps' O once
// the loop is done); the ring; the short plan's exchange; the ring's full
// and empty mbarriers and Q's.
template <int DMAX, bool SHORT>
constexpr size_t f32_smem() {
  using P = F32Plan<DMAX, SHORT>;
  return 1024 +
         4 * ((size_t)kF32BQ * DMAX + (size_t)P::ST * 2 * P::KH * kF32Box +
              kF32Red) +
         8 * (2 * P::ST + 1);
}

// The kv tiles [begin, end) (of kF32BK keys) q tile qt (of kF32BQ rows,
// row i at position qoff + i) reads: not wholly above the diagonal of its
// last row (rows past Sq do not count) nor wholly below the window of its
// first.
__host__ __device__ inline void f32_kv_range(int qt, int Sq, int Sk,
                                             int causal, int window, int qoff,
                                             int* begin, int* end) {
  const int q0 = qoff + qt * kF32BQ;
  const int rows = Sq - qt * kF32BQ < kF32BQ ? Sq - qt * kF32BQ : kF32BQ;
  const int q_last = q0 + rows - 1;
  int e = (Sk + kF32BK - 1) / kF32BK;
  if (causal && q_last / kF32BK + 1 < e) e = q_last / kF32BK + 1;
  int bg = 0;
  if (window > 0) {
    const int lo = q0 - window - kF32BK + 2;  // k0 + BK - 1 > q0 - window
    if (lo > 0) bg = (lo + kF32BK - 1) / kF32BK;
  }
  *begin = bg;
  *end = e > bg ? e : bg;
}

// Ranges each (q tile, q head, batch) cuts its kv tiles into: 1 when the
// grid of those blocks fills two waves of `sms` SMs (one block an SM);
// else enough for kF32SplitBlocks blocks an SM, at most the longest
// block's tiles.
int f32_splits(int B, int Sq, int Sk, int Hq, int Hkv, int causal,
               int window, int qoff, int sms) {
  (void)Hkv;
  const int nq = (Sq + kF32BQ - 1) / kF32BQ;
  const long long blocks = (long long)B * Hq * nq;
  if (blocks <= 0 || blocks >= 2LL * sms) return 1;
  int longest = 0;
  for (int qt = 0; qt < nq; ++qt) {
    int bg, e;
    f32_kv_range(qt, Sq, Sk, causal, window, qoff, &bg, &e);
    if (e - bg > longest) longest = e - bg;
  }
  long long s = (long long)kF32SplitBlocks * sms / blocks;
  if (s > longest) s = longest;
  return s < 1 ? 1 : (int)s;
}

// Split s of `splits` takes the tiles [kb + s n / splits, kb + (s + 1) n /
// splits) of its q tile's range [kb, kb + n).
__host__ __device__ inline void f32_split_range(int kb, int ke, int split,
                                                int splits, int* begin,
                                                int* end) {
  const int n = ke - kb;
  *begin = kb + (int)((long long)split * n / splits);
  *end = kb + (int)((long long)(split + 1) * n / splits);
}

// Floats of the split plan's scratch: O [splits, B, Hq, Sq, D], then m and
// l [splits, B, Hq, Sq] each; none when splits == 1.
long long f32_scratch(int B, int Sq, int Hq, int D, int splits) {
  return splits > 1 ? (long long)splits * B * Hq * Sq * (D + 2) : 0;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// s += Q K^T of one d-chunk, its first kst k8 steps: Q the 16 rows from row
// xr of the chunk's Q boxes (shared address xq, the second box kF32QBox
// later), or with QREG its k8 steps split once in qh, ql; K the NS n8
// tiles of keys from row yr of the stage at yk (its second box `box` bytes
// later).  Fragments load with ldmatrix (a lone n8 tile: two 4-byte loads,
// conflict-free on the swizzle) and are split as they load.  The chunk
// sums into a fresh accumulator, added to s in fp32: the tensor cores
// truncate as they accumulate, so their chains stay at 3 kst products.  A
// k8 step takes the lo hi products, then hi lo, then hi hi.
template <int NS, bool QREG>
__device__ __forceinline__ void f32_scores(float (&s)[NS][4],
                                           const uint32_t (&qh)[8][4],
                                           const uint32_t (&ql)[8][4],
                                           uint32_t xq, uint32_t yk,
                                           uint32_t box, int xr, int yr,
                                           int kst) {
  const int lane = threadIdx.x & 31, m = lane >> 3, i = lane & 7;
  const int g = lane >> 2, q = lane & 3;
  float acc[NS][4];
#pragma unroll
  for (int nt = 0; nt < NS; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kF32DC / 8; ++ks) {
    if (ks >= kst) break;
    const uint32_t yb = yk + (ks >> 2) * box;
    const int c = 8 * (ks & 3);
    uint32_t ah[4], al[4];
    if constexpr (QREG) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[e] = qh[ks][e];
        al[e] = ql[ks][e];
      }
    } else {
      uint32_t ar[4];
      ldsm4(xq + (ks >> 2) * kF32QBox + swz(xr + i + 8 * (m & 1),
                                            c + 4 * (m >> 1)),
            ar);
#pragma unroll
      for (int e = 0; e < 4; ++e) split1(ar[e], ah[e], al[e]);
    }
    uint32_t bh[NS][2], bl[NS][2];
    if constexpr (NS == 1) {
      split1(lds32(yb + swz(yr + g, c + q)), bh[0][0], bl[0][0]);
      split1(lds32(yb + swz(yr + g, c + q + 4)), bh[0][1], bl[0][1]);
    } else {
#pragma unroll
      for (int pp = 0; pp < NS / 2; ++pp) {
        uint32_t br[4];
        ldsm4(yb + swz(yr + 16 * pp + 8 * (m >> 1) + i, c + 4 * (m & 1)),
              br);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split1(br[e], bh[2 * pp + (e >> 1)][e & 1],
                 bl[2 * pp + (e >> 1)][e & 1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) mma_tf32(acc[nt], al, bh[nt]);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) mma_tf32(acc[nt], ah, bl[nt]);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) mma_tf32(acc[nt], ah, bh[nt]);
  }
#pragma unroll
  for (int nt = 0; nt < NS; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] += acc[nt][e];
}

// o = o corr + P V of one d-chunk: P the KS k8 steps of weights in s (the
// m16n8 accumulators of S, read in place as A fragments: columns 2q, 2q +
// 1 of an n8 group as k = q, q + 4, elements 0, 2, 1, 3), split as they are
// read; V the stage at yv (its second box `box` bytes later), k step ks
// reading keys kr + 8 ks + 2q and + 1 as k = q, q + 4 and, of each
// 16-column pair, columns 2g, 2g + 1 for two n8 tiles (one 8-byte load,
// conflict-free on the swizzle), so tile 2p + u holds the chunk's columns
// 16 p + 2n + u; pairs at or past `left` (the chunk's columns below D) are
// skipped.  Passes of NP n8 tiles, each summing into a fresh accumulator
// added to o in fp32 after o's rescale.
template <int NP, int KS>
__device__ __forceinline__ void f32_pv(float (&o)[8][4],
                                       const float (&s)[KS][4],
                                       const float (&corr)[2], uint32_t yv,
                                       uint32_t box, int kr, int left) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int hs = 0; hs < 8 / NP; ++hs) {
    if (16 * (NP / 2) * hs >= left) break;
    float acc[NP][4];
#pragma unroll
    for (int nt = 0; nt < NP; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[4], al[4];
      split_tf32(s[ks][0], ah[0], al[0]);
      split_tf32(s[ks][2], ah[1], al[1]);
      split_tf32(s[ks][1], ah[2], al[2]);
      split_tf32(s[ks][3], ah[3], al[3]);
      uint32_t bh[NP][2], bl[NP][2];
#pragma unroll
      for (int pp = 0; pp < NP / 2; ++pp) {
        const int p = NP / 2 * hs + pp;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint2 v = make_uint2(0u, 0u);
          if (16 * p < left)
            asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                         : "=r"(v.x), "=r"(v.y)
                         : "r"(yv + (p >> 1) * box +
                               swz(kr + 8 * ks + 2 * q + kk,
                                   16 * (p & 1) + 2 * g)));
          split1(v.x, bh[2 * pp][kk], bl[2 * pp][kk]);
          split1(v.y, bh[2 * pp + 1][kk], bl[2 * pp + 1][kk]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NP; ++nt)
        if (16 * (NP / 2 * hs + nt / 2) < left) mma_tf32(acc[nt], al, bh[nt]);
#pragma unroll
      for (int nt = 0; nt < NP; ++nt)
        if (16 * (NP / 2 * hs + nt / 2) < left) mma_tf32(acc[nt], ah, bl[nt]);
#pragma unroll
      for (int nt = 0; nt < NP; ++nt)
        if (16 * (NP / 2 * hs + nt / 2) < left) mma_tf32(acc[nt], ah, bh[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < NP; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[NP * hs + nt][e] =
            fmaf(o[NP * hs + nt][e], corr[e >> 1], acc[nt][e]);
  }
}

// Row s_ of (batch b, head h): four columns from col of its O (`v`, summed
// over `l`, max `m` in exp2 units), to out (and lse) or, with splits > 1,
// unnormalised to the split's partials (with m and l).
__device__ __forceinline__ void f32_put(const Args& a, float* part,
                                        int splits, int split, int b, int h,
                                        int s_, int col, float4 v, float l,
                                        float m) {
  const long long R = (long long)a.B * a.Hq * a.Sq;   // rows, [B, Hq, Sq]
  const long long row = ((long long)b * a.Hq + h) * a.Sq + s_;
  if (splits > 1) {                     // merged by the finish kernel
    const long long pr = split * R + row;
    *reinterpret_cast<float4*>(part + pr * a.D + col) = v;
    if (col == 0) {
      part[splits * R * a.D + pr] = m;
      part[splits * R * (a.D + 1) + pr] = l;
    }
    return;
  }
  const float den = fmaxf(l, 1e-30f);
  *reinterpret_cast<float4*>(static_cast<float*>(a.o) +
                             (((long long)b * a.Sq + s_) * a.Hq + h) * a.D +
                             col) =
      make_float4(v.x / den, v.y / den, v.z / den, v.w / den);
  if (a.lse && col == 0)                // exp2 units back to natural log
    a.lse[row] = m == kNegInf ? kNegInf : (m + log2f(den)) * kLn2;
}

// One block a (split, q head, batch, q tile), q tiles longest first when
// causal, 8 warps (the plans: F32Plan).  Q loads once (TMA); the split's
// kv tiles stream in steps of KH keys, a step's n1 = ceil(D / 64) K chunks
// then its n1 V chunks, through a ring of ST stages: thread 0 copies chunk
// t + ST - 1 (TMA, completing on the stage's full mbarrier) into the stage
// chunk t - 1 held once every warp has released it (its empty mbarrier),
// so copies run ST - 1 chunks ahead.  Long plan: a warp whose rows all lie
// past Sq lands and releases each chunk and computes nothing.  Short plan:
// the warps exchange their rows' maxima once a step (named barrier 1,
// maxima double-buffered by step), and their O and l are summed in warp
// order at the end.  With splits > 1 each block writes its rows'
// unnormalised O, m and l to `part`; the finish kernel merges them.
template <int DMAX, bool SHORT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_f32_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const Args a, float* part, int splits) {
  using P = F32Plan<DMAX, SHORT>;
  constexpr int KH = P::KH, ST = P::ST, NC = DMAX / kF32DC;
  constexpr int NS = SHORT ? 1 : KH / 8;    // n8 tiles of S a warp
  constexpr int SPT = kF32BK / KH;          // steps a kv tile
  constexpr uint32_t kBox = KH * 128;       // bytes of a K or V box
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023u) & ~1023u;
  float* const qf = reinterpret_cast<float*>(smem + (sQ - smem_u32(smem)));
  const uint32_t ring = sQ + (DMAX / kF32Box) * kF32QBox;
  float* const red = qf + kF32BQ * DMAX + ST * 2 * KH * kF32Box;
  const uint32_t full = ring + ST * 2 * kBox + 4 * kF32Red;   // landed
  const uint32_t empty = full + 8 * ST;                        // released
  const uint32_t qbar = empty + 8 * ST;

  // block -> (split, pair = (head, batch), q tile rank)
  const int nq = (a.Sq + kF32BQ - 1) / kF32BQ, pairs = a.Hq * a.B;
  const int split = blockIdx.x % splits;
  const int pair = (int)(blockIdx.x / splits) % pairs;
  const int rank = (int)(blockIdx.x / splits) / pairs;
  const int qt = a.causal ? nq - 1 - rank : rank;
  const int h = pair % a.Hq, b = pair / a.Hq, hk = h % a.Hkv;
  const int q0 = qt * kF32BQ;
  int kb, ke, j0, j1;
  f32_kv_range(qt, a.Sq, a.Sk, a.causal, a.window, a.qoff, &kb, &ke);
  f32_split_range(kb, ke, split, splits, &j0, &j1);
  const int D = a.D, n1 = (D + kF32DC - 1) / kF32DC;
  const int T = (j1 - j0) * SPT * 2 * n1;  // chunks: each step's K, then V

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int band = SHORT ? 0 : w;           // the warp's rows: 16 band ..
  const bool live = SHORT || q0 + 16 * w < a.Sq;
  const int pw = a.qoff + q0 + 16 * band;   // the position of its first row

  // chunk t into ring stage t % ST (thread 0): the boxes that hold columns
  // below D
  auto issue = [&](int t) {
    const int j = t / (2 * n1), c = t - j * 2 * n1;
    const int cc = c < n1 ? c : c - n1;
    const uint32_t st = ring + (t % ST) * 2 * kBox;
    const uint32_t bar = full + 8 * (t % ST);
    const int boxes = cc * kF32DC + kF32Box < D ? 2 : 1;
    mbar_expect_tx(bar, boxes * kBox);
    for (int x = 0; x < boxes; ++x)
      tma_load(st + x * kBox, c < n1 ? &tk : &tv, bar,
               cc * kF32DC + x * kF32Box, (j0 * SPT + j) * KH, hk, b);
  };
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads / 32);   // lane 0 of each warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && T > 0) {
    const int nb = (D + kF32Box - 1) / kF32Box;
    mbar_expect_tx(qbar, nb * kF32QBox);
    for (int x = 0; x < nb; ++x)
      tma_load(sQ + x * kF32QBox, &tq, qbar, x * kF32Box, q0, h, b);
    for (int t = 0; t < ST - 1 && t < T; ++t) issue(t);
  }
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
  if (T > 0) mbar_wait(qbar, 0);
  // the long plan at DMAX = 64: the warp's Q fragments (one d-chunk) split
  // once into registers for the whole block
  constexpr bool QREG = DMAX == 64 && !SHORT;
  uint32_t qh[8][4], ql[8][4];
  if (QREG && T > 0 && live) {
    const int mm = lane >> 3, ii = lane & 7;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t ar[4];
      ldsm4(sQ + (ks >> 2) * kF32QBox +
                swz(16 * band + ii + 8 * (mm & 1),
                    8 * (ks & 3) + 4 * (mm >> 1)),
            ar);
#pragma unroll
      for (int e = 0; e < 4; ++e) split1(ar[e], qh[ks][e], ql[ks][e]);
    }
  }

  float o[NC][8][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][nt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * 1.4426950408889634f;   // scale * log2(e)
  const int kr = SHORT ? 8 * w : 0;         // the warp's first key of a step
  int t = 0;
  for (int js = j0 * SPT; js < j1 * SPT; ++js) {
    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    for (int c = 0; c < n1; ++c, ++t) {
      land(t);
      if (live)
        f32_scores<NS, QREG>(s, qh, ql, sQ + 2 * c * kF32QBox,
                             ring + (t % ST) * 2 * kBox, kBox, 16 * band, kr,
                             min(kF32DC, D - c * kF32DC) / 8);
      release(t);
    }

    // softmax of the step in exp2 units: scale, mask, running max over the
    // quad that holds a row (the short plan: then over the warps); a masked
    // score is -1e30, so a row with no live key yet gets exp2(0) = 1 for
    // every key, as in Pallas, else 0
    float corr[2] = {1.f, 1.f};
    if (live) {
      const int k0 = js * KH;
      const bool edge = k0 + KH > a.Sk || (a.causal && k0 + KH - 1 > pw) ||
                        (a.window > 0 && k0 <= pw + 15 - a.window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge) {
            const int kpos = k0 + kr + 8 * nt + 2 * q4 + (e & 1);
            const int qpos = pw + g + 8 * (e >> 1);
            const bool ok = kpos < a.Sk && (!a.causal || kpos <= qpos) &&
                            (a.window <= 0 || kpos > qpos - a.window);
            if (!ok) s[nt][e] = -INFINITY;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      if constexpr (SHORT) {
        float* rm = red + (js & 1) * 8 * 16;
        if (q4 == 0) {
          rm[w * 16 + g] = mx[0];
          rm[w * 16 + g + 8] = mx[1];
        }
        bar_sync(1);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = rm[g + 8 * r];
#pragma unroll
          for (int x = 1; x < 8; ++x) mx[r] = fmaxf(mx[r], rm[x * 16 + g + 8 * r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mt = mx[r] == -INFINITY ? kNegInf : mx[r] * sl2;
        const float m_new = fmaxf(m[r], mt);
        corr[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          s[nt][e] = s[nt][e] == -INFINITY ? ex2(kNegInf - m[r])
                                           : ex2(fmaf(s[nt][e], sl2, -m[r]));
          l[r] += s[nt][e];
        }
    }

#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < n1) {
        land(t);
        if (live)
          f32_pv<P::NP, NS>(o[c], s, corr, ring + (t % ST) * 2 * kBox, kBox,
                            kr, D - c * kF32DC);
        release(t);
        ++t;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (SHORT) {
    // the warps' O (in Q's room, slot i of lane ln at i * 32 + ln) and l
    // summed in warp order; slot (c, nt, e) is row g + 8 (e / 2), column
    // 64 c + 16 (nt / 2) + 4 q4 + 2 (e % 2) + nt % 2
    __syncthreads();                    // every warp is done with Q
    float* ow = qf + w * 16 * DMAX;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ow[((c * 8 + nt) * 4 + e) * 32 + lane] = o[c][nt][e];
    float* lw = red + 2 * 8 * 16;       // [8][16] the warps' l, then m
    if (q4 == 0) {
      lw[w * 16 + g] = l[0];
      lw[w * 16 + g + 8] = l[1];
      if (w == 0) {
        lw[8 * 16 + g] = m[0];
        lw[8 * 16 + g + 8] = m[1];
      }
    }
    __syncthreads();
    // thread tid: four columns of a row at a time (slots e, nt: 0 and 1)
    for (int f = tid; f < 4 * DMAX; f += kThreads) {
      const int ln = f & 31, rest = f >> 5;   // rest: (c, pair, hf)
      const int hf = rest & 1, p = (rest >> 1) & 3, c = rest >> 3;
      const int r = (ln >> 2) + 8 * hf;
      const int col = c * kF32DC + 16 * p + 4 * (ln & 3);
      if (q0 + r >= a.Sq || col >= D) continue;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      float ls = 0.f;
      const int s0 = (c * 8 + 2 * p) * 4 + 2 * hf;   // tile 2p, element 2 hf
      for (int x = 0; x < 8; ++x) {
        const float* ox = qf + x * 16 * DMAX;
        v.x += ox[s0 * 32 + ln];
        v.y += ox[(s0 + 4) * 32 + ln];
        v.z += ox[(s0 + 1) * 32 + ln];
        v.w += ox[(s0 + 5) * 32 + ln];
        ls += lw[x * 16 + r];
      }
      f32_put(a, part, splits, split, b, h, q0 + r, col, v, ls,
              lw[8 * 16 + r]);
    }
    return;
  }
  // rows q0 + 16 w + g + 8 hf; of chunk c, pair p the columns 64 c + 16 p
  // + 4 q4 .. + 3 (tiles 2p, 2p + 1 alternate)
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s_ = q0 + 16 * w + g + 8 * hf;
    if (s_ >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int col = c * kF32DC + 16 * p;
        if (c >= n1 || col >= D) continue;
        f32_put(a, part, splits, split, b, h, s_, col + 4 * q4,
                make_float4(o[c][2 * p][2 * hf], o[c][2 * p + 1][2 * hf],
                            o[c][2 * p][2 * hf + 1],
                            o[c][2 * p + 1][2 * hf + 1]),
                l[hf], m[hf]);
      }
  }
}

// out and lse of the split plan, one thread a row's 4 columns: the row's
// splits merged in split order -- their largest m, then each split's O and
// l rescaled to it and added in order --, out = O / max(l, 1e-30)
__global__ void __launch_bounds__(kThreads)
    flash_attn_f32_finish_kernel(const float* part, float* out, float* lse,
                                 int B, int Sq, int Hq, int D, int splits) {
  const int D4 = D / 4;
  const long long R = (long long)B * Hq * Sq;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= R * D4) return;
  const long long row = i / D4;
  const int c4 = (int)(i - row * D4);
  const float* pm = part + (long long)splits * R * D;
  const float* pl = pm + (long long)splits * R;
  float mt = pm[row];
  for (int s = 1; s < splits; ++s) mt = fmaxf(mt, pm[s * R + row]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float wt = ex2(pm[s * R + row] - mt);
    const float4 x =
        reinterpret_cast<const float4*>(part + (s * R + row) * D)[c4];
    l = fmaf(wt, pl[s * R + row], l);
    acc = make_float4(fmaf(wt, x.x, acc.x), fmaf(wt, x.y, acc.y),
                      fmaf(wt, x.z, acc.z), fmaf(wt, x.w, acc.w));
  }
  const float den = fmaxf(l, 1e-30f);
  const int s_ = (int)(row % Sq);
  const long long bh = row / Sq;
  const int h = (int)(bh % Hq), b = (int)(bh / Hq);
  reinterpret_cast<float4*>(out + (((long long)b * Sq + s_) * Hq + h) * D)[c4] =
      make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den);
  if (lse && c4 == 0)
    lse[row] = mt == kNegInf ? kNegInf : (mt + log2f(den)) * kLn2;
}

template <int DMAX, bool SHORT>
cudaError_t launch_f32(const Args& a, float* scratch, int splits,
                       cudaStream_t stream) {
  // the runtime's first call before the driver's (the tensor maps), as in
  // the backward: on a thread new to this library the other order failed
  constexpr size_t smem = f32_smem<DMAX, SHORT>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_f32_kernel<DMAX, SHORT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  constexpr int KH = F32Plan<DMAX, SHORT>::KH;
  if (!tensor_map_f32(enc, &tq, a.q, a.D, a.Sq, a.Hq, a.B, a.q_s, a.q_h,
                      a.q_b, kF32BQ) ||
      !tensor_map_f32(enc, &tk, a.k, a.D, a.Sk, a.Hkv, a.B, a.k_s, a.k_h,
                      a.k_b, KH) ||
      !tensor_map_f32(enc, &tv, a.v, a.D, a.Sk, a.Hkv, a.B, a.v_s, a.v_h,
                      a.v_b, KH))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)splits * a.Hq * a.B *
                           ((a.Sq + kF32BQ - 1) / kF32BQ);
  flash_attn_f32_kernel<DMAX, SHORT>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(tq, tk, tv, a, scratch,
                                                     splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = (long long)a.B * a.Hq * a.Sq * (a.D / 4);
  flash_attn_f32_finish_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                                 kThreads, 0, stream>>>(
      scratch, static_cast<float*>(a.o), a.lse, a.B, a.Sq, a.Hq, a.D, splits);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_f32(const Args& a, float* scratch, int splits,
                       cudaStream_t stream) {
  return a.Sq <= kF32Short ? launch_f32<DMAX, true>(a, scratch, splits, stream)
                           : launch_f32<DMAX, false>(a, scratch, splits,
                                                     stream);
}

bool bad_shape(int D, int Hq, int Hkv) {
  return D <= 0 || D % 16 || D > 256 || Hkv <= 0 || Hq % Hkv;
}

}  // namespace

extern "C" {

// The largest head dimension; D must be a multiple of 16.
int flash_attn_max_d() { return 256; }

// (head, batch) pairs per group of the bf16 kernel's launch order.
int flash_attn_head_group(int Sk, int D, int pairs) {
  return head_group(Sk, D, pairs);
}

// The bf16 kernel's tile plan for head dimension D: {DP, BK, STAGES}.
void flash_attn_bf16_plan(int D, int* plan) {
  const int dp = D <= 64 ? 64 : D <= 128 ? 128 : 256;
  plan[0] = dp;
  plan[1] = dp == 64 ? Plan<64>::BK : dp == 128 ? Plan<128>::BK
                                                : Plan<256>::BK;
  plan[2] = dp == 64 ? Plan<64>::STAGES : dp == 128 ? Plan<128>::STAGES
                                                    : Plan<256>::STAGES;
}

// The fp32 kernel's plan at head dimension D, long (short == 0) or short
// (Sq <= flash_attn_f32_short_rows()): {DMAX, q rows a block, keys a kv
// tile of the ranges, keys a step, ring stages, columns a d-chunk, n8
// tiles a pass of P V}.
void flash_attn_f32_plan(int D, int short_, int* plan) {
  const int dmax = f32_dmax(D);
  const int kh = dmax == 256 && !short_ ? 32 : 64;
  const int v[7] = {dmax, kF32BQ, kF32BK, kh, 4 * kF32BK / kh, kF32DC,
                    dmax == 256 ? 4 : 8};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
}

// Sq at which the fp32 kernel takes its short plan (at most this).
int flash_attn_f32_short_rows() { return kF32Short; }

// Shared-memory bytes of an fp32 block at head dimension D, long or short.
long long flash_attn_f32_smem(int D, int short_) {
  switch (f32_dmax(D)) {
    case 64: return (long long)(short_ ? f32_smem<64, true>()
                                       : f32_smem<64, false>());
    case 128: return (long long)(short_ ? f32_smem<128, true>()
                                        : f32_smem<128, false>());
    default: return (long long)(short_ ? f32_smem<256, true>()
                                       : f32_smem<256, false>());
  }
}

// The fp32 kernel's splits of each block's kv tiles on a card of `sms` SMs.
int flash_attn_f32_splits(int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                          int window, int q_offset, int sms) {
  return f32_splits(B, Sq, Sk, Hq, Hkv, causal, window, q_offset, sms);
}

// The kv tiles [range[0], range[1]) (of 64 keys) split `split` of `splits`
// of the fp32 kernel's q tile qt (of 128 rows) reads.
void flash_attn_f32_split_range(int qt, int split, int splits, int Sq, int Sk,
                                int causal, int window, int q_offset,
                                int* range) {
  int kb, ke;
  f32_kv_range(qt, Sq, Sk, causal, window, q_offset, &kb, &ke);
  f32_split_range(kb, ke, split, splits, range, range + 1);
}

// Floats of the fp32 kernel's scratch at `splits` (0 for one).
long long flash_attn_f32_scratch_floats(int B, int Sq, int Hq, int D,
                                        int splits) {
  return f32_scratch(B, Sq, Hq, D, splits);
}

// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (strides in elements, D contiguous);
// out: contiguous [B, Sq, Hq, D] of the same dtype; lse: null, or
// contiguous [B, Hq, Sq] fp32.  window <= 0: no window.  q row i sits at
// position q_offset + i (k and v at 0 .. Sk - 1) for the causal and window
// tests; the wrapper checks q_offset >= 0 and, when causal at an offset,
// q_offset + Sq <= Sk.  q, k and v 16-byte aligned with B, S and H strides
// multiples of 4 elements (TMA's rules; the wrapper copies any other
// layout once).  scratch: flash_attn_f32_scratch_floats floats at the
// splits flash_attn_f32_splits gives for `sms` (null when that is 0).
// Launches the kernel and, with splits > 1, the finish kernel.  Returns a
// cudaError_t.
int flash_attn_f32_launch(const void* q, const void* k, const void* v,
                          void* out, float* lse, int B, int Sq, int Sk,
                          int Hq, int Hkv, int D, long long q_b, long long q_s,
                          long long q_h, long long k_b, long long k_s,
                          long long k_h, long long v_b, long long v_s,
                          long long v_h, float scale, int causal, int window,
                          int q_offset, float* scratch, int sms,
                          void* stream) {
  if (bad_shape(D, Hq, Hkv) || sms <= 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(k) |
       reinterpret_cast<size_t>(v) | reinterpret_cast<size_t>(scratch)) % 16 ||
      (q_b | q_s | q_h | k_b | k_s | k_h | v_b | v_s | v_h) % 4)
    return (int)cudaErrorMisalignedAddress;
  const int splits =
      f32_splits(B, Sq, Sk, Hq, Hkv, causal, window, q_offset, sms);
  if (splits > 1 && !scratch) return (int)cudaErrorInvalidValue;
  const Args a{q,   k,   v,   out, lse, B,   Sq,  Sk,  Hq,  Hkv, D,
               q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, scale, causal,
               window, q_offset};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (f32_dmax(D)) {
    case 64: return (int)launch_f32<64>(a, scratch, splits, st);
    case 128: return (int)launch_f32<128>(a, scratch, splits, st);
    default: return (int)launch_f32<256>(a, scratch, splits, st);
  }
}

// As flash_attn_f32_launch for bf16, without scratch or SM count (one
// plan at every shape); the base pointers must be 16-byte aligned and the
// B, S and H strides multiples of 8.
int flash_attn_bf16_launch(const void* q, const void* k, const void* v,
                           void* out, float* lse, int B, int Sq, int Sk,
                           int Hq, int Hkv, int D, long long q_b,
                           long long q_s, long long q_h, long long k_b,
                           long long k_s, long long k_h, long long v_b,
                           long long v_s, long long v_h, float scale,
                           int causal, int window, int q_offset,
                           void* stream) {
  if (bad_shape(D, Hq, Hkv)) return (int)cudaErrorInvalidValue;
  const size_t ptrs = reinterpret_cast<size_t>(q) |
                      reinterpret_cast<size_t>(k) |
                      reinterpret_cast<size_t>(v) |
                      reinterpret_cast<size_t>(out);
  if (ptrs % 16 || (q_b | q_s | q_h | k_b | k_s | k_h | v_b | v_s | v_h) % 8)
    return (int)cudaErrorMisalignedAddress;
  const Args a{q,   k,   v,   out, lse, B,   Sq,  Sk,  Hq,  Hkv, D,
               q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, scale, causal,
               window, q_offset};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return (int)launch_bf16<64>(a, st);
  if (D <= 128) return (int)launch_bf16<128>(a, st);
  return (int)launch_bf16<256>(a, st);
}

}  // extern "C"
