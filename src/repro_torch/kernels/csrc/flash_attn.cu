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
// bf16 rate.  Two kernels, picked by the wrapper by dtype:
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
// flash_attn_f32_kernel (fp32 inputs): the products as fp32 FMAs on the
//   CUDA cores (TF32 tensor cores would miss the fp32 tolerance).  One
//   block of 256 threads per (64 q rows, q head, batch); each tile of 64
//   keys and values staged in shared memory; thread (ty, tx) of a 16 x 16
//   grid owns q rows 4ty..4ty+3 and, of the 64 x 64 score tile, columns
//   tx + 16c; of the [64, D] accumulator, columns tx + 16c; row max and sum
//   over the row's 16 threads by a fixed shuffle tree.  Read through any
//   strides (D contiguous).
//
// Both: a row wholly masked in a tile that runs gets exp(0) = 1 for every
// key while its max is still -1e30, and the first tile with a real key
// multiplies that away by exp(-1e30 - m) = 0, as in Pallas.  The output is
// acc / max(l, 1e-30), contiguous [B, Sq, Hq, D] in the inputs' dtype.
// With a non-null `lse` (training: the backward kernels of
// flash_attn_bwd.cu read it) each row's log-sum-exp of its scaled scores,
// m + log l in natural-log units, goes to lse [B, Hq, Sq] fp32 (the bf16
// kernel's m and l are in its exp2 units: (m + log2 l) ln 2); a row with no
// live key keeps the -1e30 fill's m (about -1e30).  A null `lse` (serving)
// writes nothing more, and the output's bits do not change.

#include <math.h>

#include "hopper.cuh"

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
// fp32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32BQ = 64;        // q rows per block
constexpr int kF32BK = 64;        // keys per kv tile

__device__ __forceinline__ float max16(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t f32_smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)kF32BQ * (D + 1) + (size_t)kF32BK * (D + 1) +
          (size_t)kF32BK * D + (size_t)kF32BQ * (kF32BK + 1));
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_attn_f32_kernel(const Args a) {
  extern __shared__ __align__(16) float fsmem[];
  const int D = a.D;
  const int ldq = D + 1, ldk = D + 1, ldv = D, ldp = kF32BK + 1;
  float* Qs = fsmem;                      // [kF32BQ][D+1], scaled
  float* Ks = Qs + kF32BQ * ldq;          // [kF32BK][D+1]
  float* Vs = Ks + kF32BK * ldk;          // [kF32BK][D]
  float* Ps = Vs + kF32BK * ldv;          // [kF32BQ][kF32BK+1]

  const int q0 = blockIdx.x * kF32BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* q = static_cast<const float*>(a.q) + b * a.q_b + h * a.q_h;
  const float* k =
      static_cast<const float*>(a.k) + b * a.k_b + (h % a.Hkv) * a.k_h;
  const float* v =
      static_cast<const float*>(a.v) + b * a.v_b + (h % a.Hkv) * a.v_h;

  for (int e = tid; e < kF32BQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D, s = q0 + r;
    Qs[r * ldq + d] = s < a.Sq ? q[s * a.q_s + d] * a.scale : 0.f;
  }

  const int p0 = a.qoff + q0;       // the position of row q0
  int kt_end = (a.Sk + kF32BK - 1) / kF32BK;
  if (a.causal) kt_end = min(kt_end, (p0 + kF32BQ - 1) / kF32BK + 1);
  int kt_begin = 0;
  if (a.window > 0) {
    const int lo = p0 - a.window - kF32BK + 2;
    if (lo > 0) kt_begin = (lo + kF32BK - 1) / kF32BK;
  }

  constexpr int NC = DMAX / 16;
  const int nc = D / 16;
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kF32BK;
    __syncthreads();                  // the last tile's readers are done
    for (int e = tid; e < kF32BK * D; e += kThreads) {
      const int j = e / D, d = e - j * D, s = k0 + j;
      const bool in = s < a.Sk;
      Ks[j * ldk + d] = in ? k[s * a.k_s + d] : 0.f;
      Vs[j * ldv + d] = in ? v[s * a.v_s + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * ldq + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * ldk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = p0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        const bool ok = kpos < a.Sk && (!a.causal || kpos <= qpos) &&
                        (a.window <= 0 || kpos > qpos - a.window);
        sc[i][c] = ok ? sc[i][c] : kNegInf;
        mx = fmaxf(mx, sc[i][c]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(sc[i][c] - m_new);
        Ps[(4 * ty + i) * ldp + tx + 16 * c] = p;
        rs += p;
      }
      l[i] = l[i] * corr + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < kF32BK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * ty + i) * ldp + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nc) {
          const float vv = Vs[j * ldv + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

  float* o = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * ty + i;
    if (s >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (a.lse && tx == 0)
      a.lse[((long long)b * a.Hq + h) * a.Sq + s] = m[i] + logf(den);
    float* row = o + (((long long)b * a.Sq + s) * a.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < nc) row[tx + 16 * c] = acc[i][c] / den;
  }
}

template <int DMAX>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(a.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_f32_kernel<DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kF32BQ - 1) / kF32BQ, a.Hq, a.B);
  flash_attn_f32_kernel<DMAX><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
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

// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (strides in elements, D contiguous);
// out: contiguous [B, Sq, Hq, D] of the same dtype; lse: null, or
// contiguous [B, Hq, Sq] fp32.  window <= 0: no window.  q row i sits at
// position q_offset + i (k and v at 0 .. Sk - 1) for the causal and window
// tests; the wrapper checks q_offset >= 0 and, when causal at an offset,
// q_offset + Sq <= Sk.  Returns a cudaError_t.
int flash_attn_f32_launch(const void* q, const void* k, const void* v,
                          void* out, float* lse, int B, int Sq, int Sk,
                          int Hq, int Hkv, int D, long long q_b, long long q_s,
                          long long q_h, long long k_b, long long k_s,
                          long long k_h, long long v_b, long long v_s,
                          long long v_h, float scale, int causal, int window,
                          int q_offset, void* stream) {
  if (bad_shape(D, Hq, Hkv)) return (int)cudaErrorInvalidValue;
  const Args a{q,   k,   v,   out, lse, B,   Sq,  Sk,  Hq,  Hkv, D,
               q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, scale, causal,
               window, q_offset};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return (int)launch_f32<64>(a, st);
  if (D <= 128) return (int)launch_f32<128>(a, st);
  return (int)launch_f32<256>(a, st);
}

// As flash_attn_f32_launch for bf16; besides, the base pointers must be
// 16-byte aligned and the B, S and H strides multiples of 8.
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
