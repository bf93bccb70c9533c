// Backward of the Mamba2 SSD scan for Hopper (sm_90a), built by
// repro_torch/kernels/build.py with nvcc into a shared library with a plain
// C interface and called through ctypes from repro_torch/kernels/ssd_scan.py
// (ssd_scan_backward).  Compiled without --use_fast_math.
//
// Replaces no TPU kernel: the JAX package differentiates its SSD scan by XLA
// autodiff of repro/nn/ssm.py::ssd_chunked.  It gives dx, ddt, dA, dB and
// dC of ssd_scan (csrc/ssd_scan.cu) from dy and the final state's gradient
// dhfin (zero when null).  The wrapper first runs the forward's kernels 1-3
// again (ssd_scan_states_launch: the state before each chunk h_prev, C B^T,
// exp(tot) of each chunk, the final state); then, per (batch, head h,
// chunk) with positions i, j in the chunk, cum the cumulative -A dt, tot =
// cum_{l-1}, xd_j = x_j dt_j, K = C B^T of h's group, L_ij = exp(cum_i -
// cum_j)[j <= i], D_ij = dy_i . xd_j and W = K ⊙ L ⊙ D:
//   1. ssd_bwd_chunk_dstates, one block per (head, chunk, batch):
//        gst_c = dy^T @ (exp(cum) ⊙ C)                           [P, N]
//      the gradient that chunk c's outputs send to h_prev; it also writes
//      cum to a [b, H, S] scratch that kernels 3 and 4 read.
//   2. ssd_bwd_state_pass, 256 four-entry chains of a (batch, head) a
//      block: g <- g exp(tot_c) + gst_c backwards over the chunks from g =
//      dhfin, storing g_c (the gradient of the state after chunk c) in
//      place, and a warp's sum of g_c ⊙ (state after chunk c) a chunk.
//   3. ssd_bwd_chunk_dx, one block per (heads_per_block heads, 64 rows j,
//      chunk, batch):
//        dxd = [(K ⊙ L)^T | exp(tot - cum) ⊙ B] @ [dy ; g^T]      [l, P]
//      (the forward's output kernel run backwards in time), dx = dt dxd,
//      s = x . dxd, and dcum's carried-state terms q = dy . (exp(cum) ⊙ C
//      @ h_prev^T) - xd . (exp(tot - cum) ⊙ B @ g^T).
//   4. ssd_bwd_chunk_dbc, a cluster of `ranks` 512-thread blocks per (slice
//      of a group's heads, group, chunk, batch): one rank at N <= 64, two
//      above, each owning half of D's 16 x 8 tiles j <= i and half of the N
//      columns.  Per head it forms L ⊙ D once, tile by tile in registers,
//      and from those tiles takes W's row sums off the diagonal (wrow_k =
//      sum_{j < k} W_kj) and its column sums (wcol_k = sum_{i > k} W_ik),
//      the rank's share of each, and adds them to S = sum over the slice's
//      heads of L ⊙ D in shared memory; beside it the carried-state terms
//        dC_i += exp(cum_i) h_prev^T dy_i,   dB_j += exp(tot - cum_j) g^T xd_j
//      sum in registers.  After the slice the ranks swap their tiles of S
//      (distributed shared memory) and each adds
//        dC += S @ B,   dB += S^T @ C
//      for its columns: B and C are shared by the group's heads, so the
//      l x l products run once a slice, not once a head.  Each slice
//      writes partial dB and dC ([slices, b, S, G, N]); the slice count
//      comes from the card's SM count (bwd_slices).
//   5. ssd_bwd_finish, one warp per (batch, head, chunk):
//        dcum = (wrow - wcol) + q, plus sum g ⊙ (state after the chunk) at
//        the last position; da its suffix sums; ddt = s - A da; a partial
//        of dA = -sum dt da.
//   6. ssd_bwd_sums: dA[h] = the partials summed over (batch, chunk); dB
//      and dC the slices' partials summed in slice order.
// Over a chunk the row sums of W minus its column sums add up to zero, and
// with a large dt its diagonal is most of each: wrow and wcol leave W_kk
// out of both, so it cancels exactly, as in the plain version's W.sum(-1)
// - W.sum(-2), and the products that feed them are split TF32.  The
// scratch of per-position terms (q, s, wrow, wcol) is [b, H, S], so that
// the blocks that write a head's chunk and the finish that reads it touch
// contiguous positions.
//
// Exponents as in the forward: every factor is exp(cum_i - cum_j) with
// j <= i, exp(tot - cum_j), exp(cum_i) or exp(tot), so it is <= 1.
// Products: split TF32 on mma.sync m16n8k8 (ssd_common.cuh).  Kernel 4's
// accumulators and kernel 3's intra part (which feeds dx and s alone) take
// a_lo b_hi, a_hi b_lo and a_hi b_hi in one chain, for the register budget
// (dB and dC stay near 5e-6 of fp64, dx near 2e-6); kernel 1 and kernel
// 3's yint and inter keep hi and lo apart: in one chain the tensor cores'
// fp32 sums cost dA, through q, a factor of four at a large dt.  Kernel 4
// reads its A operands and D's x rows in pairs of columns (mma_pairs).
// TF32 wgmma wants both operands K-major in shared memory and split ahead
// of time (B's hi and lo as two tiles): D's tiles are cut to j <= i and
// spread over the ranks, S^T @ C, the carried terms of dB and the intra
// part of dx read B down its columns, and the budget has no room for the
// extra tiles at N = 128; mma.sync serves all of them from the same
// layouts.  Every sum runs in a fixed order, no atomics: two launches give
// the same bits.
//
// Loads ahead of products.  Kernels 3 and 4 hold one buffer of each tile
// and issue the next copy into it (cp.async) as soon as the phase that
// reads it ends, so every copy has a phase of products to land in.
// Kernel 4 runs dB's carried part (x, g), then D (x, dy), then dC's
// carried part (dy, h_prev); kernel 3 runs the intra part over the first
// half of the rows i (dy), yint (h_prev), the intra part over the second
// half (dy), inter (g).  dt and cum take two buffers.
//
// What bounds it on this card: operations.  At zamba2-1.2b's training call
// (b = 2, S = 4096, H = 64, P = N = 64, G = 1, l = 128) the function is
// ~39 GFLOP counted once (~0.24 ms at split TF32's 165 TFLOP/s) against
// ~0.17 ms of inputs and outputs at 3.35 TB/s; the scratch adds the states
// and g (134 MB each, each written twice and read twice).  The kernels
// issue some six instructions per mma.sync (fragment loads, splits,
// factors), which holds kernels 3 and 4 well below the tensor cores' rate.
// Shared memory at l = 128, N = 64 / 128: dstates 74 KB (three blocks an
// SM), dx 111 / 159 KB (two blocks an SM at N = 64, one at N = 128, where
// B's and C's 64 rows of 128 columns take 66 KB of it), dB/dC 225 / 207 KB
// (one block an SM).  Limits (raised by the wrapper): l <= 128, N <= 128,
// P a multiple of 16 up to 64.

#include <cooperative_groups.h>

#include "ssd_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxP = kCols;       // head dimension
constexpr int kDbcThreads = 512;   // kernel 4: 16 warps
constexpr int kSmemSM = 233472;    // shared memory of an SM
constexpr int kReservedSmem = 1024;  // kept by the runtime for each block
constexpr int kDbcTiles = 4;       // 8-column tiles of dB and of dC a warp owns
constexpr int kRp = 17;            // row stride of W's row sums by column tile
constexpr int kCp = 9;             // and of its column sums by row band

struct BwdArgs {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* dy;
  const float* dhfin;   // [b, H, P, N] or null (zero)
  const float* hfin;    // [b, H, P, N]: the final state, recomputed
  const float* hprev;   // [b, nc, H, P, N]: the state before each chunk
  const float* cb;      // [b, nc, G, LP, LP]: C B^T
  const float* dec;     // [b, H, nc]: exp(tot) of each chunk
  float* gst;           // [b, nc, H, P, N]: dy's pull on h_prev, then g_c
  float* lastp;         // [b, H, nc, W]: warp sums of g_c ⊙ state after c
  float* cum;           // [b, H, S]: cum of each chunk
  float* q;             // [b, H, S]: the carried-state terms of dcum
  float* sdot;          // [b, H, S]: x . dxd
  float* wrow;          // [ranks, b, H, S]: sum_{j < k} W_kj, a rank's share
  float* wcol;          // [ranks, b, H, S]: sum_{i > k} W_ik, likewise
  float* pdB;           // [slices, b, S, G, N]: a slice's part of dB
  float* pdC;           // [slices, b, S, G, N]: and of dC
  float* dap;           // [b, nc, H]: partials of dA
  float* dx;            // [b, S, H, P]
  float* ddt;           // [b, S, H]
  float* dA;            // [H]
  float* dB;            // [b, S, G, N]
  float* dC;            // [b, S, G, N]
  int S, H, P, G, N, l;
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, B_b, B_s, B_g, C_b, C_s, C_g,
      dy_b, dy_s, dy_h;
};

struct DstatesLayout {             // offsets in floats into shared memory
  int LP, dts, cum, edec, Y, Cs, total;
  __host__ __device__ explicit DstatesLayout(int l) {
    LP = round_up(l, 16);
    dts = 0;
    cum = dts + LP;
    edec = cum + LP;               // exp(cum)    [LP]
    Y = edec + LP;                 // dy          [LP][kLdRow]
    Cs = Y + LP * kLdRow;          // C           [LP][kLdRow]
    total = Cs + LP * kLdRow;
  }
};

// Kernel 3: K's columns and B's and C's rows for the block; then one buffer
// for half of a head's dy rows (i >= j0 in two halves) and one for g or
// h_prev, each refilled a phase ahead.
struct DxLayout {
  int LP, NP, ldk, KT, Bb, Cb, dts, cum, fac, Y, GH, red, total;
  __host__ __device__ DxLayout(int l, int N) {
    LP = round_up(l, 16);
    NP = round_up(N, 8);
    ldk = NP + 4;
    KT = 0;                        // C B^T, 64 columns j    [LP][kLdRow]
    Bb = KT + LP * kLdRow;         // B rows j                [kRows][ldk]
    Cb = Bb + kRows * ldk;         // C rows j                [kRows][ldk]
    dts = Cb + kRows * ldk;        // dt of two heads         [2][LP]
    cum = dts + 2 * LP;            // cum of two heads        [2][LP]
    fac = cum + 2 * LP;            // column factors          [kRows / 16][LP]
    Y = fac + kRows / 16 * LP;     // half of dy's rows i     [kRows][kLdRow]
    GH = Y + kRows * kLdRow;       // g or h_prev             [kMaxP][ldk]
    red = GH + kMaxP * ldk;        // row dots of two halves  [kRows][2][3]
    total = red + kRows * 6;
  }
};

// Kernel 4.  A block is one rank of a cluster of `ranks` (1 at N <= 64,
// where a block holds every column's sums; 2 above, each rank half the
// columns and half of D's units).  A rank's columns: NH (N / ranks rounded
// up to 8) from r NH.  C (for dB's last product) is copied over x once the
// last head has read it, B (for dC's) over dy.  K at the elements of the
// rank's units of D: the unit's 32 lanes' four values, in unit order.
__host__ __device__ inline int dbc_ranks(int N) { return N <= 64 ? 1 : 2; }

struct DbcLayout {
  int LP, NH, ldS, ldx, ldh, S, X, G, Y, Hp, Ks, dts, cum, rp, cp, total;
  __host__ __device__ DbcLayout(int l, int N) {
    const int ranks = dbc_ranks(N);
    LP = round_up(l, 16);
    NH = round_up((N + ranks - 1) / ranks, 8);
    ldS = LP + 8;                  // pairs along rows: == 8 mod 16
    ldx = kMaxP + 8;               // likewise
    ldh = round_up(NH, 32) + 4;    // pairs of rows: 2 ldh == 8 mod 32
    const int nb = LP / 16, T = nb * (nb + 1);
    S = 0;                         // sum of L ⊙ D          [LP][ldS]
    X = S + LP * ldS;              // x                     [LP][ldx]
    G = X + LP * ldx;              // g, the rank's columns [kMaxP][ldh]
    Y = G + kMaxP * ldh;           // dy                    [LP][ldx]
    Hp = Y + LP * ldx;             // h_prev, likewise      [kMaxP][ldh]
    Ks = Hp + kMaxP * ldh;         // K at the rank's units [units][128]
    dts = Ks + (ranks == 2 ? T - T / 2 : T) * 128;
    cum = dts + 2 * LP;            // dt, cum of two heads  [2][LP] each
    rp = cum + 2 * LP;             // W's row sums by 8 columns j  [LP][kRp]
    cp = rp + LP * kRp;            // W's column sums by 16 rows i [LP][kCp]
    total = cp + LP * kCp;
  }
};

// n of a strided column (stride in floats) into dst[0..LP), zero past n.
__device__ __forceinline__ void copy_col(float* dst, const float* src,
                                         long long stride, int n, int LP,
                                         int tid, int nthreads) {
  for (int i = tid; i < LP; i += nthreads)
    cp_async4(dst + i, i < n ? src + i * stride : src, i < n ? 4 : 0);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ const float* dt_col(const BwdArgs& a, int b, int h,
                                               int s0) {
  return a.dt + b * a.dt_b + (long long)s0 * a.dt_s + h * a.dt_h;
}

__device__ __forceinline__ const float* cum_col(const BwdArgs& a, int b,
                                                int h, int s0) {
  return a.cum + ((long long)b * a.H + h) * a.S + s0;
}

// One warp: acc[t] += A[16 rows][k steps ks0..ks1) @ B[..][8 columns from
// 8t] for t < nt, split TF32 into one accumulator a tile (a_lo b_hi, a_hi
// b_lo, a_hi b_hi).  The fragment's columns q and q + 4 of step ks are
// k = 8 ks + 2q and 8 ks + 2q + 1 (a permutation of the step's eight, the
// same in A and B), so that a lane reads its A pair in one 8-byte load:
// a2(u, k) = {A(g + 8u, k), A(g + 8u, k + 1)} for even k, b(k, c) =
// B(k, c).
template <int NT, class A2Fn, class BFn>
__device__ __forceinline__ void mma_pairs(float (&acc)[NT][4], A2Fn a2, BFn b,
                                           int nt, int ks0, int ks1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll 2
  for (int ks = ks0; ks < ks1; ++ks) {
    const int k = 8 * ks + 2 * q;
    uint32_t ah[4], al[4];
    const float2 r0 = a2(0, k), r1 = a2(1, k);
    split_tf32(r0.x, ah[0], al[0]);
    split_tf32(r1.x, ah[1], al[1]);
    split_tf32(r0.y, ah[2], al[2]);
    split_tf32(r1.y, ah[3], al[3]);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t >= nt) break;
      uint32_t bh[2], bl[2];
      split_tf32(b(k, 8 * t + g), bh[0], bl[0]);
      split_tf32(b(k + 1, 8 * t + g), bh[1], bl[1]);
      mma_tf32(acc[t], al, bh);
      mma_tf32(acc[t], ah, bl);
      mma_tf32(acc[t], ah, bh);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3)
    ssd_bwd_chunk_dstates(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int l = a.l, N = a.N, P = a.P;
  const DstatesLayout lay(l);
  const int LP = lay.LP;
  float* dts = smem + lay.dts;
  float* cum = smem + lay.cum;
  float* edec = smem + lay.edec;
  float* Y = smem + lay.Y;
  float* Cs = smem + lay.Cs;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int grp = h / (a.H / a.G), s0 = c * l;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int band = warp >> 1, half = warp & 1, g = lane >> 2, q = lane & 3;
  const float* dyg = a.dy + b * a.dy_b + (long long)s0 * a.dy_s + h * a.dy_h;
  const float* Cg = a.C + b * a.C_b + (long long)s0 * a.C_s + grp * a.C_g;
  float* st = a.gst + (((long long)b * nc + c) * a.H + h) * P * N;

  auto copy_dy = [&](int p0) {
    copy_tile(Y, kLdRow, dyg + p0, a.dy_s, LP, kCols,
              [&](int i) { return i < l ? min(kCols, P - p0) : 0; }, tid,
              kThreads);
  };
  auto copy_c = [&](int n0) {
    copy_tile(Cs, kLdRow, Cg + n0, a.C_s, LP, kCols,
              [&](int i) { return i < l ? min(kCols, N - n0) : 0; }, tid,
              kThreads);
  };
  copy_col(dts, dt_col(a, b, h, s0), a.dt_s, l, LP, tid, kThreads);
  copy_dy(0);
  copy_c(0);
  cp_async_wait_all();
  __syncthreads();
  if (warp == 0) chunk_cum(dts, cum, -a.A[h], LP);
  __syncthreads();
  float* cumg = a.cum + ((long long)b * a.H + h) * a.S + s0;
  for (int i = tid; i < LP; i += kThreads) {
    edec[i] = i < l ? expf(cum[i]) : 0.f;
    if (i < l) cumg[i] = cum[i];
  }

  for (int p0 = 0; p0 < P; p0 += kCols) {
    for (int n0 = 0; n0 < N; n0 += kCols) {
      __syncthreads();             // edec written; the last tile read
      if (p0 || n0) {
        if (n0 == 0) copy_dy(p0);
        copy_c(n0);
        cp_async_wait_all();
        __syncthreads();
      }
      // gst[p][n] = sum_i dy[i][p] (C[i][n] exp(cum_i)): rows p, k = i,
      // columns n
      float hi[4][4] = {}, lo[4][4] = {};
      const float* yw = Y + 16 * band + g;
      const float* cw = Cs + 32 * half;
      warp_mma(hi, lo, [&](int u, int i) { return yw[i * kLdRow + 8 * u]; },
               [&](int i, int cc) { return cw[i * kLdRow + cc] * edec[i]; },
               0, LP / 8);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = p0 + 16 * band + g + 8 * r;
          const int n = n0 + 32 * half + 8 * t + 2 * q;
          const float2 v = tile_sum(hi, lo, t, r);
          if (p >= P) continue;
          if (n < N) st[(long long)p * N + n] = v.x;
          if (n + 1 < N) st[(long long)p * N + n + 1] = v.y;
        }
    }
  }
}

// Block (x, b h): the four-entry chains x * 256 + tid of (batch, head) bh,
// backwards over the chunks with eight loads in flight.  A warp covers 128
// entries of one (batch, head); lanes past P N / 4 carry zeros.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_state_pass(const BwdArgs a, int nc, int W) {
  const int PN4 = a.P * a.N / 4;
  const int e4 = blockIdx.x * kThreads + threadIdx.x, lane = threadIdx.x & 31;
  const long long bh = blockIdx.y;
  const long long b = bh / a.H, h = bh - b * a.H;
  if ((e4 & ~31) >= PN4) return;               // a warp past the entries
  const bool live = e4 < PN4;
  const int e = live ? e4 : 0;
  const long long cs = (long long)a.H * PN4;     // one chunk, in float4
  float4* gs = reinterpret_cast<float4*>(a.gst) + (b * nc * a.H + h) * PN4 + e;
  const float4* hp = reinterpret_cast<const float4*>(a.hprev)
      + (b * nc * a.H + h) * PN4 + e;
  const float* dec = a.dec + bh * nc;
  float* part = a.lastp + bh * nc * W + (e4 >> 5);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 run = live && a.dhfin
      ? reinterpret_cast<const float4*>(a.dhfin)[bh * PN4 + e] : zero;
  float4 after = live ? reinterpret_cast<const float4*>(a.hfin)[bh * PN4 + e]
                      : zero;
  constexpr int kAhead = 8;
  for (int c0 = nc - 1; c0 >= 0; c0 -= kAhead) {
    float4 s[kAhead], hv[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 - k;
      s[k] = hv[k] = zero;
      if (live && c >= 0) {
        s[k] = gs[c * cs];
        if (c > 0) hv[k] = hp[c * cs];
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 - k;
      if (c < 0) break;
      if (live) gs[c * cs] = run;
      const float v = warp_sum(dot4(run, after));
      if (lane == 0) part[(long long)c * W] = v;
      const float d = dec[c];
      run = make_float4(run.x * d + s[k].x, run.y * d + s[k].y,
                        run.z * d + s[k].z, run.w * d + s[k].w);
      after = hv[k];
    }
  }
}

// dxd_j = sum_{i >= j} C B^T[i][j] exp(cum_i - cum_j) dy_i       (intra)
//       + exp(tot - cum_j) g B_j                                   (inter)
// for a warp's 16-row band of j from j_b: the rows i past the band take
// the decay as exp(cum_i - cum_r) exp(cum_r - cum_j) with r = j_b + 15 (a
// column factor fac[band][i] and a row factor, both <= 1); the band's own
// 16 x 16 diagonal block takes exp(cum_i - cum_j) per element, masked to
// i >= j.  Beside it the carried state's part of the outputs,
// yint_j = exp(cum_j) h_prev C_j, for dcum's terms dy_j . yint_j and
// xd_j . inter_j (x and dy of the row read from device memory while the
// products run).  One block walks through heads_per_block heads, C B^T's
// columns and B's and C's rows copied once.  A head takes four phases,
// each reading one buffer while the other fills: the intra part over the
// first half of the rows i (dy), yint (h_prev), the intra part over the
// second half (dy), inter (g).
template <int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ssd_bwd_chunk_dx(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int l = a.l, N = a.N, P = a.P;
  const DxLayout lay(l, N);
  const int LP = lay.LP, NP = lay.NP, ldk = lay.ldk;
  float* KT = smem + lay.KT;
  float* Bb = smem + lay.Bb;
  float* Cb = smem + lay.Cb;
  float* dts = smem + lay.dts;
  float* cum = smem + lay.cum;
  float* fac = smem + lay.fac;
  float* Y = smem + lay.Y;
  float* GH = smem + lay.GH;
  float* red = smem + lay.red;

  const int nrb = (LP + kRows - 1) / kRows, nc = gridDim.y / nrb;
  const int c = blockIdx.y / nrb, b = blockIdx.z;
  const int j0 = (blockIdx.y % nrb) * kRows, s0 = c * l;
  const int hg = heads_per_block(a.H, a.G), h0 = blockIdx.x * hg;
  const int grp = h0 / (a.H / a.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int band = warp >> 1, half = warp & 1, g = lane >> 2, q = lane & 3;
  const float* cbg = a.cb + (((long long)b * nc + c) * a.G + grp) * LP * LP;
  const float* Bg = a.B + b * a.B_b + (long long)s0 * a.B_s + grp * a.B_g;
  const float* Cg = a.C + b * a.C_b + (long long)s0 * a.C_s + grp * a.C_g;
  // the rows i >= j0 in two halves [lo[0], lo[1]) and [lo[1], LP)
  const int LPj = LP - j0;
  const int lo[2] = {j0, j0 + min(kRows, round_up((LPj + 1) / 2, 16))};

  // dy's rows of half u of head h0 + k (u = 0: dt and cum into slot k & 1)
  auto load_y = [&](int k, int u) {
    const int h = h0 + k, r0 = lo[u], r1 = u ? LP : lo[1];
    if (u == 0) {
      copy_col(dts + (k & 1) * LP, dt_col(a, b, h, s0), a.dt_s, l, LP, tid,
               kThreads);
      copy_col(cum + (k & 1) * LP, cum_col(a, b, h, s0), 1, l, LP, tid,
               kThreads);
    }
    copy_tile(Y, kLdRow,
              a.dy + b * a.dy_b + (long long)(s0 + r0) * a.dy_s + h * a.dy_h,
              a.dy_s, r1 - r0, kCols,
              [&](int r) { return r0 + r < l ? P : 0; }, tid, kThreads);
  };
  // h_prev (u = 0) or g (u = 1) of head h0 + k
  auto load_gh = [&](int k, int u) {
    const long long st = (((long long)b * nc + c) * a.H + h0 + k) * P * N;
    copy_tile(GH, ldk, (u ? a.gst : a.hprev) + st, N, kMaxP, NP,
              [&](int p) { return p < P ? N : 0; }, tid, kThreads);
  };
  // C B^T[i][j0 + jj] for i >= j0, every column jj < 64 that exists
  copy_tile(KT + j0 * kLdRow, kLdRow, cbg + (long long)j0 * LP + j0, LP, LPj,
            kCols, [&](int) { return min(kCols, LPj); }, tid, kThreads);
  copy_tile(Bb, ldk, Bg + (long long)j0 * a.B_s, a.B_s, kRows, NP,
            [&](int r) { return j0 + r < l ? N : 0; }, tid, kThreads);
  copy_tile(Cb, ldk, Cg + (long long)j0 * a.C_s, a.C_s, kRows, NP,
            [&](int r) { return j0 + r < l ? N : 0; }, tid, kThreads);
  load_y(0, 0);
  cp_async_commit();
  load_gh(0, 0);
  cp_async_commit();

  // this thread's rows j0 + 16 band + g + 8u, u = 0, 1
  const int jb = j0 + 16 * band, ju[2] = {jb + g, jb + g + 8};
  const bool live = jb < l;
  const int jr = jb + 15;                      // the band's reference row
  const float* ktw = KT + 16 * band + g;
  const float* bbw = Bb + (16 * band + g) * ldk;
  const float* cbw = Cb + (16 * band + g) * ldk;
  const float* facw = fac + band * LP;
  for (int k = 0; k < hg; ++k) {
    const int h = h0 + k;
    const float* dtk = dts + (k & 1) * LP;
    const float* cuk = cum + (k & 1) * LP;
    // cum past the chunk's end stays at its last value (dt is zero there)
    auto cm = [&](int i) { return cuk[min(i, l - 1)]; };
    float intra_acc[4][4] = {};    // hi and lo in one chain: dx and s only
    float dots[2][3] = {};         // per row: x . dxd, x . inter, dy . yint
    // the intra part over the rows of half u, from the buffer's dy
    auto intra = [&](int u) {
      if (!live) return;
      const int r0 = lo[u], r1 = u ? LP : lo[1];
      float cj[2], er[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        cj[v] = cm(ju[v]);
        er[v] = expf(cm(jr) - cj[v]);
      }
      auto diag = [&](int v, int i) {        // the band's diagonal block
        return i >= ju[v] ? ktw[i * kLdRow + 8 * v] * expf(cm(i) - cj[v])
                          : 0.f;
      };
      auto past = [&](int v, int i) {        // rows i past the band
        return ktw[i * kLdRow + 8 * v] * er[v] * facw[i];
      };
      auto yr = [&](int i, int cc) {
        return Y[(i - r0) * kLdRow + 32 * half + cc];
      };
      const int d0 = max(jb / 8, r0 / 8), d1 = min(jb / 8 + 2, r1 / 8);
      const int p0 = max(jb / 8 + 2, r0 / 8), p1 = r1 / 8;
      if (d0 < d1) warp_mma(intra_acc, intra_acc, diag, yr, d0, d1);
      if (p0 < p1) warp_mma(intra_acc, intra_acc, past, yr, p0, p1);
    };
    // x or dy at this thread's outputs: read while a product runs at one
    // block an SM; after it at two, where the other block's products hide
    // the wait and the product keeps the registers
    auto rows_of = [&](const float* base, long long bs, long long ss,
                       long long hs, float (&v)[2][4][2]) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = ju[r], p = 32 * half + 8 * t + 2 * q;
          const bool in = j < l && p < P;
          const float* e = base + b * bs + (s0 + (in ? j : 0)) * ss + h * hs
              + p;
          v[r][t][0] = in ? __ldg(e) : 0.f;
          v[r][t][1] = in ? __ldg(e + 1) : 0.f;
        }
    };
    // 1. the intra part over the first half of the rows i
    cp_async_wait<1>();
    __syncthreads();               // dt, cum and dy's first half; fac free
    for (int e = tid; e < kRows / 16 * LP; e += kThreads) {
      const int bb = e / LP, i = e - bb * LP, r = j0 + 16 * bb + 15;
      fac[e] = r < LP && i > r ? expf(cm(i) - cm(r)) : 0.f;
    }
    __syncthreads();
    intra(0);
    __syncthreads();               // dy read
    load_y(k, 1);
    cp_async_commit();
    // 2. yint, for dy . yint alone
    cp_async_wait<1>();
    __syncthreads();               // h_prev
    if (live) {
      float v[2][4][2], yhi[4][4] = {}, ylo[4][4] = {};
      if constexpr (kMinBlocks == 1) rows_of(a.dy, a.dy_b, a.dy_s, a.dy_h, v);
      float ec[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) ec[u] = ju[u] < l ? expf(cuk[ju[u]]) : 0.f;
      warp_mma(yhi, ylo,
               [&](int u, int n) { return cbw[8 * u * ldk + n] * ec[u]; },
               [&](int n, int cc) { return GH[(32 * half + cc) * ldk + n]; },
               0, NP / 8);
      if constexpr (kMinBlocks == 2) rows_of(a.dy, a.dy_b, a.dy_s, a.dy_h, v);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 yi = tile_sum(yhi, ylo, t, r);
          dots[r][2] += v[r][t][0] * yi.x + v[r][t][1] * yi.y;
        }
    }
    __syncthreads();               // h_prev read
    load_gh(k, 1);
    cp_async_commit();
    // 3. the intra part over the second half of the rows i
    cp_async_wait<1>();
    __syncthreads();               // dy's second half
    intra(1);
    __syncthreads();               // dy read
    if (k + 1 < hg) load_y(k + 1, 0);
    cp_async_commit();
    // 4. inter, dx = dt (intra + inter), x . dxd and x . inter
    cp_async_wait<1>();
    __syncthreads();               // g
    if (live) {
      float v[2][4][2], ehi[4][4] = {}, elo[4][4] = {};
      if constexpr (kMinBlocks == 1) rows_of(a.x, a.x_b, a.x_s, a.x_h, v);
      const float tot = cuk[l - 1];
      float wr[2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        wr[u] = ju[u] < l ? expf(tot - cuk[ju[u]]) : 0.f;
      warp_mma(ehi, elo,
               [&](int u, int n) { return bbw[8 * u * ldk + n] * wr[u]; },
               [&](int n, int cc) { return GH[(32 * half + cc) * ldk + n]; },
               0, NP / 8);
      if constexpr (kMinBlocks == 2) rows_of(a.x, a.x_b, a.x_s, a.x_h, v);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = ju[r], p = 32 * half + 8 * t + 2 * q;
          if (j >= l || p >= P) continue;
          const float2 in = make_float2(intra_acc[t][2 * r],
                                        intra_acc[t][2 * r + 1]);
          const float2 ex = tile_sum(ehi, elo, t, r);
          const float2 d = make_float2(in.x + ex.x, in.y + ex.y);
          const long long sj = (long long)b * a.S + s0 + j;
          const float dtj = dtk[j];
          *reinterpret_cast<float2*>(a.dx + (sj * a.H + h) * P + p) =
              make_float2(dtj * d.x, dtj * d.y);
          dots[r][0] += v[r][t][0] * d.x + v[r][t][1] * d.y;
          dots[r][1] += v[r][t][0] * ex.x + v[r][t][1] * ex.y;
        }
    }
    // a row's four lanes, then its two halves in order
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        dots[r][v] += __shfl_xor_sync(0xffffffffu, dots[r][v], 1);
        dots[r][v] += __shfl_xor_sync(0xffffffffu, dots[r][v], 2);
        if (q == 0) red[((16 * band + g + 8 * r) * 2 + half) * 3 + v] =
            dots[r][v];
      }
    __syncthreads();               // red written; g read
    if (k + 1 < hg) load_gh(k + 1, 0);
    cp_async_commit();
    if (tid < kRows && j0 + tid < l) {
      const int j = j0 + tid;
      const float* rr = red + tid * 6;
      const long long sj = ((long long)b * a.H + h) * a.S + s0 + j;
      a.sdot[sj] = rr[0] + rr[3];
      // dy . yint - xd . inter
      a.q[sj] = (rr[2] + rr[5]) - dtk[j] * (rr[1] + rr[4]);
    }
  }
}

// The unit u of D's 16 x 8 tiles j <= i in band-major order: band r (rows
// 16 r..) holds 2 r + 2 of them, column tiles c8 = 0..2 r + 1.
__device__ __forceinline__ void dbc_unit(int u, int& r, int& c8) {
  r = 0;
  while ((r + 1) * (r + 2) <= u) ++r;
  c8 = u - r * (r + 1);
}

// Kernel 4: rank r = blockIdx.x % kRanks of the cluster, slice
// (blockIdx.x / kRanks) % nsl of group (blockIdx.x / kRanks) / nsl, heads
// h0..h0 + nh.  D's units are dealt in band-major order, in equal halves to
// the ranks, each rank's to its 16 warps in order (at most 5 a warp at l =
// 128, formed 3 at a time).  Warp w owns the rows of band w / 2 of dB and
// dC and half (w & 1) of the rank's column tiles, so its two final products
// (S @ B: 2 b + 2 k steps, S^T @ C: LP / 8 - 2 b) take LP / 8 + 2 steps in
// every band.
template <int kRanks>
__global__ void __launch_bounds__(kDbcThreads, 1)
    ssd_bwd_chunk_dbc(const BwdArgs a, int nsl) {
  constexpr int kGroup = 3;        // D's units a warp forms at once
  extern __shared__ __align__(16) float smem[];
  const int l = a.l, N = a.N, P = a.P;
  const DbcLayout lay(l, N);
  const int LP = lay.LP, ldS = lay.ldS, ldx = lay.ldx, ldh = lay.ldh;
  float* S = smem + lay.S;
  float* X = smem + lay.X;
  float* Gt = smem + lay.G;
  float* Y = smem + lay.Y;
  float* Hp = smem + lay.Hp;
  float* Ks = smem + lay.Ks;
  float* dts = smem + lay.dts;
  float* cum = smem + lay.cum;
  float* rp = smem + lay.rp;
  float* cpt = smem + lay.cp;
  float* Cs = X;                   // C, once x and g are read for good
  float* Bs = Y;                   // B, once dy and h_prev are

  int rank = 0;
  if constexpr (kRanks == 2) rank = (int)cg::this_cluster().block_rank();
  const int sg = blockIdx.x / kRanks, sl = sg % nsl, grp = sg / nsl;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int s0 = c * l, rep = a.H / a.G;
  const int h0 = grp * rep + sl * rep / nsl;
  const int nh = grp * rep + (sl + 1) * rep / nsl - h0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int nb = LP / 16, T = nb * (nb + 1);
  const int ulo = rank ? T / 2 : 0;
  const int Tr = kRanks == 1 ? T : rank ? T - T / 2 : T / 2;
  const int u0 = ulo + warp * Tr / 16;
  const int nu = ulo + (warp + 1) * Tr / 16 - u0;
  // the rank's columns n0..n0 + ncol; this warp's band and column tiles
  const int n0 = rank * lay.NH, ncol = max(0, min(N - n0, lay.NH));
  const int rb = warp >> 1, NT = (ncol + 7) / 8, tw = (NT + 1) / 2;
  const int t0 = (warp & 1) * tw, nt = max(0, min(tw, NT - t0));
  const bool own = rb < nb && nt > 0;
  const int ir0 = 16 * rb + g;     // this thread's rows ir0, ir0 + 8
  const long long sbase = ((long long)b * nc + c) * a.H;
  const float* xg = a.x + b * a.x_b + (long long)s0 * a.x_s;
  const float* dyg = a.dy + b * a.dy_b + (long long)s0 * a.dy_s;
  auto lim_p = [&](int p) { return p < P ? ncol : 0; };
  auto lim_l = [&](int i) { return i < l ? P : 0; };
  auto load_gdt = [&](int k) {     // g, dt, cum of head h0 + k
    const int h = h0 + k;
    copy_col(dts + (k & 1) * LP, dt_col(a, b, h, s0), a.dt_s, l, LP, tid,
             kDbcThreads);
    copy_col(cum + (k & 1) * LP, cum_col(a, b, h, s0), 1, l, LP, tid,
             kDbcThreads);
    copy_tile(Gt, ldh, a.gst + (sbase + h) * P * N + n0, N, P, lay.NH, lim_p,
              tid, kDbcThreads);
  };
  auto load_x = [&](int k) {
    copy_tile(X, ldx, xg + (h0 + k) * a.x_h, a.x_s, LP, kMaxP, lim_l, tid,
              kDbcThreads);
  };
  auto load_yh = [&](int k) {
    const int h = h0 + k;
    copy_tile(Y, ldx, dyg + h * a.dy_h, a.dy_s, LP, kMaxP, lim_l, tid,
              kDbcThreads);
    copy_tile(Hp, ldh, a.hprev + (sbase + h) * P * N + n0, N, P, lay.NH,
              lim_p, tid, kDbcThreads);
  };
  auto lim_n = [&](int i) { return i < l ? ncol : 0; };
  // row r's columns k, k + 1 of a tile (row stride ld) times f
  auto pair = [](const float* t, int r, int ld, int k, float f) {
    const float2 v = *reinterpret_cast<const float2*>(t + r * ld + k);
    return make_float2(v.x * f, v.y * f);
  };
  // this thread's element e of unit u: row i, column j
  auto elem = [&](int u, int e, int& i, int& j) {
    int r, c8;
    dbc_unit(u, r, c8);
    i = 16 * r + g + 8 * (e >> 1);
    j = 8 * c8 + 2 * q + (e & 1);
  };

  // K at this thread's elements of D: the same for every head
  const float* cbg = a.cb + (((long long)b * nc + c) * a.G + grp) * LP * LP;
  for (int t = 0; t < nu; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int i, j;
      elem(u0 + t, e, i, j);
      cp_async4(Ks + ((u0 + t - ulo) * 32 + lane) * 4 + e,
                cbg + (long long)i * LP + j, 4);
    }
  for (int e = tid; e < (kRp + kCp) * LP; e += kDbcThreads) rp[e] = 0.f;
  // Groups of copies, committed in this order a head k: g, dt and cum of
  // head k + 1 after dB's carried part; x_{k + 1} after D; dy_{k + 1} and
  // h_prev_{k + 1} after dC's carried part.  Each phase waits for all but
  // the latest group.
  load_gdt(0);
  load_x(0);
  cp_async_commit();
  load_yh(0);
  cp_async_commit();

  const long long wsz = (long long)gridDim.z * a.S * a.H;
  float accB[kDbcTiles][4] = {}, accC[kDbcTiles][4] = {};
  for (int k = 0; k < nh; ++k) {
    const int h = h0 + k;
    const float* dtk = dts + (k & 1) * LP;
    const float* cuk = cum + (k & 1) * LP;
    cp_async_wait<1>();
    __syncthreads();               // x, g, dt and cum of head k
    if (own) {                     // dB_j += exp(tot - cum_j) dt_j x_j . g
      const float tot = cuk[l - 1];
      float f[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = ir0 + 8 * u;
        f[u] = i < l ? expf(tot - cuk[i]) * dtk[i] : 0.f;
      }
      mma_pairs(accB,
                [&](int u, int p) {
                  return pair(X, ir0 + 8 * u, ldx, p, f[u]);
                },
                [&](int p, int cc) { return Gt[p * ldh + 8 * t0 + cc]; }, nt,
                0, P / 8);
    }
    __syncthreads();               // g read
    if (k + 1 < nh) load_gdt(k + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();               // dy and h_prev of head k
    // D = dy x^T on this warp's units, kGroup at a time: L ⊙ D into S; W =
    // K ⊙ L ⊙ D off the diagonal, summed along the unit's rows (its four
    // lanes q) and columns (its eight lanes g)
    for (int base = 0; base < nu; base += kGroup) {
      const int ng = min(kGroup, nu - base);
      int ur[kGroup], uc[kGroup];
#pragma unroll
      for (int t = 0; t < kGroup; ++t)
        dbc_unit(min(u0 + base + t, T - 1), ur[t], uc[t]);
      float dacc[kGroup][4] = {};
      for (int ks = 0; ks < P / 8; ++ks) {
        const int p = 8 * ks + 2 * q;          // paired columns, as mma_pairs
        uint32_t ah[4], al[4];
        int rcur = -1;
#pragma unroll
        for (int t = 0; t < kGroup; ++t) {
          if (t >= ng) break;
          if (ur[t] != rcur) {
            rcur = ur[t];
            const float2 y0 = pair(Y, 16 * rcur + g, ldx, p, 1.f);
            const float2 y1 = pair(Y, 16 * rcur + g + 8, ldx, p, 1.f);
            split_tf32(y0.x, ah[0], al[0]);
            split_tf32(y1.x, ah[1], al[1]);
            split_tf32(y0.y, ah[2], al[2]);
            split_tf32(y1.y, ah[3], al[3]);
          }
          const float2 xv = pair(X, 8 * uc[t] + g, ldx, p, 1.f);
          uint32_t bh[2], bl[2];
          split_tf32(xv.x, bh[0], bl[0]);
          split_tf32(xv.y, bh[1], bl[1]);
          mma_tf32(dacc[t], al, bh);
          mma_tf32(dacc[t], ah, bl);
          mma_tf32(dacc[t], ah, bh);
        }
      }
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        if (t >= ng) break;
        const float4 kv = *reinterpret_cast<const float4*>(
            Ks + ((u0 + base + t - ulo) * 32 + lane) * 4);
        const float kk[4] = {kv.x, kv.y, kv.z, kv.w};
        const int j0 = 8 * uc[t] + 2 * q;
        const float2 dj = *reinterpret_cast<const float2*>(dtk + j0);
        const float2 cj = *reinterpret_cast<const float2*>(cuk + j0);
        float w[4], v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * ur[t] + g + 8 * (e >> 1), j = j0 + (e & 1);
          const float ci = cuk[i];
          v[e] = j <= i && i < l
              ? dacc[t][e] * (e & 1 ? dj.y : dj.x)
                  * expf(ci - (e & 1 ? cj.y : cj.x))
              : 0.f;
          w[e] = j < i ? kk[e] * v[e] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float2* sp = reinterpret_cast<float2*>(
              S + (16 * ur[t] + g + 8 * r) * ldS + j0);
          const float2 o = k ? *sp : make_float2(0.f, 0.f);
          *sp = make_float2(o.x + v[2 * r], o.y + v[2 * r + 1]);
        }
        float rs[2] = {w[0] + w[1], w[2] + w[3]};
        float cs[2] = {w[0] + w[2], w[1] + w[3]};
#pragma unroll
        for (int vv = 0; vv < 2; ++vv) {
          rs[vv] += __shfl_xor_sync(0xffffffffu, rs[vv], 1);
          rs[vv] += __shfl_xor_sync(0xffffffffu, rs[vv], 2);
          cs[vv] += __shfl_xor_sync(0xffffffffu, cs[vv], 4);
          cs[vv] += __shfl_xor_sync(0xffffffffu, cs[vv], 8);
          cs[vv] += __shfl_xor_sync(0xffffffffu, cs[vv], 16);
        }
        if (q == 0) {
          rp[(16 * ur[t] + g) * kRp + uc[t]] = rs[0];
          rp[(16 * ur[t] + g + 8) * kRp + uc[t]] = rs[1];
        }
        if (g == 0) {
          cpt[(8 * uc[t] + 2 * q) * kCp + ur[t]] = cs[0];
          cpt[(8 * uc[t] + 2 * q + 1) * kCp + ur[t]] = cs[1];
        }
      }
    }
    __syncthreads();               // x read; S and W's sums written
    if (k + 1 < nh)
      load_x(k + 1);
    else                           // C's rows of the rank's columns
      copy_tile(Cs, ldh,
                a.C + b * a.C_b + (long long)s0 * a.C_s + grp * a.C_g + n0,
                a.C_s, LP, lay.NH, lim_n, tid, kDbcThreads);
    cp_async_commit();
    // this rank's share of wrow (its units' row sums in column order) and
    // of wcol (column sums in band order)
    for (int e = tid; e < 2 * l; e += kDbcThreads) {
      const int i = e < l ? e : e - l;
      float sum = 0.f;
      if (e < l)
        for (int u = 0; u <= 2 * (i >> 4) + 1; ++u) sum += rp[i * kRp + u];
      else
        for (int r = i >> 4; r < nb; ++r) sum += cpt[i * kCp + r];
      (e < l ? a.wrow : a.wcol)[rank * wsz
          + ((long long)b * a.H + h) * a.S + s0 + i] = sum;
    }
    if (own) {                     // dC_i += exp(cum_i) dy_i . h_prev
      float f[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = ir0 + 8 * u;
        f[u] = i < l ? expf(cuk[i]) : 0.f;
      }
      mma_pairs(accC,
                [&](int u, int p) {
                  return pair(Y, ir0 + 8 * u, ldx, p, f[u]);
                },
                [&](int p, int cc) { return Hp[p * ldh + 8 * t0 + cc]; }, nt,
                0, P / 8);
    }
    __syncthreads();               // dy and h_prev read; W's sums read
    if (k + 1 < nh)
      load_yh(k + 1);
    else                           // B's rows of the rank's columns
      copy_tile(Bs, ldh,
                a.B + b * a.B_b + (long long)s0 * a.B_s + grp * a.B_g + n0,
                a.B_s, LP, lay.NH, lim_n, tid, kDbcThreads);
    cp_async_commit();
  }
  if constexpr (kRanks == 2) {     // each rank sends its tiles of S over
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    float* peer = cluster.map_shared_rank(S, rank ^ 1);
    for (int t = 0; t < nu; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int i, j;
        elem(u0 + t, e, i, j);
        peer[i * ldS + j] = S[i * ldS + j];
      }
    cluster.sync();
  }
  cp_async_wait<0>();
  __syncthreads();                 // C and B
  if (!own) return;
  // dB_j += sum_{i >= j} S_ij C_i, dC_i += sum_{j <= i} S_ij B_j
  mma_pairs(accB,
            [&](int u, int i) {
              return make_float2(S[i * ldS + ir0 + 8 * u],
                                 S[(i + 1) * ldS + ir0 + 8 * u]);
            },
            [&](int i, int cc) { return Cs[i * ldh + 8 * t0 + cc]; }, nt,
            2 * rb, LP / 8);
  mma_pairs(accC,
            [&](int u, int j) { return pair(S, ir0 + 8 * u, ldS, j, 1.f); },
            [&](int j, int cc) { return Bs[j * ldh + 8 * t0 + cc]; }, nt, 0,
            2 * rb + 2);
  const long long E = (long long)gridDim.z * a.S * a.G * N;
  const long long o = sl * E + (((long long)b * a.S + s0) * a.G + grp) * N;
#pragma unroll
  for (int t = 0; t < kDbcTiles; ++t) {
    if (t >= nt) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = ir0 + 8 * r, n = n0 + 8 * (t0 + t) + 2 * q;
      if (i >= l) continue;
      const long long e = o + (long long)i * a.G * N + n;
      if (n < n0 + ncol) {
        a.pdB[e] = accB[t][2 * r];
        a.pdC[e] = accC[t][2 * r];
      }
      if (n + 1 < n0 + ncol) {
        a.pdB[e + 1] = accB[t][2 * r + 1];
        a.pdC[e + 1] = accC[t][2 * r + 1];
      }
    }
  }
}

// One warp per (batch, head, chunk), four positions a lane: dcum = (wrow -
// wcol) + q, plus the chunk's state sums at the last position; da its
// suffix sums (each lane's four, then a shuffle scan of the lanes' totals
// from the top); ddt = s - A da; dap = -sum dt da (a shuffle tree).  wrow
// and wcol are the dB/dC ranks' shares, added in rank order.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_finish(const BwdArgs a, int nb, int nc, int W, int ranks) {
  const long long wid = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31, l = a.l;
  if (wid >= (long long)nb * a.H * nc) return;          // whole warps
  const int c = (int)(wid % nc);
  const long long bh = wid / nc;
  const int b = (int)(bh / a.H), h = (int)(bh % a.H);
  const float* part = a.lastp + (bh * nc + c) * W;
  float last = 0.f;
  for (int w = 0; w < W; ++w) last += part[w];
  const float* dtg = dt_col(a, b, h, c * l);
  const long long base = (long long)b * a.S + (long long)c * l;
  const long long hb = bh * a.S + (long long)c * l;   // [b, H, S] scratch
  const long long wsz = (long long)nb * a.S * a.H;
  float v[4], dtv[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int k = 4 * lane + m;
    v[m] = dtv[m] = 0.f;
    if (k < l) {
      const long long e = hb + k;
      float wr = a.wrow[e], wc = a.wcol[e];
      for (int r = 1; r < ranks; ++r) {
        wr += a.wrow[r * wsz + e];
        wc += a.wcol[r * wsz + e];
      }
      v[m] = (wr - wc) + a.q[e] + (k == l - 1 ? last : 0.f);
      dtv[m] = dtg[(long long)k * a.dt_s];
    }
  }
  float sfx[4];
  sfx[3] = v[3];
#pragma unroll
  for (int m = 2; m >= 0; --m) sfx[m] = v[m] + sfx[m + 1];
  float incl = sfx[0];
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += t;
  }
  float excl = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) excl = 0.f;
  const float Ah = a.A[h];
  float acc = 0.f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int k = 4 * lane + m;
    if (k >= l) continue;
    const float da = sfx[m] + excl;
    a.ddt[(base + k) * a.H + h] = a.sdot[hb + k] - Ah * da;
    acc += dtv[m] * da;
  }
  acc = warp_sum(acc);
  if (lane == 0) a.dap[((long long)b * nc + c) * a.H + h] = -acc;
}

// A thread per element of dB / dC (the slices' partials in slice order)
// and, in the first H threads, per head of dA (the (batch, chunk)
// partials in order).
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_sums(const BwdArgs a, int bn, int nsl, long long E) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e < a.H) {
    float s = 0.f;
    for (int k = 0; k < bn; ++k) s += a.dap[(long long)k * a.H + e];
    a.dA[e] = s;
  }
  if (e < E) {
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < nsl; ++k) {
      sb += a.pdB[k * E + e];
      sc += a.pdC[k * E + e];
    }
    a.dB[e] = sb;
    a.dC[e] = sc;
  }
}

size_t smem_bytes(int which, int l, int N) {
  switch (which) {
    case 0: return sizeof(float) * DstatesLayout(l).total;
    case 1: return sizeof(float) * DxLayout(l, N).total;
    default: return sizeof(float) * DbcLayout(l, N).total;
  }
}

// Blocks of the dx kernel an SM can hold by their shared memory (two at
// N <= 64, l = 128): its registers are bounded to match.
int dx_blocks(int chunk, int N) {
  return 2 * (smem_bytes(1, chunk, N) + kReservedSmem) <= kSmemSM ? 2 : 1;
}

const void* smem_kernel(int which, int chunk, int N) {
  if (which == 0) return (const void*)ssd_bwd_chunk_dstates;
  if (which == 1)
    return dx_blocks(chunk, N) == 2 ? (const void*)ssd_bwd_chunk_dx<2>
                                    : (const void*)ssd_bwd_chunk_dx<1>;
  return dbc_ranks(N) == 2 ? (const void*)ssd_bwd_chunk_dbc<2>
                           : (const void*)ssd_bwd_chunk_dbc<1>;
}

cudaError_t set_smem(int chunk, int N) {
  for (int k = 0; k < 3; ++k) {
    const void* fn = smem_kernel(k, chunk, N);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(k, chunk, N));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Head slices of a group in the dB/dC kernel: the count s from 2 (1 when a
// group has one head) to H / G whose blocks (ranks s G S / chunk b, one an
// SM) take the fewest waves over ``sms`` SMs times the heads of the
// longest slice plus one (the slice's last products); the smallest such s.
int bwd_slices(int b, int S, int H, int G, int N, int chunk, int sms) {
  const int rep = H / G;
  const long long units = (long long)dbc_ranks(N) * G * (S / chunk) * b;
  int best = 1;
  long long cost = -1;
  for (int s = min(2, rep); s <= rep; ++s) {
    const long long waves = (units * s + sms - 1) / sms;
    const long long c = waves * ((rep + s - 1) / s + 1);
    if (cost < 0 || c < cost) {
      cost = c;
      best = s;
    }
  }
  return best;
}

// Grid of backward kernel ``which``: 0 dstates, 1 the state pass, 2 dx,
// 3 dB / dC, 4 the finish, 5 the sums.
dim3 bwd_grid(int which, int b, int S, int H, int P, int G, int N,
              int chunk, int slices) {
  const int nc = S / chunk;
  const int nrb = (round_up(chunk, 16) + kRows - 1) / kRows;
  switch (which) {
    case 0: return dim3(H, nc, b);
    case 1: return dim3((P * N / 4 + kThreads - 1) / kThreads, b * H);
    case 2: return dim3(H / heads_per_block(H, G), nc * nrb, b);
    case 3: return dim3(dbc_ranks(N) * slices * G, nc, b);
    case 4:
      return dim3((unsigned)(((long long)b * H * nc * 32 + kThreads - 1) /
                             kThreads));
    default: {
      const long long E = (long long)b * S * G * N;
      return dim3((unsigned)(((E > H ? E : H) + kThreads - 1) / kThreads));
    }
  }
}

}  // namespace

extern "C" {

int ssd_scan_bwd_max_p() { return kMaxP; }

// The grid (x, y, z) of backward kernel ``which`` (as bwd_grid) into xyz.
void ssd_scan_bwd_grid(int which, int b, int S, int H, int P, int G, int N,
                       int chunk, int slices, int* xyz) {
  const dim3 g = bwd_grid(which, b, S, H, P, G, N, chunk, slices);
  xyz[0] = (int)g.x;
  xyz[1] = (int)g.y;
  xyz[2] = (int)g.z;
}

// Head slices of a group in the dB/dC kernel on a card of ``sms`` SMs.
int ssd_scan_bwd_slices(int b, int S, int H, int G, int N, int chunk,
                        int sms) {
  return bwd_slices(b, S, H, G, N, chunk, sms);
}

// Warp sums a (batch, head, chunk) of the state pass leaves: W in the
// wrapper's lastp buffer [b, H, nc, W].
int ssd_scan_bwd_state_warps(int P, int N) { return (P * N / 4 + 31) / 32; }

// Heads a dx block walks through.
int ssd_scan_bwd_heads_per_block(int H, int G) {
  return heads_per_block(H, G);
}

// Shared memory of a block of the dstates (0), dx (1) and dB/dC (2)
// kernels.
long long ssd_scan_bwd_smem_bytes(int which, int chunk, int N) {
  return (long long)smem_bytes(which, chunk, N);
}

// Blocks of kernel ``which`` (as above) that one SM holds at once (for a
// dB/dC kernel of two ranks, twice the clusters the card holds at once over
// its SMs); -1 on error.
int ssd_scan_bwd_blocks_per_sm(int which, int chunk, int N) {
  if (which < 0 || which > 2 || set_smem(chunk, N) != cudaSuccess) return -1;
  const size_t bytes = smem_bytes(which, chunk, N);
  const void* fn = smem_kernel(which, chunk, N);
  int blocks = 0;
  if (which < 2 || dbc_ranks(N) == 1) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, fn, which == 2 ? kDbcThreads : kThreads, bytes)
        != cudaSuccess)
      return -1;
    return blocks;
  }
  int dev = 0, sms = 0, clusters = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(2 * sms, 1, 1);
  cfg.blockDim = dim3(kDbcThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg) != cudaSuccess)
    return -1;
  return 2 * clusters / sms;
}

// x [b, S, H, P], dt [b, S, H], B/C [b, S, G, N], dy [b, S, H, P] (strides
// in elements, the last dim contiguous), A [H], dhfin contiguous
// [b, H, P, N] or null; from ssd_scan_states_launch (ssd_scan.cu) hfin
// [b, H, P, N], h_prev (its states buffer) [b, S/chunk, H, P, N], cb
// [b, S/chunk, G, LP, LP] and dec [b, H, S/chunk], all contiguous; scratch
// contiguous: gst like h_prev, lastp [b, H, S/chunk, W] (W from
// ssd_scan_bwd_state_warps), cum [b, H, S], q and sdot [b, S, H], wrow and
// wcol [2, b, S, H], pdB and pdC [slices, b, S, G, N] (slices from
// ssd_scan_bwd_slices, 1..H/G), dap [b, S/chunk, H]; outputs contiguous:
// dx [b, S, H, P], ddt [b, S, H], dA [H], dB and dC [b, S, G, N]; all
// fp32.  Six launches on ``stream``; returns a cudaError_t.
int ssd_scan_bwd_launch(const float* x, const float* dt, const float* A,
                        const float* B, const float* C, const float* dy,
                        const float* dhfin, const float* hfin,
                        const float* hprev, const float* cb,
                        const float* dec, float* gst, float* lastp,
                        float* cum, float* q, float* sdot, float* wrow,
                        float* wcol, float* pdB, float* pdC, float* dap,
                        float* dx, float* ddt, float* dA, float* dB,
                        float* dC, int b, int S, int H, int P, int G, int N,
                        int chunk, int slices, long long x_b, long long x_s,
                        long long x_h, long long dt_b, long long dt_s,
                        long long dt_h, long long B_b, long long B_s,
                        long long B_g, long long C_b, long long C_s,
                        long long C_g, long long dy_b, long long dy_s,
                        long long dy_h, void* stream) {
  if (b <= 0 || chunk <= 0 || chunk > kMaxL || S <= 0 || S % chunk ||
      N <= 0 || N > kMaxN || P <= 0 || P % 16 || P > kMaxP || G <= 0 ||
      H % G || slices < 1 || slices > H / G)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{x,     dt,   A,     B,    C,    dy,   dhfin, hfin,
                  hprev, cb,   dec,   gst,  lastp, cum, q,     sdot,
                  wrow,  wcol, pdB,   pdC,  dap,  dx,   ddt,   dA,
                  dB,    dC,   S,     H,    P,    G,    N,     chunk,
                  x_b,   x_s,  x_h,   dt_b, dt_s, dt_h, B_b,   B_s,
                  B_g,   C_b,  C_s,   C_g,  dy_b, dy_s, dy_h};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = S / chunk, W = ssd_scan_bwd_state_warps(P, N);
  auto grid = [&](int which) {
    return bwd_grid(which, b, S, H, P, G, N, chunk, slices);
  };
  const cudaError_t set = set_smem(chunk, N);
  if (set != cudaSuccess) return (int)set;
  ssd_bwd_chunk_dstates<<<grid(0), kThreads, smem_bytes(0, chunk, N), s>>>(
      a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_state_pass<<<grid(1), kThreads, 0, s>>>(a, nc, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (dx_blocks(chunk, N) == 2)
    ssd_bwd_chunk_dx<2><<<grid(2), kThreads, smem_bytes(1, chunk, N), s>>>(a);
  else
    ssd_bwd_chunk_dx<1><<<grid(2), kThreads, smem_bytes(1, chunk, N), s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (dbc_ranks(N) == 1) {
    ssd_bwd_chunk_dbc<1><<<grid(3), kDbcThreads, smem_bytes(2, chunk, N),
                           s>>>(a, slices);
  } else {                         // clusters of the two ranks
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 2;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = grid(3);
    cfg.blockDim = dim3(kDbcThreads, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes(2, chunk, N);
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, ssd_bwd_chunk_dbc<2>, a, slices);
    if (err != cudaSuccess) return (int)err;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_finish<<<grid(4), kThreads, 0, s>>>(a, b, nc, W, dbc_ranks(N));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_sums<<<grid(5), kThreads, 0, s>>>(a, b * nc, slices,
                                            (long long)b * S * G * N);
  return (int)cudaGetLastError();
}

}  // extern "C"
