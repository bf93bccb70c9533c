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
//      the gradient that chunk c's outputs send to h_prev.
//   2. ssd_bwd_state_pass, 256 four-entry chains of a (batch, head) a
//      block: g <- g exp(tot_c) + gst_c backwards over the chunks from g =
//      dhfin, storing g_c (the gradient of the state after chunk c) in
//      place, and a warp's sum of g_c ⊙ (state after chunk c) a chunk.
//   3. ssd_bwd_chunk_dx, one block per (16 heads, 64 rows j, chunk, batch):
//        dxd = [(K ⊙ L)^T | exp(tot - cum) ⊙ B] @ [dy ; g^T]      [l, P]
//      (the forward's output kernel run backwards in time), dx = dt dxd,
//      s = x . dxd, and dcum's carried-state terms q = dy . (exp(cum) ⊙ C
//      @ h_prev^T) - xd . (exp(tot - cum) ⊙ B @ g^T).
//   4. ssd_bwd_chunk_dbc, one block per (64 rows, dB or dC, group, chunk,
//      batch), walking the group's heads in order with the sums in
//      registers:
//        dC_i = sum_h (L ⊙ D)_i: @ B + exp(cum_i) h_prev^T dy_i
//        dB_j = sum_h (L ⊙ D)_:j^T @ C + exp(tot - cum_j) g^T xd_j
//      each block forming D again; per head it writes W's row sums off the
//      diagonal (dC's blocks: wrow_k = sum_{j < k} W_kj) or its column
//      sums (dB's: wcol_k = sum_{i > k} W_ik).
//   5. ssd_bwd_finish, one warp per (batch, head, chunk):
//        dcum = (wrow - wcol) + q, plus sum g ⊙ (state after the chunk) at
//        the last position; da its suffix sums; ddt = s - A da; a partial
//        of dA = -sum dt da.
//   6. ssd_bwd_da: dA[h] = the partials summed over (batch, chunk).
// Over a chunk the row sums of W minus its column sums add up to zero, and
// with a large dt its diagonal is most of each: wrow and wcol leave W_kk
// out of both, so it cancels exactly, as in the plain version's W.sum(-1)
// - W.sum(-2), and the products that feed them are split TF32.
//
// Exponents as in the forward: every factor is exp(cum_i - cum_j) with
// j <= i, exp(tot - cum_j), exp(cum_i) or exp(tot), so it is <= 1.
// Products: split TF32 on mma.sync m16n8k8 (ssd_common.cuh).  Every sum
// runs in a fixed order, no atomics: two launches give the same bits.
//
// What bounds it on this card: operations.  At zamba2-1.2b's training call
// (b = 2, S = 4096, H = 64, P = N = 64, G = 1, l = 128) the recomputation
// and the six kernels do ~50 GFLOP counted once (~0.3 ms at split TF32's
// 165 TFLOP/s) against ~0.17 ms of inputs and outputs at 3.35 TB/s; the
// scratch adds the states and g (134 MB each, each written twice and read
// twice).  Kernel 4 forms D for dB and again for dC and holds one block
// an SM (193 KB of shared memory at N = 128), kernel 3 one (214 KB): a
// first design, kept simple.  Limits (raised by the wrapper): l <= 128,
// N <= 128, P a multiple of 16 up to 64.

#include "ssd_common.cuh"

namespace {

constexpr int kGrpThreads = 512;   // kernel 4: 4 bands x 4 quarters of 32
constexpr int kMaxP = kCols;       // head dimension

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
  float* q;             // [b, S, H]: the carried-state terms of dcum
  float* sdot;          // [b, S, H]: x . dxd
  float* wrow;          // [b, S, H]: sum_{j < k} W_kj
  float* wcol;          // [b, S, H]: sum_{i > k} W_ik
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

struct DxLayout {
  int LP, NP, ldk, KT, Bb, Cb, dts, cum, fac, Y, Gs, Hs, red, total;
  __host__ __device__ DxLayout(int l, int N) {
    LP = round_up(l, 16);
    NP = round_up(N, 8);
    ldk = NP + 4;
    KT = 0;                        // C B^T, 64 columns j    [LP][kLdRow]
    Bb = KT + LP * kLdRow;         // B rows j                [kRows][ldk]
    Cb = Bb + kRows * ldk;         // C rows j                [kRows][ldk]
    dts = Cb + kRows * ldk;        // dt                      [LP]
    cum = dts + LP;                // cum                     [LP]
    fac = cum + LP;                // column factors          [kRows / 16][LP]
    Y = fac + kRows / 16 * LP;     // dy                      [LP][kLdRow]
    Gs = Y + LP * kLdRow;          // g                       [kMaxP][ldk]
    Hs = Gs + kMaxP * ldk;         // h_prev                  [kMaxP][ldk]
    red = Hs + kMaxP * ldk;        // row dots of two halves  [kRows][2][3]
    total = red + kRows * 6;
  }
};

struct GrpLayout {
  int LP, NP, ldg, ldp, ldm, Grp, Band, Oth, St, LD, dts, cum, rf, wp,
      total;
  __host__ __device__ GrpLayout(int l, int N) {
    LP = round_up(l, 16);
    NP = round_up(N, 8);
    ldg = round_up(NP, 32) + 8;    // read down columns: == 8 mod 32
    ldp = kMaxP + 4;               // read along rows: == 4 mod 8
    ldm = LP + 4;
    Grp = 0;                       // B (dC) or C (dB) rows    [LP][ldg]
    Band = Grp + LP * ldg;         // dy (dC) or x (dB) rows   [kRows][ldp]
    Oth = Band + kRows * ldp;      // x (dC) or dy (dB) rows   [LP][ldp]
    St = Oth + LP * ldp;           // h_prev (dC) or g (dB)    [kMaxP][ldg]
    LD = St + kMaxP * ldg;         // L ⊙ D, the band's rows   [kRows][ldm]
    dts = LD + kRows * ldm;        // dt                       [LP]
    cum = dts + LP;                // cum                      [LP]
    rf = cum + LP;                 // row factors              [kRows]
    wp = rf + kRows;               // W's row sums by quarter  [kRows][4]
    total = wp + kRows * 4;
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
  for (int i = tid; i < LP; i += kThreads) edec[i] = i < l ? expf(cum[i]) : 0.f;

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
// xd_j . inter_j.  One block walks through heads_per_block heads, C B^T's
// columns and B's and C's rows copied once.
__global__ void __launch_bounds__(kThreads, 1)
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
  float* Gs = smem + lay.Gs;
  float* Hs = smem + lay.Hs;
  float* red = smem + lay.red;

  const int nrb = (LP + kRows - 1) / kRows, nc = gridDim.y / nrb;
  const int c = blockIdx.y / nrb, b = blockIdx.z;
  const int j0 = (blockIdx.y % nrb) * kRows, s0 = c * l;
  const int hg = heads_per_block(a.H, a.G), h0 = blockIdx.x * hg;
  const int grp = h0 / (a.H / a.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int band = warp >> 1, half = warp & 1, g = lane >> 2, q = lane & 3;
  const int LPj = LP - j0;                     // rows i >= j0
  const float* cbg = a.cb + (((long long)b * nc + c) * a.G + grp) * LP * LP;
  const float* Bg = a.B + b * a.B_b + (long long)s0 * a.B_s + grp * a.B_g;
  const float* Cg = a.C + b * a.C_b + (long long)s0 * a.C_s + grp * a.C_g;

  // C B^T[i][j0 + jj] for i >= j0, every column jj < 64 that exists
  copy_tile(KT + j0 * kLdRow, kLdRow, cbg + (long long)j0 * LP + j0, LP, LPj,
            kCols, [&](int) { return min(kCols, LPj); }, tid, kThreads);
  copy_tile(Bb, ldk, Bg + (long long)j0 * a.B_s, a.B_s, kRows, NP,
            [&](int r) { return j0 + r < l ? N : 0; }, tid, kThreads);
  copy_tile(Cb, ldk, Cg + (long long)j0 * a.C_s, a.C_s, kRows, NP,
            [&](int r) { return j0 + r < l ? N : 0; }, tid, kThreads);

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
    const float* dyg = a.dy + b * a.dy_b + (long long)s0 * a.dy_s
        + h * a.dy_h;
    const long long st = (((long long)b * nc + c) * a.H + h) * P * N;
    __syncthreads();               // the last head's tiles are read
    copy_col(dts, dt_col(a, b, h, s0), a.dt_s, l, LP, tid, kThreads);
    copy_tile(Y + j0 * kLdRow, kLdRow, dyg + (long long)j0 * a.dy_s, a.dy_s,
              LPj, kCols, [&](int r) { return j0 + r < l ? P : 0; }, tid,
              kThreads);
    copy_tile(Gs, ldk, a.gst + st, N, kMaxP, NP,
              [&](int p) { return p < P ? N : 0; }, tid, kThreads);
    copy_tile(Hs, ldk, a.hprev + st, N, kMaxP, NP,
              [&](int p) { return p < P ? N : 0; }, tid, kThreads);
    cp_async_wait_all();
    __syncthreads();
    if (warp == 0) chunk_cum(dts, cum, -a.A[h], LP);
    __syncthreads();
    for (int e = tid; e < kRows / 16 * LP; e += kThreads) {
      const int bb = e / LP, i = e - bb * LP, r = j0 + 16 * bb + 15;
      fac[e] = r < LP && i > r ? expf(cum[i] - cum[r]) : 0.f;
    }
    __syncthreads();
    // per row u: x . dxd, x . inter, dy . yint over this thread's columns
    float dots[2][3] = {};
    if (live) {
      const float tot = cum[l - 1];
      float cj[2], er[2], wr[2], ec[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        cj[u] = cum[ju[u]];
        er[u] = expf(cum[jr] - cj[u]);
        wr[u] = ju[u] < l ? expf(tot - cj[u]) : 0.f;
        ec[u] = ju[u] < l ? expf(cj[u]) : 0.f;
      }
      auto diag = [&](int u, int i) {        // the band's diagonal block
        return i >= ju[u] ? ktw[i * kLdRow + 8 * u] * expf(cum[i] - cj[u])
                          : 0.f;
      };
      auto past = [&](int u, int i) {        // rows i past the band
        return ktw[i * kLdRow + 8 * u] * er[u] * facw[i];
      };
      auto bw = [&](int u, int n) { return bbw[8 * u * ldk + n] * wr[u]; };
      auto cw = [&](int u, int n) { return cbw[8 * u * ldk + n] * ec[u]; };
      auto yr = [&](int i, int cc) { return Y[i * kLdRow + 32 * half + cc]; };
      auto gr = [&](int n, int cc) { return Gs[(32 * half + cc) * ldk + n]; };
      auto hr = [&](int n, int cc) { return Hs[(32 * half + cc) * ldk + n]; };
      float ihi[4][4] = {}, ilo[4][4] = {}, ehi[4][4] = {}, elo[4][4] = {},
            yhi[4][4] = {}, ylo[4][4] = {};
      warp_mma(ihi, ilo, diag, yr, jb / 8, jb / 8 + 2);
      warp_mma(ihi, ilo, past, yr, jb / 8 + 2, LP / 8);
      warp_mma(ehi, elo, bw, gr, 0, NP / 8);
      warp_mma(yhi, ylo, cw, hr, 0, NP / 8);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = ju[r], p = 32 * half + 8 * t + 2 * q;
          if (j >= l || p >= P) continue;
          const float2 in = tile_sum(ihi, ilo, t, r);
          const float2 ex = tile_sum(ehi, elo, t, r);
          const float2 yi = tile_sum(yhi, ylo, t, r);
          const float2 d = make_float2(in.x + ex.x, in.y + ex.y);
          const long long sj = (long long)b * a.S + s0 + j;
          const float dtj = dts[j];
          *reinterpret_cast<float2*>(a.dx + (sj * a.H + h) * P + p) =
              make_float2(dtj * d.x, dtj * d.y);
          const float* xr = a.x + b * a.x_b + (long long)(s0 + j) * a.x_s
              + h * a.x_h + p;
          const float* dyr = Y + j * kLdRow + p;
          dots[r][0] += xr[0] * d.x + xr[1] * d.y;
          dots[r][1] += xr[0] * ex.x + xr[1] * ex.y;
          dots[r][2] += dyr[0] * yi.x + dyr[1] * yi.y;
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
    __syncthreads();
    if (tid < kRows && j0 + tid < l) {
      const int j = j0 + tid;
      const float* rr = red + tid * 6;
      const long long sj = ((long long)b * a.S + s0 + j) * a.H + h;
      a.sdot[sj] = rr[0] + rr[3];
      // dy . yint - xd . inter
      a.q[sj] = (rr[2] + rr[5]) - dts[j] * (rr[1] + rr[4]);
    }
  }
}

// One block: rows r0..r0 + 63 of dC (role 0: rows i, the other index
// j <= i) or dB (role 1: rows j, the other index i >= j) of one (group,
// chunk, batch), the group's heads in order.  Each head: D of the band's
// rows against the other index (dC: dy_i . x_j, dB: x_j . dy_i), times
// dt_j exp(cum_i - cum_j)[j <= i] into LD; then the band's sum takes
//   LD @ [B (dC) or C (dB)] + [exp(cum_i) dy_i (dC) or
//   exp(tot - cum_j) dt_j x_j (dB)] @ [h_prev (dC) or g (dB)].
// Sixteen warps: 4 bands of 16 rows x 4 quarters of 32 columns (of D's
// other index, then of N).
template <bool kDB>
__device__ __forceinline__ void chunk_dbc(const BwdArgs& a, int rb, int grp) {
  extern __shared__ __align__(16) float smem[];
  const int l = a.l, N = a.N, P = a.P;
  const GrpLayout lay(l, N);
  const int LP = lay.LP, NP = lay.NP, ldg = lay.ldg, ldp = lay.ldp,
            ldm = lay.ldm;
  float* Grp = smem + lay.Grp;
  float* Band = smem + lay.Band;
  float* Oth = smem + lay.Oth;
  float* St = smem + lay.St;
  float* LD = smem + lay.LD;
  float* dts = smem + lay.dts;
  float* cum = smem + lay.cum;
  float* rf = smem + lay.rf;
  float* wp = smem + lay.wp;

  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int r0 = rb * kRows, s0 = c * l;
  const int olo = kDB ? r0 : 0, ohi = kDB ? LP : min(LP, r0 + kRows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int band = warp >> 2, qt = warp & 3, g = lane >> 2, q = lane & 3;
  const int rw = r0 + 16 * band, o0 = 32 * qt;
  const bool live = rw < l;
  // D's tile of this warp holds pairs that count, and its N columns exist
  const bool dlive = live && o0 < ohi && (kDB ? o0 + 32 > rw : o0 <= rw + 15);
  const bool nlive = live && o0 < NP;
  const int rep = a.H / a.G;
  const float* Gm = kDB ? a.C : a.B;
  const long long Gm_b = kDB ? a.C_b : a.B_b, Gm_s = kDB ? a.C_s : a.B_s,
                  Gm_g = kDB ? a.C_g : a.B_g;
  const float* Gmg = Gm + b * Gm_b + (long long)s0 * Gm_s + grp * Gm_g;
  const float* cbg = a.cb + (((long long)b * nc + c) * a.G + grp) * LP * LP;
  copy_tile(Grp + olo * ldg, ldg, Gmg + (long long)olo * Gm_s, Gm_s,
            ohi - olo, NP, [&](int r) { return olo + r < l ? N : 0; }, tid,
            kGrpThreads);

  float hi[4][4] = {}, lo[4][4] = {};
  const float* bw = Band + (16 * band + g) * ldp;
  const float* ldw = LD + (16 * band + g) * ldm;
  const float* rfw = rf + 16 * band + g;
  for (int h = grp * rep; h < (grp + 1) * rep; ++h) {
    const float* xg = a.x + b * a.x_b + (long long)s0 * a.x_s + h * a.x_h;
    const float* dyg = a.dy + b * a.dy_b + (long long)s0 * a.dy_s
        + h * a.dy_h;
    const float* bandg = kDB ? xg : dyg;
    const float* othg = kDB ? dyg : xg;
    const long long band_s = kDB ? a.x_s : a.dy_s;
    const long long oth_s = kDB ? a.dy_s : a.x_s;
    const float* stg = (kDB ? a.gst : a.hprev)
        + (((long long)b * nc + c) * a.H + h) * P * N;
    __syncthreads();               // the last head's tiles are read
    copy_col(dts, dt_col(a, b, h, s0), a.dt_s, l, LP, tid, kGrpThreads);
    copy_tile(Band, ldp, bandg + (long long)r0 * band_s, band_s, kRows,
              kMaxP, [&](int r) { return r0 + r < l ? P : 0; }, tid,
              kGrpThreads);
    copy_tile(Oth + olo * ldp, ldp, othg + (long long)olo * oth_s, oth_s,
              ohi - olo, kMaxP, [&](int r) { return olo + r < l ? P : 0; },
              tid, kGrpThreads);
    copy_tile(St, ldg, stg, N, kMaxP, NP,
              [&](int p) { return p < P ? N : 0; }, tid, kGrpThreads);
    cp_async_wait_all();
    __syncthreads();
    if (warp == 0) chunk_cum(dts, cum, -a.A[h], LP);
    __syncthreads();
    if (tid < kRows) {
      const int i = r0 + tid;
      rf[tid] = i >= l ? 0.f
              : kDB ? expf(cum[l - 1] - cum[i]) * dts[i] : expf(cum[i]);
    }
    // this warp's part of W's sums off the diagonal along the band's rows
    // (dC: sum_{j < i} W_ij; dB: sum_{i > j} W_ij), W = C B^T ⊙ L ⊙ D
    float ws[2] = {0.f, 0.f};
    if (dlive) {
      // D[r][o] = sum_p Band[r][p] Oth[o][p]: rows r, k = p, columns o
      float dhi[4][4] = {}, dlo[4][4] = {};
      warp_mma(dhi, dlo, [&](int u, int p) { return bw[8 * u * ldp + p]; },
               [&](int p, int cc) { return Oth[(o0 + cc) * ldp + p]; }, 0,
               P / 8);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rl = 16 * band + g + 8 * r, ra = r0 + rl;
          const float2 v = tile_sum(dhi, dlo, t, r);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = o0 + 8 * t + 2 * q + e;
            const int i = kDB ? o : ra, j = kDB ? ra : o;
            if (o >= LP) continue;   // a quarter past a ragged chunk's end
            const float ld = j <= i && i < l
                ? (e ? v.y : v.x) * dts[j] * expf(cum[i] - cum[j]) : 0.f;
            LD[rl * ldm + o] = ld;
            if (j < i && i < l) ws[r] += cbg[(long long)i * LP + j] * ld;
          }
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ws[r] += __shfl_xor_sync(0xffffffffu, ws[r], 1);
      ws[r] += __shfl_xor_sync(0xffffffffu, ws[r], 2);
      if (q == 0) wp[(16 * band + g + 8 * r) * 4 + qt] = ws[r];
    }
    __syncthreads();
    if (tid < kRows && r0 + tid < l) {
      const float* w4 = wp + tid * 4;
      (kDB ? a.wcol : a.wrow)[((long long)b * a.S + s0 + r0 + tid) * a.H + h]
          = ((w4[0] + w4[1]) + w4[2]) + w4[3];
    }
    if (nlive) {
      // rows r, k = the other index, columns n
      const int k0 = kDB ? rw / 8 : 0;
      const int k1 = kDB ? LP / 8 : min(rw + 16, ohi) / 8;
      warp_mma(hi, lo, [&](int u, int o) { return ldw[8 * u * ldm + o]; },
               [&](int o, int cc) { return Grp[o * ldg + o0 + cc]; }, k0, k1);
      // rows r, k = p, columns n
      warp_mma(hi, lo,
               [&](int u, int p) { return bw[8 * u * ldp + p] * rfw[8 * u]; },
               [&](int p, int cc) { return St[p * ldg + o0 + cc]; }, 0,
               P / 8);
    }
  }
  if (!nlive) return;
  float* out = (kDB ? a.dB : a.dC) + (((long long)b * a.S + s0) * a.G + grp)
      * N;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = rw + g + 8 * r, n = o0 + 8 * t + 2 * q;
      const float2 v = tile_sum(hi, lo, t, r);
      if (i >= l) continue;
      float* row = out + (long long)i * a.G * N;
      if (n < N) row[n] = v.x;
      if (n + 1 < N) row[n + 1] = v.y;
    }
}

// blockIdx.x = (group * row bands + band) * 2 + role
__global__ void __launch_bounds__(kGrpThreads, 1)
    ssd_bwd_chunk_dbc(const BwdArgs a) {
  const int nrb = (round_up(a.l, 16) + kRows - 1) / kRows;
  const int rb = (blockIdx.x >> 1) % nrb, grp = (blockIdx.x >> 1) / nrb;
  if (blockIdx.x & 1)
    chunk_dbc<true>(a, rb, grp);
  else
    chunk_dbc<false>(a, rb, grp);
}

// One warp per (batch, head, chunk), four positions a lane: dcum = (wrow -
// wcol) + q, plus the chunk's state sums at the last position; da its
// suffix sums (each lane's four, then a shuffle scan of the lanes' totals
// from the top); ddt = s - A da; dap = -sum dt da (a shuffle tree).
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_finish(const BwdArgs a, int nb, int nc, int W) {
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
  float v[4], dtv[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int k = 4 * lane + m;
    v[m] = dtv[m] = 0.f;
    if (k < l) {
      const long long e = (base + k) * a.H + h;
      v[m] = (a.wrow[e] - a.wcol[e]) + a.q[e] + (k == l - 1 ? last : 0.f);
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
    a.ddt[(base + k) * a.H + h] = a.sdot[(base + k) * a.H + h] - Ah * da;
    acc += dtv[m] * da;
  }
  acc = warp_sum(acc);
  if (lane == 0) a.dap[((long long)b * nc + c) * a.H + h] = -acc;
}

__global__ void __launch_bounds__(kThreads)
    ssd_bwd_da(const BwdArgs a, int bn) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= a.H) return;
  float s = 0.f;
  for (int k = 0; k < bn; ++k) s += a.dap[(long long)k * a.H + h];
  a.dA[h] = s;
}

size_t smem_bytes(int which, int l, int N) {
  switch (which) {
    case 0: return sizeof(float) * DstatesLayout(l).total;
    case 1: return sizeof(float) * DxLayout(l, N).total;
    default: return sizeof(float) * GrpLayout(l, N).total;
  }
}

typedef void (*Kernel)(BwdArgs);
const Kernel kSmemKernels[3] = {ssd_bwd_chunk_dstates, ssd_bwd_chunk_dx,
                                ssd_bwd_chunk_dbc};
const int kSmemThreads[3] = {kThreads, kThreads, kGrpThreads};

cudaError_t set_smem(int chunk, int N) {
  for (int k = 0; k < 3; ++k) {
    cudaError_t err = cudaFuncSetAttribute(
        kSmemKernels[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(k, chunk, N));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kSmemKernels[k],
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Grid of backward kernel ``which``: 0 dstates, 1 the state pass, 2 dx,
// 3 dB / dC, 4 the finish, 5 dA.
dim3 bwd_grid(int which, int b, int S, int H, int P, int G, int N,
              int chunk) {
  const int nc = S / chunk;
  const int nrb = (round_up(chunk, 16) + kRows - 1) / kRows;
  switch (which) {
    case 0: return dim3(H, nc, b);
    case 1: return dim3((P * N / 4 + kThreads - 1) / kThreads, b * H);
    case 2: return dim3(H / heads_per_block(H, G), nc * nrb, b);
    case 3: return dim3(2 * nrb * G, nc, b);
    case 4:
      return dim3((unsigned)(((long long)b * H * nc * 32 + kThreads - 1) /
                             kThreads));
    default: return dim3((H + kThreads - 1) / kThreads);
  }
}

}  // namespace

extern "C" {

int ssd_scan_bwd_max_p() { return kMaxP; }

// The grid (x, y, z) of backward kernel ``which`` (as bwd_grid) into xyz.
void ssd_scan_bwd_grid(int which, int b, int S, int H, int P, int G, int N,
                       int chunk, int* xyz) {
  const dim3 g = bwd_grid(which, b, S, H, P, G, N, chunk);
  xyz[0] = (int)g.x;
  xyz[1] = (int)g.y;
  xyz[2] = (int)g.z;
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

// Blocks of kernel ``which`` (as above) that one SM holds at once; -1 on
// error.
int ssd_scan_bwd_blocks_per_sm(int which, int chunk, int N) {
  int blocks = 0;
  if (which < 0 || which > 2 || set_smem(chunk, N) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kSmemKernels[which], kSmemThreads[which],
          smem_bytes(which, chunk, N)) != cudaSuccess)
    return -1;
  return blocks;
}

// x [b, S, H, P], dt [b, S, H], B/C [b, S, G, N], dy [b, S, H, P] (strides
// in elements, the last dim contiguous), A [H], dhfin contiguous
// [b, H, P, N] or null; from ssd_scan_states_launch (ssd_scan.cu) hfin
// [b, H, P, N], h_prev (its states buffer) [b, S/chunk, H, P, N], cb
// [b, S/chunk, G, LP, LP] and dec [b, H, S/chunk], all contiguous; scratch
// contiguous: gst like h_prev, lastp [b, H, S/chunk, W] (W from
// ssd_scan_bwd_state_warps), q, sdot, wrow and wcol [b, S, H], dap
// [b, S/chunk, H]; outputs contiguous: dx [b, S, H, P], ddt [b, S, H], dA
// [H], dB and dC [b, S, G, N]; all fp32.  Six launches on ``stream``;
// returns a cudaError_t.
int ssd_scan_bwd_launch(const float* x, const float* dt, const float* A,
                        const float* B, const float* C, const float* dy,
                        const float* dhfin, const float* hfin,
                        const float* hprev, const float* cb,
                        const float* dec, float* gst, float* lastp, float* q,
                        float* sdot, float* wrow, float* wcol, float* dap,
                        float* dx, float* ddt, float* dA, float* dB,
                        float* dC, int b, int S, int H, int P, int G, int N,
                        int chunk, long long x_b, long long x_s,
                        long long x_h, long long dt_b, long long dt_s,
                        long long dt_h, long long B_b, long long B_s,
                        long long B_g, long long C_b, long long C_s,
                        long long C_g, long long dy_b, long long dy_s,
                        long long dy_h, void* stream) {
  if (b <= 0 || chunk <= 0 || chunk > kMaxL || S <= 0 || S % chunk ||
      N <= 0 || N > kMaxN || P <= 0 || P % 16 || P > kMaxP || G <= 0 ||
      H % G)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{x,    dt,    A,     B,     C,    dy,   dhfin, hfin,
                  hprev, cb,   dec,   gst,   lastp, q,   sdot,  wrow,
                  wcol, dap,   dx,    ddt,   dA,   dB,   dC,    S,
                  H,    P,     G,     N,     chunk, x_b, x_s,   x_h,
                  dt_b, dt_s,  dt_h,  B_b,   B_s,  B_g,  C_b,   C_s,
                  C_g,  dy_b,  dy_s,  dy_h};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = S / chunk, W = ssd_scan_bwd_state_warps(P, N);
  auto grid = [&](int which) {
    return bwd_grid(which, b, S, H, P, G, N, chunk);
  };
  const cudaError_t set = set_smem(chunk, N);
  if (set != cudaSuccess) return (int)set;
  ssd_bwd_chunk_dstates<<<grid(0), kThreads, smem_bytes(0, chunk, N), s>>>(
      a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_state_pass<<<grid(1), kThreads, 0, s>>>(a, nc, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_chunk_dx<<<grid(2), kThreads, smem_bytes(1, chunk, N), s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_chunk_dbc<<<grid(3), kGrpThreads, smem_bytes(2, chunk, N), s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_finish<<<grid(4), kThreads, 0, s>>>(a, b, nc, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_da<<<grid(5), kThreads, 0, s>>>(a, b * nc);
  return (int)cudaGetLastError();
}

}  // extern "C"
