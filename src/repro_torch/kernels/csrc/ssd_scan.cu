// Mamba2 SSD scan for Hopper (sm_90a), built by repro_torch/kernels/build.py
// with nvcc into a shared library with a plain C interface and called
// through ctypes from repro_torch/kernels/ssd_scan.py.  Compiled without
// --use_fast_math: expf is the accurate version.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan
// (pallas_call at ssd_scan.py:111), which walks the chunks of each
// (batch, head) in order with the [P, N] state in VMEM.  Here the SSD's own
// chunk-parallel split (the dataflow of repro_torch.nn.ssm.ssd_chunked) runs
// as four launches, and only an elementwise recurrence is sequential:
//   1. ssd_scan_chunk_states, one block per (head, chunk, batch):
//        cum    = cumsum(-A dt)                                  [l]
//        states = (x dt)^T @ (exp(cum_l - cum) ⊙ B)              [P, N]
//        dec    = exp(cum_l)
//   2. ssd_scan_chunk_cb, one block per (64 rows, group, chunk, batch):
//        cb     = C B^T                                          [l, l]
//      once per group, not per head (zamba2 has one group for 64 heads).
//   3. ssd_scan_state_pass, one thread per four (batch, head, p, n) chains:
//        h <- h dec_c + states_c over the chunks, storing the state before
//        each chunk in place of states_c, the last one in hfin.
//   4. ssd_scan_chunk_out, one block per (16 heads, 64 rows of a chunk,
//      batch), two teams of 8 warps taking the heads in turn:
//        y = [cb ⊙ exp(cum_i - cum_j)[j <= i] | exp(cum) ⊙ C]
//            @ [x dt ; h_prev^T]                                 [l, P]
// Head h reads B/C group h / (H / G).  Every exponent is a difference
// cum_i - cum_j with j <= i, or cum itself, so it is <= 0: no factor
// exp(-cum_j), which overflows fp32 once a chunk's decay passes e^-88.
//
// Products: mma.sync m16n8k8 on the tensor cores as split TF32, a = a_hi +
// a_lo with a_hi = a cut to TF32 (its top 19 bits, one AND) and a_lo =
// a - a_hi, of which the tensor cores read the top 19 bits; a_lo b_hi +
// a_hi b_lo + a_hi b_hi sum into fp32 accumulators: about 20 bits of each
// product, where one TF32 pass keeps 10 (too few for the 2e-4 bar:
// tests/test_torch_ssd_plan.py emulates both).  Eight warps a block (a
// team, in the output kernel), a warp 16 rows x 32 columns (four m16n8
// tiles); the outputs skip the k steps above the diagonal of their rows.
// A block or team issues all the global reads of an item at once as
// cp.async copies into shared memory (16 bytes a lane where a tile's base
// and row stride allow it, else 4; zero-filled past the edges; read
// through the inputs' strides) and waits once.  dt, the decays and
// exp(cum) are applied as the fragments are read (see ssd_scan_chunk_out).
//
// What bounds it on this card: bytes.  At the prefill's call (b = 2,
// S = 8192, H = 64, P = N = 64, G = 1, l = 128) the inputs and outputs are
// 551.5 MB (0.165 ms at 3.35 TB/s) and the work 26 GFLOP counted once
// (0.157 ms at split TF32's 165 TFLOP/s); the scratch adds the states
// [b, S/l, H, P, N] (134 MB: written, read and written, read) and cb
// (8.4 MB).  What holds it back is latency: a team's copies, scan and
// products run in turn, and registers (~126 a thread in the output
// kernel) leave room for 16 warps an SM.
// Shared memory: 75 KB (states), 52 KB (cb), 162 KB (out) at l = 128,
// N = 64: three state blocks or one output block an SM.  Limits (raised
// by the wrapper): l <= 128, N <= 128, P a multiple of 16.  Every sum runs
// in a fixed order, no atomics: two launches give the same bits.  The
// tile sizes and the split-TF32, scan and copy helpers are in
// ssd_common.cuh, shared with the backward (ssd_scan_bwd.cu).

#include "ssd_common.cuh"

namespace {

constexpr int kOutThreads = 512;   // the output kernel: two teams of 8 warps

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  float* hfin;
  float* states;   // [b, nc, H, P, N]: chunk states, then each h_prev
  float* cb;       // [b, nc, G, LP, LP]: C B^T of each chunk and group
  float* dec;      // [b, H, nc]: exp(cum_l) of each chunk
  int S, H, P, G, N, l;
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, B_b, B_s, B_g, C_b, C_s, C_g;
};

struct StatesLayout {              // offsets in floats into shared memory
  int LP, dts, cum, wdec, X, Bs, total;
  __host__ __device__ explicit StatesLayout(int l) {
    LP = round_up(l, 16);
    dts = 0;
    cum = dts + LP;
    wdec = cum + LP;
    X = wdec + LP;                 // x           [LP][kLdRow]
    Bs = X + LP * kLdRow;          // B           [LP][kLdRow]
    total = Bs + LP * kLdRow;
  }
};

struct CbLayout {
  int LP, NP, JP, ldk, Cs, Bs, total;
  __host__ __device__ CbLayout(int l, int N) {
    LP = round_up(l, 16);
    NP = round_up(N, 8);
    JP = round_up(LP, kCols);      // rows of Bs read by a 64-column tile
    ldk = NP + 4;
    Cs = 0;                        // C rows   [kRows][ldk]
    Bs = Cs + kRows * ldk;         // B rows   [JP][ldk]
    total = Bs + JP * ldk;
  }
};

struct OutLayout {                 // a stage for each of two teams
  int LP, NP, ldm, ldk, CB, Cr, stage, stage_size, dts, cum, fac, X, Hp,
      total;
  __host__ __device__ OutLayout(int l, int N) {
    LP = round_up(l, 16);
    NP = round_up(N, 8);
    ldm = LP + 4;
    ldk = NP + 4;
    CB = 0;                        // C B^T rows      [kRows][ldm]
    Cr = CB + kRows * ldm;         // C rows          [kRows][ldk]
    stage = Cr + kRows * ldk;
    dts = 0;                       // within a stage: dt [LP],
    cum = dts + LP;                // cum             [LP]
    fac = cum + LP;                // column factors  [kRows / 16][LP]
    X = fac + kRows / 16 * LP;     // x               [LP][kLdRow]
    Hp = X + LP * kLdRow;          // h_prev          [kCols][ldk]
    stage_size = Hp + kCols * ldk;
    total = stage + 2 * stage_size;
  }
};

// The chunk's dt, zero past l (completes with the block's next wait).
__device__ __forceinline__ void copy_dt(const Args& a, int b, int h, int s0,
                                        float* dts, int LP, int tid,
                                        int nthreads) {
  const float* dtg = a.dt + b * a.dt_b + (long long)s0 * a.dt_s + h * a.dt_h;
  for (int i = tid; i < LP; i += nthreads)
    cp_async4(dts + i, i < a.l ? dtg + (long long)i * a.dt_s : dtg,
              i < a.l ? 4 : 0);
}

__global__ void __launch_bounds__(kThreads, 3)
    ssd_scan_chunk_states(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int l = a.l, N = a.N, P = a.P;
  const StatesLayout lay(l);
  const int LP = lay.LP;
  float* dts = smem + lay.dts;
  float* cum = smem + lay.cum;
  float* wdec = smem + lay.wdec;
  float* X = smem + lay.X;
  float* Bs = smem + lay.Bs;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int grp = h / (a.H / a.G), s0 = c * l;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int band = warp >> 1, half = warp & 1, g = lane >> 2, q = lane & 3;
  const float* xg = a.x + b * a.x_b + (long long)s0 * a.x_s + h * a.x_h;
  const float* Bg = a.B + b * a.B_b + (long long)s0 * a.B_s + grp * a.B_g;
  float* st = a.states + (((long long)b * nc + c) * a.H + h) * P * N;

  auto copy_x = [&](int p0) {
    copy_tile(X, kLdRow, xg + p0, a.x_s, LP, kCols,
              [&](int j) { return j < l ? min(kCols, P - p0) : 0; }, tid,
              kThreads);
  };
  auto copy_b = [&](int n0) {
    copy_tile(Bs, kLdRow, Bg + n0, a.B_s, LP, kCols,
              [&](int j) { return j < l ? min(kCols, N - n0) : 0; }, tid,
              kThreads);
  };
  copy_dt(a, b, h, s0, dts, LP, tid, kThreads);
  copy_x(0);
  copy_b(0);
  cp_async_wait_all();
  __syncthreads();
  if (warp == 0) chunk_cum(dts, cum, -a.A[h], LP);
  __syncthreads();
  const float tot = cum[l - 1];
  for (int j = tid; j < LP; j += kThreads)
    wdec[j] = j < l ? expf(tot - cum[j]) : 0.f;
  if (tid == 0) a.dec[((long long)b * a.H + h) * nc + c] = expf(tot);

  for (int p0 = 0; p0 < P; p0 += kCols) {
    for (int n0 = 0; n0 < N; n0 += kCols) {
      __syncthreads();             // wdec written; the last tile read
      if (p0 || n0) {              // the first tiles came with dt
        if (n0 == 0) copy_x(p0);
        copy_b(n0);
        cp_async_wait_all();
        __syncthreads();
      }
      // states[p][n] = sum_j (x[j][p] dt_j) (B[j][n] wdec_j): rows p,
      // k = j, columns n
      float hi[4][4] = {}, lo[4][4] = {};
      const float* xw = X + 16 * band + g;
      const float* bw = Bs + 32 * half;
      warp_mma(hi, lo,
               [&](int u, int j) { return xw[j * kLdRow + 8 * u] * dts[j]; },
               [&](int j, int cc) { return bw[j * kLdRow + cc] * wdec[j]; },
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

__global__ void __launch_bounds__(kThreads) ssd_scan_chunk_cb(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int l = a.l, N = a.N;
  const CbLayout lay(l, N);
  const int LP = lay.LP, NP = lay.NP, ldk = lay.ldk;
  float* Cs = smem + lay.Cs;
  float* Bs = smem + lay.Bs;

  const int nrb = (LP + kRows - 1) / kRows;
  const int grp = blockIdx.x / nrb, i0 = (blockIdx.x % nrb) * kRows;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y, s0 = c * l;
  const int jn = min(LP, i0 + kRows);          // columns j <= the last row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int band = warp >> 1, half = warp & 1, g = lane >> 2, q = lane & 3;
  const float* Bg = a.B + b * a.B_b + (long long)s0 * a.B_s + grp * a.B_g;
  const float* Cg = a.C + b * a.C_b + (long long)s0 * a.C_s + grp * a.C_g;
  float* out = a.cb + (((long long)b * nc + c) * a.G + grp) * LP * LP;

  copy_tile(Cs, ldk, Cg + (long long)i0 * a.C_s, a.C_s, kRows, NP,
            [&](int r) { return i0 + r < l ? N : 0; }, threadIdx.x,
            kThreads);
  copy_tile(Bs, ldk, Bg, a.B_s, lay.JP, NP,
            [&](int j) { return j < jn && j < l ? N : 0; }, threadIdx.x,
            kThreads);
  cp_async_wait_all();
  __syncthreads();
  for (int j0 = 0; j0 < jn; j0 += kCols) {
    // cb[i][j] = sum_n C[i][n] B[j][n]: rows i, k = n, columns j
    float hi[4][4] = {}, lo[4][4] = {};
    const float* cw = Cs + (16 * band + g) * ldk;
    const float* bw = Bs + (j0 + 32 * half) * ldk;
    warp_mma(hi, lo, [&](int u, int n) { return cw[8 * u * ldk + n]; },
             [&](int n, int jj) { return bw[jj * ldk + n]; }, 0, NP / 8);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + 16 * band + g + 8 * r;
        const int j = j0 + 32 * half + 8 * t + 2 * q;
        if (i < LP && j < jn)
          *reinterpret_cast<float2*>(out + (long long)i * LP + j) =
              tile_sum(hi, lo, t, r);
      }
  }
}

// One thread per four consecutive (p, n) of a (batch, head): the states of
// the nc chunks, eight loads in flight ahead of the recurrence.
__global__ void __launch_bounds__(kThreads)
    ssd_scan_state_pass(const Args a, int nc, long long chains) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= chains) return;
  const int PN4 = a.P * a.N / 4;
  const long long bh = t / PN4;
  const int e4 = (int)(t - bh * PN4);
  const long long b = bh / a.H, h = bh - b * a.H;
  float4* st = reinterpret_cast<float4*>(a.states)
      + (b * nc * a.H + h) * PN4 + e4;
  const long long cs = (long long)a.H * PN4;     // one chunk, in float4
  const float* dec = a.dec + bh * nc;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kAhead = 8;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 s[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (c0 + k < nc) s[k] = st[(c0 + k) * cs];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (c0 + k < nc) {
        st[(c0 + k) * cs] = run;
        const float d = dec[c0 + k];
        run = make_float4(run.x * d + s[k].x, run.y * d + s[k].y,
                          run.z * d + s[k].z, run.w * d + s[k].w);
      }
  }
  reinterpret_cast<float4*>(a.hfin)[t] = run;
}

// The decay of row i from column j <= i is exp(cum_i - cum_j).  For a
// warp's 16-row band from row i_b, the columns j < i_b take it as
// exp(cum_i - cum_r) exp(cum_r - cum_j) with r = i_b - 1: a factor of the
// row, in registers, and one of the column, fac[band][j] (with dt_j folded
// in), both <= 1, so neither overflows; the band's own 16 x 16 diagonal
// block takes exp(cum_i - cum_j) dt_j for each element, masked to j <= i.
// The decay enters the product as the A fragments are read.
//
// One block walks through heads_per_block heads (and the 64-column tiles
// of P) of one (64 rows of a chunk, batch), C B^T and C copied once.  Two
// teams of 8 warps take the items in turn, each with its own stage of dt,
// x and h_prev and its own barrier, so that one team's loads, scan and
// stores overlap the other's products, as two blocks an SM would, without
// a block's launch and its copy of C B^T for every head.
__global__ void __launch_bounds__(kOutThreads, 1)
    ssd_scan_chunk_out(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int l = a.l, N = a.N, P = a.P;
  const OutLayout lay(l, N);
  const int LP = lay.LP, NP = lay.NP, ldm = lay.ldm, ldk = lay.ldk;
  float* CB = smem + lay.CB;
  float* Cr = smem + lay.Cr;

  const int nrb = (LP + kRows - 1) / kRows, nc = gridDim.y / nrb;
  const int c = blockIdx.y / nrb, b = blockIdx.z;
  const int i0 = (blockIdx.y % nrb) * kRows, s0 = c * l;
  const int hg = heads_per_block(a.H, a.G), h0 = blockIdx.x * hg;
  const int grp = h0 / (a.H / a.G);
  const int npt = (P + kCols - 1) / kCols, items = hg * npt;
  const int jn = min(LP, i0 + kRows);          // columns j <= the last row
  const int team = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const int band = warp >> 1, half = warp & 1, g = lane >> 2, q = lane & 3;
  const float* Cg = a.C + b * a.C_b + (long long)s0 * a.C_s + grp * a.C_g;
  const float* cbg = a.cb + (((long long)b * nc + c) * a.G + grp) * LP * LP;
  float* st = smem + lay.stage + team * lay.stage_size;
  float* dts = st + lay.dts;
  float* X = st + lay.X;
  float* Hp = st + lay.Hp;
  float* cum = st + lay.cum;
  float* fac = st + lay.fac;
  auto team_sync = [&]() {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "n"(kThreads));
  };

  copy_tile(CB, ldm, cbg + (long long)i0 * LP, LP, kRows, jn,
            [&](int r) { return i0 + r < l ? min(jn, i0 + r + 1) : 0; },
            threadIdx.x, kOutThreads);
  copy_tile(Cr, ldk, Cg + (long long)i0 * a.C_s, a.C_s, kRows, NP,
            [&](int r) { return i0 + r < l ? N : 0; }, threadIdx.x,
            kOutThreads);
  cp_async_wait_all();
  __syncthreads();

  // this thread's rows i0 + 16 band + g + 8u, u = 0, 1
  const int ib = i0 + 16 * band, iu[2] = {ib + g, ib + g + 8};
  const bool live = ib < l;
  const float* cbw = CB + (16 * band + g) * ldm;
  const float* crw = Cr + (16 * band + g) * ldk;
  const float* facw = fac + band * LP;
  for (int k = team; k < items; k += 2) {
    const int h = h0 + k / npt, p0 = (k % npt) * kCols;
    const float* xg = a.x + b * a.x_b + (long long)s0 * a.x_s + h * a.x_h;
    const float* hp = a.states + (((long long)b * nc + c) * a.H + h) * P * N;
    team_sync();                   // the team's last item is read
    copy_dt(a, b, h, s0, dts, LP, tid, kThreads);
    copy_tile(X, kLdRow, xg + p0, a.x_s, jn, kCols,
              [&](int j) { return j < l ? min(kCols, P - p0) : 0; }, tid,
              kThreads);
    copy_tile(Hp, ldk, hp + (long long)p0 * N, N, kCols, NP,
              [&](int pp) { return p0 + pp < P ? N : 0; }, tid, kThreads);
    cp_async_wait_all();
    team_sync();
    if (warp == 0) chunk_cum(dts, cum, -a.A[h], LP);
    team_sync();
    for (int e = tid; e < kRows / 16 * LP; e += kThreads) {
      const int bb = e / LP, j = e - bb * LP, r = i0 + 16 * bb - 1;
      fac[e] = j <= r ? expf(cum[r] - cum[j]) * dts[j] : 0.f;
    }
    team_sync();
    if (!live) continue;
    float ci[2], er[2], ec[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      ci[u] = cum[iu[u]];
      er[u] = ib > 0 ? expf(ci[u] - cum[ib - 1]) : 0.f;
      ec[u] = iu[u] < l ? expf(ci[u]) : 0.f;
    }
    auto below = [&](int u, int j) {         // columns left of the band
      return cbw[8 * u * ldm + j] * er[u] * facw[j];
    };
    auto diag = [&](int u, int j) {          // the band's diagonal block
      return j <= iu[u] ? cbw[8 * u * ldm + j] * expf(ci[u] - cum[j]) * dts[j]
                        : 0.f;
    };
    auto ecr = [&](int u, int n) { return crw[8 * u * ldk + n] * ec[u]; };
    auto xr = [&](int j, int cc) { return X[j * kLdRow + 32 * half + cc]; };
    auto hr = [&](int n, int cc) { return Hp[(32 * half + cc) * ldk + n]; };
    // y[i][p] = sum_{j <= i} C B^T[i][j] decay(i, j) dt_j x[j][p]
    //         + sum_n exp(cum_i) C[i][n] h_prev[p][n]
    float hi[4][4] = {}, lo[4][4] = {};
    warp_mma(hi, lo, below, xr, 0, ib / 8);
    warp_mma(hi, lo, diag, xr, ib / 8, ib / 8 + 2);
    warp_mma(hi, lo, ecr, hr, 0, NP / 8);
    float* yg = a.y + (((long long)b * a.S + s0) * a.H + h) * P;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = iu[r];
        const int p = p0 + 32 * half + 8 * t + 2 * q;
        if (i < l && p < P)
          *reinterpret_cast<float2*>(yg + (long long)i * a.H * P + p) =
              tile_sum(hi, lo, t, r);
      }
  }
}

size_t smem_bytes(int which, int l, int N) {
  switch (which) {
    case 0: return sizeof(float) * StatesLayout(l).total;
    case 1: return sizeof(float) * CbLayout(l, N).total;
    default: return sizeof(float) * OutLayout(l, N).total;
  }
}

typedef void (*Kernel)(Args);
const Kernel kSmemKernels[3] = {ssd_scan_chunk_states, ssd_scan_chunk_cb,
                                ssd_scan_chunk_out};
const int kSmemThreads[3] = {kThreads, kThreads, kOutThreads};

// Dynamic shared memory of the three tile kernels, and the largest carveout
// of the SM's memory for it, so that two output blocks fit one SM.
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

// The forward's launches on ``stream``: kernels 1-3 and, when ``outputs``,
// kernel 4 (the backward takes the states, C B^T and the decays alone).
int launch(const Args& a, int b, bool outputs, cudaStream_t s) {
  const int S = a.S, H = a.H, P = a.P, G = a.G, N = a.N, chunk = a.l;
  if (b <= 0 || chunk <= 0 || chunk > kMaxL || S <= 0 || S % chunk ||
      N <= 0 || N > kMaxN || P <= 0 || P % 16 || G <= 0 || H % G)
    return (int)cudaErrorInvalidValue;
  const int nc = S / chunk;
  const int nrb = (round_up(chunk, 16) + kRows - 1) / kRows;
  const cudaError_t set = set_smem(chunk, N);
  if (set != cudaSuccess) return (int)set;
  ssd_scan_chunk_states<<<dim3(H, nc, b), kThreads, smem_bytes(0, chunk, N),
                          s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_scan_chunk_cb<<<dim3(G * nrb, nc, b), kThreads,
                      smem_bytes(1, chunk, N), s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long chains = (long long)b * H * P * N / 4;
  ssd_scan_state_pass<<<(unsigned)((chains + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>(a, nc, chains);
  if ((err = cudaGetLastError()) != cudaSuccess || !outputs) return (int)err;
  ssd_scan_chunk_out<<<dim3(H / heads_per_block(H, G), nc * nrb, b),
                       kOutThreads,
                       smem_bytes(2, chunk, N), s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ssd_scan_max_chunk() { return kMaxL; }
int ssd_scan_max_state() { return kMaxN; }

// Shared memory of a block of the states (0), cb (1) and output (2) kernels.
long long ssd_scan_smem_bytes(int which, int chunk, int N) {
  return (long long)smem_bytes(which, chunk, N);
}

// Blocks of kernel ``which`` (as above) that one SM holds at once; -1 on
// error.
int ssd_scan_blocks_per_sm(int which, int chunk, int N) {
  int blocks = 0;
  if (which < 0 || which > 2 || set_smem(chunk, N) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kSmemKernels[which], kSmemThreads[which],
          smem_bytes(which, chunk, N)) != cudaSuccess)
    return -1;
  return blocks;
}

// x [b, S, H, P], dt [b, S, H], B/C [b, S, G, N] (strides in elements, the
// last dim contiguous), A [H]; y contiguous [b, S, H, P], hfin contiguous
// [b, H, P, N]; scratch contiguous: states [b, S/chunk, H, P, N], cb
// [b, S/chunk, G, LP, LP] with LP = chunk rounded up to 16, dec
// [b, H, S/chunk]; all fp32.  Four launches on ``stream``; returns a
// cudaError_t.
int ssd_scan_launch(const float* x, const float* dt, const float* A,
                    const float* B, const float* C, float* y, float* hfin,
                    float* states, float* cb, float* dec,
                    int b, int S, int H, int P, int G, int N, int chunk,
                    long long x_b, long long x_s, long long x_h,
                    long long dt_b, long long dt_s, long long dt_h,
                    long long B_b, long long B_s, long long B_g,
                    long long C_b, long long C_s, long long C_g,
                    void* stream) {
  const Args a{x,   dt,  A,   B,   C,   y,   hfin, states, cb,  dec,
               S,   H,   P,   G,   N,   chunk, x_b, x_s,   x_h, dt_b,
               dt_s, dt_h, B_b, B_s, B_g, C_b, C_s, C_g};
  return launch(a, b, true, static_cast<cudaStream_t>(stream));
}

// As ssd_scan_launch without y: kernels 1-3, leaving the state before each
// chunk in ``states``, C B^T in ``cb``, exp(tot) in ``dec`` and the final
// state in ``hfin`` (three launches; the backward's recomputation).
int ssd_scan_states_launch(const float* x, const float* dt, const float* A,
                           const float* B, const float* C, float* hfin,
                           float* states, float* cb, float* dec,
                           int b, int S, int H, int P, int G, int N,
                           int chunk, long long x_b, long long x_s,
                           long long x_h, long long dt_b, long long dt_s,
                           long long dt_h, long long B_b, long long B_s,
                           long long B_g, long long C_b, long long C_s,
                           long long C_g, void* stream) {
  const Args a{x,   dt,  A,   B,   C,   nullptr, hfin, states, cb,  dec,
               S,   H,   P,   G,   N,   chunk,   x_b,  x_s,    x_h, dt_b,
               dt_s, dt_h, B_b, B_s, B_g, C_b,   C_s,  C_g};
  return launch(a, b, false, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
