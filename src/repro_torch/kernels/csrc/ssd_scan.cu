// Mamba2 SSD chunk pass for Hopper (sm_90a), built by
// repro_torch/kernels/build.py with nvcc into a shared library with a plain C
// interface and called through ctypes from repro_torch/kernels/ssd_scan.py.
// Compiled without --use_fast_math: expf is the accurate version.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan
// (pallas_call at ssd_scan.py:111).  For each (batch, head) and each chunk
// of l steps, in order, with the [P, N] state h carried across chunks:
//   cum   = cumsum(-A dt)                                   [l]
//   y     = (C B^T ⊙ exp(cum_i - cum_j)[j <= i]) @ (x dt)
//           + exp(cum) ⊙ (C @ h^T)                          [l, P]
//   h    <- h exp(cum_l) + (x dt)^T @ (exp(cum_l - cum) ⊙ B) [P, N]
// Head h reads B/C group h / (H / G).  Returns y and the final state.
//
// What bounds it on this card: operations.  Per (batch, head, chunk) it does
// about l^2 (N + P) + 4 l N P flops on l (P + 2N + 1) input floats; at the
// path's l = 128, P = N = 64 that is ~170 flops per input float (~40 per
// byte, above the card's fp32 ridge of 20), all fp32 on the CUDA cores
// (67 TFLOP/s peak).
//
// Design: one block of 256 threads per (16 columns of P, head, batch).  The
// state's rows p are independent, so slicing P gives the card 4x the
// blocks at P = 64 (512 at the path's b = 2, H = 64), at the price of each
// block recomputing the chunk's C B^T.  The Pallas grid walks the chunk axis
// in sequence with h in VMEM scratch; here that axis is a loop inside the
// block, with h (transposed, [N][16]) in shared memory.  Per chunk, staged
// in shared memory: B and C transposed ([N][l]), x dt ([l][16]), dt, cum
// and the decays to the chunk's end; then
//   1. the lower-triangle 4x4 tiles of G = C B^T ⊙ decay, one tile per
//      thread (float4 loads of C^T and B^T, 16 FMAs per pair of loads);
//   2. y for two rows and four columns per thread: G's rows against x dt,
//      plus exp(cum_i) C_i against h (the state before this chunk);
//   3. h for four columns and one n per thread, in place.
// The cumulative sum is one warp's shuffle scan.  Limits (raised by the
// wrapper): l <= 128, N <= 128, P a multiple of 16 (shared memory: 216 KB
// at l = N = 128).  Every sum runs in a fixed order, no atomics: two
// launches give the same bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPB = 16;            // columns of P per block
constexpr int kMaxL = 128;         // chunk length
constexpr int kMaxN = 128;         // state size

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  float* hfin;
  int S, H, P, G, N, l;
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, B_b, B_s, B_g, C_b, C_s, C_g;
};

struct Layout {                    // offsets in floats into shared memory
  int LP, LS, Ct, Bt, Gs, Xs, hT, dts, cum, wdec, total;
  __host__ __device__ Layout(int l, int N) {
    LP = (l + 3) & ~3;             // chunk rounded up to the 4x4 tiles
    LS = LP + 4;                   // row stride of the transposed arrays
    Ct = 0;
    Bt = Ct + N * LS;
    Gs = Bt + N * LS;
    Xs = Gs + LP * LS;
    hT = Xs + LP * kPB;
    dts = hT + N * kPB;
    cum = dts + LP;
    wdec = cum + LP;
    total = wdec + LP;
  }
};

__device__ __forceinline__ float4 f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int l = a.l, N = a.N;
  const Layout lay(l, N);
  const int LP = lay.LP, LS = lay.LS;
  float* Ct = smem + lay.Ct;
  float* Bt = smem + lay.Bt;
  float* Gs = smem + lay.Gs;
  float* Xs = smem + lay.Xs;
  float* hT = smem + lay.hT;
  float* dts = smem + lay.dts;
  float* cum = smem + lay.cum;
  float* wdec = smem + lay.wdec;

  const int p0 = blockIdx.x * kPB, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x, lane = tid & 31;
  const float negA = -a.A[h];
  const float* xg = a.x + b * a.x_b + h * a.x_h + p0;
  const float* dtg = a.dt + b * a.dt_b + h * a.dt_h;
  const float* Bg = a.B + b * a.B_b + g * a.B_g;
  const float* Cg = a.C + b * a.C_b + g * a.C_g;
  float* yg = a.y + ((long long)b * a.S * a.H + h) * a.P + p0;

  for (int e = tid; e < N * kPB; e += kThreads) hT[e] = 0.f;

  const int na = LP / 4;                       // 4x4 tiles per side
  const int n_tri = na * (na + 1) / 2;         // lower-triangle tiles

  for (int s0 = 0; s0 < a.S; s0 += l) {
    // -- stage the chunk ----------------------------------------------------
    for (int i = tid; i < LP; i += kThreads)
      dts[i] = i < l ? dtg[(s0 + i) * a.dt_s] : 0.f;
    for (int e = tid; e < LP * N; e += kThreads) {
      const int i = e / N, n = e - i * N;
      const bool in = i < l;
      Bt[n * LS + i] = in ? Bg[(s0 + i) * a.B_s + n] : 0.f;
      Ct[n * LS + i] = in ? Cg[(s0 + i) * a.C_s + n] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < LP * kPB; e += kThreads) {
      const int i = e / kPB, pp = e - i * kPB;
      Xs[e] = i < l ? xg[(s0 + i) * a.x_s + pp] * dts[i] : 0.f;
    }
    if (tid < 32) {                 // cum = cumsum(-A dt): one warp's scan
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * lane + k;
        run += i < LP ? negA * dts[i] : 0.f;
        v[k] = run;
      }
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * lane + k < LP) cum[4 * lane + k] = excl + v[k];
      __syncwarp();
      const float tot = cum[l - 1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * lane + k;
        if (i < LP) wdec[i] = i < l ? expf(tot - cum[i]) : 0.f;
      }
    }
    __syncthreads();

    // -- 1. G = C B^T ⊙ exp(cum_i - cum_j), j <= i, in 4x4 tiles ------------
    for (int t = tid; t < n_tri; t += kThreads) {
      int ta = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while ((ta + 1) * (ta + 2) / 2 <= t) ++ta;
      while (ta * (ta + 1) / 2 > t) --ta;
      const int tb = t - ta * (ta + 1) / 2;
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        const float4 c = f4(Ct + n * LS + 4 * ta);
        const float4 bb = f4(Bt + n * LS + 4 * tb);
        const float cv[4] = {c.x, c.y, c.z, c.w};
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(cv[r], bv[s], acc[r][s]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ta + r;
        float out[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int j = 4 * tb + s;
          out[s] = j <= i ? acc[r][s] * expf(cum[i] - cum[j]) : 0.f;
        }
        *reinterpret_cast<float4*>(Gs + i * LS + 4 * tb) =
            make_float4(out[0], out[1], out[2], out[3]);
      }
    }
    __syncthreads();

    // -- 2. y = G @ (x dt) + exp(cum) ⊙ (C @ h^T), two rows x four columns --
    for (int t = tid; t < (LP / 2) * 4; t += kThreads) {
      const int i0 = 2 * (t >> 2), pq = 4 * (t & 3);
      float y0[4] = {}, y1[4] = {}, z0[4] = {}, z1[4] = {};
      const int jmax = min(i0 + 1, l - 1);
      for (int j = 0; j <= jmax; ++j) {
        const float g0 = Gs[i0 * LS + j], g1 = Gs[(i0 + 1) * LS + j];
        const float4 xv = f4(Xs + j * kPB + pq);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          y0[s] = fmaf(g0, xs[s], y0[s]);
          y1[s] = fmaf(g1, xs[s], y1[s]);
        }
      }
      for (int n = 0; n < N; ++n) {
        const float c0 = Ct[n * LS + i0], c1 = Ct[n * LS + i0 + 1];
        const float4 hv = f4(hT + n * kPB + pq);
        const float hs[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          z0[s] = fmaf(c0, hs[s], z0[s]);
          z1[s] = fmaf(c1, hs[s], z1[s]);
        }
      }
      const float e0 = expf(cum[i0]), e1 = expf(cum[i0 + 1]);
      if (i0 < l) {
        float* row = yg + (long long)(s0 + i0) * a.H * a.P + pq;
        *reinterpret_cast<float4*>(row) =
            make_float4(y0[0] + e0 * z0[0], y0[1] + e0 * z0[1],
                        y0[2] + e0 * z0[2], y0[3] + e0 * z0[3]);
      }
      if (i0 + 1 < l) {
        float* row = yg + (long long)(s0 + i0 + 1) * a.H * a.P + pq;
        *reinterpret_cast<float4*>(row) =
            make_float4(y1[0] + e1 * z1[0], y1[1] + e1 * z1[1],
                        y1[2] + e1 * z1[2], y1[3] + e1 * z1[3]);
      }
    }
    __syncthreads();

    // -- 3. h <- h exp(cum_l) + (x dt)^T @ (exp(cum_l - cum) ⊙ B) -----------
    const float dec = expf(cum[l - 1]);
    for (int t = tid; t < N * 4; t += kThreads) {
      const int pq = 4 * (t & 3), n = t >> 2;
      float acc[4] = {};
      for (int j = 0; j < l; ++j) {
        const float w = wdec[j] * Bt[n * LS + j];
        const float4 xv = f4(Xs + j * kPB + pq);
        acc[0] = fmaf(xv.x, w, acc[0]);
        acc[1] = fmaf(xv.y, w, acc[1]);
        acc[2] = fmaf(xv.z, w, acc[2]);
        acc[3] = fmaf(xv.w, w, acc[3]);
      }
      float* hp = hT + n * kPB + pq;
      const float4 hv = f4(hp);
      *reinterpret_cast<float4*>(hp) =
          make_float4(hv.x * dec + acc[0], hv.y * dec + acc[1],
                      hv.z * dec + acc[2], hv.w * dec + acc[3]);
    }
    __syncthreads();
  }

  float* hf = a.hfin + (((long long)b * a.H + h) * a.P + p0) * N;
  for (int e = tid; e < kPB * N; e += kThreads) {
    const int pp = e / N, n = e - pp * N;
    hf[pp * N + n] = hT[n * kPB + pp];
  }
}

}  // namespace

extern "C" {

int ssd_scan_max_chunk() { return kMaxL; }
int ssd_scan_max_state() { return kMaxN; }

// x [b, S, H, P], dt [b, S, H], B/C [b, S, G, N] (strides in elements, the
// last dim contiguous), A [H]; y contiguous [b, S, H, P], hfin contiguous
// [b, H, P, N]; all fp32.  Returns a cudaError_t.
int ssd_scan_launch(const float* x, const float* dt, const float* A,
                    const float* B, const float* C, float* y, float* hfin,
                    int b, int S, int H, int P, int G, int N, int chunk,
                    long long x_b, long long x_s, long long x_h,
                    long long dt_b, long long dt_s, long long dt_h,
                    long long B_b, long long B_s, long long B_g,
                    long long C_b, long long C_s, long long C_g,
                    void* stream) {
  if (chunk <= 0 || chunk > kMaxL || S % chunk || N <= 0 || N > kMaxN ||
      P % kPB || G <= 0 || H % G)
    return (int)cudaErrorInvalidValue;
  const Args a{x,   dt,  A,   B,   C,    y,    hfin, S,    H,    P,
               G,   N,   chunk, x_b, x_s, x_h, dt_b, dt_s, dt_h, B_b,
               B_s, B_g, C_b, C_s, C_g};
  const size_t smem = sizeof(float) * Layout(chunk, N).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(P / kPB, H, b);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}

}  // extern "C"
