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
//   delta_i = sum_d dO_id O_id                         (flash_bwd_preprocess)
//   dS = P o (dO V^T - delta)
//   dQ = scale dS K                                    (flash_bwd_dq)
//   dV = P^T dO,  dK = scale dS^T Q                    (flash_bwd_dkdv)
// Pairs outside the mask (causal, window, past Sq or Sk) have P = 0: a row
// with no live key gets no gradient.
//
// What bounds it on this card: operations.  Per (batch, q head) it does
// 10 D flops a live pair (the five products) on (4 Sq + 4 Sk) D inputs and
// outputs, ~600 flops a byte at granite's Sq = Sk = 4096, D = 64, so the
// bound is the tensor cores' bf16 rate.  These first kernels are simple:
// every product is an fp32 FMA on the CUDA cores (67 TFLOP/s at most),
// from fp32 tiles in shared memory; S and dP are computed twice (once in
// each of the two kernels), 14 D flops a live pair in all.  A tensor-core
// redesign (wgmma, TMA) is later work.
//
// Plan (mirrored by repro_torch.kernels.flash_attn.bwd_plan,
// dq_kv_tile_range, q_tile_range, dkdv_heads and checked against this
// library when it is loaded):
//   * Tiles of BQ = 64 q rows and BK = 64 keys, 256 threads; thread (ty, tx)
//     of a 16 x 16 grid owns rows 4ty..4ty+3 of a 64 x 64 score tile and its
//     columns tx + 16c, and of a [64, D] accumulator the columns tx + 16c.
//     D <= 128, a multiple of 16.
//   * flash_bwd_dq: one block a (q head, batch) pair and q tile; it loops
//     over the kv tiles the mask lets through, in order (the range of
//     flash_attn.cu's fp32 forward), recomputing S and dP, and keeps dQ in
//     registers.  Blocks run longest first: causal, the last q tile first.
//   * flash_bwd_dkdv: one block a (kv head, batch) pair and kv tile; it
//     loops over the G = Hq / Hkv q heads that read this kv head (h = g Hkv
//     + hk, G-major, g = 0, 1, ... in order) and, for each, over the q tiles
//     the mask lets through, in order; it keeps dK and dV in registers, so
//     the G heads' sums need no atomics.  Causal: kv tile 0 first.
//   * No atomics, fixed order: two launches give the same bits.
// Inputs bf16 or fp32 (q, k, v, O, dO alike), read through their B, S and H
// strides with D contiguous; outputs dQ [B, Sq, Hq, D] and dK, dV
// [B, Sk, Hkv, D] contiguous in the inputs' dtype, delta [B, Hq, Sq] fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;           // q rows a tile
constexpr int kBK = 64;           // keys a tile
constexpr int kMaxD = 128;
constexpr int kLdP = kBK + 1;     // row stride of the score tiles in smem
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;               // [B, Hq, Sq]
  float* delta;                   // [B, Hq, Sq]
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, Hq, Hkv, D;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
  long long o_b, o_s, o_h, do_b, do_s, do_h;
  float scale;
  int causal, window;             // window <= 0: none
};

// The kv tiles [begin, end) q tile qt reads (rows past Sq do not count).
__host__ __device__ inline void dq_kv_range(int qt, int Sq, int Sk,
                                            int causal, int window,
                                            int* begin, int* end) {
  const int q0 = qt * kBQ;
  const int q_last = (q0 + kBQ < Sq ? q0 + kBQ : Sq) - 1;
  int e = (Sk + kBK - 1) / kBK;
  if (causal && q_last / kBK + 1 < e) e = q_last / kBK + 1;
  int bg = 0;
  if (window > 0) {
    const int lo = q0 - window - kBK + 2;   // k0 + BK - 1 > q0 - window
    if (lo > 0) bg = (lo + kBK - 1) / kBK;
  }
  *begin = bg;
  *end = e > bg ? e : bg;
}

// The q tiles [begin, end) that read kv tile kt (keys past Sk do not count).
__host__ __device__ inline void q_range(int kt, int Sq, int Sk, int causal,
                                        int window, int* begin, int* end) {
  const int k0 = kt * kBK;
  const int k_last = (k0 + kBK < Sk ? k0 + kBK : Sk) - 1;
  int e = (Sq + kBQ - 1) / kBQ;
  if (window > 0) {                         // q0 < k_last + window
    const int hi = (k_last + window - 1) / kBQ + 1;
    if (hi < e) e = hi;
  }
  const int bg = causal ? k0 / kBQ : 0;     // q0 + BQ - 1 >= k0
  *begin = bg;
  *end = e > bg ? e : bg;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool live(int qpos, int kpos, const BwdArgs& a) {
  return qpos < a.Sq && kpos < a.Sk && (!a.causal || kpos <= qpos) &&
         (a.window <= 0 || kpos > qpos - a.window);
}

// rows [r0, r0 + 64) of one head of x (S rows, strides s_s) into an fp32
// tile [64][ld] in shared memory, zeros past S
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ldd, const T* x,
                                          long long s_s, int r0, int S,
                                          int D) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, d = e - r * D, s = r0 + r;
    dst[r * ldd + d] = s < S ? ld(x + s * s_s + d) : 0.f;
  }
}

// delta [B, Hq, Sq]: one warp a row, a fixed shuffle tree
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_preprocess_kernel(const BwdArgs a) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.Hq * a.Sq) return;
  const int i = (int)(row % a.Sq);
  const int h = (int)(row / a.Sq % a.Hq);
  const int b = (int)(row / ((long long)a.Sq * a.Hq));
  const T* o = static_cast<const T*>(a.o) + b * a.o_b + i * a.o_s + h * a.o_h;
  const T* g = static_cast<const T*>(a.dout) + b * a.do_b + i * a.do_s +
               h * a.do_h;
  float s = 0.f;
  for (int d = lane; d < a.D; d += 32) s = fmaf(ld(g + d), ld(o + d), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.delta[row] = s;
}

size_t dq_smem_bytes(int D) {
  return sizeof(float) * (4 * (size_t)kBQ * (D + 1) + (size_t)kBQ * kLdP +
                          2 * kBQ);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int D = a.D, ldt = D + 1;
  float* Qs = sm;                         // [64][D+1]
  float* Gs = Qs + kBQ * ldt;             // dO [64][D+1]
  float* Ks = Gs + kBQ * ldt;             // [64][D+1]
  float* Vs = Ks + kBK * ldt;             // [64][D+1]
  float* dSs = Vs + kBK * ldt;            // [64][65]
  float* Ls = dSs + kBQ * kLdP;           // lse * log2(e) of the rows
  float* Dl = Ls + kBQ;                   // delta of the rows

  const int pair = blockIdx.x, h = pair % a.Hq, b = pair / a.Hq;
  const int nq = (a.Sq + kBQ - 1) / kBQ;
  const int qt = a.causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kBQ, hk = h % a.Hkv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* q = static_cast<const T*>(a.q) + b * a.q_b + h * a.q_h;
  const T* g = static_cast<const T*>(a.dout) + b * a.do_b + h * a.do_h;
  const T* k = static_cast<const T*>(a.k) + b * a.k_b + hk * a.k_h;
  const T* v = static_cast<const T*>(a.v) + b * a.v_b + hk * a.v_h;
  const long long lrow = ((long long)b * a.Hq + h) * a.Sq;

  load_tile(Qs, ldt, q, a.q_s, q0, a.Sq, D);
  load_tile(Gs, ldt, g, a.do_s, q0, a.Sq, D);
  if (tid < kBQ) {
    const int s = q0 + tid;
    Ls[tid] = s < a.Sq ? a.lse[lrow + s] * kLog2e : 0.f;
    Dl[tid] = s < a.Sq ? a.delta[lrow + s] : 0.f;
  }
  int kt_begin, kt_end;
  dq_kv_range(qt, a.Sq, a.Sk, a.causal, a.window, &kt_begin, &kt_end);

  constexpr int NC = DMAX / 16;
  const int nc = D / 16;
  const float sl2 = a.scale * kLog2e;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                      // the last tile's readers are done
    load_tile(Ks, ldt, k, a.k_s, k0, a.Sk, D);
    load_tile(Vs, ldt, v, a.v_s, k0, a.Sk, D);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(4 * ty + i) * ldt + d];
        gv[i] = Gs[(4 * ty + i) * ldt + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = Ks[(tx + 16 * c) * ldt + d];
        vv[c] = Vs[(tx + 16 * c) * ldt + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(gv[i], vv[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = live(q0 + r, k0 + tx + 16 * c, a)
                            ? exp2f(fmaf(s[i][c], sl2, -Ls[r]))
                            : 0.f;
        dSs[r * kLdP + tx + 16 * c] = p * (dp[i][c] - Dl[r]);
      }
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(4 * ty + i) * kLdP + j];
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

  T* out = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * ty + i;
    if (s >= a.Sq) continue;
    T* row = out + (((long long)b * a.Sq + s) * a.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < nc) st(row + tx + 16 * c, acc[i][c] * a.scale);
  }
}

size_t dkdv_smem_bytes(int D) {
  return sizeof(float) * (4 * (size_t)kBQ * (D + 1) + 2 * (size_t)kBK * kLdP +
                          2 * kBQ);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int D = a.D, ldt = D + 1;
  float* Ks = sm;                         // [64][D+1]
  float* Vs = Ks + kBK * ldt;             // [64][D+1]
  float* Qs = Vs + kBK * ldt;             // [64][D+1]
  float* Gs = Qs + kBQ * ldt;             // dO [64][D+1]
  float* Ps = Gs + kBQ * ldt;             // P^T [64 keys][65]
  float* dSs = Ps + kBK * kLdP;           // dS^T [64 keys][65]
  float* Ls = dSs + kBK * kLdP;
  float* Dl = Ls + kBQ;

  const int pair = blockIdx.x, hk = pair % a.Hkv, b = pair / a.Hkv;
  const int kt = blockIdx.y, k0 = kt * kBK;
  const int G = a.Hq / a.Hkv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* k = static_cast<const T*>(a.k) + b * a.k_b + hk * a.k_h;
  const T* v = static_cast<const T*>(a.v) + b * a.v_b + hk * a.v_h;

  load_tile(Ks, ldt, k, a.k_s, k0, a.Sk, D);
  load_tile(Vs, ldt, v, a.v_s, k0, a.Sk, D);
  int qt_begin, qt_end;
  q_range(kt, a.Sq, a.Sk, a.causal, a.window, &qt_begin, &qt_end);

  constexpr int NC = DMAX / 16;
  const int nc = D / 16;
  const float sl2 = a.scale * kLog2e;
  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = gi * a.Hkv + hk;        // q head h reads kv head h % Hkv
    const T* q = static_cast<const T*>(a.q) + b * a.q_b + h * a.q_h;
    const T* g = static_cast<const T*>(a.dout) + b * a.do_b + h * a.do_h;
    const long long lrow = ((long long)b * a.Hq + h) * a.Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();                    // the last tile's readers are done
      load_tile(Qs, ldt, q, a.q_s, q0, a.Sq, D);
      load_tile(Gs, ldt, g, a.do_s, q0, a.Sq, D);
      if (tid < kBQ) {
        const int s = q0 + tid;
        Ls[tid] = s < a.Sq ? a.lse[lrow + s] * kLog2e : 0.f;
        Dl[tid] = s < a.Sq ? a.delta[lrow + s] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: rows are this block's keys 4ty + i, columns q rows
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(4 * ty + i) * ldt + d];
          vv[i] = Vs[(4 * ty + i) * ldt + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qv[c] = Qs[(tx + 16 * c) * ldt + d];
          gv[c] = Gs[(tx + 16 * c) * ldt + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[i][c] = fmaf(kv[i], qv[c], s[i][c]);
            dp[i][c] = fmaf(vv[i], gv[c], dp[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          const float p = live(q0 + col, k0 + r, a)
                              ? exp2f(fmaf(s[i][c], sl2, -Ls[col]))
                              : 0.f;
          Ps[r * kLdP + col] = p;
          dSs[r * kLdP + col] = p * (dp[i][c] - Dl[col]);
        }
      }
      __syncthreads();

      for (int j = 0; j < kBQ; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[(4 * ty + i) * kLdP + j];
          ds[i] = dSs[(4 * ty + i) * kLdP + j];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (c < nc) {
            const float gg = Gs[j * ldt + tx + 16 * c];
            const float qq = Qs[j * ldt + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dv[i][c] = fmaf(p[i], gg, dv[i][c]);
              dk[i][c] = fmaf(ds[i], qq, dk[i][c]);
            }
          }
        }
      }
    }
  }

  T* ok = static_cast<T*>(a.dk);
  T* ov = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + 4 * ty + i;
    if (s >= a.Sk) continue;
    const long long off = (((long long)b * a.Sk + s) * a.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < nc) {
        st(ok + off + tx + 16 * c, dk[i][c] * a.scale);
        st(ov + off + tx + 16 * c, dv[i][c]);
      }
  }
}

template <typename T, int DMAX>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.Hq * a.Sq;
  flash_bwd_preprocess_kernel<T>
      <<<(unsigned)((rows + 7) / 8), kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dq_smem = dq_smem_bytes(a.D);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(a.Hq * a.B, (a.Sq + kBQ - 1) / kBQ);
  flash_bwd_dq_kernel<T, DMAX><<<dq_grid, kThreads, dq_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t kv_smem = dkdv_smem_bytes(a.D);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_smem);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(a.Hkv * a.B, (a.Sk + kBK - 1) / kBK);
  flash_bwd_dkdv_kernel<T, DMAX><<<kv_grid, kThreads, kv_smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// {BQ, BK, largest D, threads}.
void flash_bwd_plan(int* plan) {
  plan[0] = kBQ;
  plan[1] = kBK;
  plan[2] = kMaxD;
  plan[3] = kThreads;
}

// The kv tiles [range[0], range[1]) q tile qt of flash_bwd_dq reads.
void flash_bwd_dq_kv_range(int qt, int Sq, int Sk, int causal, int window,
                           int* range) {
  dq_kv_range(qt, Sq, Sk, causal, window, range, range + 1);
}

// The q tiles [range[0], range[1]) flash_bwd_dkdv visits for kv tile kt.
void flash_bwd_q_range(int kt, int Sq, int Sk, int causal, int window,
                       int* range) {
  q_range(kt, Sq, Sk, causal, window, range, range + 1);
}

// Shared-memory bytes of a block of flash_bwd_dq (kernel 0) or
// flash_bwd_dkdv (kernel 1) at head dimension D.
long long flash_bwd_smem(int kernel, int D) {
  return (long long)(kernel == 0 ? dq_smem_bytes(D) : dkdv_smem_bytes(D));
}

// q, o, dout [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (strides in elements, D
// contiguous), all of one dtype (bf16 != 0: bf16, else fp32); lse [B, Hq,
// Sq] fp32 from the forward.  Writes delta [B, Hq, Sq] fp32 (scratch), dq
// [B, Sq, Hq, D] and dk, dv [B, Sk, Hkv, D], contiguous, in the inputs'
// dtype.  Three launches on `stream`: flash_bwd_preprocess, flash_bwd_dq,
// flash_bwd_dkdv.  Returns a cudaError_t.
int flash_attn_bwd_launch(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const float* lse,
                          float* delta, void* dq, void* dk, void* dv, int B,
                          int Sq, int Sk, int Hq, int Hkv, int D,
                          long long q_b, long long q_s, long long q_h,
                          long long k_b, long long k_s, long long k_h,
                          long long v_b, long long v_s, long long v_h,
                          long long o_b, long long o_s, long long o_h,
                          long long do_b, long long do_s, long long do_h,
                          float scale, int causal, int window, int bf16,
                          void* stream) {
  if (D <= 0 || D % 16 || D > kMaxD || Hkv <= 0 || Hq % Hkv || B <= 0 ||
      Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q,   k,    v,    o,    dout, lse,  delta, dq,  dk,  dv,
                  B,   Sq,   Sk,   Hq,   Hkv,  D,    q_b,   q_s, q_h, k_b,
                  k_s, k_h,  v_b,  v_s,  v_h,  o_b,  o_s,   o_h, do_b, do_s,
                  do_h, scale, causal, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)(D <= 64 ? launch_bwd<__nv_bfloat16, 64>(a, st)
                         : launch_bwd<__nv_bfloat16, 128>(a, st));
  return (int)(D <= 64 ? launch_bwd<float, 64>(a, st)
                       : launch_bwd<float, 128>(a, st));
}

}  // extern "C"
