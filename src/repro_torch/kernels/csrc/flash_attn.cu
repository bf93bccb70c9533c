// Causal / sliding-window GQA softmax attention for Hopper (sm_90a), built by
// repro_torch/kernels/build.py with nvcc into a shared library with a plain C
// interface and called through ctypes from repro_torch/kernels/flash_attn.py.
// Compiled without --use_fast_math: expf is the accurate version.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn.py::flash_attention
// (pallas_call at flash_attn.py:117): an online softmax over kv tiles,
// fully masked kv tiles skipped, q head h reading kv head h % Hkv.
//
// What bounds it on this card: operations.  Per head it does 4·Sq·Sk_eff·D
// flops on (Sq + 2·Sk)·D inputs, ~2000 flops per byte at the path's
// Sq = Sk = 8192, D = 64, window 4096.  The card's bound is the bf16 tensor
// core rate; this first version does every product as an fp32 FMA on the
// CUDA cores (67 TFLOP/s peak), so it cannot come near that bound: wgmma
// on bf16 tiles is the redesign.
//
// Design: one block of 256 threads per (q tile of 64 rows, q head, batch).
// The Pallas grid walks the kv axis in sequence with the running max, sum
// and accumulator in VMEM scratch; here that axis is a loop inside the
// block over the kv tiles that are not wholly masked, each tile of 64 keys
// and values staged in shared memory as fp32.  The threads form a 16 x 16
// grid: thread (ty, tx) owns q rows 4ty..4ty+3 and, of the 64 x 64 score
// tile, columns tx + 16c; of the [64, D] accumulator, columns tx + 16c.  A
// row's max and sum are reduced over its 16 threads by a fixed shuffle tree,
// and every thread keeps the row's running (max, sum) in registers, so the
// accumulator never leaves registers until the final division by
// max(l, 1e-30).  P stays fp32 (the plain attention_blockwise rounds it to
// v's dtype before PV; this kernel does not).  The mask value is -1e30, as
// in the Pallas kernel: a row wholly masked in a tile that runs gets
// exp(0) = 1 for every key while its max is still -1e30, and the first tile
// with a real key multiplies that away by exp(-1e30 - m) = 0.  Inputs are
// read in the [B, S, H, D] layout through their strides (D contiguous), as
// bf16 or fp32; the output is written in q's dtype.  No atomics: two
// launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;           // q rows per block
constexpr int kBK = 64;           // keys per kv tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, Hq, Hkv, D;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
  float scale;
  int causal, window;             // window <= 0: none
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float max16(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D + (size_t)kBQ * (kBK + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_attn_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  const int ldq = D + 1, ldk = D + 1, ldv = D, ldp = kBK + 1;
  float* Qs = smem;                       // [kBQ][D+1], scaled
  float* Ks = Qs + kBQ * ldq;             // [kBK][D+1]
  float* Vs = Ks + kBK * ldk;             // [kBK][D]
  float* Ps = Vs + kBK * ldv;             // [kBQ][kBK+1]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* q = static_cast<const T*>(a.q) + b * a.q_b + h * a.q_h;
  const T* k = static_cast<const T*>(a.k) + b * a.k_b + (h % a.Hkv) * a.k_h;
  const T* v = static_cast<const T*>(a.v) + b * a.v_b + (h % a.Hkv) * a.v_h;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D, s = q0 + r;
    Qs[r * ldq + d] = s < a.Sq ? to_f(q[s * a.q_s + d]) * a.scale : 0.f;
  }

  // the kv tiles not wholly above the diagonal nor wholly below the window
  int kt_end = (a.Sk + kBK - 1) / kBK;
  if (a.causal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBK + 1);
  int kt_begin = 0;
  if (a.window > 0) {
    const int lo = q0 - a.window - kBK + 2;   // k0 + kBK - 1 > q0 - window
    if (lo > 0) kt_begin = (lo + kBK - 1) / kBK;
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
    const int k0 = kt * kBK;
    __syncthreads();                  // the last tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e - j * D, s = k0 + j;
      const bool in = s < a.Sk;
      Ks[j * ldk + d] = in ? to_f(k[s * a.k_s + d]) : 0.f;
      Vs[j * ldv + d] = in ? to_f(v[s * a.v_s + d]) : 0.f;
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
      const int qpos = q0 + 4 * ty + i;
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

    for (int j = 0; j < kBK; ++j) {
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

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * ty + i;
    if (s >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* row = o + (((long long)b * a.Sq + s) * a.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < nc) row[tx + 16 * c] = from_f<T>(acc[i][c] / den);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, B);
  flash_attn_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int B, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64>(a, B, stream);
  if (a.D <= 128) return launch<T, 128>(a, B, stream);
  return launch<T, 256>(a, B, stream);
}

}  // namespace

extern "C" {

// The largest head dimension; D must be a multiple of 16.
int flash_attn_max_d() { return 256; }

// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (strides in elements, D contiguous),
// bf16 != 0: bf16 inputs and output, else fp32.  out: contiguous
// [B, Sq, Hq, D].  window <= 0: no window.  Returns a cudaError_t.
int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                      int bf16, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                      long long q_b, long long q_s, long long q_h,
                      long long k_b, long long k_s, long long k_h,
                      long long v_b, long long v_s, long long v_h,
                      float scale, int causal, int window, void* stream) {
  if (D <= 0 || D % 16 || D > flash_attn_max_d() || Hkv <= 0 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  const Args a{q,   k,   v,   out, Sq,  Sk,  Hq,    Hkv,    D,     q_b, q_s,
               q_h, k_b, k_s, k_h, v_b, v_s, v_h, scale, causal, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? dispatch<__nv_bfloat16>(a, B, st)
                    : dispatch<float>(a, B, st));
}

}  // extern "C"
