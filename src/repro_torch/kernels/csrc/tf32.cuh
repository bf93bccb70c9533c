// Split-TF32 arithmetic on mma.sync m16n8k8 and cp.async copies into
// shared memory: the primitives that ssd_common.cuh (the SSD scan's
// kernels), flash_attn.cu and flash_attn_bwd.cu (the fp32 attention
// forward and backward) share.
// repro_torch/kernels/build.py hashes this header into the build key of
// every source that includes it, directly or through another header.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// v = hi + lo: hi is v cut to TF32 (its top 19 bits), lo the rest, exact
// in fp32; the tensor cores read the top 19 bits of lo.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// An fp32 operand register (its bits) split: hi and lo
__device__ __forceinline__ void split1(uint32_t v, uint32_t& hi,
                                       uint32_t& lo) {
  split_tf32(__uint_as_float(v), hi, lo);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Asynchronous copies of 4 and 16 bytes into shared memory; the bytes past
// ``bytes`` are zero-filled (nothing is read for bytes == 0).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// Closes this thread's group of copies issued since the last commit (a
// group may be empty); cp_async_wait<n> waits until at most the n most
// recent groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

}  // namespace
