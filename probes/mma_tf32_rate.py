"""The rate of mma.sync m16n8k8 TF32 on the card, nothing else in the loop.

Builds a small kernel (its source below, compiled by ``nvcc`` for sm_90a
into ``build/probes/``) in which each warp issues ``chain`` dependent
mma.sync into each of ``nt`` accumulator tiles, over and over, at 4 to 32
warps an SM (one block an SM), and prints mma a microsecond an SM and a
clock at the card's maximum SM clock.  It is the ceiling that
``csrc/ssd_scan_bwd.cu``'s split-TF32 loops (three dependent mma a tile a
k step) are held against.

    python3 probes/mma_tf32_rate.py

Prints the card's name and power limit, then one line a configuration.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <int NT, int CH>
__global__ void bench(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 7 + i;
  b[0] = threadIdx.x;
  b[1] = threadIdx.x + 3;
  float acc[NT][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < CH; ++c) mma_tf32(acc[t], a, b);
  float s = 0.f;
  for (int t = 0; t < NT; ++t)
    s += acc[t][0] + acc[t][1] + acc[t][2] + acc[t][3];
  if (s == 12345.f) out[threadIdx.x] = s;
}
template <int NT, int CH>
float timed(int threads, int blocks, int iters) {
  float* out;
  cudaMalloc(&out, 4096);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  bench<NT, CH><<<blocks, threads>>>(out, iters);
  cudaDeviceSynchronize();
  cudaEventRecord(e0);
  bench<NT, CH><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
extern "C" float run(int nt, int ch, int threads, int blocks, int iters) {
  if (nt == 1 && ch == 3) return timed<1, 3>(threads, blocks, iters);
  if (nt == 2 && ch == 3) return timed<2, 3>(threads, blocks, iters);
  if (nt == 4 && ch == 3) return timed<4, 3>(threads, blocks, iters);
  if (nt == 4 && ch == 1) return timed<4, 1>(threads, blocks, iters);
  if (nt == 8 && ch == 1) return timed<8, 1>(threads, blocks, iters);
  return -1.f;
}
"""
CONFIGS = [(1, 3), (2, 3), (4, 3), (4, 1), (8, 1)]   # (tiles, chain)
ITERS = 20000


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("mma_tf32_rate: no CUDA device", file=sys.stderr)
        return 1
    query = lambda what: subprocess.run(
        ["nvidia-smi", f"--query-gpu={what}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(query("name,power.limit"), flush=True)
    out = os.path.join(ROOT, "build", "probes")
    os.makedirs(out, exist_ok=True)
    src, lib = os.path.join(out, "mma_rate.cu"), os.path.join(out,
                                                              "mma_rate.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True)
    run = ctypes.CDLL(lib).run
    run.argtypes = [ctypes.c_int] * 5
    run.restype = ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(query("clocks.max.sm").split()[0])
    for nt, ch in CONFIGS:
        for threads in (128, 256, 512, 1024):
            ms = run(nt, ch, threads, sms, ITERS)
            per_us = sms * threads // 32 * ITERS * nt * ch / (ms * 1e3) / sms
            print(f"tiles {nt}, chain {ch}, warps an SM {threads // 32}: "
                  f"{ms:.3f} ms, {per_us:.1f} mma a us an SM, "
                  f"{per_us / mhz:.3f} a clock at the {mhz:.0f} MHz maximum",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
