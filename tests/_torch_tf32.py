"""Split-TF32 arithmetic on CPU tensors, as the port's fp32 attention
kernels take their products (``csrc/tf32.cuh``): the emulations of
``tests/test_torch_flash_fwd.py`` and ``tests/test_torch_flash_bwd.py``
share it."""

import torch


def _tf32(x):
    """x cut to TF32 (its top 19 bits), as the tensor cores read it."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _mm3(a, b):
    """a @ b in split TF32 as the kernels take it: a = a_hi + a_lo with
    a_hi = tf32(a), the tensor cores reading tf32(a_lo); lo hi + hi lo +
    hi hi, products exact, sums in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh
