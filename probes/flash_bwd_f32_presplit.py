"""The fp32 attention backward against the design that splits each operand
once as it lands in shared memory, on the card.

``probes/variants/flash_attn_bwd_f32_presplit.cu`` is that design (cp.async
d-chunks of 32 columns, each thread splitting the pieces it copied into hi
and lo slabs; same C interface).  This probe builds it beside the
repository's ``csrc/flash_attn_bwd.cu`` and, at chip_smoke's fp32 rows
(``BWD_F32_CASES``), holds both to the plain backward (relative L2 of dq,
dk and dv over BWD_F32_REL) and times them in turns (repository, variant,
variant, repository; CUDA events over back-to-back calls of
``flash_attention_backward``, the variant's library swapped in).

    python3 probes/flash_bwd_f32_presplit.py

Prints the card's name and power limit, one line a shape, and a JSON line
``{"ms": {...}, "ratio": {...}}``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _time(torch, fn, iters=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, flash_attn

    if not torch.cuda.is_available():
        print("flash_bwd_f32_presplit: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(),
        flush=True)
    out_dir = os.path.join(ROOT, "build", "probes")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "flash_attn_bwd_f32_presplit.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", so, os.path.join(ROOT, "probes", "variants",
                                           "flash_attn_bwd_f32_presplit.cu")],
                   check=True, capture_output=True)
    libs = {"repository": flash_attn._bwd_lib(), "presplit": ctypes.CDLL(so)}
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = libs["presplit"].flash_attn_bwd_launch
    fn.argtypes = [p] * 10 + [i] * 6 + [ll] * 15 + [ctypes.c_float, i, i, i,
                                                     i, i, p]
    fn.restype = i
    libs["presplit"]._typed = True
    dev = torch.device("cuda:0")
    ms, ratio = {}, {}
    for where, (qs, ks, causal) in cs.BWD_F32_CASES.items():
        g = torch.Generator(device=dev).manual_seed(9)
        q, k, v = (torch.randn(s, generator=g, device=dev)
                   for s in (qs, ks, ks))
        dout = torch.randn(qs, generator=g, device=dev)
        out, lse = flash_attn._forward(q, k, v, causal, None, None, True)
        exp = flash_attn.flash_attention_backward_plain(
            q, k, v, out, lse, dout, causal=causal)
        call = lambda: flash_attn.flash_attention_backward(   # noqa: E731
            q, k, v, out, lse, dout, causal=causal)
        ms[where] = {"repository": [], "presplit": []}
        for which in ("repository", "presplit", "presplit", "repository"):
            build._LOADED["flash_attn_bwd"] = libs[which]
            if which not in ratio.setdefault(where, {}):
                ratio[where][which] = cs._bwd_ratio(call(), exp)
            ms[where][which].append(_time(torch, call))
        build._LOADED["flash_attn_bwd"] = libs["repository"]
        print(f"{where} q{list(qs)} k{list(ks)} causal={causal}: ms "
              f"repository {ms[where]['repository']}, operands split once "
              f"in shared memory {ms[where]['presplit']}; relative L2 over "
              f"BWD_F32_REL {ratio[where]}", flush=True)
        del q, k, v, dout, out, lse, exp
    print(json.dumps({"ms": ms, "ratio": ratio}))
    return 0 if all(r <= 1 for w in ratio.values() for r in w.values()) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
