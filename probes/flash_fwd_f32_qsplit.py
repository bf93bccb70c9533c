"""The fp32 forward kernel's Q split once against split as it loads.

In the long plan at DMAX = 64, ``csrc/flash_attn.cu``'s fp32 kernel has
each warp split its Q fragments into TF32 hi and lo once, before the kv
loop, and hold them in registers for the whole block (64 registers a
thread; at DMAX = 128 and 256 they do not fit beside O, and hi and lo
copies in shared memory would not fit beside the ring at 256).  The
variant splits each Q fragment as it loads it from shared memory, once
for every kv step, as the kernel does at DMAX = 128 and 256.  The probe
writes the variant from this checkout's source (one textual edit, checked
to apply) under ``build/probes/``, builds it with nvcc (ptxas's registers
and spills of both), and times ``flash_attn._forward`` on fp32 inputs with
this checkout's library and with the variant's, in turns (repository,
variant, variant, repository; CUDA events over back-to-back calls), at
whisper's encoder [8, 1500, 16, 64] and cross attention (q [8, 448, 16,
64], k/v [8, 1500, 16, 64]), the variant's output checked against the
repository's within ATTN_F32_TOL (1 + |exp|).

    python3 probes/flash_fwd_f32_qsplit.py

Prints the card's name and power limit, then one line a shape and a JSON
line ``{"ms": {...}}``.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTN_F32_TOL = 2e-5

# (old, new): every Q fragment split as it loads
EDITS = [("  constexpr bool QREG = DMAX == 64 && !SHORT;\n",
          "  constexpr bool QREG = false;\n")]


def _variant(build):
    src = (build.CSRC / "flash_attn.cu").read_text()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"the variant's edit no longer applies: "
                               f"{old[:60]!r}")
        src = src.replace(old, new)
    out = os.path.join(ROOT, "build", "probes")
    os.makedirs(out, exist_ok=True)
    path, so = (os.path.join(out, f"flash_attn_f32_qload{x}")
                for x in (".cu", ".so"))
    with open(path, "w") as f:
        f.write(src)
    log = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                          str(build.CSRC), "-o", so, path],
                         capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"nvcc failed for the variant:\n{log.stdout}"
                           f"{log.stderr}")
    lines = (log.stdout + log.stderr).splitlines()
    for n, line in enumerate(lines):
        if "flash_attn_f32_kernelILi64ELb0E" in line \
                and "Compiling entry function" in line:
            after = " ".join(lines[n + 1:n + 4])
            regs = re.search(r"Used (\d+) registers", after)
            spill = re.search(r"(\d+) bytes spill stores", after)
            print(f"ptxas the variant's flash_attn_f32_kernel<64, long>: "
                  f"{regs.group(1) if regs else '?'} registers, spill "
                  f"stores {spill.group(1) if spill else '?'} B", flush=True)
    return so


def _time(torch, fn, iters=20):
    for _ in range(3):
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
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attn as F

    if not torch.cuda.is_available():
        print("flash_fwd_f32_qsplit: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    repo = F._lib()
    var = ctypes.CDLL(_variant(build))
    var.flash_attn_f32_launch.argtypes = repo.flash_attn_f32_launch.argtypes
    var.flash_attn_f32_launch.restype = ctypes.c_int
    libs = {"repository": repo, "variant": var}
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(8)
    kv = (8, 1500, 16, 64)
    shapes = {"whisper_encoder": (kv, kv), "whisper_cross": ((8, 448, 16, 64),
                                                             kv)}
    ms = {}
    lib_of = F._lib
    try:
        for where, (qs, ks) in shapes.items():
            q = torch.randn(qs, generator=g, device=dev)
            k, v = (torch.randn(ks, generator=g, device=dev)
                    for _ in range(2))
            outs, got = {}, {"repository": [], "variant": []}
            for which in ("repository", "variant", "variant", "repository"):
                F._lib = lambda w=which: libs[w]
                call = lambda: F._forward(q, k, v, False, None, None, False)
                outs[which] = call()[0]
                got[which].append(_time(torch, call))
            exp = outs["repository"]
            ratio = float(((outs["variant"] - exp).abs()
                           / (ATTN_F32_TOL * (1 + exp.abs()))).max())
            ms[where] = got
            print(f"{where} q{list(qs)} k{list(ks)}: ms repository "
                  f"{got['repository']} (Q split once), variant (split "
                  f"as it loads) "
                  f"{got['variant']}; the variant within {ratio:.4f} of "
                  f"the bar of the repository's output", flush=True)
    finally:
        F._lib = lib_of
    print(json.dumps({"ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
