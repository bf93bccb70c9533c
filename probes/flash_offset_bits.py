"""``flash_attention``'s kernels of an older checkout and of this one, side
by side: the same bits wherever both take the call, the fp32 backward
(redesigned since: split-TF32 products on the tensor cores) within the
fp32 bar of the older one's instead, and the fp32 forward (redesigned
since: split TF32 on the tensor cores, a split-KV plan) against the plain
version within ATTN_F32_TOL when the older one is the CUDA-core design.

Builds ``flash_attn.cu`` and ``flash_attn_bwd.cu`` of an older checkout
(the first argument, a directory holding ``src/``; its ``hopper.cuh``
beside them) into ``build/flash_parent/``, loads them with ctypes, and
calls them and this checkout's wrappers (``flash_attn._forward``,
``flash_attention_backward``) on the same inputs: the forward's output and
lse and the backward's dq, dk and dv, bf16 and fp32, causal, windowed and
non-causal, GQA and MQA, D 64 / 128 / 256 (the backward where the older
checkout takes D: fp32 up to 128 before the fp32 kernels' 32-key plan).
The fp32 backward is held to relative L2 of dq, dk and dv within
BWD_F32_REL (1e-5, chip_smoke.py's bar) of the older checkout's, when the
older checkout's fp32 backward is the CUDA-core design (its source has
``F32Tiles``); else to its bits.  The fp32 forward's out and lse are held
to ``attention_blockwise`` and ``attention_lse_plain`` within
ATTN_F32_TOL (1 + |exp|) (2e-5, chip_smoke.py's bar) when the older
checkout's fp32 forward is the CUDA-core design (its ``flash_attn.cu``
has "FMAs on the CUDA cores"), and both backwards then take the newer
forward's out and lse; else to the older one's bits.
An older checkout whose launches take a q offset (since the causal q
offset) also runs the cases at an offset; one from before it runs the
cases at offset 0.  Then times both forwards and backwards in turns
(older, newer, newer, older; CUDA events over back-to-back launches) at
granite's training call, gemma's, and an fp32 call at D 128.

    python3 probes/flash_offset_bits.py PARENT_CHECKOUT

Prints the card's name and power limit, one line a case, and a JSON line
``{"same_bits": bool, "cases": n, "ms": {...}}``; exits 1 if any case
differs (or an fp32 backward is over the bar).
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

BWD_F32_REL = 1e-5               # chip_smoke.py's bar for an fp32 backward
ATTN_F32_TOL = 2e-5              # chip_smoke.py's bar for an fp32 forward

CASES = [  # B, Sq, Sk, Hq, Hkv, D, causal, window, dtype, q_offset
    (2, 256, 256, 4, 2, 64, True, None, "bfloat16", 0),
    (1, 300, 300, 8, 2, 64, True, 100, "bfloat16", 0),
    (1, 384, 384, 8, 1, 256, True, None, "bfloat16", 0),
    (2, 200, 200, 4, 4, 128, False, None, "bfloat16", 0),
    (1, 96, 300, 4, 1, 64, False, None, "bfloat16", 0),
    (1, 200, 200, 4, 2, 80, True, 70, "bfloat16", 0),
    (1, 128, 384, 4, 4, 256, True, None, "bfloat16", 128),
    (2, 256, 256, 4, 2, 64, True, None, "float32", 0),
    (1, 300, 300, 8, 2, 64, True, 100, "float32", 0),
    (1, 96, 300, 4, 1, 128, False, None, "float32", 0),
    (1, 200, 200, 4, 2, 16, True, 70, "float32", 0),
    (1, 200, 600, 8, 2, 64, True, 100, "float32", 250),
    (1, 128, 384, 4, 2, 128, True, None, "float32", 256),
]
TIMED = {"granite train (8 x 4096, 32 / 8 heads, D 64)":
         (8, 4096, 4096, 32, 8, 64, True, None, "bfloat16", 0),
         "gemma train (2 x 4096, 8 / 1 heads, D 256)":
         (2, 4096, 4096, 8, 1, 256, True, None, "bfloat16", 0),
         "fp32 (2 x 2048, 8 / 2 heads, D 128)":
         (2, 2048, 2048, 8, 2, 128, True, None, "float32", 0)}


def _build_parent(parent):
    from repro_torch.kernels import build

    out = os.path.join(ROOT, "build", "flash_parent")
    os.makedirs(out, exist_ok=True)
    csrc = os.path.join(parent, "src", "repro_torch", "kernels", "csrc")
    procs = {}
    for name in ("flash_attn", "flash_attn_bwd"):
        so = os.path.join(out, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", so,
             os.path.join(csrc, f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the older {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    # the launches take q_offset (before the stream) since the causal offset,
    # and the SM count after bf16 since the split-TF32 fp32 backward
    with open(os.path.join(csrc, "flash_attn_bwd.cu")) as f:
        text = f.read()
    libs["offset"] = "int q_offset" in text
    libs["sms"] = "int bf16, int sms" in text
    libs["fp32_fma"] = "F32Tiles" in text
    # the fp32 forward: the CUDA-core design, and whether its launch takes
    # a scratch and the SM count (since the split-TF32 redesign)
    with open(os.path.join(csrc, "flash_attn.cu")) as f:
        text = f.read()
    libs["fwd_fma"] = "FMAs on the CUDA cores" in text
    libs["fwd_split"] = "float* scratch, int sms" in text
    off = [ctypes.c_int] if libs["offset"] else []
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (libs["flash_attn"].flash_attn_f32_launch,
               libs["flash_attn"].flash_attn_bf16_launch):
        fn.argtypes = ([p] * 5 + [i] * 6 + [ll] * 9 + [ctypes.c_float, i, i]
                       + off + [p])
        fn.restype = i
    if libs["fwd_split"]:
        libs["flash_attn"].flash_attn_f32_launch.argtypes = (
            [p] * 5 + [i] * 6 + [ll] * 9 + [ctypes.c_float, i, i] + off
            + [p, i, p])
    fn = libs["flash_attn_bwd"].flash_attn_bwd_launch
    fn.argtypes = ([p] * 10 + [i] * 6 + [ll] * 15 + [ctypes.c_float, i, i]
                   + off + [i] + ([i] if libs["sms"] else []) + [p])
    fn.restype = i
    return libs


def _older_max_d(parent, bf16):
    """The older backward's largest D (``kF32MaxD`` in its source for
    fp32; 256 for bf16)."""
    if bf16:
        return 256
    path = os.path.join(parent, "src", "repro_torch", "kernels", "csrc",
                        "flash_attn_bwd.cu")
    with open(path) as f:
        for line in f:
            if line.startswith("constexpr int kF32MaxD"):
                return int(line.split("=")[1].strip(" ;\n"))
    raise RuntimeError(f"no kF32MaxD in {path}")


def _inputs(torch, case, seed):
    B, Sq, Sk, Hq, Hkv, D, causal, window, dtype, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    mk = lambda S, H: torch.randn((B, S, H, D), generator=g,   # noqa: E731
                                  device="cuda").to(dt)
    return mk(Sq, Hq), mk(Sk, Hkv), mk(Sk, Hkv), mk(Sq, Hq)


def _old_forward(torch, libs, q, k, v, causal, window, off=0):
    from repro_torch.kernels import flash_attn as F

    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    fn = (libs["flash_attn"].flash_attn_bf16_launch if bf16
          else libs["flash_attn"].flash_attn_f32_launch)
    split = []
    if not bf16 and libs["fwd_split"]:
        # room for this checkout's split plan's scratch
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        n = F.f32_scratch_floats(B, Sq, Hq, D, F.f32_splits(
            B, Sq, Sk, Hq, Hkv, causal, window, off, sms))
        scratch = torch.empty((max(n, 4),), device=q.device)
        split = [scratch.data_ptr(), sms]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), B, Sq, Sk, Hq, Hkv, D, *q.stride()[:3],
             *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(D), int(causal),
             int(window or 0), *([off] if libs["offset"] else []), *split,
             torch.cuda.current_stream().cuda_stream)
    assert not err, err
    return out, lse


def _old_backward(torch, libs, q, k, v, out, lse, g, causal, window, off=0):
    from repro_torch.kernels import flash_attn as F

    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # room for any older layout: L and delta, and the split partials
    splits = F.dkdv_splits(B, Sq, Sk, Hq, Hkv, causal, window, off, sms)
    scratch = torch.empty((F.bwd_scratch_floats(B, Sq, Sk, Hq, Hkv, D, False,
                                                splits),),
                          dtype=torch.float32, device=q.device)
    err = libs["flash_attn_bwd"].flash_attn_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        g.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, Hq, Hkv, D, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], *g.stride()[:3],
        1.0 / math.sqrt(D), int(causal), int(window or 0),
        *([off] if libs["offset"] else []), int(bf16),
        *([sms] if libs["sms"] else []),
        torch.cuda.current_stream().cuda_stream)
    assert not err, err
    return dq, dk, dv


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


def main(parent):
    import torch

    from repro_torch.kernels import flash_attn as F
    from repro_torch.nn import attention as A

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = _build_parent(parent)
    same, ran = True, 0
    for n, case in enumerate(CASES):
        B, Sq, Sk, Hq, Hkv, D, causal, window, dtype, off = case
        if off and not libs["offset"]:
            continue
        ran += 1
        q, k, v, g = _inputs(torch, case, n)
        old = _old_forward(torch, libs, q, k, v, causal, window, off)
        new = F._forward(q, k, v, causal, window, None, True, off)
        vs_plain = None
        if dtype == "float32" and libs["fwd_fma"]:
            # another design: the newer forward against the plain version
            kw = dict(causal=causal, window=window, q_offset=off)
            vs_plain = [float(((a - e).abs()
                               / (ATTN_F32_TOL * (1 + e.abs()))).max())
                         for a, e in zip(new, (
                             A.attention_blockwise(q, k, v, **kw),
                             F.attention_lse_plain(q, k, **kw)))]
            bits = [max(vs_plain) <= 1]
        else:
            bits = [torch.equal(a, b) for a, b in zip(old, new)]
        ratios = None
        if D <= _older_max_d(parent, dtype == "bfloat16"):
            # the older backward on the newer forward's out and lse where
            # the forwards differ by design
            ob = _old_backward(torch, libs, q, k, v,
                               *(new if vs_plain else old), g, causal, window,
                               off)
            nb = F.flash_attention_backward(q, k, v, *new, g, causal=causal,
                                            window=window, q_offset=off)
            if dtype == "float32" and libs["fp32_fma"]:
                # another design: the older kernels' gradients within the
                # fp32 bar of the newer's
                ratios = [float((a - b).norm() / b.norm().clamp_min(1e-30))
                          / BWD_F32_REL for a, b in zip(nb, ob)]
                bits.append(max(ratios) <= 1)
            else:
                bits += [torch.equal(a, b) for a, b in zip(ob, nb)]
        torch.cuda.synchronize()
        same &= all(bits)
        what = ("; dq, dk, dv within BWD_F32_REL" if ratios
                else ", dq, dk, dv" if len(bits) > 2 else "")
        head = (f"out, lse within ATTN_F32_TOL of the plain version "
                f"({vs_plain[0]:.3f}, {vs_plain[1]:.3f} of the bar)"
                if vs_plain
                else "out, lse")
        print(f"case {case}: {head}{what} the same bits: {bits}"
              + (f" (relative L2 over the bar: "
                 f"{', '.join(f'{r:.3f}' for r in ratios)})" if ratios
                 else ""), flush=True)
    ms = {}
    for name, case in TIMED.items():
        B, Sq, Sk, Hq, Hkv, D, causal, window, dtype, _ = case
        q, k, v, g = _inputs(torch, case, 99)
        out, lse = F._forward(q, k, v, causal, window, None, True)
        runs = {"older": (lambda: _old_forward(torch, libs, q, k, v, causal,
                                               window),
                          lambda: _old_backward(torch, libs, q, k, v, out,
                                                lse, g, causal, window)),
                "newer": (lambda: F._forward(q, k, v, causal, window, None,
                                             True),
                          lambda: F.flash_attention_backward(
                              q, k, v, out, lse, g, causal=causal,
                              window=window))}
        got = {"older": [], "newer": []}
        for which in ("older", "newer", "newer", "older"):
            fwd, bwd = runs[which]
            got[which].append((_time(torch, fwd), _time(torch, bwd)))
        ms[name] = got
        print(f"{name}: forward / backward ms, older "
              f"{got['older']}, newer {got['newer']}", flush=True)
    print(json.dumps({"same_bits": bool(same), "cases": ran, "ms": ms}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
