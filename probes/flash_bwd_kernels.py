"""The three backward kernels of ``flash_attention`` apart, on the card.

At the five bf16 shapes of chip_smoke's ``flash_attention_bwd/<where>``
rows (granite, mixtral, whisper's encoder and cross attention, gemma) and
its fp32 ones (``BWD_F32_CASES``), one ``flash_attention_backward`` call
on random inputs is profiled with torch.profiler over ``ITERS`` calls
after a warm-up: the device time a call of the prep (L, delta), dQ and
dK/dV kernels (and the fp32 route's finish kernel, which sums the dK/dV
blocks' partials), and each kernel's rate on the flops it does (bf16: dQ
8·D a live pair, dK/dV 10·D, 14·D at D = 256, where both warpgroups form
S^T and dP^T; fp32: dQ 6·D, dK/dV 8·D, both kernels forming S and dP).
For the fp32 kernels also the mma.sync m16n8k8 they issue a microsecond
an SM (three a product step, over every 64 x 64 tile the plan visits), to
hold against ``probes/mma_tf32_rate.py``'s ceiling.  First, ptxas's
registers and spills of every backward kernel, from a fresh build of
``csrc/flash_attn_bwd.cu``.

    python3 probes/flash_bwd_kernels.py

Prints the card's name and power limit, then one line a shape.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 5


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import build, flash_attn

    if not torch.cuda.is_available():
        print("flash_bwd_kernels: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(),
        flush=True)
    shutil.rmtree(build._lib_path("flash_attn_bwd").parent,
                  ignore_errors=True)     # a fresh build: ptxas's report
    lines = build.build_all()[1]["flash_attn_bwd"].splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry function" in line:
            after = " ".join(lines[n + 1:n + 4])
            name = re.search(r"(flash_bwd_\w+?_kernel)(ILi(\d+)E)?",
                             line)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", after)
            regs = re.search(r"Used (\d+) registers", after)
            if name and spill and regs:
                print(f"ptxas {name.group(1)}"
                      + (f"<{name.group(3)}>" if name.group(3) else "")
                      + f": {regs.group(1)} registers, spill stores "
                      f"{spill.group(1)} B, loads {spill.group(2)} B",
                      flush=True)
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(9)
    tc, mc, ac, gc = (cs._train_config(), cs._moe_config(),
                      cs._audio_config(), cs._gemma_config())
    kv = (cs.AUDIO_B, ac.encoder.enc_len, ac.n_heads, ac.head_dim_)
    cases = {
        "granite": ((cs.TRAIN_B, cs.TRAIN_S, tc.n_heads, tc.head_dim_),
                    (cs.TRAIN_B, cs.TRAIN_S, tc.n_kv_heads, tc.head_dim_),
                    True, tc.sliding_window),
        "mixtral": ((cs.MOE_B, cs.MOE_S, mc.n_heads, mc.head_dim_),
                    (cs.MOE_B, cs.MOE_S, mc.n_kv_heads, mc.head_dim_), True,
                    mc.sliding_window),
        "whisper_encoder": (kv, kv, False, None),
        "whisper_cross": ((cs.AUDIO_B, cs.AUDIO_S, ac.n_heads, ac.head_dim_),
                          kv, False, None),
        "gemma": ((cs.TRAIN_GEMMA_B, cs.TRAIN_GEMMA_S, gc.n_heads,
                   gc.head_dim_),
                  (cs.TRAIN_GEMMA_B, cs.TRAIN_GEMMA_S, gc.n_kv_heads,
                   gc.head_dim_), True, gc.sliding_window)}
    cases = {w: (*c, torch.bfloat16) for w, c in cases.items()}
    cases.update({w: (qs, ks, causal, None, torch.float32)
                  for w, (qs, ks, causal) in cs.BWD_F32_CASES.items()})
    for where, (qs, ks, causal, window, dt) in cases.items():
        B, Sq, Hq, D = qs
        q, k, v = (torch.randn(s, generator=g, device=dev).to(dt)
                   for s in (qs, ks, ks))
        dout = torch.randn(qs, generator=g, device=dev).to(dt)
        out, lse = flash_attn._forward(q, k, v, causal, window, None, True)

        def call():
            flash_attn.flash_attention_backward(
                q, k, v, out, lse, dout, causal=causal, window=window)

        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                call()
            torch.cuda.synchronize()
        ms = {"prep": 0.0, "dq": 0.0, "dkdv": 0.0, "finish": 0.0}
        bf16 = dt == torch.bfloat16
        kind = "bf16" if bf16 else "f32"
        names = {k_: f"flash_bwd_{k_}_{kind}" for k_ in ms}
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for key in ms:
                if names[key] in ev.name:
                    ms[key] += ev.time_range.elapsed_us() / 1e3 / ITERS
        pairs = B * Hq * flash_attn.live_pairs(Sq, ks[1], causal, window)
        dq_flops = (8 if bf16 else 6) * D * pairs
        kv_flops = (8 if not bf16 else 14 if D > 128 else 10) * D * pairs
        rate = ""
        if not bf16:
            # 12 D mma.sync a product of a 64 x 64 tile step (4 D m16n8k8
            # products, three each), 3 products (dQ) or 4 (dK/dV) a step
            t, Sk = flash_attn.F32_TILE, ks[1]
            dq_steps = B * Hq * sum(
                len(flash_attn.dq_kv_tile_range(qt, Sq, Sk, causal, window,
                                                t, t))
                for qt in range(-(-Sq // t)))
            kv_steps = B * Hq * sum(
                len(flash_attn.q_tile_range(kt, Sq, Sk, causal, window, t,
                                            t)) for kt in range(-(-Sk // t)))
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            per_us = lambda n, m: n / (m * 1e3) / sms
            splits = flash_attn.dkdv_splits(B, Sq, Sk, Hq, ks[2], causal,
                                            window, 0, sms)
            rate = (f"; mma.sync a us an SM: dQ "
                    f"{per_us(36 * D * dq_steps, ms['dq']):.1f}, dK/dV "
                    f"{per_us(48 * D * kv_steps, ms['dkdv']):.1f}; finish "
                    f"{ms['finish']:.4f} ms (splits {splits})")
        print(f"{where} {str(dt)[6:]} q{list(qs)} k{list(ks)}: prep "
              f"{ms['prep']:.4f} ms, "
              f"dQ {ms['dq']:.4f} ms ({dq_flops / ms['dq'] / 1e9:.1f} "
              f"TFLOP/s), dK/dV {ms['dkdv']:.4f} ms "
              f"({kv_flops / ms['dkdv'] / 1e9:.1f} TFLOP/s)" + rate,
              flush=True)
        del q, k, v, dout, out, lse
    return 0


if __name__ == "__main__":
    sys.exit(main())
