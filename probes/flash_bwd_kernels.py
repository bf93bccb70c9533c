"""The three backward kernels of ``flash_attention`` apart, on the card.

At the five bf16 shapes of chip_smoke's ``flash_attention_bwd/<where>``
rows (granite, mixtral, whisper's encoder and cross attention, gemma) and
its fp32 ones at D > 128 (``BWD_F32_CASES``), one
``flash_attention_backward`` call on random inputs is profiled with
torch.profiler over ``ITERS`` calls after a warm-up: the device time a
call of the prep (delta), dQ and dK/dV kernels, and each kernel's rate
on the flops it does (bf16: dQ 8·D a live pair, dK/dV 10·D, 14·D at
D = 256, where both warpgroups form S^T and dP^T; fp32: dQ 6·D, dK/dV
8·D, both kernels forming S and dP).

    python3 probes/flash_bwd_kernels.py

Prints the card's name and power limit, then one line a shape.
"""

from __future__ import annotations

import os
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
    build.build_all()
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
        ms = {"prep": 0.0, "dq": 0.0, "dkdv": 0.0}
        bf16 = dt == torch.bfloat16
        names = {"prep": "flash_bwd_prep_bf16" if bf16
                 else "flash_bwd_preprocess",
                 "dq": "flash_bwd_dq_bf16" if bf16 else "flash_bwd_dq_kernel",
                 "dkdv": "flash_bwd_dkdv_bf16" if bf16
                 else "flash_bwd_dkdv_kernel"}
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for key in ms:
                if names[key] in ev.name:
                    ms[key] += ev.time_range.elapsed_us() / 1e3 / ITERS
        pairs = B * Hq * flash_attn.live_pairs(Sq, ks[1], causal, window)
        dq_flops = (8 if bf16 else 6) * D * pairs
        kv_flops = (8 if not bf16 else 14 if D > 128 else 10) * D * pairs
        print(f"{where} {str(dt)[6:]} q{list(qs)} k{list(ks)}: prep "
              f"{ms['prep']:.4f} ms, "
              f"dQ {ms['dq']:.4f} ms ({dq_flops / ms['dq'] / 1e9:.1f} "
              f"TFLOP/s), dK/dV {ms['dkdv']:.4f} ms "
              f"({kv_flops / ms['dkdv'] / 1e9:.1f} TFLOP/s)", flush=True)
        del q, k, v, dout, out, lse
    return 0


if __name__ == "__main__":
    sys.exit(main())
