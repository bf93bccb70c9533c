"""The fp32 forward kernel of ``flash_attention`` on the card: its build,
its agreement with the plain version, its device time and its mma.sync
rate.

First ptxas's registers and spills of every kernel of a fresh build of
``csrc/flash_attn.cu``.  Then ``flash_attn._forward`` on fp32 inputs at
small cases -- D 16 to 256, causal, windowed, at a q offset, GQA, Sq = 1
to 300 against Sk = 1 to 1500, split and unsplit plans, a row with no
live key, views off TMA's rules --, each within ATTN_F32_TOL (1 + |exp|)
of ``attention_blockwise`` (out) and of ``attention_lse_plain`` (lse), two
launches the same bits.  Then, at chip_smoke's fp32 forward rows
(whisper's encoder, cross attention and decode step's cross attention)
and at ``BWD_F32_CASES``, one call profiled with torch.profiler over
``ITERS`` calls: the device time a call of the kernel and of the finish
kernel, the split count, the TFLOP/s over the live pairs, and the
mma.sync m16n8k8 the kernel issues a microsecond an SM (three a product
step: 6 D a warp with a row below Sq and a 64-key tile it visits), beside
one ``scaled_dot_product_attention`` call.  Last, ``probes/mma_tf32_rate.py``
in the same process: the ceiling those rates are held against.

    python3 probes/flash_fwd_f32.py

Prints the card's name and power limit, then one line a kernel, a case
and a shape; exits 1 if a case misses its bar or two launches differ.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 5
ATTN_F32_TOL = 2e-5              # chip_smoke.py's bar for an fp32 launch

CASES = [  # B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset
    (1, 1, 1, 2, 2, 16, False, None, 0),
    (2, 1, 1500, 4, 4, 64, False, None, 0),          # decode: short, split
    (1, 16, 1500, 2, 2, 256, True, None, 1484),      # short at D 256
    (1, 3, 64, 2, 2, 128, False, 1, 63),             # short, rows 1, 2 none
    (1, 2, 64, 4, 2, 144, False, None, 0),
    (1, 17, 1500, 4, 1, 256, True, None, 1483),      # causal at an offset
    (2, 130, 1500, 2, 2, 64, False, None, 0),
    (1, 300, 300, 8, 2, 64, True, 100, 0),           # GQA with a window
    (1, 200, 600, 8, 2, 128, True, 100, 250),
    (2, 256, 256, 4, 2, 80, True, None, 0),
    (8, 448, 1500, 16, 16, 64, False, None, 0),      # unsplit
    (1, 100, 64, 2, 2, 64, False, 1, 0),             # rows 64.. no live key
    (1, 128, 128, 2, 2, 64, False, 10, 72),          # split, rows 65.. none
]


def _ratio(torch, got, exp):
    return float(((got - exp).abs() / (ATTN_F32_TOL * (1 + exp.abs())))
                 .max())


def _ptxas(build):
    shutil.rmtree(build._lib_path("flash_attn").parent, ignore_errors=True)
    lines = build.build_all()[1]["flash_attn"].splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry function" in line:
            after = " ".join(lines[n + 1:n + 4])
            name = re.search(r"(flash_attn_\w+?_kernel)(ILi(\d+)E(Lb([01])E)?)?",
                             line)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", after)
            regs = re.search(r"Used (\d+) registers", after)
            if name and spill and regs:
                plan = ("" if not name.group(5) else ", short"
                        if name.group(5) == "1" else ", long")
                print(f"ptxas {name.group(1)}"
                      + (f"<{name.group(3)}{plan}>" if name.group(3) else "")
                      + f": {regs.group(1)} registers, spill stores "
                      f"{spill.group(1)} B, loads {spill.group(2)} B",
                      flush=True)


def _checks(torch, F, A, dev):
    ok = True
    for n, (B, Sq, Sk, Hq, Hkv, D, causal, window, off) in enumerate(CASES):
        g = torch.Generator(device=dev).manual_seed(n)
        q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev)
                   for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))
        got = F._forward(q, k, v, causal, window, None, True, off)
        again = F._forward(q, k, v, causal, window, None, True, off)
        # q, k and v as views off TMA's rules: one copy, the same bits
        wide = [torch.zeros(t.shape[:3] + (D + 2,), device=dev)
                for t in (q, k, v)]
        for w, t in zip(wide, (q, k, v)):
            w[..., 1:D + 1] = t
        copies = F.ROUTES["f32_copy"]
        viewed = F._forward(*(w[..., 1:D + 1] for w in wide), causal, window,
                            None, True, off)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again)) \
            and all(torch.equal(a, b) for a, b in zip(got, viewed)) \
            and F.ROUTES["f32_copy"] == copies + 1
        kw = dict(causal=causal, window=window, q_offset=off)
        r_out = _ratio(torch, got[0], A.attention_blockwise(q, k, v, **kw))
        r_lse = _ratio(torch, got[1], F.attention_lse_plain(q, k, **kw))
        splits = F.f32_splits(B, Sq, Sk, Hq, Hkv, causal, window, off,
                              F.sm_count(dev))
        ok &= same and r_out <= 1 and r_lse <= 1
        print(f"case {(B, Sq, Sk, Hq, Hkv, D, causal, window, off)} splits "
              f"{splits}: out {r_out:.4f} and lse {r_lse:.4f} of the bar, "
              f"same bits (again, through views) {same}", flush=True)
    return ok


def _mma(F, B, Sq, Sk, Hq, D, causal, window):
    """mma.sync m16n8k8 the kernel issues: 6 D a 64-key kv tile its block
    visits (3 D for S, 3 D for P V) and a warp with a row below Sq (the
    short plan: the 8 warps share the 16 rows and 6 D)."""
    p = F.f32_tile_plan(D)
    n = 0
    for qt in range(-(-Sq // p.bq)):
        warps = -(-min(p.bq, Sq - qt * p.bq) // 16)
        n += warps * len(F.dq_kv_tile_range(qt, Sq, Sk, causal, window,
                                            p.bq, p.tile))
    return 6 * D * n * B * Hq


def _rows(torch, F, cs, dev):
    from torch.profiler import ProfilerActivity, profile
    import torch.nn.functional as Fnn

    ac = cs._audio_config()
    kv = (cs.AUDIO_B, ac.encoder.enc_len, ac.n_heads, ac.head_dim_)
    shapes = {"whisper_encoder": (kv, kv, False),
              "whisper_cross": ((cs.AUDIO_B, cs.AUDIO_S, ac.n_heads,
                                 ac.head_dim_), kv, False),
              "whisper_decode_cross": ((cs.AUDIO_B, 1, ac.n_heads,
                                        ac.head_dim_), kv, False)}
    shapes.update(cs.BWD_F32_CASES)
    g = torch.Generator(device=dev).manual_seed(8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for where, (qs, ks, causal) in shapes.items():
        B, Sq, Hq, D = qs
        Sk, Hkv = ks[1], ks[2]
        q = torch.randn(qs, generator=g, device=dev)
        k, v = (torch.randn(ks, generator=g, device=dev) for _ in range(2))
        call = lambda: F._forward(q, k, v, causal, None, None, False)
        call()
        torch.cuda.synchronize()
        ms = {"kernel": 0.0, "finish": 0.0}
        for _ in range(3):   # a profile may come back without device events
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(ITERS):
                    call()
                torch.cuda.synchronize()
            for ev in prof.events():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                key = ("finish" if "f32_finish" in ev.name else "kernel"
                       if "flash_attn_f32_kernel" in ev.name else None)
                if key:
                    ms[key] += ev.time_range.elapsed_us() / 1e3 / ITERS
            if ms["kernel"]:
                break
        heads = torch.arange(Hq, device=dev) % Hkv
        qx = q.transpose(1, 2)
        kx, vx = (t[:, :, heads].transpose(1, 2) for t in (k, v))
        sdpa = cs.time_ms(lambda: Fnn.scaled_dot_product_attention(
            qx, kx, vx, is_causal=causal), iters=3, warmup=1)
        event = cs.time_ms(call, iters=3, warmup=1)
        flops = F.attention_flops(B, Sq, Sk, Hq, D, causal)
        per_us = _mma(F, B, Sq, Sk, Hq, D, causal, None) \
            / (ms["kernel"] * 1e3) / sms if ms["kernel"] else 0.0
        splits = F.f32_splits(B, Sq, Sk, Hq, Hkv, causal, None, 0, sms)
        print(f"{where} q{list(qs)} k{list(ks)} causal={causal}: kernel "
              f"{ms['kernel']:.4f} ms, finish {ms['finish']:.4f} ms "
              f"(splits {splits}), event ms {event:.4f}, sdpa ms "
              f"{sdpa:.4f}; {flops / (ms['kernel'] or 1) / 1e9:.1f} "
              f"TFLOP/s over the live pairs, {per_us:.1f} mma.sync a us an "
              f"SM", flush=True)
        del q, k, v, kx, vx


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "probes"))
    import torch

    import chip_smoke as cs
    import mma_tf32_rate
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attn as F
    from repro_torch.nn import attention as A

    if not torch.cuda.is_available():
        print("flash_fwd_f32: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(),
        flush=True)
    _ptxas(build)
    dev = torch.device("cuda:0")
    ok = _checks(torch, F, A, dev)
    _rows(torch, F, cs, dev)
    mma_tf32_rate.main()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
