"""``ssd_scan_backward``'s kernels on the card, against the plain backward.

Builds the kernels (printing the backward source's ptxas report), then at
each shape of ``SHAPES`` on random inputs (x, B, C, dy, dhfin standard
normal, dt = softplus(randn + shift), A = exp(linspace(0, 2.77, H))):
two launches the same bits, the relative L2 error of dx, ddt, dA, dB and
dC against the plain backward in fp64 and the plain backward in fp32's
own, and autograd through ``ssd_scan`` giving the wrapper's bits.  At
zamba2-1.2b's and mamba2-1.3b's training calls ([2, 4096, 64, 64], N 64
and 128, chunk 128) it also times the call with CUDA events beside the
plain backward in fp32, and profiles one call's kernels by name.

    python3 probes/ssd_bwd_kernels.py

Prints the card's name and power limit, then one line a shape.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (b, S, H, P, G, N, chunk, dt shift, timed)
SHAPES = [(1, 256, 4, 64, 1, 64, 128, -4.0, False),
          (2, 512, 8, 32, 2, 128, 128, 2.0, False),
          (1, 90, 6, 16, 3, 24, 30, 0.0, False),
          (2, 192, 4, 48, 4, 7, 64, -1.0, False),
          (2, 1800, 7, 32, 1, 128, 90, 0.0, False),
          (2, 1280, 10, 16, 2, 64, 64, -1.0, False),
          (2, 4096, 64, 64, 1, 64, 128, -4.0, True),
          (2, 4096, 64, 64, 1, 128, 128, -4.0, True)]


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.nn.functional as Fnn
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import build, ssd_scan as K

    if not torch.cuda.is_available():
        print("ssd_bwd_kernels: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(),
        flush=True)
    secs, logs = build.build_all()
    print(f"build {secs:.1f} s\n{logs.get('ssd_scan_bwd', '(cached)')}",
          flush=True)
    dev = torch.device("cuda:0")
    bad = 0
    for b, S, H, P, G, N, chunk, shift, timed in SHAPES:
        g = torch.Generator(device=dev).manual_seed(S + N)
        rn = lambda *s: torch.randn(*s, generator=g, device=dev)
        x, dy = rn(b, S, H, P), rn(b, S, H, P)
        dt = Fnn.softplus(rn(b, S, H) + shift)
        A = torch.exp(torch.linspace(0.0, 2.77, H, device=dev))
        BC = rn(b, S, 2 * G * N)            # B and C strided, as in Mamba2
        B, C = (t.reshape(b, S, G, N) for t in BC.chunk(2, -1))
        dh = rn(b, H, P, N)
        args = (x, dt, A, B, C, dy, dh, chunk)
        kern = lambda: K.ssd_scan_backward(*args)
        got, again = kern(), kern()
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(got, again))
        del again
        exp = K.ssd_scan_backward_plain(
            *[t.double() for t in args[:7]], chunk)
        plain = K.ssd_scan_backward_plain(*args)
        err = [cs._ssd_bwd_rel(u, e) for u, e in zip(got, exp)]
        err32 = [cs._ssd_bwd_rel(u, e) for u, e in zip(plain, exp)]
        ratio = cs._ssd_bwd_ratio(got, plain)
        del exp, plain
        xr, dtr, Ar, Br, Cr = (t.detach().clone().requires_grad_()
                               for t in (x, dt, A, B, C))
        y, h = K.ssd_scan(xr, dtr, Ar, Br, Cr, chunk)
        auto = torch.autograd.grad((y, h), (xr, dtr, Ar, Br, Cr), (dy, dh))
        same_auto = all(torch.equal(u, v) for u, v in zip(auto, got))
        ok = same and same_auto and ratio <= 1
        bad += not ok
        line = (f"[b={b}, S={S}, H={H}, P={P}, G={G}, N={N}, chunk={chunk}, "
                f"dt shift {shift}]: relative L2 vs fp64 dx/ddt/dA/dB/dC "
                + " ".join(f"{e:.2e}" for e in err) + " (plain fp32 "
                + " ".join(f"{e:.2e}" for e in err32)
                + f"); vs plain fp32 over the bar {ratio:.3f}; two launches "
                f"{'the same bits' if same else 'DIFFER'}; autograd "
                f"{'the same bits' if same_auto else 'DIFFERS'}")
        if timed:
            ms = cs.time_ms(kern, iters=5, warmup=2)
            pms = cs.time_ms(lambda: K.ssd_scan_backward_plain(*args),
                             iters=2, warmup=1)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                kern()
                torch.cuda.synchronize()
            names = {}
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    names[ev.name] = names.get(ev.name, 0.0) \
                        + ev.time_range.elapsed_us() / 1e3
            line += (f"; ms {ms:.4f}, plain ms {pms:.4f}; kernels (ms) "
                     + ", ".join(f"{k[:40]} {v:.4f}" for k, v in
                                 sorted(names.items(), key=lambda kv: -kv[1]))
                     + f"; blocks an SM {K.bwd_blocks_per_sm(chunk, N)}")
        print(line, flush=True)
        del got, args, x, dy, dt, B, C, BC, dh
        torch.cuda.empty_cache()
    print("ok" if not bad else f"{bad} shapes failed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
