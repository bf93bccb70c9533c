"""``log_marginalize`` and ``clg_suffstats_latent`` of two checkouts, side by side.

Times the two kernels' wrappers of the ``repro_torch`` package under each
checkout given on the command line (a directory holding ``src/``), one
process a checkout, in the order given, so that a change and its parent can
be run in turns on one card (parent, change, change, parent):

- ``log_marginalize`` at every [B, M, N] shape one discrete32 propagation of
  ``chip_smoke.py``'s serving phase launches at B = 1024, plus few long rows
  [1024, 1, 16384] and ragged N, on tables a quarter ``-inf``;
- ``clg_suffstats_latent`` at fa_plate (2^20 instances, F = 16, Do = 1,
  K = 1, L = 4), a wide row (2^18, F = 300, K = 2), K = 3, L = 16 (D > 8)
  and the per-leaf latent model's L = F = 16 (``CustomGlobalLocalModel``);
- ``clg_suffstats`` at D = 12 and D = 40, whose units share the latent
  kernels' source file.

Each timing is CUDA events over back-to-back wrapper calls (host work
included), then the device time a call (torch.profiler: the kernels' busy
time over the calls, host work excluded), after a check against the plain
version: the max abs error of ``log_marginalize`` over finite rows, the
largest error of the moments relative to 1 + max |plain|.

    python3 probes/lse_latent_versions.py PARENT_CHECKOUT . . PARENT_CHECKOUT

Prints the card's name and power limit, then one JSON line a checkout:
{"checkout": ..., "ms": {shape: [ms, device ms, err]}}.
"""

from __future__ import annotations

import json
import subprocess
import sys

LSE_SHAPES = [(1024, 1024, 16), (1024, 16, 1024), (1024, 256, 64),
              (1024, 1024, 4), (1024, 64, 64), (1024, 16, 256),
              (1024, 256, 16), (1024, 256, 4), (1024, 64, 4),
              (1024, 16, 16), (1024, 1, 256), (1024, 4, 64), (1024, 16, 4),
              (1024, 4, 4), (1024, 1, 4), (1024, 1, 16384), (64, 100, 3),
              (16, 60, 129)]
LATENT_SHAPES = [(1 << 20, 16, 1, 1, 4), (1 << 18, 300, 1, 2, 4),
                 (1 << 20, 16, 1, 3, 4), (1 << 18, 10, 1, 2, 16),
                 (1 << 18, 16, 1, 1, 16)]
MOMENT_SHAPES = [(1 << 18, 4, 12, 2), (1 << 16, 3, 40, 2)]


def time_ms(torch, fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, calls=10):
    """Device time a call: the busy time of the kernels of ``calls`` warm
    calls, from torch.profiler, over ``calls``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA)
    return busy / calls / 1e3


def run(checkout: str) -> dict:
    """The timings of the package under ``checkout`` (in this process)."""
    sys.path.insert(0, f"{checkout}/src")
    import torch

    from repro_torch.kernels import build, clg_stats, factor_ops, ref

    build.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    out = {}
    for shape in LSE_SHAPES:
        x = randn(*shape)
        x[torch.rand(*shape, generator=g, device="cuda") < 0.25] = float(
            "-inf")
        got, exp = factor_ops.log_marginalize(x), ref.log_marginalize_ref(x)
        fin = torch.isfinite(exp)
        fn = lambda: factor_ops.log_marginalize(x)
        out[f"log_marginalize {list(shape)}"] = [
            time_ms(torch, fn, 50), device_ms(torch, fn),
            float((got[fin] - exp[fin]).abs().max())]
    for n, F, Do, K, L in LATENT_SHAPES:
        obs, y, hm = randn(n, F, Do), randn(n, F), randn(n, K, L)
        r = torch.softmax(randn(n, K), -1)
        shh = torch.eye(L, device="cuda").expand(K, L, L).contiguous()
        fn = lambda: clg_stats.clg_suffstats_latent(obs, hm, y, r, shh)
        exp = ref.clg_suffstats_latent_ref(obs, hm, y, r, shh)
        err = max(float((a - b).abs().max() / (1 + b.abs().max()))
                  for a, b in zip(fn(), exp))
        out[f"clg_suffstats_latent {[n, F, Do, K, L]}"] = [
            time_ms(torch, fn, 20), device_ms(torch, fn), err]
    for n, F, D, K in MOMENT_SHAPES:
        d, y = randn(n, F, D), randn(n, F)
        r = torch.softmax(randn(n, K), -1)
        fn = lambda: clg_stats.clg_suffstats(d, y, r)
        exp = ref.clg_suffstats_ref(d, y, r)
        err = max(float((a - b).abs().max() / (1 + b.abs().max()))
                  for a, b in zip(fn(), exp))
        out[f"clg_suffstats {[n, F, D, K]}"] = [
            time_ms(torch, fn, 20), device_ms(torch, fn), err]
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps({"checkout": sys.argv[2], "ms": run(sys.argv[2])}))
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    for checkout in sys.argv[1:]:           # one process a checkout
        res = subprocess.run([sys.executable, __file__, "--one", checkout],
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stderr, file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
