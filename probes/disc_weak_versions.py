"""``clg_disc_counts`` and ``cg_weak_marg`` of two checkouts, side by side.

Times the two kernels' wrappers of the ``repro_torch`` package under each
checkout given on the command line (a directory holding ``src/``), one
process a checkout, in the order given, so that a change and its parent can
be run in turns on one card (parent, change, change, parent):

- ``clg_disc_counts`` at nb_mixed (2^20 instances, Fd = 2, K = 3, C = 4)
  and at a wide row (2^18 instances, Fd = 360, K = 4, C = 8: Fd + K = 364
  stays within what a shared-memory tile kernel takes);
- ``cg_weak_marg`` at every shape one propagation of ``chip_smoke.py``'s
  serving networks launches ([1024, 1, 3] in n = 1 on chain12, [16384, 1,
  4] in n = 4 on fa16), with a quarter of the weights ``-inf``, and at
  [1024, 1, 4] in n = 8 (the most a one-thread-a-row kernel held in
  registers).

Each timing is CUDA events over back-to-back wrapper calls (host work
included), then the device time a call (torch.profiler: the kernels' busy
time over the calls, host work excluded), after a check against the plain
version: the largest error relative to 1 + max |plain| over finite entries.

    python3 probes/disc_weak_versions.py PARENT_CHECKOUT . . PARENT_CHECKOUT

Prints the card's name and power limit, then one JSON line a checkout:
{"checkout": ..., "ms": {shape: [ms, device ms, err]}}.
"""

from __future__ import annotations

import json
import subprocess
import sys

DISC_SHAPES = [(1 << 20, 2, 3, 4), (1 << 18, 360, 4, 8)]
WEAK_SHAPES = [(1024, 1, 3, 1), (16384, 1, 4, 4), (1024, 1, 4, 8)]


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


def device_ms(torch, fn, calls=20):
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


def rel_err(torch, got, exp):
    err = 0.0
    for a, b in zip(got, exp):
        fin = torch.isfinite(b)
        if fin.any():
            err = max(err, float((a[fin] - b[fin]).abs().max()
                                 / (1 + b[fin].abs().max())))
    return err


def run(checkout: str) -> dict:
    """The timings of the package under ``checkout`` (in this process)."""
    sys.path.insert(0, f"{checkout}/src")
    import torch

    from repro_torch.kernels import build, clg_stats, factor_ops, ref

    build.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    out = {}
    for n, Fd, K, C in DISC_SHAPES:
        xd = torch.randint(0, C, (n, Fd), generator=g, device="cuda",
                           dtype=torch.int32)
        r = torch.softmax(randn(n, K), -1)
        fn = lambda: [clg_stats.clg_disc_counts(xd, r, C)]
        err = rel_err(torch, fn(), [ref.clg_disc_counts_ref(xd, r, C)])
        out[f"clg_disc_counts {[n, Fd, K, C]}"] = [
            time_ms(torch, fn, 50), device_ms(torch, fn), err]
    for B, M, N, k in WEAK_SHAPES:
        lw = randn(B, M, N)
        lw[torch.rand(B, M, N, generator=g, device="cuda") < 0.25] = float(
            "-inf")
        mu = randn(B, M, N, k)
        q = randn(B, M, N, k, k)
        sg = q @ q.transpose(-1, -2) + 0.5 * torch.eye(k, device="cuda")
        fn = lambda: factor_ops.cg_weak_marg(lw, mu, sg)
        err = rel_err(torch, fn(), ref.cg_weak_marg_ref(lw, mu, sg))
        out[f"cg_weak_marg {[B, M, N]} n={k}"] = [
            time_ms(torch, fn, 50), device_ms(torch, fn), err]
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
