"""Replay chip_smoke's first kernel check -- the first two launches of
``clg_suffstats`` in a process, on gmm_large's inputs (N = 2^20, F = 10,
D = 1, K = 4), compared bit for bit -- in fresh processes, and run the first
launches under ``compute-sanitizer``.

    python3 probes/clg_first_launch.py [processes]      # on a CUDA card

Each child replays ``chip_smoke.main`` up to and through ``kernel_phase``:
the same torch settings, every kernel source built in the child's own
process into a fresh directory (as the smoke builds them on a clean
checkout), then ``chip_smoke.kernel_phase`` itself, whose first check is the
bitwise one; then ``CALLS`` more launches on the same draws against the
first.  Before the children, the two first launches run once under each of
``compute-sanitizer``'s memcheck, initcheck, racecheck and synccheck tools,
filtered to the moments kernels.

Prints one JSON line a child, each sanitizer tool's exit code and summary,
and a summary line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

N, CALLS = 1 << 20, 50
SANITIZER = "/usr/local/cuda/bin/compute-sanitizer"
TOOLS = ("memcheck", "initcheck", "racecheck", "synccheck")


def _draw(dev):
    """gmm_large's inputs as ``chip_smoke.kernel_phase`` draws them."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)
    F, K, D = 10, 4, 1
    d, y = randn(N, F, D), randn(N, F)
    return d, y, torch.softmax(randn(N, K), -1)


def _same(a, b):
    import torch

    return all(torch.equal(p, q) for p, q in zip(a, b))


def replay(build_dir: str) -> dict:
    """chip_smoke.main's prefix in this process, then more launches."""
    from pathlib import Path

    import torch

    import chip_smoke
    from repro_torch.kernels import build, clg_stats

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    build.BUILD_ROOT = Path(build_dir)
    secs, _ = build.build_all()
    failure = None
    try:
        chip_smoke.kernel_phase(dev)
    except AssertionError as e:
        failure = str(e)
    d, y, r = _draw(dev)
    first = clg_stats.clg_suffstats(d, y, r)
    later = [clg_stats.clg_suffstats(d, y, r) for _ in range(CALLS)]
    torch.cuda.synchronize()
    return {"build_s": round(secs, 2), "kernel_phase_failure": failure,
            "later_equal_first": sum(_same(first, o) for o in later)}


def launches() -> int:
    """The first two launches in a fresh process (the sanitizer's target):
    exit 3 when they differ in bits."""
    import torch

    from repro_torch.kernels import clg_stats

    d, y, r = _draw(torch.device("cuda:0"))
    first = clg_stats.clg_suffstats(d, y, r)
    second = clg_stats.clg_suffstats(d, y, r)
    torch.cuda.synchronize()
    same = _same(first, second)
    print(json.dumps({"first_two_equal": same}), flush=True)
    return 0 if same else 3


def sanitize() -> None:
    if not os.path.exists(SANITIZER):
        print(f"compute-sanitizer: not found at {SANITIZER}", flush=True)
        return
    for tool in TOOLS:
        cmd = [SANITIZER, "--tool", tool, "--kernel-name", "kns=moments",
               "--error-exitcode", "9", "--print-limit", "20",
               sys.executable, __file__, "--launches"]
        t0 = time.perf_counter()
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
            rc, text = out.returncode, out.stdout + out.stderr
        except subprocess.TimeoutExpired as e:
            rc, text = "timeout", str(e.stdout or "") + str(e.stderr or "")
        tail = "\n".join(text.strip().splitlines()[-12:])
        print(f"compute-sanitizer --tool {tool}: rc {rc} in "
              f"{time.perf_counter() - t0:.1f} s\n{tail}", flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--replay":
        print(json.dumps(replay(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--launches":
        return launches()
    import torch

    if not torch.cuda.is_available():
        print("clg_first_launch: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    build.build_all()
    sanitize()
    bad = 0
    for i in range(n):
        build_dir = os.path.join(ROOT, "build", "probe_replay", str(i))
        shutil.rmtree(build_dir, ignore_errors=True)
        out = subprocess.run([sys.executable, __file__, "--replay", build_dir],
                             capture_output=True, text=True, timeout=600)
        shutil.rmtree(build_dir, ignore_errors=True)
        line = out.stdout.strip().splitlines()[-1] if out.stdout else ""
        print(line or out.stderr[-2000:], flush=True)
        rec = json.loads(line) if line.startswith("{") else {}
        bad += not (rec and rec["kernel_phase_failure"] is None
                    and rec["later_equal_first"] == CALLS)
    print(f"{n} replays of chip_smoke's build and kernel phase, {bad} with a "
          f"failed check or a launch that differs in bits; card {card}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
