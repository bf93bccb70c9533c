"""What the SPLIT template parameter of ``family_counts.cu`` buys.

With C in one range the counting loop skips the range offset (``SPLIT`` is
false); with more ranges each code takes ``min(code - c0, Cb)``.  This
script builds the kernel twice -- as it is, and with the offset path forced
for every launch -- and times both, interleaved in one process, at the
all-candidates shape of ``chip_smoke.py`` (2^20 instances of 32 card-4
columns, all 15904 families of at most 2 parents, C = 64) and at hill
climbing's first step (the 992 one-parent families, C = 16), on uniform
random categories.  Each build must give the plain version's bits.

    python3 probes/family_counts_split.py      # needs one CUDA card

Prints the card's name and power limit, then one JSON line of ms a call.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.clg_stats import sm_count  # noqa: E402
from repro_torch.kernels import family_counts as fc  # noqa: E402

SWITCH = "by_k(k, C > Cb,"          # the launcher's choice of SPLIT


def _families(n_vars, card, max_parents):
    rows = []
    for child in range(n_vars):
        others = [v for v in range(n_vars) if v != child]
        for n_pa in range(max_parents + 1):
            for pa in itertools.combinations(others, n_pa):
                row = [0] * n_vars
                stride = 1
                for v in (child,) + pa:
                    row[v] = stride
                    stride *= card
                rows.append(row)
    return torch.tensor(rows, dtype=torch.int32)


def _build(out_dir):
    src = (build.CSRC / "family_counts.cu").read_text()
    if src.count(SWITCH) != 1:
        raise RuntimeError(f"family_counts.cu: {SWITCH!r} not found once")
    libs, procs = {}, {}
    for name, text in (("as built", src),
                       ("offset always", src.replace(SWITCH,
                                                     "by_k(k, true,"))):
        cu = out_dir / f"fc_{len(procs)}.cu"
        cu.write_text(text)
        so = out_dir / f"fc_{len(procs)}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.DEVNULL), so)
    for name, (proc, so) in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for {name}")
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.family_counts_launch.argtypes = [p] * 6 + [i] * 9 + [p]
        lib.family_counts_launch.restype = i
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("family_counts_split: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    N, Fd, card = 1 << 20, 32, 4
    xd = torch.randint(0, card, (N, Fd), generator=g, device=dev,
                       dtype=torch.int32)
    w = (torch.rand(N, generator=g, device=dev) < 0.9).float()
    every = _families(Fd, card, 2).to(dev)
    shapes = {"all candidates (M=15904, C=64)": (every, card ** 3),
              "hill climbing's first step (M=992, C=16)":
                  (every[(every != 0).sum(1) == 2], card ** 2)}
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build(Path(tmp))
        for label, (strides, C) in shapes.items():
            M = strides.shape[0]
            cols, svals = fc.compact_strides(strides)
            p = fc.plan(N, Fd, M, C, sm_count(dev))
            partial = torch.empty(p.n_slabs * M * C, device=dev)
            out = torch.empty(M, C, device=dev)

            def run(lib):
                err = lib.family_counts_launch(
                    xd.data_ptr(), cols.data_ptr(), svals.data_ptr(),
                    w.data_ptr(), partial.data_ptr(), out.data_ptr(), N, Fd,
                    M, cols.shape[1], C, p.Cb, p.G, p.T, p.slab_len,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed with CUDA error {err}")

            exp = ref.family_counts_ref(xd, strides, w, C)
            for name, lib in libs.items():
                run(lib)
                torch.cuda.synchronize()
                if not torch.equal(out, exp):
                    raise AssertionError(f"{name} at {label}: not the plain "
                                         f"version's bits")
            ms = {name: [] for name in libs}
            for name in ["as built", "offset always"] * 2 + [
                    "offset always", "as built"] * 2:
                run(libs[name])
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    run(libs[name])
                end.record()
                torch.cuda.synchronize()
                ms[name].append(start.elapsed_time(end) / 10)
            result[label] = dict(plan=p._asdict(), ms=ms)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
