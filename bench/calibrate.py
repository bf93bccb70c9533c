"""Readings that the check's limits are set from, on the chip at a cell's
own sizes (not run by the benchmark's runs).

    python bench/calibrate.py --workload <cell> --program-seeds a,b,... \\
        [--control-seeds x,y,...] [--fault-seeds u,v,...]

For each program seed: the program's set-up as a run makes it, driven on
until every checked output exists (the kind's ``fill_checked``), then the
check's numbers against the reference.  For each control seed: the
reference one precision step below (float8 products) in the program's
place.  For each fault seed: each of the kind's ``FAULTS`` planted in the
reference.  One JSON line a reading on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch

    from bench import spec
    from bench.run import tiny

    cell = spec.find_cell(args.workload)
    cfg, traffic = cell.config, cell.traffic
    if args.device == "cpu":
        cfg, traffic = tiny(cfg), tiny(traffic)
    else:
        from repro_torch.kernels import build

        build.build_all()
    dev = torch.device(args.device)
    kmod = spec.kind(traffic["kind"])

    def emit(what, seed, numbers, t0, look=None):
        print(json.dumps({"cell": cell.name, "reading": what, "seed": seed,
                          "numbers": numbers, "worst": look,
                          "seconds": time.perf_counter() - t0}), flush=True)

    for seed in args.program_seeds:
        t0 = time.perf_counter()
        kind = kmod.Kind(cfg, traffic, seed, dev)
        kind.setup()
        kind.fill_checked()
        out = kind.outputs()
        kind.free()
        look = {}
        numbers = kmod.check_outputs(cfg, traffic, seed, dev, out, look)
        emit("program", seed, numbers, t0, look or None)
        del kind, out
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        emit("control_fp8", seed, kmod.control(cfg, traffic, seed, dev), t0)
    for seed in args.fault_seeds:
        for name, fault in kmod.FAULTS.items():
            t0 = time.perf_counter()
            emit(f"fault_{name}", seed, fault(cfg, traffic, seed, dev), t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
