"""Run one cell of the port's benchmark and print one JSON line.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The run builds the port's kernels (or
finds them built in ``build/repro_torch_kernels/`` inside the checkout),
makes the weights and the traffic from ``--seed``, drives the cell's
warm-up and checked steps, measures for ``--seconds``, then with
``--trace 1`` profiles a few more steps or calls, checks what the program
produced against the plain reference, and prints the result as the last
line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, ``breakdown`` (traced runs) and ``checks``
(each number compared beside its limit, also the last lines of standard
error).  It exits non-zero and prints no result where the card is missing
or too few, where a metric cannot be read, or where JAX or the JAX
package was loaded.

``--device cpu`` is a dry path for the tests: the configuration's and
the traffic's ``tiny`` sizes on the CPU, the program's plain path, no
device metric.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)


def tiny(base: dict) -> dict:
    """``base`` with its ``tiny`` sizes put in (nested groups whole)."""
    out = {k: v for k, v in base.items() if k != "tiny"}
    out.update(base.get("tiny", {}))
    return out


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from bench import spec

    cell = spec.find_cell(args.workload)
    import torch

    cfg, traffic = cell.config, cell.traffic
    if args.device == "cuda":
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            log(f"{cell.name} needs {cell.chips} CUDA card(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                f" available")
            return 2
        dev = torch.device("cuda", 0)
        from repro_torch.kernels import build

        build_s, _ = build.build_all()
        log(f"card: {card_line()}; kernels built or found in {build_s:.2f} s")
        torch.cuda.reset_peak_memory_stats()
    else:
        dev = torch.device("cpu")
        cfg, traffic = tiny(cfg), tiny(traffic)
    from bench import check, trace

    kmod = spec.kind(traffic["kind"])
    kind = kmod.Kind(cfg, traffic, args.seed, dev)
    kind.setup()
    setup_s = time.perf_counter() - T0
    win = kind.window(args.seconds)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    log(f"{cell.name} seed {args.seed}: set-up {setup_s:.3f} s; window "
        f"{win['seconds']:.3f} s, {win['units']} units, {win['tokens']} "
        f"tokens; peak {peak / GIB:.3f} GiB")
    if win["unit_s"]:
        u = sorted(win["unit_s"])
        log(f"unit s: min {u[0]:.4f} median {u[len(u) // 2]:.4f} max "
            f"{u[-1]:.4f}; in order " + " ".join(f"{x:.4f}"
                                                 for x in win["unit_s"]))
    ctx = {"cell": cell.name, "config": cfg, "traffic": traffic,
           "window": win, "setup_s": setup_s, "peak_bytes": peak,
           "trace": None}
    readers = {m.name: spec.reader(m.name)
               for m in (cell.per_layer if args.trace else cell.end_to_end)}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if dev.type == "cuda"
              else "cpu", "count": cell.chips, "memory_peak_bytes": peak}
    breakdown = None
    if args.trace:
        wraps = {}
        for r in readers.values():
            wraps.update(getattr(r, "WRAPS", {}))
        tr = trace.profile(kind.unit, traffic["profiled_units"], wraps)
        ctx["trace"] = tr
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops_top(),
                     "idle_gaps": tr.idle_gaps_top()}
        log(f"trace: {len(tr.ops)} device ops over {tr.units} units, "
            f"{tr.unmatched} without a launching call; ranges "
            f"{tr.span_count}; device s by range "
            f"{ {k: round(v, 6) for k, v in tr.span_device_s.items()} }; "
            f"missing wrap points {tr.missing}; events {tr.kinds}")
    metrics = {}
    for name, r in readers.items():
        m = next(x for x in cell.end_to_end + cell.per_layer
                 if x.name == name)
        value = r.read(ctx)
        if value is None:
            if not args.trace and dev.type == "cuda":
                log(f"end-to-end metric {name} could not be read")
                return 3
            log(f"metric {name}: nothing to read")
            continue
        if not math.isfinite(value):
            log(f"metric {name} reads {value}")
            return 3
        metrics[name] = {"value": value, "unit": m.unit}
    outputs = kind.outputs()
    kind.free()
    numbers = kmod.check_outputs(cfg, traffic, args.seed, dev, outputs)
    limits = cell.limits["limits" if dev.type == "cuda" else "tiny_limits"]
    correct = check.verdict(numbers, limits) and win["units"] > 0 \
        and win["failed"] == 0
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {bad}: the port's benchmark may load "
            f"neither JAX nor the JAX package")
        return 4
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    for k, c in checks.items():
        log(f"check {k} {c['value']:.6e} limit {c['limit']:.6e}")
    result = {"correct": correct, "attempted": win["units"],
              "failed": win["failed"], "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
