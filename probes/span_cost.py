"""What the program's spans cost when they are on, on one card.

    python3 probes/span_cost.py [--cells C1,C2] [--units 6] [--rounds 3]
                                [--seed N] [--device cuda|cpu]

Sets up each benchmark cell (``bench/`` kinds: the same trainer or
prefill calls as ``bench/run.py``), then times its units (a training step
or a prefill call, each ending on the host) in four modes, in turns,
``--rounds`` times:

    off         spans inactive (the benchmark's timed window);
    trace       ``REPRO_OBS=trace``: spans active, a JSONL event each;
    prof        under ``torch.profiler`` (CPU and CUDA): spans active,
                each a ``record_function`` range (``bench/run.py
                --trace 1``);
    prof_bare   under the profiler with the program's spans held off.

and prints one JSON line a cell: the median ms a unit of each mode,
spans a unit, and the costs trace - off and prof - prof_bare.  In a
VB cell it also profiles ``posterior_kl`` alone on the trainer's state
(device ms a call), the KL that ``train.update`` holds beside
``vb_update``; and first it times empty spans alone in each mode (host us
a span).  ``--device cpu`` runs the cells' tiny sizes (a
rehearsal; no times to keep).
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from bench import run, spec, trace  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

CELLS = ("granite-3-2b.train-adamw.2x4096,granite-3-2b.train-vb.2x4096,"
         "granite-3-2b.prefill.2x4096")
MODES = ("off", "trace", "prof", "prof_bare")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _timed(kind, dev, n):
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        kind.unit()
        _sync(dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _mode(mode, kind, dev, n, events):
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    obs.clear_spans()
    if mode == "off":
        return _timed(kind, dev, n), 0
    if mode == "trace":
        prev = obs.configure(level="trace", path=events)
        try:
            ms = _timed(kind, dev, n)
        finally:
            obs.configure(level=prev["level"], path=prev["path"])
        return ms, len(obs.recorded_spans())
    saved = obs_trace._profiling
    if mode == "prof_bare":
        obs_trace._profiling = lambda: False
    try:
        with torch.profiler.profile(activities=acts):
            ms = _timed(kind, dev, n)
    finally:
        obs_trace._profiling = saved
    return ms, len(obs.recorded_spans())


class _NoWork:
    """A unit of ``n`` empty spans (no device work)."""

    n = 5000

    def unit(self):
        for _ in range(self.n):
            with obs.span("probe.empty"):
                pass


def span_us(dev, events):
    """Host us an empty span in each mode (the median of 5 units)."""
    out = {}
    for m in MODES:
        ms, _ = _mode(m, _NoWork(), dev, 5, events)
        out[m] = statistics.median(ms) * 1e3 / _NoWork.n
    return out


def kl_ms(kind, dev):
    """Device ms a call of ``posterior_kl`` on the trainer's VB state."""
    from repro_torch.bayes import vb_optimizer as vb

    if dev.type != "cuda":
        return None
    st, n_total = kind.trainer.state.vb, kind.trainer.tcfg.n_total
    tr = trace.profile(lambda: vb.posterior_kl(st, n_total), 3, {})
    return sum(op.dur_ns for op in tr.ops) / 1e6 / tr.units


def measure(cell_name, args, dev):
    cell = spec.find_cell(cell_name)
    cfg, traffic = cell.config, cell.traffic
    if dev.type == "cpu":
        cfg, traffic = run.tiny(cfg), run.tiny(traffic)
    kind = spec.kind(traffic["kind"]).Kind(cfg, traffic, args.seed, dev)
    kind.setup()
    _timed(kind, dev, 2)
    fd, events = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    ms = {m: [] for m in MODES}
    spans = {m: [] for m in MODES}
    try:
        for r in range(args.rounds):
            order = MODES if r % 2 == 0 else MODES[::-1]
            for m in order:
                t, n = _mode(m, kind, dev, args.units, events)
                ms[m] += t
                spans[m].append(n / args.units)
        kl = kl_ms(kind, dev) if traffic.get("optimizer") == "vb" else None
    finally:
        os.unlink(events)
        kind.free()
    med = {m: statistics.median(v) for m, v in ms.items()}
    res = {"cell": cell_name, "units_a_mode": args.units * args.rounds,
           "median_ms": med, "ms": ms,
           "spans_a_unit": {m: statistics.median(v)
                            for m, v in spans.items()},
           "trace_minus_off_ms": med["trace"] - med["off"],
           "prof_minus_prof_bare_ms": med["prof"] - med["prof_bare"],
           "posterior_kl_device_ms": kl}
    print(json.dumps(res), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=CELLS)
    ap.add_argument("--units", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2360000001)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0) if args.device == "cuda" \
        else torch.device("cpu")
    card = run.card_line() if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        from repro_torch.kernels import build

        build.build_all()
    fd, events = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    try:
        empty = span_us(dev, events)
    finally:
        os.unlink(events)
    print(json.dumps({"empty_span_us": empty}), flush=True)
    for c in args.cells.split(","):
        measure(c, args, dev)
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
