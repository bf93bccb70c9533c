"""Finding a cell and everything that belongs to it, by name.

``BENCHMARK.json`` at the root names the cells, configurations and
metrics; each configuration, traffic mix, cell and per-layer metric is a
file of its own under ``bench/`` (package docstring).  Adding one takes new
files and new entries, never an edit of a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer")


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]]    # None: every cell

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads``, with its configuration, traffic and
    limits read from their files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _metric(entry: dict) -> Metric:
    return Metric(name=entry["name"], unit=entry["unit"],
                  workloads=entry.get("workloads"))


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration
    (``bench/configs/<config>.json``), traffic mix (``bench/traffic/
    <traffic>.json``, which names its kind) and limits
    (``bench/workloads/<cell>.json``)."""
    spec = benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"it has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "bench" / "workloads" / f"{name}.json")
    e2e = [m for m in map(_metric, spec["end_to_end"]) if m.applies_to(name)]
    per = [m for m in map(_metric, spec["per_layer"]) if m.applies_to(name)]
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per)


def _load(path: Path, mod_name: str, what: str) -> ModuleType:
    """The module at ``path``, loaded by path (a name may hold dots)."""
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {what} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    """The reader of metric ``metric``: ``bench/metrics/<metric>.py``."""
    return _load(root / "bench" / "metrics" / f"{metric}.py",
                 "bench_metric_" + re.sub(r"\W", "_", metric),
                 f"reader for metric {metric!r}")


def kind(name: str, root: Path = ROOT) -> ModuleType:
    """The traffic kind ``name``: ``bench/traffic/<name>.py``, with its
    ``Kind`` (set-up, window, unit, fill_checked, outputs, free),
    ``check_outputs``, ``control`` and ``FAULTS``."""
    return _load(root / "bench" / "traffic" / f"{name}.py",
                 "bench_traffic_" + re.sub(r"\W", "_", name),
                 f"traffic kind {name!r}")


def problems(spec: dict, root: Path = ROOT) -> List[str]:
    """What in ``spec`` (a parsed BENCHMARK.json) breaks the rules the
    harness relies on: key sets, names, units, sources, the cells' files,
    the metrics' cells; empty when it holds."""
    out: List[str] = []
    if tuple(sorted(spec)) != tuple(sorted(TOP_KEYS)):
        out.append(f"top-level keys {sorted(spec)}")
    names: Dict[str, set] = {"configs": set(), "workloads": set(),
                             "metrics": set()}

    def name_ok(kind, n):
        if not isinstance(n, str) or not NAME_RE.match(n):
            out.append(f"{kind} name {n!r}")

    for c in spec.get("configs", []):
        name_ok("config", c.get("name"))
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config {c.get('name')} keys {sorted(c)}")
        if not (root / c["file"]).exists():
            out.append(f"config file {c['file']} missing")
        for k in c.get("reduced", []):
            name_ok("reduced key", k)
        names["configs"].add(c["name"])
    for w in spec.get("workloads", []):
        name_ok("workload", w.get("name"))
        name_ok("traffic", w.get("traffic"))
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"workload {w.get('name')} keys {sorted(w)}")
        if w.get("config") not in names["configs"]:
            out.append(f"workload {w['name']} names config {w.get('config')}")
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w['name']} chips {w.get('chips')}")
        if not 1 <= len(w.get("why", "")) <= 200 or "\n" in w["why"]:
            out.append(f"workload {w['name']} why")
        mix = root / "bench" / "traffic" / f"{w['traffic']}.json"
        files = [mix, root / "bench" / "workloads" / f"{w['name']}.json"]
        if mix.exists():
            files.append(root / "bench" / "traffic" /
                         f"{load_json(mix)['kind']}.py")
        for f in files:
            if not f.exists():
                out.append(f"workload {w['name']}: {f.relative_to(root)} "
                           f"missing")
        names["workloads"].add(w["name"])
    e2e_names = set()
    for kind in ("end_to_end", "per_layer"):
        for m in spec.get(kind, []):
            name_ok("metric", m.get("name"))
            if m["name"] in names["metrics"]:
                out.append(f"metric {m['name']} twice")
            names["metrics"].add(m["name"])
            if not isinstance(m.get("unit"), str) \
                    or not UNIT_RE.match(m["unit"]):
                out.append(f"metric {m['name']} unit {m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher"):
                out.append(f"metric {m['name']} better {m.get('better')}")
            allowed = SOURCES_E2E if kind == "end_to_end" else SOURCES
            if m.get("source") not in allowed:
                out.append(f"metric {m['name']} source {m.get('source')}")
            for w in m.get("workloads", []):
                if w not in names["workloads"]:
                    out.append(f"metric {m['name']} names cell {w}")
            if kind == "end_to_end":
                e2e_names.add(m["name"])
                if not 0 < m.get("bound", 0) <= 0.25:
                    out.append(f"metric {m['name']} bound {m.get('bound')}")
            else:
                if m.get("moves") not in e2e_names:
                    out.append(f"metric {m['name']} moves {m.get('moves')}")
                layer = m.get("layer", "")
                if not 1 <= len(layer) <= 200 or "\n" in layer:
                    out.append(f"metric {m['name']} layer {layer!r}")
                if not (root / "bench" / "metrics" / f"{m['name']}.py"
                        ).exists():
                    out.append(f"metric {m['name']} has no reader")
    return out
