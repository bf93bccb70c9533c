"""The program's own spans read against a :class:`bench.trace.Trace`.

While ``torch.profiler`` records, every span of the program
(``repro_torch.obs.span``) is also a ``record_function`` range of its own
name, and the program keeps the span -- name, id, parent, native thread
id, wall-clock start and end, attrs -- in a buffer it hands out through
``repro_torch.obs.recorded_spans()``.  :func:`program` places each kept
span on the trace's time axis by its own range's start: the same name on
the same thread, in the same order, the newest of each (the profile is the
buffer's last).  It then ties every device operation to the innermost
span open on its launching thread when it was launched.  Spans with no
range in the trace (those of an earlier profile, or ranges the profiler
lost) are left out and counted.

The readers of ``bench/metrics/`` read from here: a span's device time (its
own launches and those of the spans inside it), the device's idle time
between the first and last operation of a span, and the time of the
operations launched outside every span.  Where the program keeps no span
(a program without them), every reading is ``None``, never 0.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import statistics
import sys
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

MATMUL_NAMES = ("gemm", "nvjet", "xmma", "cutlass")   # cuBLAS's own names
KERNEL_PREFIX = "kernel."                              # the hand kernels
TOLERANCE_NS = 10_000_000    # a placed span's clock offset off the median


@dataclasses.dataclass
class Placed:
    """A program span on the trace's time axis (ns)."""

    name: str
    span_id: int
    parent_id: Optional[int]
    tid: int
    start_ns: int
    end_ns: int
    attrs: dict


@dataclasses.dataclass
class Program:
    spans: List[Placed]
    unmatched: int                   # kept spans with no range in the trace
    by_id: Dict[int, Placed]
    op_span: List[Optional[int]]     # innermost span of each trace op

    def chain(self, span_id: Optional[int]) -> List[Placed]:
        """The span ``span_id`` and its placed ancestors, innermost first."""
        out = []
        while span_id is not None and span_id in self.by_id:
            sp = self.by_id[span_id]
            out.append(sp)
            span_id = sp.parent_id
        return out

    def named(self, name: str) -> List[Placed]:
        return [s for s in self.spans if s.name == name]


def _records() -> Optional[list]:
    """The program's kept spans, or None where it keeps none."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    read = getattr(obs, "recorded_spans", None)
    spans = read() if read is not None else None
    return spans or None


def place(records: Sequence, host_labels: Dict[int, List[Tuple[int, str]]]
          ) -> Tuple[List[Placed], int]:
    """(placed spans, the number left out): each record matched to its own
    range in ``host_labels`` (tid -> sorted (start, name)), the newest of
    each (tid, name) to the newest ranges, and kept where its clock offset
    (range start - wall start) lies within ``TOLERANCE_NS`` of the
    median's.  A span starts where its range does and ends at its wall end
    moved by the median offset (the trace keeps no range's end; the
    program reads its clock inside the range, so a span never outlasts
    it)."""
    wanted = {r.name for r in records}
    ranges: Dict[tuple, List[int]] = defaultdict(list)
    for tid, labels in host_labels.items():
        for start, name in labels:
            if name in wanted:
                ranges[(tid, name)].append(start)
    kept: Dict[tuple, list] = defaultdict(list)
    for r in records:
        kept[(r.tid, r.name)].append(r)
    pairs = []
    for key, recs in kept.items():
        recs.sort(key=lambda r: r.start_ns)
        starts = ranges.get(key, [])
        n = min(len(recs), len(starts))
        pairs += zip(recs[len(recs) - n:], starts[len(starts) - n:])
    if not pairs:
        return [], len(records)
    mid = statistics.median_low([s - r.start_ns for r, s in pairs])
    placed = [Placed(r.name, r.span_id, r.parent_id, r.tid, s,
                     max(s, r.end_ns + mid), dict(r.attrs))
              for r, s in pairs
              if abs(s - r.start_ns - mid) <= TOLERANCE_NS]
    return placed, len(records) - len(placed)


def attribute(ops: Sequence, placed: Sequence[Placed]
              ) -> List[Optional[int]]:
    """The id of the innermost placed span open on each op's launching
    thread when it was launched (``None``: outside every span, or an op
    with no launching call)."""
    out: List[Optional[int]] = [None] * len(ops)
    by_tid: Dict[int, List[Placed]] = defaultdict(list)
    for sp in placed:
        by_tid[sp.tid].append(sp)
    launched: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for i, op in enumerate(ops):
        if op.launch_tid is not None and op.launch_ns is not None:
            launched[op.launch_tid].append((op.launch_ns, i))
    for tid, seq in launched.items():
        spans = sorted(by_tid.get(tid, []),
                       key=lambda s: (s.start_ns, -s.end_ns))
        stack: List[Placed] = []
        j = 0
        for t, i in sorted(seq):
            while j < len(spans) and spans[j].start_ns <= t:
                sp = spans[j]
                j += 1
                while stack and stack[-1].end_ns < sp.start_ns:
                    stack.pop()
                stack.append(sp)
            while stack and stack[-1].end_ns < t:
                stack.pop()
            out[i] = stack[-1].span_id if stack else None
    return out


def read_program(tr, records: Sequence) -> Program:
    placed, unmatched = place(records, tr.host_labels)
    return Program(spans=placed, unmatched=unmatched,
                   by_id={s.span_id: s for s in placed},
                   op_span=attribute(tr.ops, placed))


_CACHE: Dict[int, tuple] = {}


def program(tr) -> Optional[Program]:
    """The program's spans on the trace ``tr`` (computed once a trace and
    summarised on standard error), or None where there is nothing to
    read."""
    if tr is None:
        return None
    hit = _CACHE.get(id(tr))
    if hit is not None and hit[0] is tr:
        return hit[1]
    records = _records()
    pg = None if records is None else read_program(tr, records)
    if pg is not None and not pg.spans:
        pg = None
    _CACHE.clear()
    _CACHE[id(tr)] = (tr, pg)
    if pg is not None:
        _log(tr, pg)
    return pg


# -- readings ---------------------------------------------------------------


def is_matmul(name: str) -> bool:
    low = name.lower()
    return any(f in low for f in MATMUL_NAMES)


def in_names(names: Iterable[str]) -> Callable[[List[Placed]], bool]:
    names = frozenset(names)
    return lambda chain: any(s.name in names for s in chain)


def in_kernel(chain: List[Placed]) -> bool:
    return any(s.name.startswith(KERNEL_PREFIX) for s in chain)


def device_ns(tr, pg: Program, where: Callable[[List[Placed]], bool],
              op_ok: Callable = lambda op: True) -> int:
    """Device ns of the ops launched in a span for which ``where(chain)``
    holds (the chain of spans open on the launching thread, innermost
    first) and ``op_ok(op)``."""
    chains: Dict[Optional[int], List[Placed]] = {}
    total = 0
    for op, sid in zip(tr.ops, pg.op_span):
        if sid is None or not op_ok(op):
            continue
        chain = chains.get(sid)
        if chain is None:
            chain = chains[sid] = pg.chain(sid)
        if where(chain):
            total += op.dur_ns
    return total


def ms_per_unit(tr, ns: int) -> Optional[float]:
    return ns / 1e6 / tr.units if tr.units else None


def idle_ns(intervals: List[Tuple[int, int]]) -> int:
    """Idle ns between the first start and the last end of ``intervals``
    (the span of device time they reach, less their union)."""
    if not intervals:
        return 0
    ivs = sorted(intervals)
    total, cur_s, cur_e = 0, ivs[0][0], ivs[0][1]
    for s, e in ivs[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    total += cur_e - cur_s
    return max(e for _, e in ivs) - ivs[0][0] - total


def gap_ms(tr, pg: Program, name: str, any_thread: bool
           ) -> Optional[float]:
    """Mean device idle ms between the first and last op of each placed
    span ``name``: the ops launched in it on its thread (and in the spans
    inside it), or with ``any_thread`` every op launched, on any thread,
    while it was open."""
    spans = pg.named(name)
    if not spans:
        return None
    ids = {s.span_id for s in spans}
    ops: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    if any_thread:
        spans.sort(key=lambda s: s.start_ns)
        starts = [s.start_ns for s in spans]
        for op in tr.ops:
            if op.launch_ns is None:
                continue
            k = bisect.bisect_right(starts, op.launch_ns) - 1
            if k >= 0 and op.launch_ns <= spans[k].end_ns:
                ops[spans[k].span_id].append(
                    (op.start_ns, op.start_ns + op.dur_ns))
    else:
        for op, sid in zip(tr.ops, pg.op_span):
            for sp in pg.chain(sid):
                if sp.span_id in ids:
                    ops[sp.span_id].append(
                        (op.start_ns, op.start_ns + op.dur_ns))
                    break
    return sum(idle_ns(ops[s.span_id]) for s in spans) / len(spans) / 1e6


def elementwise_in(names: Iterable[str]) -> Callable:
    """A reader of the device ms a unit of the ops launched in spans
    ``names`` (forward, recomputation and backward), neither cuBLAS
    products nor inside a hand kernel's span."""
    inside = in_names(names)

    def read(ctx):
        tr = ctx["trace"]
        pg = program(tr)
        if pg is None or not any(pg.named(n) for n in names):
            return None
        return ms_per_unit(tr, device_ns(
            tr, pg, lambda c: inside(c) and not in_kernel(c),
            lambda op: not is_matmul(op.name)))
    return read


def device_ms_in(names: Iterable[str]) -> Callable:
    """A reader of the device ms a unit of every op launched in spans
    ``names`` (and in the spans inside them)."""
    names = tuple(names)
    inside = in_names(names)

    def read(ctx):
        tr = ctx["trace"]
        pg = program(tr)
        if pg is None or not any(pg.named(n) for n in names):
            return None
        return ms_per_unit(tr, device_ns(tr, pg, inside))
    return read


def gap_of(name: str, any_thread: bool) -> Callable:
    def read(ctx):
        pg = program(ctx["trace"])
        return None if pg is None else gap_ms(ctx["trace"], pg, name,
                                              any_thread)
    return read


# -- the summary on standard error -----------------------------------------


BREAKDOWN = ("lm.embed", "lm.attn", "lm.mlp", "lm.head", "train.loss",
             "train.update", "lm.block", "lm.block.backward",
             "lm.head.backward", "train.loss.backward", "lm.forward",
             "train.step", "gc")


def _key(chain: List[Placed]) -> str:
    """The breakdown's row of an op: its innermost span among
    ``BREAKDOWN`` and the hand kernels', ``@bwd`` where a block's or the
    head's backward holds it (recomputation)."""
    for i, sp in enumerate(chain):
        if sp.name.startswith(KERNEL_PREFIX) or sp.name in BREAKDOWN:
            back = any(s.name.endswith(".backward") for s in chain[i + 1:])
            return sp.name + ("@bwd" if back else "")
    return chain[0].name if chain else "(outside)"


_PARTS = (re.compile(r"::(\w*Functor\w*)<"),      # BinaryFunctor's inner one
          re.compile(r"::(\w+_kernel(?:_cuda)?)\("),
          re.compile(r"ReduceOp<[\w:]+, (?:\w+::)*(\w+)<"),
          re.compile(r"\b(cutlass_\w+)"))
_DTYPE = re.compile(r"[<(](c10::BFloat16|c10::Half|float|double|long|bool)\b")


def short_name(name: str) -> str:
    """A device op's kernel family, the functor or function it applies and
    its first data type (``vectorized_elementwise_kernel/MulFunctor/
    float``), from the demangled name."""
    s = name[5:] if name.startswith("void ") else name
    parts = [re.split(r"[<(]", s, maxsplit=1)[0].split("::")[-1]]
    for pat in _PARTS:
        found = [f for f in pat.findall(s) if f != "BinaryFunctor"]
        if found:
            parts.append(found[0])
            break
    t = _DTYPE.search(s)
    if t:
        parts.append(t.group(1).replace("c10::", ""))
    return "/".join(parts) if len(parts) > 1 else s[:80]


def breakdown(tr, pg: Program, top: int = 8) -> Dict[str, dict]:
    """Device ms a unit by row (:func:`_key`): all ops, the elementwise
    ones (neither cuBLAS products nor hand kernels), and the ``top``
    elementwise op names."""
    rows: Dict[str, dict] = {}
    chains: Dict[Optional[int], str] = {}
    for op, sid in zip(tr.ops, pg.op_span):
        key = chains.get(sid)
        if key is None:
            key = chains[sid] = _key(pg.chain(sid))
        row = rows.setdefault(key, {"ms": 0.0, "elementwise_ms": 0.0,
                                    "ops": defaultdict(float)})
        ms = op.dur_ns / 1e6 / tr.units
        row["ms"] += ms
        if not is_matmul(op.name) and not key.startswith(KERNEL_PREFIX):
            row["elementwise_ms"] += ms
            row["ops"][short_name(op.name)] += ms
    for row in rows.values():
        row["ops"] = [[k, round(v, 4)] for k, v in sorted(
            row["ops"].items(), key=lambda kv: -kv[1])[:top]]
        row["ms"] = round(row["ms"], 4)
        row["elementwise_ms"] = round(row["elementwise_ms"], 4)
    return dict(sorted(rows.items(), key=lambda kv: -kv[1]["ms"]))


def gaps(tr, pg: Program, top: int = 5) -> List[list]:
    """The ``top`` longest device idle gaps: their ms, the spans open on
    the launching thread of the op that ends each (innermost first), and
    the garbage collections (generation, ms) open on the host during it."""
    ops = sorted(range(len(tr.ops)), key=lambda i: tr.ops[i].start_ns)
    found, end = [], None
    for i in ops:
        op = tr.ops[i]
        if end is not None and op.start_ns > end:
            found.append((op.start_ns - end, end, i))
        end = max(end or 0, op.start_ns + op.dur_ns)
    found.sort(reverse=True)
    collections = pg.named("gc")
    out = []
    for ns, g0, i in found[:top]:
        g1 = tr.ops[i].start_ns
        out.append([round(ns / 1e6, 4),
                    [s.name for s in pg.chain(pg.op_span[i])][:4],
                    [[c.attrs.get("generation"),
                      round((c.end_ns - c.start_ns) / 1e6, 3)]
                     for c in collections
                     if c.start_ns < g1 and c.end_ns > g0]])
    return out


def _log(tr, pg: Program) -> None:
    total = sum(op.dur_ns for op in tr.ops)
    outside = sum(op.dur_ns for op, sid in zip(tr.ops, pg.op_span)
                  if sid is None)
    counts: Dict[str, int] = defaultdict(int)
    for sp in pg.spans:
        counts[sp.name] += 1
    print(f"program spans: {len(pg.spans)} placed, {pg.unmatched} left out "
          f"(no range in the trace); by name {dict(counts)}; ops outside "
          f"every span {outside / 1e6 / tr.units:.4f} ms a unit, "
          f"{100.0 * outside / max(total, 1):.4f}% of the ops' device time "
          f"({100.0 * outside / 1e9 / tr.busy_s:.4f}% of busy)",
          file=sys.stderr, flush=True)
    print(f"program span breakdown (device ms a unit): "
          f"{breakdown(tr, pg)}", file=sys.stderr, flush=True)
    print(f"longest device gaps (ms, spans at the launch that ends it, "
          f"collections during it): {gaps(tr, pg)}", file=sys.stderr,
          flush=True)
