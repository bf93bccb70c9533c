"""The port's spans (``repro_torch.obs.trace``) on the CPU: an inactive
span is one shared object that allocates nothing and reads no clock; an
active one is a ``torch.profiler`` range on its native thread whose kept
record starts within 50 us of the range; spans and their backward
markers change no bit of a training step; each block's backward span
lies on the thread autograd runs it on and holds that block's backward
(and, under remat, its recomputed forward); a garbage collection in a
profiled region is one ``gc`` span."""

import gc
import json
import sys
import threading
import tracemalloc

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.train import step as ts  # noqa: E402

CPU = [ProfilerActivity.CPU]


def _alive_in_trace_module(fn):
    """Bytes allocated inside ``obs/trace.py`` and still held while
    ``fn``'s span is open."""
    tracemalloc.start(8)
    try:
        before = tracemalloc.take_snapshot()
        during = fn()
    finally:
        tracemalloc.stop()
    flt = [tracemalloc.Filter(True, trace.__file__)]
    diff = during.filter_traces(flt).compare_to(before.filter_traces(flt),
                                                "filename")
    return sum(max(d.size_diff, 0) for d in diff)


def _open_span(**attrs):
    with obs.span("lm.block", **attrs):
        return tracemalloc.take_snapshot() if tracemalloc.is_tracing() \
            else None


def test_an_inactive_span_is_one_shared_object_and_allocates_nothing(
        monkeypatch, tmp_path):
    assert not trace.active()
    first = obs.span("a")
    assert all(obs.span("b", index=i) is first for i in range(100))
    assert obs.backward_span("c", torch.ones(2, requires_grad=True)) \
        is obs.backward_span("d", torch.ones(2))
    for _ in range(3):
        _open_span(index=7)
    assert _alive_in_trace_module(lambda: _open_span(index=7)) == 0

    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"an inactive span read time.{name}")

    with monkeypatch.context() as m:
        m.setattr(trace, "time", NoClock())
        with obs.span("x", step=3) as sp:
            sp.add(more=1)
    assert obs.current_span() is None
    # the same measure sees an active span's allocation
    prev = obs.configure(level="trace", path=str(tmp_path / "e.jsonl"))
    try:
        assert _alive_in_trace_module(lambda: _open_span(index=7)) > 0
    finally:
        obs.configure(level=prev["level"], path=prev["path"])


def test_a_span_under_the_profiler_is_a_range_on_its_native_thread(
        tmp_path):
    obs.clear_spans()
    with profile(activities=CPU) as prof:
        with obs.span("warm.up"):
            pass
        with obs.span("outer", tag="x") as outer:
            with obs.span("inner") as inner:
                torch.ones(64).cumsum(0)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    base = doc["baseTimeNanoseconds"]
    ranges = {e["name"]: e for e in doc["traceEvents"]
              if e.get("cat") == "user_annotation"}
    recs = {r.name: r for r in obs.recorded_spans()}
    tid = threading.get_native_id()
    assert inner.parent_id == outer.span_id and outer.parent_id is None
    for name in ("outer", "inner"):
        e, r = ranges[name], recs[name]
        assert e["tid"] == tid and r.tid == tid
        assert abs(e["ts"] * 1e3 + base - r.start_ns) <= 50_000
        assert abs((e["ts"] + e["dur"]) * 1e3 + base - r.end_ns) <= 50_000
    assert recs["outer"].attrs == {"tag": "x"}
    assert recs["inner"].parent_id == recs["outer"].span_id


def _granite():
    return get_config("granite-3-2b").reduced()


def _model(cfg):
    return T.init_model(torch.Generator().manual_seed(0), cfg,
                        trainable=True)


def _batch(cfg, seq=32):
    toks = torch.randint(0, cfg.vocab, (2, seq),
                         generator=torch.Generator().manual_seed(1))
    return ts.TrainBatch(toks, toks.roll(-1, 1))


def _leaves(state):
    out = [t for t in state.params.parameters()]
    for tree in state[1]:
        if isinstance(tree, dict):
            out += list(tree.values())
    return out


@pytest.mark.parametrize("optimizer", ["adamw", "vb"])
def test_spans_change_no_bit_of_a_train_step(optimizer):
    cfg, batch = _granite(), _batch(_granite())

    def one_step():
        p = _model(cfg)
        if optimizer == "adamw":
            return ts.train_step(ts.init_train_state(p), batch, cfg)
        return ts.vb_train_step(ts.init_vb_state(p), batch, cfg)

    off, m_off = one_step()
    obs.clear_spans()
    with profile(activities=CPU):
        on, m_on = one_step()
    names = {r.name for r in obs.recorded_spans()}
    assert {"lm.block.backward", "lm.head.backward", "train.loss.backward",
            "train.update", "lm.forward"} <= names
    assert all(torch.equal(m_off[k], m_on[k]) for k in m_off)
    a, b = _leaves(off), _leaves(on)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch,seq", [("mixtral-8x7b", 32),
                                      ("zamba2-1.2b", 64)])
def test_spans_change_no_gradient_of_mixtures_and_hybrids(arch, seq):
    cfg = get_config(arch).reduced()
    batch = _batch(cfg, seq)

    def grads():
        p = _model(cfg)
        return ts.grads_of(p, batch, cfg)

    (t_off, _), g_off = grads()
    obs.clear_spans()
    with profile(activities=CPU):
        (t_on, _), g_on = grads()
    names = [r.name for r in obs.recorded_spans()]
    # under remat the recomputation runs the block function alone: one
    # backward span for each block's forward span
    assert names.count("lm.block.backward") == names.count("lm.block") > 0
    assert torch.equal(t_off, t_on)
    assert all(torch.equal(g_off[k], g_on[k]) for k in g_off)


def _evaluations(events):
    return [e for e in events
            if e["name"].startswith("autograd::engine::evaluate_function")]


def _inside(e, r):
    return r["ts"] <= e["ts"] and e["ts"] + e["dur"] <= r["ts"] + r["dur"]


@pytest.mark.parametrize("remat", [True, False])
def test_block_backward_spans_hold_the_blocks_backward(remat, tmp_path):
    cfg = _granite()
    p, batch = _model(cfg), _batch(cfg, 16)
    obs.clear_spans()
    with profile(activities=CPU) as prof:
        total, _ = ts.loss_fn(p, batch, cfg, remat=remat)
        torch.autograd.grad(total, list(p.parameters()))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]
    evals = _evaluations(events)
    grad_tids = {e["tid"] for e in evals}
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] == "lm.block.backward"]
    recs = [r for r in obs.recorded_spans() if r.name == "lm.block.backward"]
    assert len(ranges) == len(recs) == cfg.n_layers
    assert [r.attrs["index"] for r in recs] == \
        list(range(cfg.n_layers))[::-1]
    held = []
    for rng in ranges:
        assert rng["tid"] in grad_tids          # the autograd thread
        held.append([e["name"].split(": ")[-1] for e in evals
                     if e["tid"] == rng["tid"] and _inside(e, rng)])
    assert all(h == held[0] for h in held) and "MmBackward0" in held[0]
    # every product's backward lies in a block's, the head's or the
    # loss's backward span
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].endswith(".backward")]
    for e in evals:
        if e["name"].endswith(("MmBackward0", "BmmBackward0")):
            assert any(_inside(e, s) for s in spans), e["name"]
    # the recomputed forward: lm.attn and lm.mlp inside each block's span
    ids = {r.span_id for r in recs}
    again = [r for r in obs.recorded_spans()
             if r.name in ("lm.attn", "lm.mlp") and r.parent_id in ids]
    assert len(again) == (2 * cfg.n_layers if remat else 0)
    if remat:
        mlp = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == "lm.mlp" and e["tid"] in grad_tids
               and any(_inside(e, r) for r in ranges)]
        assert len(mlp) == cfg.n_layers
        assert all(any(o["name"] == "aten::mm" and _inside(o, m)
                       for o in events if o.get("cat") == "cpu_op")
                   for m in mlp)


def test_a_collection_in_a_profiled_region_is_one_gc_span():
    obs.clear_spans()
    with profile(activities=CPU):
        with obs.span("region") as region:
            gc.collect()
    full = [r for r in obs.recorded_spans()
            if r.name == "gc" and r.attrs["generation"] == 2]
    assert len(full) == 1
    assert full[0].parent_id == region.span_id
    assert full[0].tid == threading.get_native_id()
    assert full[0].attrs["collected"] >= 0
    obs.clear_spans()
    gc.collect()                      # spans inactive: nothing kept
    assert obs.recorded_spans() == []


def test_spans_at_trace_level_emit_events_with_native_tids(tmp_path):
    path = str(tmp_path / "events.jsonl")
    prev = obs.configure(level="trace", path=path, reset_counters=True)
    obs.clear_spans()
    try:
        x = torch.ones(4, requires_grad=True)
        with obs.span("fwd", step=2):
            bw = obs.backward_span("bwd", x, index=1)
            y = bw.opens((bw.closes(x) * 3).sum())
        y.backward()
        gc.collect()
    finally:
        obs.configure(level=prev["level"], path=prev["path"],
                      reset_counters=True)
    assert torch.equal(x.grad, torch.full((4,), 3.0))
    with open(path) as fh:
        evs = [json.loads(line) for line in fh]
    spans = {e["name"]: e for e in evs if e["event"] == "span"}
    assert set(spans) == {"fwd", "bwd"}      # gc spans stay in memory
    tid = threading.get_native_id()
    assert spans["fwd"]["tid"] == tid and spans["fwd"]["step"] == 2
    assert spans["bwd"]["index"] == 1
    assert obs.validate_obs_events(path)["span"] == 2
    kept = [r.name for r in obs.recorded_spans()]
    assert kept[:2] == ["fwd", "bwd"] and "gc" in kept


def test_spans_of_many_threads_are_each_kept_once(tmp_path):
    path = str(tmp_path / "events.jsonl")
    prev = obs.configure(level="trace", path=path, reset_counters=True)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    obs.clear_spans()
    n_threads, n = 12, 100
    reads = []

    def work(k):
        for i in range(n):
            with obs.span("outer", k=k, i=i):
                with obs.span("inner"):
                    pass
        reads.append(len(obs.recorded_spans()))

    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        obs.configure(level=prev["level"], path=prev["path"],
                      reset_counters=True)
    recs = [r for r in obs.recorded_spans() if r.name != "gc"]
    assert len(recs) == 2 * n_threads * n and len(reads) == n_threads
    assert len({r.span_id for r in recs}) == len(recs)
    outer = {r.span_id: r for r in recs if r.name == "outer"}
    for r in recs:
        if r.name == "inner":              # nested on its own thread
            assert outer[r.parent_id].tid == r.tid
    assert len({r.tid for r in outer.values()}) == n_threads
    assert obs.validate_obs_events(path)["span"] == 2 * n_threads * n
