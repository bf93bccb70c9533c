"""The program's spans read against the trace (``bench/program_spans.py``):
each kept span placed by its own range (name, thread, order), device ops
tied to the innermost span open on their launching thread, the idle time
between a span's first and last op, spans with no range counted, every
new reader absent (``None``, not 0) without spans, and the readers that
were there reading what they read without the program's ranges."""

from collections import namedtuple

import pytest

from bench import program_spans as ps
from bench import spec, trace

Rec = namedtuple("Rec", "name span_id parent_id tid start_ns end_ns attrs")
WALL = 1_700_000_000_000_000_000        # the wall clock at the trace's 0
MAIN, GRAD = 11, 22                     # native thread ids


def _ev(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


# (name, id, parent, tid, start us, end us) of one traced training step
SPANS = [
    ("train.step", 1, None, MAIN, 0, 1000),
    ("lm.forward", 2, 1, MAIN, 10, 300),
    ("lm.block", 3, 2, MAIN, 20, 200),
    ("lm.attn", 4, 3, MAIN, 30, 100),
    ("kernel.flash_attention", 5, 4, MAIN, 40, 60),
    ("lm.head", 6, 2, MAIN, 210, 290),
    ("lm.block.backward", 7, None, GRAD, 400, 550),
    ("lm.attn", 8, 7, GRAD, 410, 450),
    ("train.update", 9, 1, MAIN, 600, 900),
]
# (launch thread, launch us, kernel name, device start us, dur us)
LAUNCHES = [
    (MAIN, 35, "elementwise_kernel", 100, 5),
    (MAIN, 45, "flash_fwd", 110, 20),
    (MAIN, 150, "nvjet_gemm", 140, 10),
    (MAIN, 250, "cutlass_s1688gemm", 160, 15),
    (MAIN, 260, "softmax_kernel", 180, 5),
    (GRAD, 420, "mul_kernel", 450, 7),
    (GRAD, 500, "bwd_elementwise", 470, 8),
    (MAIN, 700, "adam_kernel", 600, 30),
    (MAIN, 1100, "copy_kernel", 700, 2),
]
WHERE = ["lm.attn", "kernel.flash_attention", "lm.block", "lm.head",
         "lm.head", "lm.attn", "lm.block.backward", "train.update", None]


def _records(shift_ns=0):
    return [Rec(n, i, p, tid, WALL + int(s * 1e3) + shift_ns,
                WALL + int(e * 1e3) + shift_ns, {})
            for n, i, p, tid, s, e in SPANS]


def _events(with_program=True):
    out = [_ev("user_annotation", n, s, e - s, tid)
           for n, _, _, tid, s, e in SPANS] if with_program else []
    for corr, (tid, t, name, start, dur) in enumerate(LAUNCHES, 1):
        out.append(_ev("cuda_runtime", "cudaLaunchKernel", t, 1.0, tid,
                       corr))
        out.append(_ev("kernel", name, start, dur, 7, corr))
    # the benchmark's own range around the update
    out.append(_ev("user_annotation", "adamw_update", 650, 200))
    return out


def _trace(with_program=True, units=1):
    sp = trace.Spans({"adamw_update": ("m", "a")})
    return trace.read_events(_events(with_program), sp, window_s=2e-3,
                             units=units)


def _program(records=None):
    tr = _trace()
    return tr, ps.read_program(tr, _records() if records is None
                               else records)


def test_spans_are_placed_by_their_own_range():
    # the wall clock runs 3 us behind the trace's: a start is its range's,
    # an end the wall clock's moved by the median offset
    recs = _records(shift_ns=-3000)
    recs[0] = recs[0]._replace(start_ns=recs[0].start_ns + 900_000)
    tr, pg = _program(recs)
    assert pg.unmatched == 0 and len(pg.spans) == len(SPANS)
    by = {s.span_id: s for s in pg.spans}
    for n, i, p, tid, s, e in SPANS:
        assert (by[i].name, by[i].tid, by[i].parent_id) == (n, tid, p)
        assert by[i].start_ns == int(s * 1e3)
        assert by[i].end_ns == int(e * 1e3)


def test_an_earlier_profile_s_spans_are_left_out_and_counted():
    earlier = [r._replace(span_id=r.span_id + 100,
                          parent_id=r.parent_id and r.parent_id + 100,
                          start_ns=r.start_ns - 10 ** 9,
                          end_ns=r.end_ns - 10 ** 9) for r in _records()]
    tr, pg = _program(earlier + _records())
    assert pg.unmatched == len(SPANS)
    assert sorted(s.span_id for s in pg.spans) == [r[1] for r in SPANS]


def test_a_span_off_the_clock_is_left_out():
    recs = _records()
    recs[6] = recs[6]._replace(start_ns=recs[6].start_ns + 50_000_000,
                               end_ns=recs[6].end_ns + 50_000_000)
    tr, pg = _program(recs)
    assert pg.unmatched == 1
    assert 7 not in pg.by_id


def test_ops_are_tied_to_the_innermost_span_on_their_thread():
    tr, pg = _program()
    got = [None if s is None else pg.by_id[s].name for s in pg.op_span]
    assert got == WHERE
    # the recomputed forward's op lies in the block's backward
    recompute = pg.chain(pg.op_span[5])
    assert [s.name for s in recompute] == ["lm.attn", "lm.block.backward"]


@pytest.mark.parametrize("intervals,idle", [
    ([], 0),
    ([(0, 10)], 0),
    ([(0, 10), (10, 20)], 0),
    ([(0, 10), (15, 20)], 5),
    ([(0, 30), (5, 10), (40, 50)], 10),
    ([(40, 50), (0, 10), (20, 25)], 25),
])
def test_idle_between_first_and_last_op(intervals, idle):
    assert ps.idle_ns(intervals) == idle


def test_a_span_s_gap_on_its_thread_and_on_any():
    tr, pg = _program()
    # lm.forward's ops: 100-105, 110-130, 140-150, 160-175, 180-185
    assert ps.gap_ms(tr, pg, "lm.forward", False) == pytest.approx(
        (5 + 10 + 10 + 5) / 1e3)
    # the step: every op launched 0-1000 us on any thread (100 .. 630)
    busy = 5 + 20 + 10 + 15 + 5 + 7 + 8 + 30
    assert ps.gap_ms(tr, pg, "train.step", True) == pytest.approx(
        (630 - 100 - busy) / 1e3)
    assert ps.gap_ms(tr, pg, "no.such.span", True) is None


def _ctx(tr):
    return {"trace": tr, "window": {"seconds": 2e-3, "units": 1},
            "cell": "c", "config": {}, "traffic": {}, "setup_s": 1.0,
            "peak_bytes": 1}


NEW = ["update_ms.train", "head_loss_ms.train", "block_elementwise_ms.train",
       "step_gap_ms.train", "head_ms.prefill", "block_elementwise_ms.prefill",
       "forward_gap_ms.prefill"]


def _with_buffer(monkeypatch, records):
    from repro_torch import obs

    monkeypatch.setattr(obs, "recorded_spans", lambda: list(records))
    ps._CACHE.clear()


def test_the_new_readers_read_the_program_s_spans(monkeypatch):
    _with_buffer(monkeypatch, _records())
    tr = _trace(units=2)
    got = {m: spec.reader(m).read(_ctx(tr)) for m in NEW}
    assert got == pytest.approx({
        "update_ms.train": 30 / 1e3 / 2,
        "head_loss_ms.train": (15 + 5) / 1e3 / 2,
        # 100-105 (lm.attn), 450-457 (recomputation), 470-478 (backward):
        # the gemm and the hand kernel's op are left out
        "block_elementwise_ms.train": (5 + 7 + 8) / 1e3 / 2,
        "step_gap_ms.train": (530 - 100) / 1e3,
        "head_ms.prefill": (15 + 5) / 1e3 / 2,
        "block_elementwise_ms.prefill": 5 / 1e3 / 2,     # forward only
        "forward_gap_ms.prefill": 30 / 1e3,
    })


@pytest.mark.parametrize("metric", NEW)
def test_a_new_reader_is_absent_without_spans(monkeypatch, metric):
    r = spec.reader(metric)
    _with_buffer(monkeypatch, [])
    assert r.read(_ctx(_trace())) is None
    assert r.read(_ctx(None)) is None
    from repro_torch import obs

    monkeypatch.delattr(obs, "recorded_spans")     # a program without them
    ps._CACHE.clear()
    assert r.read(_ctx(_trace())) is None


OLD = ["device_busy_ms.train", "device_idle.train", "device_idle.prefill",
       "optimizer_ms.train", "elementwise_ms.train"]


@pytest.mark.parametrize("metric", OLD)
def test_the_readers_that_were_there_read_the_same(metric):
    r = spec.reader(metric)
    without, with_ = _trace(False), _trace(True)
    assert r.read(_ctx(with_)) == r.read(_ctx(without))
    assert [op.span for op in with_.ops] == [op.span for op in without.ops]


def test_the_program_s_ranges_leave_the_wrap_points_alone():
    without, with_ = _trace(False), _trace(True)
    assert with_.span_device_s == without.span_device_s
    assert with_.span_count == without.span_count
    assert with_.busy_s == without.busy_s


@pytest.mark.parametrize("name,short", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "BinaryFunctor<float, float, float, at::native::binary_internal::"
     "MulFunctor<float> >, std::array<char*, 3ul> >(int, ...)",
     "vectorized_elementwise_kernel/MulFunctor/float"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1}"
     ", std::array<char*, 2ul> >(int, ...)",
     "vectorized_elementwise_kernel/bfloat16_copy_kernel_cuda/float"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, float, "
     "4, 4> >(...)", "reduce_kernel/MeanOps/float"),
    ("void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_256x128"
     "_tn_align1>(cutlass_75_tensorop_bf16_s1688gemm_bf16_256x128_tn_align1"
     "::Params)", "Kernel2/cutlass_75_tensorop_bf16_s1688gemm_bf16_256x128"
                  "_tn_align1"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT",
     "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT"),
])
def test_the_breakdown_names_an_op_by_its_functor(name, short):
    assert ps.short_name(name) == short


def test_the_breakdown_rows_are_the_innermost_layer_spans():
    tr, pg = _program()
    rows = ps.breakdown(tr, pg)
    assert set(rows) == {"lm.attn", "kernel.flash_attention", "lm.block",
                         "lm.head", "lm.attn@bwd", "lm.block.backward",
                         "train.update", "(outside)"}
    assert rows["lm.head"]["ms"] == pytest.approx(0.02)
    assert rows["lm.head"]["elementwise_ms"] == pytest.approx(0.005)
    assert rows["kernel.flash_attention"]["elementwise_ms"] == 0


def test_the_longest_gaps_name_their_spans_and_collections():
    recs = _records() + [Rec("gc", 10, None, MAIN, WALL + 390_000,
                             WALL + 440_000, {"generation": 2})]
    events = _events() + [_ev("user_annotation", "gc", 390, 50)]
    tr = trace.read_events(events, trace.Spans({}), window_s=2e-3, units=1)
    pg = ps.read_program(tr, recs)
    top = ps.gaps(tr, pg, top=2)
    # 185-450: the recomputation's op ends it while a collection runs
    assert top[0] == [pytest.approx(0.265), ["lm.attn", "lm.block.backward"],
                      [[2, pytest.approx(0.05)]]]
    assert top[1][0] == pytest.approx(0.122)           # 478-600
    assert top[1][1][0] == "train.update" and top[1][2] == []
