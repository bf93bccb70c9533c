"""The trace reading: device operations tied to the range open when they
were launched (by correlation id and thread), the busy union, idle gaps
named by the host, and a trace without device operations refused."""

import pytest

from bench import trace


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _events():
    return [
        _ev("user_annotation", "adamw_update", 10.0, 20.0),
        _ev("cpu_op", "aten::mul", 11.0, 2.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 12.0, 1.0, corr=1),
        _ev("kernel", "mul_kernel", 100.0, 5.0, tid=7, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 40.0, 1.0, corr=2),
        _ev("cpu_op", "aten::mm", 39.0, 3.0),
        _ev("kernel", "nvjet_gemm", 106.0, 4.0, tid=7, corr=2),
        # launched on the backward thread inside its own range
        _ev("user_annotation", "flash_attention_backward", 50.0, 10.0, tid=2),
        _ev("cuda_driver", "cuLaunchKernelEx", 51.0, 1.0, tid=2, corr=3),
        _ev("kernel", "flash_bwd", 120.0, 30.0, tid=7, corr=3),
        _ev("gpu_memset", "Memset", 151.0, 1.0, tid=7, corr=4),
    ]


def _spans():
    return trace.Spans({"adamw_update": ("m", "a"),
                        "flash_attention_backward": ("m", "b")})


def test_ops_are_tied_to_the_range_they_were_launched_in():
    tr = trace.read_events(_events(), _spans(), window_s=60e-6, units=2)
    by = {op.name: op.span for op in tr.ops}
    assert by == {"mul_kernel": "adamw_update", "nvjet_gemm": None,
                  "flash_bwd": "flash_attention_backward", "Memset": None}
    assert tr.span_device_s["adamw_update"] == pytest.approx(5e-6)
    assert tr.span_device_s["flash_attention_backward"] == \
        pytest.approx(30e-6)
    assert tr.unmatched == 1                       # the memset's launch
    assert tr.busy_s == pytest.approx(40e-6)       # 100-110, 120-150, 151-152
    assert tr.idle_share == pytest.approx(1 - 40 / 60)
    assert tr.span_count == {"adamw_update": 1,
                             "flash_attention_backward": 1}


def test_breakdown_names_ops_and_gaps():
    tr = trace.read_events(_events(), _spans(), window_s=1e-4, units=1)
    top = tr.device_ops_top()
    assert top[0] == ["flash_bwd", pytest.approx(30e-6)]
    gaps = tr.idle_gaps_top()
    assert gaps[0] == ["flash_attention_backward", pytest.approx(10e-6)]
    assert sorted(g[0] for g in gaps[1:]) == ["aten::mm", "unknown"]


def test_a_trace_without_device_ops_is_refused():
    host_only = [e for e in _events() if e["cat"] not in
                 ("kernel", "gpu_memset")]
    with pytest.raises(RuntimeError, match="no device operation"):
        trace.read_events(host_only, _spans(), 1.0, 1)


def test_spans_wrap_record_and_restore(monkeypatch):
    import bench.feed as target

    orig = target.markov_corpus
    sp = trace.Spans({"corpus": ("bench.feed", "markov_corpus"),
                      "gone": ("bench.feed", "no_such_function")})
    with sp:
        assert target.markov_corpus is not orig
        out = target.markov_corpus(16, 8, 3, branch=2)
    assert target.markov_corpus is orig
    assert list(out) == list(orig(16, 8, 3, branch=2))
    assert sp.calls["corpus"] == [{"args": [16, 8, 3],
                                   "kwargs": {"branch": 2}}]
    assert sp.missing == ["gone"]
