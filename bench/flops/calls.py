"""Work of one recorded call of a hand kernel's wrapper (the arguments
``trace.Spans`` kept: tensors as shape and dtype, plain values as they
were), and the peak its products are read against."""

from __future__ import annotations

from typing import Tuple

from bench.flops import peaks, work

ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def _arg(call: dict, i: int, name: str, default=None):
    if name in call["kwargs"]:
        return call["kwargs"][name]
    return call["args"][i] if len(call["args"]) > i else default


def attention(call: dict, backward: bool) -> Tuple[int, int, float]:
    """(flops, bytes, peak) of ``flash_attention(q, k, v, *, causal,
    window, ...)`` or ``flash_attention_backward(q, k, v, out, lse, dout,
    *, causal, window, scale, q_offset)``."""
    q, k = call["args"][0], call["args"][1]
    B, Sq, Hq, D = q["shape"]
    Sk, Hkv = k["shape"][1], k["shape"][2]
    kw = call["kwargs"]
    causal, window = kw.get("causal", True), kw.get("window")
    q_offset = kw.get("q_offset", 0)
    flops = work.attention_flops(B, Sq, Sk, Hq, D, causal, window, q_offset,
                                 backward)
    nbytes = work.attention_bytes(B, Sq, Sk, Hq, Hkv, D, ELEM[q["dtype"]],
                                  backward, with_lse=False)
    peak = peaks.BF16_FLOPS if q["dtype"] == "bfloat16" else peaks.TF32_FLOPS
    return flops, nbytes, peak


def ssd(call: dict, backward: bool) -> Tuple[int, int, float]:
    """(flops, bytes, peak) of ``ssd_scan(x, dt, A, B, C, chunk)`` or
    ``ssd_scan_backward(x, dt, A, B, C, dy, dhfin, chunk)`` (float32:
    TF32's peak)."""
    b, S, H, P = call["args"][0]["shape"]
    G, N = call["args"][3]["shape"][2:]
    chunk = _arg(call, 7 if backward else 5, "chunk")
    f = work.ssd_bwd_flops if backward else work.ssd_flops
    return (f(b, S, H, P, G, N, chunk),
            work.ssd_bytes(b, S, H, P, G, N, backward), peaks.TF32_FLOPS)


def share(tr, span: str, of_call, backward: bool):
    """The roofline share (%) of the calls of wrap point ``span`` in trace
    ``tr``: their summed bound over their device time; None where the
    range did not run or holds no device time."""
    calls = tr.span_calls.get(span) or []
    seconds = tr.span_device_s.get(span, 0.0)
    if not calls or seconds <= 0:
        return None
    bound = 0.0
    for c in calls:
        flops, nbytes, peak = of_call(c, backward)
        bound += max(flops / peak, nbytes / peaks.HBM_BYTES)
    return 100.0 * bound / seconds
