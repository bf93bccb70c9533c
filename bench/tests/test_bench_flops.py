"""The frozen work counts against hand counts at small shapes."""

import itertools
import json
import math
import types

import pytest

from bench import spec, weights
from bench.flops import calls, peaks, work
from bench.tests import families


def _pairs_by_hand(Sq, Sk, causal, window, q_offset):
    n = 0
    for i, j in itertools.product(range(Sq), range(Sk)):
        pos = q_offset + i
        if causal and j > pos:
            continue
        if window and j <= pos - window:
            continue
        n += 1
    return n


@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset", [
    (7, 7, True, None, 0), (7, 7, False, None, 0), (9, 9, True, 4, 0),
    (5, 12, True, None, 7), (6, 6, False, 3, 0), (1, 10, False, None, 0)])
def test_live_pairs_count_the_mask_by_hand(Sq, Sk, causal, window, q_offset):
    want = _pairs_by_hand(Sq, Sk, causal, window, q_offset)
    assert work.live_pairs(Sq, Sk, causal, window, q_offset) == want
    assert work.attention_flops(2, Sq, Sk, 3, 16, causal, window,
                                q_offset) == 4 * 16 * want * 2 * 3
    assert work.attention_flops(2, Sq, Sk, 3, 16, causal, window, q_offset,
                                backward=True) == 10 * 16 * want * 2 * 3


def _ssd_by_hand(b, S, H, P, G, N, l):
    """Flops of the chunked SSD forward, term by term: per (batch, head,
    chunk) the intra-chunk (C B^T o decay) x over pairs j <= i (2 P a
    pair), each step's state contribution B x^T (2 P N) and read-out C h
    (2 P N); C B^T per (batch, group, chunk) over the pairs (2 N a pair)."""
    total = 0
    for _ in range(b):
        for _ in range(S // l):
            pairs = sum(i + 1 for i in range(l))
            total += H * (2 * P * pairs + l * 2 * P * N + l * 2 * P * N)
            total += G * 2 * N * pairs
    return total


@pytest.mark.parametrize("shape", [(1, 8, 2, 4, 1, 3, 4), (2, 12, 4, 2, 2, 5, 6)])
def test_ssd_flops_match_a_count_by_hand(shape):
    assert work.ssd_flops(*shape) == _ssd_by_hand(*shape)
    b, S, H, P, G, N, l = shape
    T = l * (l + 1) // 2
    nc = S // l
    assert work.ssd_bwd_flops(*shape) == 2 * (
        b * H * nc * (5 * l * P * N + 2 * T * P + 2 * T * N)
        + b * G * nc * T * N)


def test_bytes_count_each_input_and_output_once():
    B, Sq, Sk, Hq, Hkv, D = 2, 16, 16, 4, 2, 8
    q, kv, lse = B * Sq * Hq * D * 2, B * Sk * Hkv * D * 2, B * Hq * Sq * 4
    assert work.attention_bytes(B, Sq, Sk, Hq, Hkv, D, 2,
                                with_lse=False) == q + 2 * kv + q
    assert work.attention_bytes(B, Sq, Sk, Hq, Hkv, D, 2) == \
        q + 2 * kv + q + lse
    assert work.attention_bytes(B, Sq, Sk, Hq, Hkv, D, 2, backward=True) \
        == (q + 2 * kv + q + q + lse) + (q + 2 * kv)
    b, S, H, P, G, N = 1, 8, 2, 4, 1, 3
    x, dt, bc = b * S * H * P, b * S * H, b * S * G * N
    assert work.ssd_bytes(b, S, H, P, G, N) == 4 * (x + dt + H + 2 * bc
                                                    + x + b * H * P * N)


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_matmul_params_are_the_layout_s_product_weights(family):
    cfg = families.config(family)
    layout = {n: math.prod(s) for n, s, _ in weights.layout(cfg)}
    product = {n: v for n, v in layout.items()
               if n.endswith(("wq", "wk", "wv", "wo", "w_gate", "w_up",
                              "w_down", "w_z", "w_x", "w_B", "w_C", "w_dt",
                              "w_out"))}
    every = cfg["hybrid_attn_every"] if family == "hybrid" else 0
    calls_of = {n: (cfg["num_hidden_layers"] // every
                    if n.startswith("shared_attn.") else 1) for n in product}
    head = layout["lm_head.table" if "lm_head.table" in layout
                  else "embed.table"]
    assert work.matmul_params(cfg) == sum(v * calls_of[n]
                                          for n, v in product.items()) + head
    assert work.attention_calls(cfg) == {
        "dense": cfg["num_hidden_layers"], "ssm": 0, "hybrid": 2}[family]
    assert work.train_step_flops(cfg, 2, 64) > 6 * work.matmul_params(cfg) \
        * 2 * 64


def test_a_hybrid_whose_shared_block_is_never_called_counts_no_attention():
    cfg = dict(families.config("hybrid"), hybrid_attn_every=0)
    assert work.attention_calls(cfg) == 0
    assert work.matmul_params(cfg) == work.matmul_params(dict(cfg,
                                                              arch="ssm"))
    assert work.forward_flops(cfg, 2, 64) == work.forward_flops(
        dict(cfg, arch="ssm"), 2, 64)


def test_granite_step_flops_by_hand():
    cfg = spec.load_json(spec.BENCH / "configs" / "granite-3-2b.json")
    N = 40 * (2048 * 2048 * 2 + 2 * 2048 * 512 + 3 * 2048 * 8192) \
        + 49155 * 2048
    pairs = 4096 * 4097 // 2
    want = 3 * (2 * N * 8192 + 40 * 4 * 64 * pairs * 2 * 32)
    assert work.train_step_flops(cfg, 2, 4096) == want
    assert weights.n_params(cfg) == 2533531648


def _trace(span, seconds, recorded):
    return types.SimpleNamespace(span_calls={span: recorded},
                                 span_device_s={span: seconds})


def test_a_roofline_share_is_bound_over_time_and_absent_without_time():
    q = {"shape": (2, 4096, 32, 64), "dtype": "bfloat16"}
    k = {"shape": (2, 4096, 8, 64), "dtype": "bfloat16"}
    call = {"args": [q, k, k, q, None, q],
            "kwargs": {"causal": True, "window": None}}
    flops, nbytes, peak = calls.attention(call, backward=True)
    assert peak == peaks.BF16_FLOPS
    bound = max(flops / peak, nbytes / peaks.HBM_BYTES)
    tr = _trace("flash_attention_backward", 4 * bound, [call])
    assert calls.share(tr, "flash_attention_backward", calls.attention,
                       True) == pytest.approx(25.0)
    assert calls.share(_trace("flash_attention_backward", 0.0, [call]),
                       "flash_attention_backward", calls.attention,
                       True) is None
    assert calls.share(_trace("flash_attention_backward", 1.0, []),
                       "flash_attention_backward", calls.attention,
                       True) is None
    x = {"shape": (2, 4096, 64, 64), "dtype": "float32"}
    bc = {"shape": (2, 4096, 1, 64), "dtype": "float32"}
    f, nb, pk = calls.ssd({"args": [x, None, None, bc, bc, x, None, 128],
                           "kwargs": {}}, backward=True)
    assert pk == peaks.TF32_FLOPS
    assert f == work.ssd_bwd_flops(2, 4096, 64, 64, 1, 64, 128)
    json.dumps(call)
