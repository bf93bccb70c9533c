"""The plain reference against the program's CPU route at a tiny width:
every family under both optimizers, and prefill."""

import pytest
import torch

from bench import drive, spec, weights
from bench.reference import lm as ref
from bench.run import tiny
from bench.tests import families

CPU = torch.device("cpu")
SEED = 4294967311
FAMILIES = ["dense", "ssm", "hybrid"]
train = spec.kind("train")
prefill = spec.kind("prefill")


def _traffic(name):
    return tiny(spec.load_json(spec.BENCH / "traffic" / f"{name}.json"))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("traffic", ["train-adamw.2x4096", "train-vb.2x4096"])
def test_reference_follows_the_program_s_checked_steps(family, traffic):
    cfg, tr = families.config(family), _traffic(traffic)
    kind = train.Kind(cfg, tr, SEED, CPU)
    kind.setup()
    out = kind.outputs()
    kind.free()
    assert len(out["losses"]) == tr["checked_steps"]
    numbers = train.check_outputs(cfg, tr, SEED, CPU, out)
    assert numbers["loss"] < 1e-3, numbers
    assert numbers["grad"] < 0.03, numbers
    assert numbers["change"] < 0.03, numbers


@pytest.mark.parametrize("family", FAMILIES)
def test_reference_logits_follow_the_program_s_prefill(family):
    from repro_torch.nn import transformer as T

    cfg = families.config(family)
    toks = torch.randint(0, cfg["vocab_size"], (2, 64),
                         generator=torch.Generator().manual_seed(0))
    w = weights.make(cfg, SEED, CPU)
    with torch.no_grad():
        got = T.forward(drive.port_model(cfg, w, trainable=False), toks,
                        drive.port_config(cfg)).logits
        want = prefill.reference_logits(cfg, w, toks, CPU)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) < 0.05 * scale
    assert prefill.widest_gap(want, got.argmax(-1)) < 0.05 * scale


@pytest.mark.parametrize("family", FAMILIES)
def test_the_weights_are_the_program_s_parameters_and_repeat_by_seed(family):
    cfg = families.config(family)
    a, b = weights.make(cfg, SEED, CPU), weights.make(cfg, SEED, CPU)
    c = weights.make(cfg, SEED + 1, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.table"], c["embed.table"])
    lm = drive.port_model(cfg, a, trainable=True)
    named = dict(lm.named_parameters())
    assert set(named) == set(a)
    assert all(named[k].data_ptr() == a[k].data_ptr() for k in a)


def test_float8_products_round_harder_than_bfloat16():
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(64, 96, generator=g), torch.randn(96, 32, generator=g)
    exact = a @ b
    err_bf = float((ref.mm(a, b, "bf16").float() - exact).abs().max())
    err_f8 = float((ref.mm(a, b, "fp8").float() - exact).abs().max())
    assert err_f8 > 4 * err_bf
