"""A run with the timed path broken underneath comes out not correct, a
sound one correct, and so does the control put in the program's place --
through the CPU dry path (the configuration's tiny sizes), past the
harness's look for a card."""

import json
import sys
import types

import pytest
import torch

from bench import check, run, spec
from bench.run import tiny

SEED = 5000000029
TRAIN = "granite-3-2b.train-adamw.2x4096"
VB = "granite-3-2b.train-vb.2x4096"
PREFILL = "granite-3-2b.prefill.2x4096"


@pytest.fixture(autouse=True)
def _guard_on_what_the_run_loads(monkeypatch):
    """Other test files load JAX into this worker; the run's guard is held
    to what the run itself loads."""
    before = set(sys.modules)
    orig = run.forbidden_modules
    monkeypatch.setattr(run, "forbidden_modules",
                        lambda: [m for m in orig() if m not in before])


def _result(capsys, cell):
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   "0.3", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    res = json.loads(out[-1])
    assert list(res)[-1] == "checks"
    return res


@pytest.mark.parametrize("cell", [TRAIN, VB, PREFILL])
def test_a_sound_run_is_correct(capsys, cell):
    res = _result(capsys, cell)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    limits = spec.find_cell(cell).limits
    assert set(res["checks"]) == set(limits["limits"]) \
        == set(limits["tiny_limits"])


def _unchanged_adamw(params, grads, state, **kw):
    return params, state


def _unchanged_vb(state, grads, **kw):
    return state


@pytest.mark.parametrize("cell,module,name,fake", [
    (TRAIN, "repro_torch.train.optimizer", "adamw_update", _unchanged_adamw),
    (VB, "repro_torch.bayes.vb_optimizer", "vb_update", _unchanged_vb)])
def test_a_step_that_returns_its_state_unchanged_is_caught(
        capsys, monkeypatch, cell, module, name, fake):
    monkeypatch.setattr(f"{module}.{name}", fake)
    assert _result(capsys, cell)["correct"] is False


@pytest.mark.parametrize("cell", [TRAIN, VB])
def test_half_of_the_batch_left_out_is_caught(capsys, monkeypatch, cell):
    from repro_torch.train import step

    orig = step.grads_of

    def half(params, batch, cfg, backend=None, sh=None, **kw):
        n = batch.tokens.shape[0] // 2
        return orig(params, batch._replace(tokens=batch.tokens[:n],
                                           labels=batch.labels[:n]),
                    cfg, backend=backend, **({} if sh is None else
                                             {"sh": sh}))

    monkeypatch.setattr(step, "grads_of", half)
    assert _result(capsys, cell)["correct"] is False


@pytest.mark.parametrize("cell,name", [(TRAIN, "train_step"),
                                       (VB, "vb_train_step")])
def test_a_loss_altered_where_it_is_produced_is_caught(
        capsys, monkeypatch, cell, name):
    from repro_torch.train import step

    orig = getattr(step, name)

    def altered(*a, **kw):
        state, metrics = orig(*a, **kw)
        return state, dict(metrics, loss=metrics["loss"] * 1.01)

    monkeypatch.setattr(step, name, altered)
    assert _result(capsys, cell)["correct"] is False


def _altered(orig):
    def forward(params, tokens, cfg, *a, **kw):
        out = orig(params, tokens, cfg, *a, **kw)
        lg = out.logits.clone()
        second = lg.topk(2, dim=-1).indices[..., 1:]
        lg.scatter_(-1, second, lg.max(-1, keepdim=True).values + 1.0)
        return out._replace(logits=lg)
    return forward


def _half_rows(orig):
    def forward(params, tokens, cfg, *a, **kw):
        out = orig(params, tokens[:1], cfg, *a, **kw)
        return out._replace(logits=out.logits.expand(tokens.shape[0], -1,
                                                     -1))
    return forward


@pytest.mark.parametrize("fault", [_altered, _half_rows])
def test_an_altered_token_or_a_left_out_prompt_is_caught(
        capsys, monkeypatch, fault):
    from repro_torch.nn import transformer as T

    monkeypatch.setattr(T, "forward", fault(T.forward))
    assert _result(capsys, PREFILL)["correct"] is False


@pytest.mark.parametrize("cell", [TRAIN, VB])
def test_the_float8_control_fails_a_training_limit(cell):
    c = spec.find_cell(cell)
    cfg, tr = tiny(c.config), tiny(c.traffic)
    numbers = spec.kind("train").control(cfg, tr, SEED, torch.device("cpu"))
    assert not check.verdict(numbers, c.limits["tiny_limits"]), numbers


def test_the_float8_control_fails_the_prefill_limit():
    c = spec.find_cell(PREFILL)
    cfg, tr = tiny(c.config), tiny(c.traffic)
    numbers = spec.kind("prefill").control(cfg, tr, SEED, torch.device("cpu"))
    assert not check.verdict(numbers, c.limits["tiny_limits"]), numbers


def test_jax_loaded_by_the_run_refuses_the_result(capsys, monkeypatch):
    from repro_torch.nn import transformer as T

    orig = T.forward

    def loads_jax(*a, **kw):
        monkeypatch.setitem(sys.modules, "jax.loaded_by_the_run",
                            types.ModuleType("jax.loaded_by_the_run"))
        return orig(*a, **kw)

    monkeypatch.setattr(T, "forward", loads_jax)
    rc = run.main(["--workload", PREFILL, "--seed", str(SEED), "--seconds",
                   "0.2", "--device", "cpu"])
    captured = capsys.readouterr()
    assert rc != 0
    assert captured.out.strip() == ""
    assert "jax" in captured.err
