"""The port's brute-force oracle (``repro_torch.infer_exact.brute``) against
the JAX package's (``repro.infer_exact.brute``) on the reference's own test
networks -- seeded random discrete networks and CLG networks with
unobserved continuous internal nodes --, and the port's junction-tree
engine against the port's oracle.

Tolerances: the oracles against each other rtol 1e-5 (atol 1e-6 for
posterior entries and moments near zero) -- both fp32, with batched
linalg in another order; the engine against the oracle atol 1e-5 (1e-4
for ``log_evidence`` on the FA network), the bars of
``tests/test_strong_jt.py`` and ``tests/test_exact_inference.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_exact_inference as E  # noqa: E402
import test_strong_jt as S  # noqa: E402
from _torch_parity import bn_to_port  # noqa: E402
from repro.infer_exact import brute as jbrute  # noqa: E402
from repro_torch.infer_exact import JunctionTreeEngine  # noqa: E402
from repro_torch.infer_exact import brute  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6

torch.set_num_threads(1)


def _clg_cases():
    """(name, network, discrete query, continuous queries, evidence)."""
    bn, Z, X1, X2, X3 = S.chain_net()
    yield "chain", bn, Z, [X2], {"X1": 0.7, "X3": -0.4}
    bn, Z, H1, H2, X = S.vstruct_net()
    yield "vstruct", bn, Z, [H1, H2], {"X": 1.3}
    for seed in (0, 1):
        bn, Z, H1, H2, xs = S.fa_net(seed)
        rng = np.random.RandomState(100 + seed)
        yield (f"fa{seed}", bn, Z, [H1, H2],
               {x.name: float(rng.randn() * 1.5) for x in xs})


CLG = {c[0]: c[1:] for c in _clg_cases()}


def _port_vars(tbn, jvar):
    """The port's variable of a reference network's variable."""
    return tbn.dag.variables.by_name(jvar.name)


def _close(got, exp):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(exp, np.float64), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7])
def test_discrete_oracle_matches_the_reference(seed):
    jbn, xs = E.random_discrete_bn(seed)
    tbn = bn_to_port(jbn)
    for ev in ({}, {"V1": 1, "V4": 0}):
        names, cards, table = brute.enumerate_log_joint(tbn, ev)
        jnames, jcards, jtable = jbrute.enumerate_log_joint(jbn, ev)
        assert (names, cards) == (jnames, jcards)
        fin = np.isfinite(np.asarray(jtable))
        assert (np.isfinite(table.numpy()) == fin).all()
        _close(table.numpy()[fin], np.asarray(jtable)[fin])
        for v in xs:
            _close(brute.brute_posterior(tbn, v, ev),
                   jbrute.brute_posterior(jbn, v, ev))
        if ev:
            _close(brute.brute_log_evidence(tbn, ev),
                   jbrute.brute_log_evidence(jbn, ev))


@pytest.mark.parametrize("name", list(CLG))
def test_clg_oracle_matches_the_reference(name):
    jbn, Z, conts, ev = CLG[name]
    tbn = bn_to_port(jbn)
    _close(brute.brute_posterior(tbn, Z, ev),
           jbrute.brute_posterior(jbn, Z, ev))
    _close(brute.brute_log_evidence(tbn, ev),
           jbrute.brute_log_evidence(jbn, ev))
    for q in conts:
        for got, exp in zip(brute.brute_posterior_mean_var(tbn, q, ev),
                            jbrute.brute_posterior_mean_var(jbn, q, ev)):
            _close(got, exp)
    # no evidence: the prior moments, each configuration's mixture
    for got, exp in zip(brute.brute_posterior_mean_var(tbn, conts[0]),
                        jbrute.brute_posterior_mean_var(jbn, conts[0])):
        _close(got, exp)
    with pytest.raises(ValueError, match="observed"):
        brute.brute_posterior_mean_var(tbn, next(iter(ev)), ev)


@pytest.mark.parametrize("name", list(CLG))
def test_port_engine_matches_the_port_oracle(name):
    jbn, Z, conts, ev = CLG[name]
    tbn = bn_to_port(jbn)
    Z, conts = _port_vars(tbn, Z), [_port_vars(tbn, q) for q in conts]
    eng = JunctionTreeEngine(tbn, device="cpu")
    eng.set_evidence(ev)
    eng.run_inference()
    np.testing.assert_allclose(eng.posterior_discrete(Z).numpy(),
                               brute.brute_posterior(tbn, Z, ev).numpy(),
                               atol=1e-5)
    for q in conts:
        m, v = eng.posterior_mean_var(q)
        mb, vb = brute.brute_posterior_mean_var(tbn, q, ev)
        np.testing.assert_allclose(float(m), float(mb), atol=1e-5)
        np.testing.assert_allclose(float(v), float(vb), atol=1e-5)
    np.testing.assert_allclose(float(eng.log_evidence()),
                               float(brute.brute_log_evidence(tbn, ev)),
                               atol=1e-4)


@pytest.mark.parametrize("seed", [0, 3])
def test_port_discrete_engine_matches_the_port_oracle(seed):
    jbn, xs = E.random_discrete_bn(seed)
    tbn = bn_to_port(jbn)
    ev = {"V1": 1, "V4": 0}
    eng = JunctionTreeEngine(tbn, device="cpu")
    eng.set_evidence(ev)
    eng.run_inference()
    for v in [_port_vars(tbn, x) for x in xs]:
        if v.name not in ev:
            np.testing.assert_allclose(
                eng.posterior_discrete(v).numpy(),
                brute.brute_posterior(tbn, v, ev).numpy(), atol=1e-5)


def test_oracle_takes_an_explicit_device():
    jbn, Z, conts, ev = CLG["chain"]
    tbn = bn_to_port(jbn)
    p = brute.brute_posterior(tbn, Z, ev, device="cpu")
    assert p.device == torch.device("cpu") and p.dtype == torch.float32
    assert torch.equal(p, brute.brute_posterior(tbn, Z, ev))
