"""Importance sampling and MAP of the port (``repro_torch.core``) against the
JAX package's, and importance serving (``PGMQueryEngine(mode=
"importance")``).

``jax.random`` draws cannot be reproduced with a ``torch.Generator``, so
the parity tests hand the port the reference's own draws: its particles
(the port's weighting of them matches the reference's log-weights within
1e-5 absolute), its particles and log-weights (ESS and moments match
within rtol 1e-4: float32 sums of 20k weights in another order; posterior
tables within 1e-5 of the float64 sums of the
same weights, and within 3e-4 of the reference's, whose scatter-add
accumulates the float32 weights one by one), and its
MAP starts, rebuilt here with ``jax.random.split`` / ``randint`` as
``repro.core.map_inference`` draws them (the port's climb gives the
reference's assignment and its log-prob within rtol 1e-5).  The
reference's own tests run on the port with their own Monte Carlo bars.
Serving answers equal direct sampler runs bit for bit and fall within
5 sqrt(p (1 - p) / ESS) + 1e-3 of exact inference.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import bn_to_port  # noqa: E402
from repro.core import map_inference as jmap  # noqa: E402
from repro.core.dag import (BayesianNetwork, CLGCPD, DAG,  # noqa: E402
                            MultinomialCPD, Variables)
from repro.core.importance_sampling import \
    ImportanceSampling as JIS  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import importance_sampling as tis  # noqa: E402
from repro_torch.core import map_inference as tmap  # noqa: E402
from repro_torch.serve.engine import PGMQueryEngine  # noqa: E402


def _clg_net():
    """``tests/test_inference.py::clg_net``: Z -> X1, Z -> X2."""
    vs = Variables()
    Z = vs.new_multinomial("Z", 2)
    X1 = vs.new_gaussian("X1")
    X2 = vs.new_gaussian("X2")
    dag = DAG(vs)
    dag.add_parent(X1, Z)
    dag.add_parent(X2, Z)
    cpds = {
        "Z": MultinomialCPD(jnp.array([0.3, 0.7])),
        "X1": CLGCPD(alpha=jnp.array([0.0, 4.0]), beta=jnp.zeros((2, 0)),
                     sigma2=jnp.array([1.0, 1.0])),
        "X2": CLGCPD(alpha=jnp.array([-2.0, 2.0]), beta=jnp.zeros((2, 0)),
                     sigma2=jnp.array([1.0, 1.0])),
    }
    return BayesianNetwork(dag, cpds)


def _mode_net():
    """``tests/test_inference.py::test_map_inference_finds_mode``'s net."""
    vs = Variables()
    Z = vs.new_multinomial("Z", 2)
    W = vs.new_multinomial("W", 3)
    X1 = vs.new_gaussian("X1")
    dag = DAG(vs)
    dag.add_parent(X1, Z)
    dag.add_parent(W, Z)
    cpds = {
        "Z": MultinomialCPD(jnp.array([0.3, 0.7])),
        "W": MultinomialCPD(jnp.array([[0.8, 0.1, 0.1], [0.1, 0.1, 0.8]])),
        "X1": CLGCPD(alpha=jnp.array([0.0, 4.0]), beta=jnp.zeros((2, 0)),
                     sigma2=jnp.array([1.0, 1.0])),
    }
    return BayesianNetwork(dag, cpds)


def _chain_net(seed=0):
    """Z (card 3) -> X0 -> X1 -> X2 with W (card 2) -> X1: continuous nodes
    with discrete and continuous parents."""
    rng = np.random.default_rng(seed)
    vs = Variables()
    Z = vs.new_multinomial("Z", 3)
    W = vs.new_multinomial("W", 2)
    xs = [vs.new_gaussian(f"X{i}") for i in range(3)]
    dag = DAG(vs)
    dag.add_parent(xs[0], Z)
    dag.add_parent(xs[1], W)
    dag.add_parent(xs[1], xs[0])
    dag.add_parent(xs[2], xs[1])
    f = lambda a: jnp.asarray(np.asarray(a, np.float32))
    cpds = {
        "Z": MultinomialCPD(f(rng.dirichlet(np.ones(3)))),
        "W": MultinomialCPD(f(rng.dirichlet(np.ones(2)))),
        "X0": CLGCPD(f(rng.normal(0, 2, 3)), f(np.zeros((3, 0))),
                     f(0.5 + rng.random(3))),
        "X1": CLGCPD(f(rng.normal(0, 1, 2)), f(rng.normal(0, 1, (2, 1))),
                     f(0.5 + rng.random(2))),
        "X2": CLGCPD(f(rng.normal()), f(rng.normal(0, 1, 1)),
                     f(0.5 + rng.random())),
    }
    return BayesianNetwork(dag, cpds)


NETS = {
    "clg": (_clg_net, {"X1": 3.0, "X2": 1.0}),
    "chain": (_chain_net, {"X2": 1.5, "W": 1}),
    "discrete": (lambda: jsyn.random_discrete_bn(8, card=3, seed=3),
                 {"D7": 2, "D4": 0}),
}


def _reference_run(jbn, evidence, n, seed):
    inf = JIS(n_samples=n, seed=seed)
    inf.set_model(jbn)
    inf.set_evidence(evidence)
    inf.run_inference()
    return inf


def _torch_particles(jinf):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jinf._particles.items()}


@pytest.mark.parametrize("name", sorted(NETS))
def test_log_weights_of_reference_particles(name):
    make, ev = NETS[name]
    jbn = make()
    jinf = _reference_run(jbn, ev, 4096, seed=5)
    logw = tis._log_weights(bn_to_port(jbn), _torch_particles(jinf), ev)
    np.testing.assert_allclose(logw.numpy(), np.asarray(jinf._logw),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(NETS))
def test_queries_on_reference_particles(name):
    make, ev = NETS[name]
    jbn = make()
    jinf = _reference_run(jbn, ev, 20_000, seed=6)
    tbn = bn_to_port(jbn)
    inf = tis.ImportanceSampling(n_samples=20_000, seed=0, device="cpu")
    inf.set_model(tbn)
    inf._particles = _torch_particles(jinf)
    inf._logw = torch.from_numpy(np.array(jinf._logw))
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)
    close(inf.effective_sample_size(), jinf.effective_sample_size())
    lw = np.array(jinf._logw, np.float64)
    w64 = np.exp(lw - lw.max())
    w64 /= w64.sum()
    for jv in jbn.dag.variables:
        tv = tbn.dag.variables.by_name(jv.name)
        if jv.is_discrete:
            got = inf.posterior_discrete(tv).numpy()
            x = np.array(jinf._particles[jv.name]).astype(np.int64)
            np.testing.assert_allclose(
                got, np.bincount(x, w64, jv.card), rtol=0, atol=1e-5)
            # the reference's scatter-add sums 20k float32 weights one by
            # one: up to 1.5e-4 off the float64 sum on these networks
            np.testing.assert_allclose(
                got, np.asarray(jinf.posterior_discrete(jv)), rtol=0,
                atol=3e-4)
        else:
            for a, b in zip(inf.posterior_mean_var(tv),
                            jinf.posterior_mean_var(jv)):
                close(a, b)


def _run(bn, evidence, n, seed):
    inf = tis.ImportanceSampling(n_samples=n, seed=seed, device="cpu")
    inf.set_model(bn)
    inf.set_evidence(evidence)
    inf.run_inference()
    return inf


def test_importance_sampling_matches_exact():
    """``test_inference.py::test_importance_sampling_matches_exact``."""
    bn = bn_to_port(_clg_net())
    inf = _run(bn, {"X1": 3.0, "X2": 1.0}, 100_000, 1)
    post = inf.posterior_discrete(bn.dag.variables.by_name("Z")).numpy()

    def norm_pdf(x, m):
        return np.exp(-0.5 * (x - m) ** 2) / np.sqrt(2 * np.pi)

    l0 = 0.3 * norm_pdf(3, 0) * norm_pdf(1, -2)
    l1 = 0.7 * norm_pdf(3, 4) * norm_pdf(1, 2)
    exact = np.array([l0, l1]) / (l0 + l1)
    np.testing.assert_allclose(post, exact, atol=0.01)
    assert float(inf.effective_sample_size()) > 1000


def test_importance_sampling_evidence_on_root():
    """``test_inference.py::test_importance_sampling_evidence_on_root``."""
    bn = bn_to_port(_clg_net())
    inf = _run(bn, {"Z": 1}, 20_000, 2)
    assert float(inf.effective_sample_size()) == pytest.approx(20_000,
                                                               rel=1e-4)
    post = inf.posterior_discrete(bn.dag.variables.by_name("Z")).numpy()
    np.testing.assert_allclose(post, [0.0, 1.0], atol=1e-3)
    assert post[0] == 0.0
    m, v = inf.posterior_mean_var(bn.dag.variables.by_name("X1"))
    assert float(m) == pytest.approx(4.0, abs=0.05)
    assert float(v) == pytest.approx(1.0, abs=0.05)


def test_importance_sampling_empty_evidence_prior():
    """``test_inference.py::test_importance_sampling_empty_evidence_prior``."""
    bn = bn_to_port(_clg_net())
    inf = _run(bn, {}, 50_000, 3)
    assert float(inf.effective_sample_size()) == pytest.approx(50_000,
                                                               rel=1e-4)
    post = inf.posterior_discrete(bn.dag.variables.by_name("Z")).numpy()
    np.testing.assert_allclose(post, [0.3, 0.7], atol=0.01)
    m, v = inf.posterior_mean_var(bn.dag.variables.by_name("X2"))
    assert float(m) == pytest.approx(0.8, abs=0.05)
    assert float(v) == pytest.approx(1.0 + 4.0 - 0.64, abs=0.1)


def test_same_seed_same_bits_and_mesh_raises():
    bn = bn_to_port(_chain_net())
    a, b = (_run(bn, {"X2": 1.5}, 5000, 9) for _ in range(2))
    assert torch.equal(a._logw, b._logw)
    assert all(torch.equal(a._particles[k], b._particles[k])
               for k in a._particles)
    with pytest.raises(TypeError, match="DeviceMesh"):
        a.run_inference(mesh=object())


def _mc_bar(p, ess):
    return 5.0 * np.sqrt(p * (1.0 - p) / ess) + 1e-3


@pytest.mark.parametrize("name", ["chain", "discrete"])
def test_importance_serving(name):
    """Answers equal a direct sampler run seeded ``seed + qid`` bit for
    bit, and fall within the Monte Carlo bar of exact serving."""
    make, _ = NETS[name]
    bn = bn_to_port(make())
    if name == "chain":
        queries = [("Z", {"X2": x}) for x in (-1.0, 0.5, 2.0)] + \
                  [("W", {"X2": 1.0, "Z": 2}), ("Z", {"X0": 0.3})]
    else:
        queries = [("D0", {"D7": 2, "D4": 0}), ("D2", {"D7": 1}),
                   ("D5", {"D7": 0, "D4": 1}), ("D1", {})]
    eng = PGMQueryEngine(bn, mode="importance", n_samples=20_000, seed=11,
                         device="cpu")
    exact = PGMQueryEngine(bn, mode="exact", device="cpu")
    got = [eng.submit(t, ev) for t, ev in queries]
    ref = [exact.submit(t, ev) for t, ev in queries]
    eng.flush()
    exact.flush()
    for q, r in zip(got, ref):
        inf = _run(bn, q.evidence, 20_000, 11 + q.qid)
        direct = inf.posterior_discrete(bn.dag.variables.by_name(q.target))
        np.testing.assert_array_equal(q.result, direct.numpy())
        ess = float(inf.effective_sample_size())
        bar = _mc_bar(r.result, ess)
        assert (np.abs(q.result - r.result) <= bar).all(), (q, r.result, bar)


# -- MAP ----------------------------------------------------------------------


def _reference_starts(jbn, evidence, n_starts, seed):
    """``map_inference.py``'s initial states: one ``randint`` a query
    variable from ``split(PRNGKey(seed), Q)``."""
    dvars = [v for v in jbn.order if v.is_discrete and v.name not in evidence]
    keys = jax.random.split(jax.random.PRNGKey(seed), len(dvars))
    init = jnp.stack([jax.random.randint(keys[i], (n_starts,), 0, v.card)
                      for i, v in enumerate(dvars)], axis=1)
    return torch.from_numpy(np.array(init)).long()


MAP_CASES = {
    "mode": (_mode_net, {"X1": 3.8}, 16, 4),
    "clg": (_clg_net, {"X1": 1.9}, 8, 3),
    "chain": (_chain_net, {"X2": 1.5}, 32, 5),
    "discrete": (lambda: jsyn.random_discrete_bn(10, card=3, seed=4),
                 {"D9": 1, "D3": 2}, 64, 6),
}


@pytest.mark.parametrize("name", sorted(MAP_CASES))
def test_hill_climb_from_reference_starts(name):
    make, ev, n_starts, n_passes = MAP_CASES[name]
    jbn = make()
    jasg, jlp = jmap.map_inference(jbn, ev, n_starts=n_starts,
                                   n_passes=n_passes, seed=7)
    tbn = bn_to_port(jbn)
    tev = tbn.evidence_tensors(ev, torch.device("cpu"))
    states, best = tmap._hill_climb(
        tbn, tev, _reference_starts(jbn, ev, n_starts, 7), n_passes)
    idx = int(best.argmax())
    dvars = tmap._query_vars(tbn, tev)
    asg = {v.name: int(states[idx, i]) for i, v in enumerate(dvars)}
    assert asg == jasg
    np.testing.assert_allclose(float(best[idx]), jlp, rtol=1e-5)


def test_map_inference_finds_mode():
    """``test_inference.py::test_map_inference_finds_mode``."""
    asg, lp = tmap.map_inference(bn_to_port(_mode_net()), {"X1": 3.8},
                                 n_starts=16, n_passes=4, device="cpu")
    assert asg == {"Z": 1, "W": 2}
    assert np.isfinite(lp)


def test_map_equals_enumeration():
    """The MAP's log-prob is the maximum over every configuration of the
    query variables (a discrete network, two evidence variables)."""
    bn = bn_to_port(jsyn.random_discrete_bn(8, card=3, seed=5))
    ev = {"D6": 0, "D2": 2}
    asg, lp = tmap.map_inference(bn, ev, n_starts=64, n_passes=6,
                                 device="cpu")
    names = [v.name for v in bn.order if v.name not in ev]
    grid = torch.tensor(list(itertools.product(range(3),
                                               repeat=len(names))))
    full = {n: grid[:, i] for i, n in enumerate(names)}
    full.update({k: torch.full((grid.shape[0],), v) for k, v in ev.items()})
    lps = bn.log_prob(full)
    np.testing.assert_allclose(lp, float(lps.max()), rtol=1e-6)
    best = grid[int(lps.argmax())]
    assert asg == {n: int(best[i]) for i, n in enumerate(names)}


def test_map_raises_on_mesh_and_on_no_query_variable():
    bn = bn_to_port(_clg_net())
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmap.map_inference(bn, {"X1": 1.0}, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="no discrete query"):
        tmap.map_inference(bn, {"Z": 0}, device="cpu")
