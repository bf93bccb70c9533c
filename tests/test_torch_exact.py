"""Exact inference of the port (``repro_torch.infer_exact``) against the JAX
package's junction-tree engine on the CPU: graph compilation, both
pipelines with batched evidence, the bucketed schedule, the kernel route's
flattening, evidence validation and the model language.

The networks are the JAX package's own test networks (carried across with
``repro_torch.convert.bayesian_network_from_numpy``) and the seeded
ground-truth generators of both packages.  Tolerances: posteriors within
1e-5, means/variances within 1e-5 (1e-4 on the FA net), ``log_evidence``
within 1e-4 -- float32 sums and batched linalg in another order.  The JAX
engine runs its plain path (``use_pallas=False``); its Pallas kernels are
held against the port's plain versions in ``test_torch_factor_kernels``.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import test_strong_jt as S  # noqa: E402
from _torch_parity import bn_to_port  # noqa: E402
from repro.core import dag as jdag  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.infer_exact import JunctionTreeEngine as JEngine  # noqa: E402
from repro.infer_exact import graph as jgraph  # noqa: E402
from repro_torch.core import dag as tdag  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.infer_exact import JunctionTreeEngine  # noqa: E402
from repro_torch.infer_exact import graph as tgraph  # noqa: E402
from repro_torch.kernels import factor_ops  # noqa: E402

torch.set_num_threads(1)


def _clg_net():
    """``tests/test_exact_inference.py``'s ``clg_net`` fixture."""
    vs = jdag.Variables()
    Z = vs.new_multinomial("Z", 2)
    X1, X2 = vs.new_gaussian("X1"), vs.new_gaussian("X2")
    dag = jdag.DAG(vs)
    dag.add_parent(X1, Z)
    dag.add_parent(X2, Z)
    return jdag.BayesianNetwork(dag, {
        "Z": jdag.MultinomialCPD(jnp.array([0.3, 0.7])),
        "X1": jdag.CLGCPD(jnp.array([0.0, 4.0]), jnp.zeros((2, 0)),
                          jnp.array([1.0, 1.0])),
        "X2": jdag.CLGCPD(jnp.array([-2.0, 2.0]), jnp.zeros((2, 0)),
                          jnp.array([0.5, 2.0]))})


def _mixed_net():
    """``test_strong_jt.py``'s partial/discrete-evidence network, with a
    discrete node whose parents were added out of sorted order (B, A)."""
    rng = np.random.RandomState(1)
    vs = jdag.Variables()
    Z, W = vs.new_multinomial("Z", 2), vs.new_multinomial("W", 3)
    B_, A_ = vs.new_multinomial("B", 2), vs.new_multinomial("A", 2)
    H, X1, X2 = (vs.new_gaussian(n) for n in ("H", "X1", "X2"))
    dag = jdag.DAG(vs)
    dag.add_parent(W, B_)
    dag.add_parent(W, A_)
    dag.add_parent(H, Z)
    dag.add_parent(X1, H)
    dag.add_parent(X1, W)
    dag.add_parent(X2, H)
    C = jdag.CLGCPD
    return jdag.BayesianNetwork(dag, {
        "Z": jdag.MultinomialCPD(jnp.array([0.3, 0.7])),
        "B": jdag.MultinomialCPD(jnp.array([0.6, 0.4])),
        "A": jdag.MultinomialCPD(jnp.array([0.2, 0.8])),
        "W": jdag.MultinomialCPD(jnp.asarray(
            rng.dirichlet(np.ones(3), size=(2, 2)), jnp.float32)),
        "H": C(jnp.array([0., 2.5]), jnp.zeros((2, 0)), jnp.array([1., .6])),
        "X1": C(jnp.asarray(rng.randn(3), jnp.float32),
                jnp.asarray(rng.randn(3, 1), jnp.float32),
                jnp.asarray(0.5 + rng.rand(3), jnp.float32)),
        "X2": C(jnp.asarray(0.1), jnp.asarray([1.3]), jnp.asarray(0.7)),
    })


def _nets():
    """name -> (JAX network, evidence with a batch of 3, continuous names
    to query)."""
    g = np.random.default_rng(0)
    nets = {}
    bn = jsyn.random_discrete_bn(8, 3, seed=0)
    nets["random_discrete_bn"] = (bn, {"D7": np.array([0, 1, 2]),
                                       "D3": np.array([2, 0, 1])}, [])
    nets["clg_net"] = (_clg_net(), {"X1": np.array([3.0, -1.0, 0.5])},
                       ["X2"])
    bn, *_ = S.chain_net()
    nets["chain"] = (bn, {"X1": np.array([0.7, 0.1, -2.0]),
                          "X3": np.array([-0.4, 1.0, 0.0])}, ["X2"])
    bn, *_ = S.vstruct_net()
    nets["vstruct"] = (bn, {"X": np.array([1.3, -0.2, 0.5])}, ["H1", "H2"])
    bn, _, _, _, xs = S.fa_net(0)
    nets["fa_net"] = (bn, {x.name: g.standard_normal(3).astype(np.float32)
                           for x in xs}, ["H1", "H2"])
    nets["mixed"] = (_mixed_net(), {"X1": np.array([0.5, -1.0, 2.0]),
                                    "W": np.array([2, 0, 1])}, ["H", "X2"])
    bn, _, _ = S._deep_chain_net(depth=6, seed=1)
    nets["deep_chain"] = (bn, {"X05": g.standard_normal(3).astype(np.float32),
                               "X02": g.standard_normal(3).astype(np.float32)},
                          ["X00", "X03"])
    return nets


NETS = _nets()


def _jax_run(bn, ev, **kw):
    eng = JEngine(bn, use_pallas=False, **kw)
    eng.set_evidence(ev)
    eng.run_inference()
    return eng


def _port_run(bn, ev, **kw):
    eng = JunctionTreeEngine(bn, device="cpu", **kw)
    eng.set_evidence(ev)
    eng.run_inference()
    return eng


@pytest.mark.parametrize("name", sorted(NETS))
def test_graph_compilation_matches_reference(name):
    jbn = NETS[name][0]
    tbn = bn_to_port(jbn)
    jeng, teng = JEngine(jbn), JunctionTreeEngine(tbn, device="cpu")
    assert teng.strong == jeng.strong
    a, b = jeng.jt, teng.jt
    assert a.cliques == b.cliques and a.edges == b.edges
    assert a.sepsets == b.sepsets and a.root == b.root
    assert a.elimination_order == b.elimination_order
    assert a.fill_in_count == b.fill_in_count
    assert teng._collect == jeng._collect
    assert teng._distribute == jeng._distribute
    assert teng._home == jeng._home


def test_moral_graph_and_triangulation_match_reference():
    jbn = jsyn.random_discrete_bn(12, card=2, max_parents=3, seed=4)
    tbn = bn_to_port(jbn)
    assert tgraph.moralize(tbn) == jgraph.moralize(jbn)
    assert tgraph.moralize_full(tbn) == jgraph.moralize_full(jbn)
    assert (tgraph.min_fill_triangulate(tgraph.moralize(tbn))
            == jgraph.min_fill_triangulate(jgraph.moralize(jbn)))


@pytest.mark.parametrize("name", sorted(NETS))
def test_engine_matches_reference_with_batched_evidence(name):
    jbn, ev, cont = NETS[name]
    tbn = bn_to_port(jbn)
    j, t = _jax_run(jbn, ev), _port_run(tbn, ev)
    for v in jbn.order:
        if v.is_discrete:
            got = t.posterior_discrete(v.name)
            assert got.shape == (3, v.card)
            np.testing.assert_allclose(got.numpy(), np.asarray(
                j.posterior_discrete(v)), atol=1e-5, err_msg=v.name)
    atol = 1e-4 if name == "fa_net" else 1e-5
    for c in cont:
        mj, vj = j.posterior_mean_var(jbn.dag.variables.by_name(c))
        mt, vt = t.posterior_mean_var(tbn.dag.variables.by_name(c))
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=atol)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=atol)
    np.testing.assert_allclose(t.log_evidence().numpy(),
                               np.asarray(j.log_evidence()), atol=1e-4)
    assert set(t.last_run) == set(j.last_run)
    assert t.last_run["pipeline"] == j.last_run["pipeline"]


@pytest.mark.parametrize("name", ["chain", "vstruct", "fa_net", "mixed",
                                  "deep_chain"])
def test_bucketed_equals_per_clique(name):
    jbn, ev, cont = NETS[name]
    tbn = bn_to_port(jbn)
    ref, buck = (_port_run(tbn, ev, bucketed=b) for b in (False, True))
    np.testing.assert_allclose(buck.posterior_discrete("Z").numpy(),
                               ref.posterior_discrete("Z").numpy(), atol=1e-6)
    for c in cont:
        v = tbn.dag.variables.by_name(c)
        for x, y in zip(buck.posterior_mean_var(v), ref.posterior_mean_var(v)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5)
    np.testing.assert_allclose(buck.log_evidence().numpy(),
                               ref.log_evidence().numpy(), atol=1e-5)


@pytest.mark.parametrize("name", ["random_discrete_bn", "clg_net", "chain",
                                  "fa_net", "mixed", "deep_chain"])
def test_kernel_route_on_cpu_tensors_matches_plain(name):
    """The engine's ``"cuda"`` route (flattened [B, M, N] views, permutes,
    the wrappers) with CPU tensors, where each wrapper runs its plain
    version, against the plain backend."""
    jbn, ev, cont = NETS[name]
    tbn = bn_to_port(jbn)
    plain = _port_run(tbn, ev)
    kern = JunctionTreeEngine(tbn, device="cpu")
    kern.backend = "cuda"          # the wrappers' CPU route, not a launch
    kern.set_evidence(ev)
    kern.run_inference()
    for v in tbn.order:
        if v.is_discrete:
            np.testing.assert_allclose(kern.posterior_discrete(v).numpy(),
                                       plain.posterior_discrete(v).numpy(),
                                       atol=1e-6)
    for c in cont:
        v = tbn.dag.variables.by_name(c)
        for x, y in zip(kern.posterior_mean_var(v),
                        plain.posterior_mean_var(v)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6)
    np.testing.assert_allclose(kern.log_evidence().numpy(),
                               plain.log_evidence().numpy(), atol=1e-6)


def test_discrete_schedule_calls_the_kernels_as_the_reference_does(
        monkeypatch):
    """On the 32-variable network one propagation makes 168 log_product
    and 48 log_marginalize calls (the JAX package's schedule, counted at
    its ops layer), whatever the evidence schema."""
    calls = collections.Counter()
    for k in factor_ops.LAUNCHES:
        fn = getattr(factor_ops, k)
        monkeypatch.setattr(factor_ops, k, lambda *a, _f=fn, _k=k: (
            calls.update([_k]), _f(*a))[1])
    bn = tsyn.random_discrete_bn(32, card=4, max_parents=3, seed=0,
                                 device="cpu")
    eng = JunctionTreeEngine(bn, device="cpu")
    eng.backend = "cuda"
    assert len(eng.jt.cliques) == 25
    for ev in ({"D31": np.array([0, 3])},
               {"D5": np.array([1, 2]), "D20": np.array([0, 0])}):
        calls.clear()
        eng.set_evidence(ev)
        eng.run_inference()
        eng.posterior_discrete("D0")
        assert dict(calls) == {"log_product": 168, "log_marginalize": 48}


def test_impossible_evidence_gives_neg_inf():
    vs = tdag.Variables()
    a, b = vs.new_multinomial("A", 2), vs.new_multinomial("B", 2)
    dag = tdag.DAG(vs)
    dag.add_parent(b, a)
    bn = tdag.BayesianNetwork(dag, {
        "A": tdag.MultinomialCPD(torch.tensor([1.0, 0.0])),
        "B": tdag.MultinomialCPD(torch.tensor([[1.0, 0.0], [0.5, 0.5]]))})
    for backend_route in ("einsum", "cuda"):
        eng = JunctionTreeEngine(bn, device="cpu")
        eng.backend = backend_route
        eng.set_evidence({"B": np.array([1, 0])})
        eng.run_inference()
        lz = eng.log_evidence()
        assert bool(torch.isneginf(lz[0])) and bool(torch.isfinite(lz[1]))


def test_bad_evidence_raises():
    bn = bn_to_port(NETS["clg_net"][0])
    eng = JunctionTreeEngine(bn, device="cpu")
    with pytest.raises(ValueError, match="unknown evidence"):
        eng.set_evidence({"X9": 1.0})
    with pytest.raises(ValueError, match="outside"):
        eng.set_evidence({"Z": 7})
    with pytest.raises(ValueError, match="outside"):
        eng.set_evidence({"Z": np.array([0.0, -1.0])})
    eng.set_evidence({"X1": np.array([1.0, 2.0]),
                      "X2": np.array([0.0, 1.0, 2.0])})
    with pytest.raises(ValueError, match="batch lengths"):
        eng.run_inference()
    eng.set_evidence({"Z": 1.0})                 # float, as served
    assert eng.evidence["Z"].dtype == torch.int32
    with pytest.raises(RuntimeError, match="run_inference"):
        eng.posterior_discrete("Z")
    eng.run_inference()
    with pytest.raises(ValueError, match="observed"):
        eng.posterior_mean_var(bn.dag.variables.by_name("Z"))


def test_plan_reuse_and_set_model_bump_the_version():
    jbn, ev, _ = NETS["chain"]
    eng = _port_run(bn_to_port(jbn), ev)
    assert not eng.last_run["cache_hit"]
    eng.run_inference()
    assert eng.last_run["cache_hit"] and eng.last_run["compile_us"] == 0.0
    eng.set_model(bn_to_port(jbn))
    assert eng.network_version == 1
    eng.run_inference()
    assert not eng.last_run["cache_hit"] and len(eng.plans) == 2


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JunctionTreeEngine(bn_to_port(NETS["chain"][0]))
    with pytest.raises(ValueError, match="needs tensors on a CUDA"):
        JunctionTreeEngine(bn_to_port(NETS["chain"][0]), device="cpu",
                           backend="cuda")


# -- the model language -------------------------------------------------------


def test_dag_rejects_duplicate_edge_cycle_and_self_loop():
    vs = tdag.Variables()
    a, b, c = (vs.new_multinomial(n, 2) for n in "ABC")
    dag = tdag.DAG(vs)
    dag.add_parent(b, a)
    dag.add_parent(c, b)
    with pytest.raises(ValueError, match="duplicate"):
        dag.add_parent(b, a)
    with pytest.raises(ValueError, match="cycle"):
        dag.add_parent(a, c)
    with pytest.raises(ValueError, match="self-loop"):
        dag.add_parent(a, a)
    assert dag.get_parents(a) == [] and len(dag.get_parents(b)) == 1
    assert [v.name for v in dag.topological_order()] == ["A", "B", "C"]
    with pytest.raises(ValueError, match="duplicate variable"):
        vs.new_gaussian("A")


def test_log_prob_and_sample_match_reference():
    jbn = NETS["chain"][0]
    tbn = bn_to_port(jbn)
    g = np.random.default_rng(3)
    asg = {"Z": np.array([0, 2, 1]), "X1": g.standard_normal(3),
           "X2": g.standard_normal(3), "X3": g.standard_normal(3)}
    jl = jbn.log_prob({k: jnp.asarray(v) for k, v in asg.items()})
    tl = tbn.log_prob({k: torch.as_tensor(v) if k == "Z" else
                       torch.as_tensor(v, dtype=torch.float32)
                       for k, v in asg.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    s = tbn.sample(torch.Generator().manual_seed(0), 20000)
    z = s["Z"].numpy()
    np.testing.assert_allclose(np.bincount(z, minlength=3) / z.size,
                               [0.5, 0.3, 0.2], atol=0.02)
    x1 = s["X1"].numpy()
    for k, mean in enumerate([0.0, 2.0, -1.0]):
        assert abs(x1[z == k].mean() - mean) < 0.1
    assert "P(X2 | X1, Z)" in str(tbn)


def test_synthetic_networks_match_reference_bit_for_bit():
    for args in [(32, 4, 3, 0), (8, 3, 2, 1)]:
        t, j = tsyn.random_discrete_bn(*args, device="cpu"), \
            jsyn.random_discrete_bn(*args)
        for v in j.order:
            tv = t.dag.variables.by_name(v.name)
            assert ([p.name for p in t.dag.get_parents(tv)]
                    == [p.name for p in j.dag.get_parents(v)])
            np.testing.assert_array_equal(t.cpds[v.name].table.numpy(),
                                          np.asarray(j.cpds[v.name].table))
    t, j = tsyn.clg_tree_bn(7, seed=2, device="cpu"), jsyn.clg_tree_bn(7, 2)
    for v in j.order:
        for f in ("alpha", "beta", "sigma2"):
            a = getattr(t.cpds[v.name], f).numpy()
            b = np.asarray(getattr(j.cpds[v.name], f))
            assert a.shape == b.shape and np.array_equal(a, b)
