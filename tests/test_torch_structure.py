"""The port's structure learning (``repro_torch.learn_structure``) against
the JAX package's (``repro.learn_structure``) on the CPU.  Data are sampled
by the reference's ``bn_stream`` (or made from a seed with numpy) and the
same numpy arrays go to both packages.

Tolerances, and why:
* counts are exact integers in both packages, so every quantity computed
  from them in float64 on the host (pairwise MI, the Chow-Liu/TAN trees)
  is equal, and discrete CPD tables (float32 host arithmetic on equal
  counts) agree to 1e-6;
* BDeu scores go through float32 ``lgamma`` of two libraries: rtol 1e-5
  per family and on a search's total score;
* NIG scores: rtol 1e-4 per family and on a search's total score -- the
  residual ``syy - m' K m`` is a small difference of large float32 sums
  taken in another order, which amplifies their rounding;
* CLG CPD parameters (float32 solves on moments summed in another order):
  atol 1e-4 (1 + |value|);
* ``hill_climb``: BDeu is score-equivalent, so float noise may orient an
  edge either way -- skeletons are compared, not orientations.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.learn_structure as J  # noqa: E402
import repro_torch.learn_structure as P  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.data.stream import Attribute, DataStream, FINITE, REAL  # noqa: E402
from repro.learn_structure import chowliu as jcl  # noqa: E402
from repro.learn_structure import scores as js  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.data.stream import Attribute as TAttribute  # noqa: E402
from repro_torch.data.stream import Batch as TBatch  # noqa: E402
from repro_torch.data.stream import DataStream as TDataStream  # noqa: E402
from repro_torch.learn_structure import chowliu as tcl  # noqa: E402
from repro_torch.learn_structure import scores as ts  # noqa: E402

from _torch_parity import bn_to_port  # noqa: E402

CPU = "cpu"
SCORE_RTOL = 1e-5        # BDeu
NIG_RTOL = 1e-4          # NIG evidence (see the module docstring)


def _np_batch(batch):
    return (np.array(batch.xc, np.float32), np.array(batch.xd, np.int32),
            np.array(batch.mask, np.float32))


def _tbatch(batch):
    return TBatch(*_np_batch(batch))


def _tattrs(attrs):
    return [TAttribute(a.name, a.kind, a.card) for a in attrs]


def _stream(jbn, n, seed):
    s = jsyn.bn_stream(jbn, n, seed=seed)
    return s, s.collect()


@pytest.fixture(scope="module")
def disc6():
    """A 6-variable card-3 network with fan-in 2 and 3000 samples."""
    bn = jsyn.random_discrete_bn(6, card=3, max_parents=2, seed=0)
    s, b = _stream(bn, 3000, 50)
    return bn, s.attributes, b


@pytest.fixture(scope="module")
def mixed():
    """5 continuous (a CLG tree) + 2 discrete columns, one of them the
    parent of two continuous columns' means."""
    g = np.random.default_rng(8)
    n = 2500
    d0 = g.integers(0, 3, n)
    d1 = (d0 + (g.random(n) < 0.3)) % 2
    x0 = g.standard_normal(n) + d0
    x1 = 0.8 * x0 + 0.5 * g.standard_normal(n)
    x2 = -1.1 * x1 + 0.4 * g.standard_normal(n) + 0.5 * d1
    x3 = 0.9 * x0 + 0.6 * g.standard_normal(n)
    x4 = g.standard_normal(n)
    xc = np.stack([x0, x1, x2, x3, x4], 1).astype(np.float32)
    xd = np.stack([d0, d1], 1).astype(np.int32)
    mask = np.ones(n, np.float32)
    mask[-200:] = 0.0
    attrs = ([Attribute(f"G{i}", REAL) for i in range(5)]
             + [Attribute("D0", FINITE, 3), Attribute("D1", FINITE, 2)])
    return attrs, xc, xd, mask


# ---------------------------------------------------------------------------
# scores
# ---------------------------------------------------------------------------


def test_package_exports_the_reference_names():
    assert P.__all__ == J.__all__
    assert all(hasattr(P, n) for n in P.__all__)


def test_disc_family_scores_match_both_reference_backends(disc6):
    _, attrs, b = disc6
    xd = np.array(b.xd, np.int32)
    mask = np.ones(len(xd), np.float32)
    mask[-300:] = 0.0
    cards = [a.card for a in attrs]
    fams = [(i, tuple(j for j in range(6) if j != i)[:k])
            for i in range(6) for k in range(3)] + [(2, (5, 0)), (4, (1,))]
    got = ts.disc_family_scores(xd, fams, cards, mask=mask, ess=2.0,
                                device=CPU)
    for backend in ("einsum", "pallas"):
        exp = js.disc_family_scores(jnp.asarray(xd), fams, cards,
                                    mask=jnp.asarray(mask), ess=2.0,
                                    backend=backend)
        np.testing.assert_allclose(got, exp, rtol=SCORE_RTOL)


def test_nig_evidence_matches_reference():
    g = np.random.default_rng(3)
    B, D = 7, 3
    X = g.standard_normal((B, 50, D)).astype(np.float32)
    X[..., 0] = 1.0
    y = (X @ g.standard_normal(D) + 0.4 * g.standard_normal((B, 50))
         ).astype(np.float32)
    sxx = np.einsum("bnd,bne->bde", X, X)
    sxy = np.einsum("bnd,bn->bd", X, y)
    syy = (y * y).sum(1)
    n = np.full(B, 50.0, np.float32)
    kw = dict(kappa=1.7, a0=1.2, b0=0.9)
    got = ts.nig_evidence(*(torch.from_numpy(a) for a in (sxx, sxy, syy, n)),
                          **kw)
    exp = js.nig_evidence(*(jnp.asarray(a) for a in (sxx, sxy, syy, n)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=NIG_RTOL)


def test_clg_family_scores_match_reference(mixed):
    attrs, xc, xd, mask = mixed
    cards = [3, 2]
    fams = [(1, (0,), ()), (1, (), ()), (2, (1,), (1,)), (2, (1, 3), (1,)),
            (0, (), (0,)), (0, (3,), (0, 1)), (4, (0, 1, 2), ()),
            (3, (0,), (0,)), (2, (), (1, 0))]
    got = ts.clg_family_scores(xc, xd, fams, cards, mask=mask, kappa=0.5,
                               device=CPU)
    exp = js.clg_family_scores(jnp.asarray(xc), jnp.asarray(xd), fams, cards,
                               mask=jnp.asarray(mask), kappa=0.5)
    np.testing.assert_allclose(got, exp, rtol=NIG_RTOL)


def test_structure_stats_and_cpds_match_reference(mixed):
    attrs, xc, xd, mask = mixed
    parents = {"G1": ["G0"], "G2": ["G1", "D1"], "G0": ["D0"],
               "D1": ["D0"], "G3": ["G0", "D0"]}
    tb = TBatch(xc, xd, mask)
    got = ts.structure_stats(_tattrs(attrs), parents, tb, device=CPU)
    from repro.data.stream import Batch as JBatch

    jb = JBatch(jnp.asarray(xc), jnp.asarray(xd), jnp.asarray(mask))
    exp = js.structure_stats(attrs, parents, jb)
    np.testing.assert_array_equal(got["disc"].numpy(), np.asarray(exp["disc"]))
    for name, stats in exp["cont"].items():
        for a, b in zip(got["cont"][name], stats):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-2)
    kw = dict(ess=3.0, kappa=0.7, a0=1.5, b0=0.5)
    tbn = ts.cpds_from_stats(_tattrs(attrs), parents, got, **kw)
    jbn = js.cpds_from_stats(attrs, parents, exp, **kw)
    fitted = ts.fit_cpds(_tattrs(attrs), parents, tb, device=CPU, **kw)
    _assert_cpds_close(jbn, tbn)
    _assert_cpds_close(jbn, fitted)


def _assert_cpds_close(jbn, tbn):
    assert set(jbn.cpds) == set(tbn.cpds)
    for name, cpd in jbn.cpds.items():
        assert ([p.name for p in jbn.dag.get_parents(
            jbn.dag.variables.by_name(name))]
            == [p.name for p in tbn.dag.parents[name]])
        t = tbn.cpds[name]
        if hasattr(cpd, "table"):
            np.testing.assert_allclose(t.table.numpy(), np.asarray(cpd.table),
                                       atol=1e-6, err_msg=name)
            continue
        for f in ("alpha", "beta", "sigma2"):
            e = np.asarray(getattr(cpd, f))
            a = getattr(t, f).numpy()
            assert a.shape == e.shape, (name, f)
            np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name}.{f}")


# ---------------------------------------------------------------------------
# Chow-Liu / TAN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cond", [None, (2, 3)])
def test_pairwise_mi_discrete_matches_reference(disc6, cond):
    _, attrs, b = disc6
    xd = _np_batch(b)[1]
    cards = [a.card for a in attrs]
    got = tcl.pairwise_mi_discrete(xd, cards, cond=cond, device=CPU)
    exp = jcl.pairwise_mi_discrete(jnp.asarray(xd), cards, cond=cond)
    np.testing.assert_allclose(got, exp, rtol=1e-12, atol=1e-15)


def test_pairwise_mi_gaussian_matches_reference(mixed):
    _, xc, _, mask = mixed
    np.testing.assert_allclose(
        tcl.pairwise_mi_gaussian(xc, mask=mask),
        jcl.pairwise_mi_gaussian(jnp.asarray(xc), mask=jnp.asarray(mask)),
        rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("kind", ["discrete", "clg"])
def test_chow_liu_matches_reference(kind):
    jbn = (jsyn.random_discrete_bn(7, card=3, seed=3, tree=True)
           if kind == "discrete" else jsyn.clg_tree_bn(7, seed=5))
    s, b = _stream(jbn, 4000, 100)
    je, jlearn = J.chow_liu(b, s.attributes, root=2)
    te, tlearn = P.chow_liu(_tbatch(b), _tattrs(s.attributes), root=2,
                            device=CPU)
    assert te == je
    assert P.undirected_edges(te) == J.undirected_edges(jbn)
    _assert_cpds_close(jlearn, tlearn)


def _tan_net():
    """Class Y -> X0..X3, plus the chain X0 -> X1 -> X2 (X3 hangs off Y)."""
    from repro.core.dag import (BayesianNetwork, DAG, MultinomialCPD,
                                Variables)

    rng = np.random.default_rng(0)
    card, ncls = 3, 2
    vs = Variables()
    Y = vs.new_multinomial("Y", ncls)
    xs = [vs.new_multinomial(f"X{i}", card) for i in range(4)]
    dag = DAG(vs)
    for x in xs:
        dag.add_parent(x, Y)
    dag.add_parent(xs[1], xs[0])
    dag.add_parent(xs[2], xs[1])

    def sharp(q):
        t = 0.15 * rng.dirichlet(np.ones(card), size=q)
        for j in range(q):
            t[j, j % card] += 0.85
        return t

    cpds = {"Y": MultinomialCPD(jnp.asarray([0.6, 0.4]))}
    for i in (0, 3):
        cpds[f"X{i}"] = MultinomialCPD(jnp.asarray(
            sharp(ncls).astype(np.float32)))
    for i in (1, 2):
        t = sharp(ncls * card).reshape(ncls, card, card)
        cpds[f"X{i}"] = MultinomialCPD(jnp.asarray(t.astype(np.float32)))
    return BayesianNetwork(dag, cpds)


def test_tan_and_predict_class_match_reference():
    s, b = _stream(_tan_net(), 4000, 7)
    je, jlearn = J.tan(b, s.attributes, "Y")
    te, tlearn = P.tan(_tbatch(b), _tattrs(s.attributes), "Y", device=CPU)
    assert te == je
    _assert_cpds_close(jlearn, tlearn)
    jp = np.asarray(J.predict_class(jlearn, "Y", b, s.attributes))
    tp = P.predict_class(tlearn, "Y", _tbatch(b), _tattrs(s.attributes))
    assert tp.dtype == torch.int64 and tp.shape == (4000,)
    # float32 log-probs of two libraries: near-ties may flip a handful
    assert (tp.numpy() == jp).mean() > 0.999


def test_chow_liu_and_tan_reject_what_the_reference_rejects():
    attrs = [TAttribute("G0", REAL), TAttribute("D0", FINITE, 2)]
    s = TDataStream.from_arrays(attrs, np.zeros((4, 1), np.float32),
                                np.zeros((4, 1), np.int32))
    with pytest.raises(ValueError, match="mixed"):
        P.chow_liu(s, attrs, device=CPU)
    g = [TAttribute("G0", REAL), TAttribute("G1", REAL)]
    s = TDataStream.from_arrays(g, np.zeros((8, 2), np.float32))
    with pytest.raises(ValueError, match="root"):
        P.chow_liu(s, g, root=2, device=CPU)
    with pytest.raises(ValueError, match="FINITE"):
        P.tan(s, g, "G0", device=CPU)


# ---------------------------------------------------------------------------
# hill-climbing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["discrete", "clg", "mixed"])
def test_hill_climb_matches_reference(case, disc6, mixed):
    """Same skeleton and total score within rtol 1e-5; the fan-in limit
    and the CLG restriction hold in the port's result."""
    if case == "discrete":
        _, attrs, b = disc6
        xc, xd, mask = _np_batch(b)
        kw = dict(max_parents=2)
    elif case == "clg":
        s, b = _stream(jsyn.clg_tree_bn(6, seed=7), 3000, 9)
        attrs = s.attributes
        xc, xd, mask = _np_batch(b)
        kw = dict(max_parents=2, kappa=0.8)
    else:
        attrs, xc, xd, mask = mixed
        kw = dict(max_parents=2, ess=2.0)
    from repro.data.stream import Batch as JBatch

    jres = J.hill_climb(JBatch(jnp.asarray(xc), jnp.asarray(xd),
                               jnp.asarray(mask)), attrs, **kw)
    tres = P.hill_climb(TBatch(xc, xd, mask), _tattrs(attrs), device=CPU,
                        **kw)
    assert (P.undirected_edges(tres.parents)
            == J.undirected_edges(jres.parents))
    np.testing.assert_allclose(tres.score, jres.score,
                               rtol=SCORE_RTOL if case == "discrete"
                               else NIG_RTOL)
    assert tres.n_iters == jres.n_iters
    assert all(d > 0 for *_, d in tres.trace)
    assert all(len(p) <= kw["max_parents"] for p in tres.parents.values())
    kinds = {a.name: a.kind for a in attrs}
    for child, ps in tres.parents.items():
        if kinds[child] == FINITE:
            assert all(kinds[p] == FINITE for p in ps)
    assert tres.bn is not None and set(tres.bn.cpds) == set(kinds)


def test_hill_climb_warm_start_and_fit_false(disc6):
    _, attrs, b = disc6
    init = {"D1": ["D0"], "D3": ["D1"]}
    tres = P.hill_climb(_tbatch(b), _tattrs(attrs), init_parents=init,
                        fit=False, device=CPU)
    jres = J.hill_climb(b, attrs, init_parents=init, fit=False)
    assert tres.bn is None
    assert (P.undirected_edges(tres.parents)
            == J.undirected_edges(jres.parents))
    np.testing.assert_allclose(tres.score, jres.score, rtol=SCORE_RTOL)


def test_entry_points_need_a_card_unless_told_cpu(disc6):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    _, attrs, b = disc6
    for call in (lambda: P.hill_climb(_tbatch(b), _tattrs(attrs)),
                 lambda: P.chow_liu(_tbatch(b), _tattrs(attrs)),
                 lambda: P.tan(_tbatch(b), _tattrs(attrs), "D0"),
                 lambda: P.fit_cpds(_tattrs(attrs), {}, _tbatch(b)),
                 lambda: P.AdaptiveStructure(_tattrs(attrs))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# streaming adaptation
# ---------------------------------------------------------------------------


def test_adaptive_structure_matches_reference_through_drift():
    """Concept switch mid-stream: the same batches flag drift in both
    packages, the final edges are equal, CPD tables close."""
    bn_a = jsyn.random_discrete_bn(5, card=3, seed=0, tree=True)
    bn_b = jsyn.random_discrete_bn(5, card=3, seed=11, tree=True)
    stream = DataStream.concat([jsyn.bn_stream(bn_a, 4000, seed=1),
                                jsyn.bn_stream(bn_b, 4000, seed=2)])
    batches = [_np_batch(b) for b in stream.batches(500)]
    jad = J.AdaptiveStructure(stream.attributes, learner="chowliu",
                              window=2000, ess=2.0)
    tad = P.AdaptiveStructure(_tattrs(stream.attributes), learner="chowliu",
                              window=2000, ess=2.0, device=CPU)
    jd, td = [], []
    for i, (xc, xd, mask) in enumerate(batches):
        ji = jad.update(xc, xd, mask)
        ti = tad.update(TBatch(xc, xd, mask))
        np.testing.assert_allclose(ti["score"], ji["score"], rtol=1e-5)
        assert ti["n_window"] == ji["n_window"]
        if ji["drifted"]:
            jd.append(i)
        if ti["drifted"]:
            td.append(i)
    assert jd and td == jd and jd[0] >= 8
    assert tad.edges() == jad.edges()
    assert tad.n_relearn == jad.n_relearn
    _assert_cpds_close(jad.bn, tad.bn)


def test_adaptive_structure_hillclimb_refit_matches_reference():
    """Scheduled relearns and per-batch refits from summed chunk stats
    (the refit's tree_map over dict stats) against the reference."""
    s = jsyn.bn_stream(jsyn.random_discrete_bn(4, card=2, seed=2, tree=True),
                       3000, seed=5)
    batches = [_np_batch(b) for b in s.batches(750)]
    jad = J.AdaptiveStructure(s.attributes, learner="hillclimb", window=1500,
                              max_parents=2, relearn_every=2)
    tad = P.AdaptiveStructure(_tattrs(s.attributes), learner="hillclimb",
                              window=1500, max_parents=2, relearn_every=2,
                              device=CPU)
    for xc, xd, mask in batches:
        jad.update(xc, xd, mask)
        tad.update(xc, xd, mask)
    assert tad.n_relearn == jad.n_relearn >= 2
    assert (P.undirected_edges(tad.parents)
            == J.undirected_edges(jad.parents))
    if tad.edges() == jad.edges():
        _assert_cpds_close(jad.bn, tad.bn)
    oneshot = P.fit_cpds(_tattrs(s.attributes),
                         {k: list(v) for k, v in tad.parents.items()},
                         tad._window_batch(), device=CPU)
    for name, cpd in oneshot.cpds.items():
        torch.testing.assert_close(tad.bn.cpds[name].table, cpd.table,
                                   atol=1e-6, rtol=0)


def test_adaptive_structure_rejects_bad_config():
    attrs = [TAttribute("D0", FINITE, 2)]
    with pytest.raises(ValueError, match="unknown learner"):
        P.AdaptiveStructure(attrs, learner="magic", device=CPU)
    with pytest.raises(ValueError, match="class_name"):
        P.AdaptiveStructure(attrs, learner="tan", device=CPU)


# ---------------------------------------------------------------------------
# metrics, DAG.remove_parent, bn_stream, serving the learned network
# ---------------------------------------------------------------------------


def test_skeleton_f1_and_undirected_edges_match_reference(disc6):
    jbn = disc6[0]
    tbn = bn_to_port(jbn)
    # the generator's parent sets with one edge more
    got = {c: [p.name for p in ps] for c, ps in jbn.dag.parents.items()}
    got["D5"] = sorted(set(got["D5"]) | {"D0"})
    cases = [(jbn, tbn, got, got), ({}, {}, {}, {}),
             ([("A", "B")], [("A", "B")], [("B", "C")], [("B", "C")])]
    for jt, tt, jg, tg in cases:
        assert P.undirected_edges(tt) == J.undirected_edges(jt)
        assert P.skeleton_f1(tt, tg) == J.skeleton_f1(jt, jg)


def test_dag_remove_parent_matches_reference():
    from repro.core.dag import DAG as JDAG, Variables as JVariables
    from repro_torch.core.dag import DAG as TDAG, Variables as TVariables

    out = []
    for DAG, Variables in ((JDAG, JVariables), (TDAG, TVariables)):
        vs = Variables()
        a, b, c = (vs.new_multinomial(n, 2) for n in "abc")
        dag = DAG(vs)
        dag.add_parent(c, a)
        dag.add_parent(c, b)
        dag.add_parent(b, a)
        dag.remove_parent(c, a)
        with pytest.raises(ValueError, match="no edge 'a' -> 'c'"):
            dag.remove_parent(c, a)
        out.append({k: [p.name for p in v] for k, v in dag.parents.items()})
    assert out[0] == out[1]


def test_dag_remove_parent_reopens_the_reverse_edge():
    from repro_torch.core.dag import DAG, Variables

    vs = Variables()
    a, b = vs.new_gaussian("a"), vs.new_gaussian("b")
    dag = DAG(vs)
    dag.add_parent(b, a)
    with pytest.raises(ValueError, match="cycle"):
        dag.add_parent(a, b)
    dag.remove_parent(b, a)
    dag.add_parent(a, b)
    assert [p.name for p in dag.parents["a"]] == ["b"]
    assert dag.parents["b"] == []


def test_bn_stream_marginals_match_the_network():
    """The port's sampler draws from the network: empirical marginals of
    every discrete variable within 0.02 of the exact marginals (the JAX
    package's junction tree), and of a CLG tree the means within 0.05 and
    the edge correlations within 0.05 of the reference sampler's."""
    from repro.infer_exact import JunctionTreeEngine

    jbn = jsyn.random_discrete_bn(6, card=3, max_parents=2, seed=4)
    s = tsyn.bn_stream(tsyn.random_discrete_bn(6, card=3, max_parents=2,
                                               seed=4, device=CPU),
                       20000, seed=1)
    b = s.collect()
    assert [a.name for a in s.attributes] == [f"D{i}" for i in range(6)]
    assert b.xd.dtype == np.int32 and b.xd.shape == (20000, 6)
    eng = JunctionTreeEngine(jbn)
    eng.run_inference()
    for i, v in enumerate(jbn.dag.variables):
        exact = np.asarray(eng.posterior_discrete(v))
        emp = np.bincount(b.xd[:, i], minlength=3) / 20000
        np.testing.assert_allclose(emp, exact, atol=0.02)

    ts_ = tsyn.bn_stream(tsyn.clg_tree_bn(5, seed=2, device=CPU), 20000,
                         seed=3, n_chunks=4)
    js_ = jsyn.bn_stream(jsyn.clg_tree_bn(5, seed=2), 20000, seed=3)
    tx = np.concatenate([c for c, _ in ts_.chunks()])
    jx = np.asarray(js_.collect().xc)
    assert tx.shape == jx.shape == (20000, 5)
    np.testing.assert_allclose(tx.mean(0), jx.mean(0), atol=0.05)
    np.testing.assert_allclose(np.corrcoef(tx.T), np.corrcoef(jx.T),
                               atol=0.05)


def test_learned_network_serves_like_the_reference():
    """Chow-Liu's network from both packages through each package's exact
    ``PGMQueryEngine``: posteriors within 1e-5, log-evidence within
    1e-4 (1 + |logZ|)."""
    from repro.serve.engine import PGMQueryEngine as JEngine
    from repro_torch.serve.engine import PGMQueryEngine as TEngine

    jbn = jsyn.random_discrete_bn(5, card=3, seed=0, tree=True)
    s, b = _stream(jbn, 6000, 1)
    _, jlearn = J.chow_liu(b, s.attributes)
    _, tlearn = P.chow_liu(_tbatch(b), _tattrs(s.attributes), device=CPU)
    je, te = JEngine(jlearn, mode="exact"), TEngine(tlearn, mode="exact",
                                                    device=CPU)
    g = np.random.default_rng(2)
    qs = [("D0", {"D3": int(g.integers(3)), "D4": int(g.integers(3))})
          for _ in range(6)] + [("D2", {"D1": 1})]
    jq = [je.submit(t, e) for t, e in qs]
    tq = [te.submit(t, e) for t, e in qs]
    je.flush()
    te.flush()
    for a, c in zip(tq, jq):
        assert a.done and c.done
        np.testing.assert_allclose(a.result, np.asarray(c.result), atol=1e-5)
        assert abs(a.log_evidence - c.log_evidence) <= 1e-4 * (
            1 + abs(c.log_evidence))
