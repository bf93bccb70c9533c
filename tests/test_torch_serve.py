"""The port's serving tier (``repro_torch.serve``) and its model-layer
entry to exact inference (``Model.posterior_exact``) on the CPU, against
the JAX package's ``PGMQueryEngine`` and models.

Tolerances: exact posteriors within 1e-5 of the JAX engine (1e-6 between
two runs of the port), ``log_evidence`` within 1e-4; ``posterior_exact``
within 1e-5 of the JAX model's on the same posterior and, on the JAX
test's mixture, within 1e-3 of ``posterior_z`` (that test's bound: the
point estimate against VMP's expected log-likelihoods); vmp mode within
1e-5 of ``posterior_z``.
"""

import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import bn_to_port  # noqa: E402
from repro.core import dag as jdag  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.pgm_models import GaussianMixture as JGMM  # noqa: E402
from repro.pgm_models import NaiveBayes as JNB  # noqa: E402
from repro.serve.engine import PGMQueryEngine as JQE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import pgm_models as tpm  # noqa: E402
from repro_torch.data import stream as tstream  # noqa: E402
from repro_torch.serve.engine import PGMQueryEngine  # noqa: E402
from repro_torch.serve.plan import PlanCache, PlanKey  # noqa: E402

torch.set_num_threads(1)


def _key(v, schema=("a",), B=4):
    return PlanKey(v, "jt-discrete", schema, (B,), ("float32",))


# -- PlanCache ----------------------------------------------------------------


def test_plan_cache_lru_counters_and_invalidate():
    cache = PlanCache(max_plans=2)
    built = []
    for v in (0, 1):
        cache.get(_key(v), lambda v=v: built.append(v) or (lambda: v))
    assert cache.get(_key(0)).run() == 0          # hit; refreshes key 0
    cache.get(_key(2), lambda: (lambda: 2))       # evicts key 1 (LRU)
    assert _key(1) not in cache and _key(0) in cache
    st = cache.stats()
    assert (st["hits"], st["misses"], st["evictions"], st["size"]) == \
        (1, 3, 1, 2)
    assert cache.get(_key(9)) is None and cache.stats()["misses"] == 4
    assert cache.peek(_key(0)).runs == 1 and cache.peek(_key(0)).hits == 1
    assert cache.invalidate(0) == 1 and len(cache) == 1
    assert cache.invalidate() == 1 and len(cache) == 0
    assert built == [0, 1]
    with pytest.raises(ValueError):
        PlanCache(max_plans=0)


def test_plan_cache_threads_and_failed_builds():
    cache = PlanCache()

    def boom():
        raise RuntimeError("build failed")

    with pytest.raises(RuntimeError):
        cache.get(_key(1), boom)
    assert _key(1) not in cache                   # no entry on failure
    out = []
    ts = [threading.Thread(target=lambda: out.append(
        cache.get(_key(5), lambda: (lambda: 5)))) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len({id(p) for p in out}) == 1 and len(cache) == 1


# -- PGMQueryEngine, exact mode --------------------------------------------------


def _clg():
    vs = jdag.Variables()
    Z = vs.new_multinomial("Z", 2)
    X1, X2 = vs.new_gaussian("X1"), vs.new_gaussian("X2")
    W = vs.new_multinomial("W", 3)
    dag = jdag.DAG(vs)
    for v in (X1, X2, W):
        dag.add_parent(v, Z)
    return jdag.BayesianNetwork(dag, {
        "Z": jdag.MultinomialCPD(jnp.array([0.3, 0.7])),
        "X1": jdag.CLGCPD(jnp.array([0.0, 4.0]), jnp.zeros((2, 0)),
                          jnp.array([1.0, 1.0])),
        "X2": jdag.CLGCPD(jnp.array([-2.0, 2.0]), jnp.zeros((2, 0)),
                          jnp.array([0.5, 2.0])),
        "W": jdag.MultinomialCPD(jnp.array([[0.2, 0.5, 0.3],
                                            [0.6, 0.1, 0.3]]))})


def _queries():
    g = np.random.default_rng(0)
    out = []
    for i in range(11):
        kind = i % 3
        if kind == 0:
            ev = {"X1": float(g.normal(2, 2)), "X2": float(g.normal())}
        elif kind == 1:
            ev = {"X1": float(g.normal(2, 2)), "W": float(g.integers(3))}
        else:
            ev = {"X2": float(g.normal())}
        out.append(("W" if i % 4 == 3 and "W" not in ev else "Z", ev))
    return out


def test_exact_mode_matches_reference_in_submission_order():
    jbn = _clg()
    ref = JQE(jbn, mode="exact", use_pallas=False)
    eng = PGMQueryEngine(bn_to_port(jbn), mode="exact", device="cpu")
    qs = _queries()
    jq = [ref.submit(t, ev) for t, ev in qs]
    tq = [eng.submit(t, ev) for t, ev in qs]
    jd, td = ref.flush(), eng.flush()
    assert [q.qid for q in td] == list(range(len(qs)))
    assert all(q.done for q in td) and not eng._queue
    for a, b in zip(jq, tq):
        assert b.result.shape == a.result.shape
        np.testing.assert_allclose(b.result, a.result, atol=1e-5)
        np.testing.assert_allclose(b.log_evidence, a.log_evidence, atol=1e-4)
    # three schemas -> three plans, reused by a second flush
    assert len(eng.plans) == 3
    for t, ev in qs:
        eng.submit(t, ev)
    again = eng.flush()
    assert len(eng.plans) == 3 and eng.plans.stats()["hits"] >= 3
    for a, b in zip(tq, again):
        np.testing.assert_array_equal(a.result, b.result)


def test_pad_pow2_leaves_real_rows_unchanged():
    bn = bn_to_port(_clg())
    g = np.random.default_rng(1)
    evs = [{"X1": float(x), "X2": float(y)}
           for x, y in g.normal(size=(5, 2))]
    res = {}
    for pad in (False, True):
        eng = PGMQueryEngine(bn, mode="exact", device="cpu", pad_pow2=pad)
        qs = [eng.submit("Z", ev) for ev in evs]
        eng.flush()
        res[pad] = np.stack([q.result for q in qs])
        assert eng.plans.keys()[0].batch_shape == ((8,) if pad else (5,))
    np.testing.assert_allclose(res[True], res[False], atol=1e-6)


def test_set_model_bumps_network_version():
    jbn = _clg()
    eng = PGMQueryEngine(bn_to_port(jbn), mode="exact", device="cpu")
    eng.submit("Z", {"X1": 1.0})
    eng.flush()
    eng.set_model(bn_to_port(jbn))
    assert eng.network_version == 1 and eng._jt.network_version == 1
    eng.submit("Z", {"X1": 1.0})
    eng.flush()
    assert sorted(k.network_version for k in eng.plans.keys()) == [0, 1]
    eng.set_model(bn_to_port(jbn), network_version=7)
    assert eng._jt.network_version == 7


def test_unported_modes_and_mesh_raise():
    bn = bn_to_port(_clg())
    # importance mode is ported: it samples on the engine's device
    eng = PGMQueryEngine(bn, mode="importance", n_samples=64, device="cpu")
    q = eng.submit("Z", {"X1": 1.0})
    eng.flush()
    assert q.done and q.result.shape == (2,)
    assert q.result.sum() == pytest.approx(1.0, abs=1e-6)
    # temporal mode is ported: a network is not a temporal model
    with pytest.raises(ValueError, match="HMM-family"):
        PGMQueryEngine(bn, mode="temporal", device="cpu")
    # a mesh is wired for mode="vmp" only, as in the reference; there it
    # must be a DeviceMesh
    with pytest.raises(ValueError, match="mode='vmp'"):
        PGMQueryEngine(bn, mode="exact", device="cpu", mesh=object())
    gmm = tpm.GaussianMixture([tstream.Attribute("X0", tstream.REAL)],
                              n_states=2, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        PGMQueryEngine(gmm, mode="vmp", mesh=object())
    with pytest.raises(ValueError, match="unknown mode"):
        PGMQueryEngine(bn, mode="nope", device="cpu")
    with pytest.raises(ValueError, match="plate Model"):
        PGMQueryEngine(bn, mode="vmp", device="cpu")


def test_discrete_network_serving_matches_reference():
    jbn = jsyn.random_discrete_bn(10, card=3, max_parents=2, seed=3)
    ref = JQE(jbn, mode="exact", use_pallas=False, pad_pow2=True)
    eng = PGMQueryEngine(bn_to_port(jbn), mode="exact", device="cpu",
                         pad_pow2=True)
    g = np.random.default_rng(2)
    for _ in range(6):
        ev = {"D9": float(g.integers(3)), "D4": float(g.integers(3))}
        ref.submit("D0", ev)
        eng.submit("D0", ev)
    for a, b in zip(ref.flush(), eng.flush()):
        np.testing.assert_allclose(b.result, a.result, atol=1e-5)
        np.testing.assert_allclose(b.log_evidence, a.log_evidence, atol=1e-4)


# -- the model layer: vmp mode and posterior_exact ---------------------------


@functools.lru_cache(maxsize=None)
def _fitted(kind="gmm"):
    """A model fitted by the JAX package on its own test data
    (``test_posterior_exact_matches_vmp_on_gmm``: ``gmm_stream(600, 3, 4,
    seed=1)``), plus a card-3 discrete leaf that follows the component for
    ``kind="nb"``; the port's model carries the same posterior."""
    from repro.data.stream import Batch as JBatch

    s, _, z = jsyn.gmm_stream(600, 3, 4, seed=1)
    b = s.collect()
    xc, n = np.array(b.xc), len(z)
    g = np.random.default_rng(4)
    attrs = [tstream.Attribute(f"X{i}", tstream.REAL) for i in range(4)]
    if kind == "gmm":
        xd = np.zeros((n, 0), np.int32)
        jm = JGMM(_jattrs(attrs), n_states=3, seed=0)
        tm = tpm.GaussianMixture(attrs, n_states=3, device="cpu")
    else:
        attrs.append(tstream.Attribute("D0", tstream.FINITE, 3))
        xd = ((z + (g.random(n) < 0.2)) % 3).astype(np.int32)[:, None]
        jm = JNB(_jattrs(attrs), n_states=3, seed=0)
        tm = tpm.NaiveBayes(attrs, n_states=3, device="cpu")
    jm.update_model(JBatch(jnp.asarray(xc), jnp.asarray(xd),
                           jnp.ones(n, jnp.float32)))
    tm.posterior = convert.plate_params_from_numpy(jm.posterior, "cpu")
    return jm, tm, xc, xd


def _jattrs(attrs):
    from repro.data import stream as js

    return [js.Attribute(a.name, a.kind, a.card) for a in attrs]


@pytest.mark.parametrize("kind", ["gmm", "nb"])
def test_posterior_exact_matches_reference_and_posterior_z(kind):
    jm, tm, xc, xd = _fitted(kind)
    batch = tstream.Batch(xc, xd, np.ones(len(xc), np.float32))
    got = tm.posterior_exact(batch)
    from repro.data.stream import Batch as JBatch

    exp = np.asarray(jm.posterior_exact(JBatch(
        jnp.asarray(xc), jnp.asarray(xd), jnp.ones(len(xc), jnp.float32)),
        use_pallas=False))
    assert got.shape == exp.shape == (len(xc), 3)
    np.testing.assert_allclose(got.numpy(), exp, atol=1e-5)
    if kind == "gmm":            # the JAX test's case and bound
        np.testing.assert_allclose(got.numpy(),
                                   tm.posterior_z(batch).numpy(), atol=1e-3)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    jb, tb = jm.to_bayesian_network(), tm.to_bayesian_network()
    for v in jb.order:
        for f in ("table", "alpha", "beta", "sigma2"):
            if hasattr(jb.cpds[v.name], f):
                np.testing.assert_allclose(
                    getattr(tb.cpds[v.name], f).numpy(),
                    np.asarray(getattr(jb.cpds[v.name], f)), rtol=1e-6,
                    atol=1e-7)
    one = tm.posterior_exact({f"X{i}": float(xc[0, i]) for i in range(4)}
                             | ({"X4": int(xd[0, 0])} if kind == "nb"
                                else {}))
    np.testing.assert_allclose(one.numpy(), got[0].numpy(), atol=1e-6)


def test_vmp_mode_matches_posterior_z_and_validates():
    _, tm, xc, _ = _fitted("gmm")
    eng = PGMQueryEngine(tm, mode="vmp")
    qs = [eng.submit("Z", {f"X{i}": float(xc[b, i]) for i in range(4)})
          for b in range(5)]
    done = eng.flush()
    assert len(done) == 5 and all(q.done for q in done)
    expect = tm.posterior_z(xc).numpy()[:5]
    np.testing.assert_allclose(np.stack([q.result for q in qs]), expect,
                               atol=1e-5)
    assert eng.plans.keys()[0].batch_shape == (8,)
    with pytest.raises(ValueError, match="missing"):
        eng.submit("Z", {"X0": 0.0})
    with pytest.raises(ValueError, match="latent Z"):
        eng.submit("X0", {f"X{i}": 0.0 for i in range(4)})
    assert not eng._queue
