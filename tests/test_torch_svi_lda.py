"""The univariate Normal-Gamma family, the SVI optimizer and LDA of the port
against the JAX package's, on the CPU from the same numpy inputs.

``jax.random`` draws cannot be reproduced, so SVI starts both packages from
the reference's initial posterior (``convert.plate_params_from_numpy``) and
LDA from the reference's topic-word Dirichlet
(``convert.lda_params_from_numpy``); the generators ``regression_stream``
and ``lda_corpus`` give the reference's arrays bit for bit.

Tolerances: the exponential-family algebra rtol 1e-5 (the same float32
formulas; the regression posterior's b, which cancels, within 1e-6 of
sum w y^2); ``stats_as_natural`` and six SVI steps rtol 1e-4 with an atol of
1e-4 of each field's largest entry (float32 sums over a few hundred
instances in another order, scaled by N/B); LDA's E-step, three
``update_model`` sweeps, an ``svi_step`` and the bound rtol 1e-4 (the
same dense arithmetic, another order of sums over V).  The reference's own
recovery tests run on the port with their own bars."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import T, data, plates  # noqa: E402
from repro.core import expfam as jef  # noqa: E402
from repro.core import svi as jsvi  # noqa: E402
from repro.core import vmp as jvmp  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.pgm_models import LDA as JLDA  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import expfam as tef  # noqa: E402
from repro_torch.core import svi as tsvi  # noqa: E402
from repro_torch.core import vmp as tvmp  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.pgm_models import LDA  # noqa: E402


def _close(got, exp, rtol=1e-5, atol=0.0):
    for g, e in zip(got, exp):
        np.testing.assert_allclose(np.asarray(g), np.asarray(e), rtol=rtol,
                                   atol=atol)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


# -- the univariate family (tests/test_expfam.py's inputs) --------------------


def test_normalgamma_family_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(2.5, 1.3, size=500).astype(np.float32)
    w = rng.random(500).astype(np.float32)
    jprior = jef.NormalGamma(*(jnp.array(v) for v in (0.0, 1.0, 1.0, 1.0)))
    tprior = tef.NormalGamma(*_t(0.0, 1.0, 1.0, 1.0))
    for weights in (np.ones(500, np.float32), w):
        js = jef.gauss_suffstats(jnp.asarray(x), jnp.asarray(weights))
        ts = tef.gauss_suffstats(*_t(x, weights))
        _close(ts, js)
        jpost = jef.normalgamma_update(jprior, js)
        tpost = tef.normalgamma_update(tprior, ts)
        _close(tpost, jpost)
        jm, tm = jef.normalgamma_moments(jpost), tef.normalgamma_moments(tpost)
        _close(tm, jm)
        _close([tef.gauss_expected_loglik(torch.from_numpy(x), tm)],
               [jef.gauss_expected_loglik(jnp.asarray(x), jm)])
    # the reference test's closed-form bars hold on the port
    tpost = tef.normalgamma_update(
        tprior, tef.gauss_suffstats(*_t(x, np.ones(500))))
    assert float(tpost.mu0) == pytest.approx(x.mean(), abs=0.02)
    assert float(tpost.b / tpost.a) == pytest.approx(x.var(), rel=0.1)
    # n == 0 is guarded
    empty = tef.normalgamma_update(tprior, tef.GaussSuffStats(*_t(0, 0, 0)))
    assert all(bool(torch.isfinite(v)) for v in empty)


def test_normalgamma_kl_matches_reference():
    vals = [(1.0, 2.0, 3.0, 2.0), (0.0, 1.0, 1.0, 1.0), (-0.5, 0.3, 7.0, 0.2)]
    for q, p in itertools.product(vals, vals):
        got = tef.normalgamma_kl(tef.NormalGamma(*_t(*q)),
                                 tef.NormalGamma(*_t(*p)))
        exp = jef.normalgamma_kl(jef.NormalGamma(*map(jnp.float32, q)),
                                 jef.NormalGamma(*map(jnp.float32, p)))
        np.testing.assert_allclose(float(got), float(exp), rtol=1e-5,
                                   atol=1e-6)
        if q == p:
            assert abs(float(got)) < 1e-5


def test_reg_family_matches_reference():
    """``reg_suffstats`` (the reference test's regression data, with one
    weight column and a [N, 2, 3] weight block), the conjugate update,
    ``reg_expected_loglik`` and ``gaussian_kl_standard``."""
    rng = np.random.default_rng(1)
    N, D = 2000, 3
    wt = np.array([0.5, -1.2, 2.0], np.float32)
    X = rng.normal(size=(N, D)).astype(np.float32)
    y = X @ wt + 0.3 * rng.normal(size=N).astype(np.float32)
    for w in (np.ones(N, np.float32), rng.random((N, 2, 3), np.float32)):
        js = jef.reg_suffstats(*(jnp.asarray(a) for a in (X, y, w)))
        ts = tef.reg_suffstats(*_t(X, y, w))
        _close(ts[:4], js[:4], rtol=1e-5, atol=1e-3)
        bshape = w.shape[1:]
        jprior = jef.MVNormalGamma(jnp.zeros(bshape + (D,)),
                                   jnp.broadcast_to(jnp.eye(D),
                                                    bshape + (D, D)),
                                   jnp.ones(bshape), jnp.ones(bshape))
        tprior = tef.MVNormalGamma(*(torch.from_numpy(np.array(a))
                                     for a in jprior))
        jpost = jef.mvnormalgamma_update(jprior, js)
        tpost = tef.mvnormalgamma_update(tprior, ts)
        _close(tpost[:3], jpost[:3], rtol=1e-5, atol=1e-5)
        # b = b0 + (syy + quad_prior - quad_post) / 2 cancels: its error is
        # the float32 sum syy's, ~1e-6 of syy
        _close([tpost.b], [jpost.b], rtol=0,
               atol=1e-6 * float(np.abs(np.asarray(js.syy)).max()))
        if w.ndim == 1:          # the reference test's recovery bar
            np.testing.assert_allclose(tpost.m.numpy(), wt, atol=0.05)
        # the expected log-likelihood under the reference's posterior; its
        # terms, of size E[lam] y^2, cancel to O(1): atol 1e-6 of that size
        jm = jef.mvnormalgamma_moments(jpost)
        got = tef.reg_expected_loglik(*_t(X, y), tef.mvnormalgamma_moments(
            tef.MVNormalGamma(*(torch.from_numpy(np.array(a))
                                for a in jpost))))
        exp = jef.reg_expected_loglik(jnp.asarray(X), jnp.asarray(y), jm)
        assert got.shape == exp.shape == (N,) + bshape
        size = float(np.asarray(jm.e_lam).max() * (y * y).max())
        _close([got], [exp], rtol=1e-5, atol=1e-6 * size)
    A = rng.normal(size=(4, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    mean = rng.normal(size=(4, 3)).astype(np.float32)
    _close([tef.gaussian_kl_standard(*_t(mean, cov))],
           [jef.gaussian_kl_standard(jnp.asarray(mean), jnp.asarray(cov))],
           rtol=1e-5, atol=1e-5)


# -- SVI --------------------------------------------------------------------

SPECS = {
    "gmm": dict(n_features=3, latent_card=2),
    "mixed": dict(n_features=5, latent_card=3,
                  discrete_features=((3, 3), (4, 2))),
    "fa": dict(n_features=6, latent_card=1, latent_dim=2),
}


def _nat_close(tn, jn, label=""):
    for name, a, b in zip(tsvi.NatParams._fields, tn, jn):
        b = np.asarray(b)
        scale = float(np.abs(b).max()) if b.size else 0.0
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * scale,
                                   err_msg=f"{label} {name}")


def _spec_data(name, n=256, seed=0):
    spec = SPECS[name]
    dm = dict(spec.get("discrete_features", ()))
    fc = spec["n_features"] - len(dm)
    return data(n, fc, len(dm), [dm[k] for k in sorted(dm)], seed=seed)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_svi_steps_match_reference(name):
    """``stats_as_natural`` of a local step, then six steps from the
    reference's initial posterior on the same minibatches: the natural
    parameters after each step."""
    jcp, jprior, jinit, tcp, tprior, tinit = plates(0, **SPECS[name])
    xc, xd, mask = _spec_data(name, n=128, seed=10)
    jst, _ = jvmp.local_step(jcp, jinit, *(jnp.asarray(a) for a in
                                           (xc, xd, mask)))
    tst, _ = tvmp.local_step(tcp, tinit, *T(xc, xd, mask))
    _nat_close(tsvi.stats_as_natural(tst), jsvi.stats_as_natural(jst),
               f"{name} stats")
    js, ts = jsvi.svi_init(jinit), tsvi.svi_init(tinit)
    assert ts.step.dtype == torch.int64 and int(ts.step) == 0
    for i in range(6):
        xc, xd, _ = _spec_data(name, n=128, seed=10 + i)
        js = jsvi.svi_step(jcp, jprior, js, jnp.asarray(xc), jnp.asarray(xd),
                           1024.0)
        ts = tsvi.svi_step(tcp, tprior, ts, xc, xd, 1024.0)
        _nat_close(ts.nat, js.nat, f"{name} step {i}")
    assert int(ts.step) == 6
    jp, tp = jsvi.svi_posterior(js), tsvi.svi_posterior(ts)
    np.testing.assert_allclose(tp.reg.m.numpy(), np.asarray(jp.reg.m),
                               rtol=1e-3, atol=1e-3)


def test_svi_converges_to_batch_posterior():
    """``test_streaming.py::test_svi_converges_to_batch_posterior`` on the
    port (the reference's initial posterior, ``PRNGKey(1)``)."""
    stream, _, _ = tsyn.gmm_stream(2000, 2, 3, seed=9)
    _, _, _, cp, prior, init = plates(1, n_features=3, latent_card=2)
    full = stream.collect()
    st = tvmp.vmp_fit(cp, prior, init, *T(full.xc, full.xd), 100, 1e-6)
    state = tsvi.svi_init(init)
    for _ in range(6):
        for b in stream.batches(250):
            state = tsvi.svi_step(cp, prior, state, b.xc, b.xd, 2000.0)
    post = tsvi.svi_posterior(state)
    m_b = np.sort(st.post.reg.m[:, :, 0].numpy().ravel())
    m_s = np.sort(post.reg.m[:, :, 0].numpy().ravel())
    np.testing.assert_allclose(m_s, m_b, atol=0.25)


def test_from_natural_roundtrip_is_solves_bits():
    """``from_natural`` solves without the info check; the bits are
    ``torch.linalg.solve``'s."""
    _, _, _, _, _, init = plates(0, **SPECS["mixed"])
    nat = tsvi.to_natural(init)
    back = tsvi.from_natural(nat)
    m = torch.linalg.solve(nat.reg_K, nat.reg_Km[..., None])[..., 0]
    assert torch.equal(back.reg.m, m)
    np.testing.assert_allclose(back.reg.b.numpy(), init.reg.b.numpy(),
                               rtol=1e-4, atol=1e-5)


# -- LDA ----------------------------------------------------------------------


def test_generators_match_reference_bit_for_bit():
    jc, jb = jsyn.lda_corpus(30, 25, 3, doc_len=40, seed=8)
    tc, tb = tsyn.lda_corpus(30, 25, 3, doc_len=40, seed=8)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tb, jb)
    js, jw = jsyn.regression_stream(100, 4, seed=3)
    ts, tw = tsyn.regression_stream(100, 4, seed=3)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(ts.collect().xc, np.asarray(js.collect().xc))
    assert [a.name for a in ts.attributes] == [a.name for a in js.attributes]


def _lda_pair(counts_shape=(40, 30), T_=3, seed=0):
    jl = JLDA(T_, counts_shape[1], seed=seed)
    tl = LDA(T_, counts_shape[1], seed=seed, device="cpu")
    tl.lam = convert.lda_params_from_numpy(jl.lam, "cpu")
    return jl, tl


def test_lda_estep_matches_reference():
    counts, _ = jsyn.lda_corpus(40, 30, 3, doc_len=60, seed=1)
    jl, tl = _lda_pair()
    jg, js = JLDA._doc_estep(jl.lam, jnp.asarray(counts), jl.alpha)
    tg, ts = LDA._doc_estep(tl.lam, torch.from_numpy(counts), tl.alpha)
    _close([tg, ts], [jg, js], rtol=1e-4, atol=1e-5)


def test_lda_estep_chunks_documents(monkeypatch):
    """Documents go through the E-step in chunks of ESTEP_ELEMS / (V T):
    the same gammas, the topic-word sums in another order."""
    from repro_torch.pgm_models import lda as tlda

    counts, _ = jsyn.lda_corpus(40, 30, 3, doc_len=60, seed=2)
    _, tl = _lda_pair()
    whole = LDA._doc_estep(tl.lam, torch.from_numpy(counts), tl.alpha)
    monkeypatch.setattr(tlda, "ESTEP_ELEMS", 7 * 30 * 3)      # 7 a chunk
    parts = LDA._doc_estep(tl.lam, torch.from_numpy(counts), tl.alpha)
    assert torch.equal(parts[0], whole[0])
    _close([parts[1]], [whole[1]], rtol=1e-6, atol=1e-6)


def test_lda_update_svi_and_bound_match_reference():
    counts, _ = jsyn.lda_corpus(40, 30, 3, doc_len=60, seed=3)
    jl, tl = _lda_pair()
    jb = jl.update_model(counts, sweeps=3)
    tb = tl.update_model(counts, sweeps=3)
    _close([tl.lam, tl.gamma], [jl.lam, jl.gamma], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb, jb, rtol=1e-4)
    for i in range(2):
        jl.svi_step(counts[i * 20:(i + 1) * 20], n_total=400)
        tl.svi_step(counts[i * 20:(i + 1) * 20], n_total=400)
        _close([tl.lam], [jl.lam], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        float(tl.perplexity_bound(counts[:25])),
        float(jl.perplexity_bound(jnp.asarray(counts[:25]))), rtol=1e-4)
    _close([tl.topics(), tl.doc_topics(counts[:5])],
           [jl.topics(), jl.doc_topics(counts[:5])], rtol=1e-4, atol=1e-5)


def test_lda_topic_recovery():
    """``test_pgm_models.py::test_lda_topic_recovery`` on the port."""
    counts, beta = tsyn.lda_corpus(300, 50, 4, doc_len=150, seed=8)
    lda = LDA(4, 50, seed=0, device="cpu")
    lda.update_model(counts, sweeps=30)
    top = lda.topics()
    score = max(sum(float(top[p[t]] @ beta[t]) for t in range(4))
                for p in itertools.permutations(range(4)))
    perfect = sum(float(beta[t] @ beta[t]) for t in range(4))
    assert score > 0.75 * perfect, (score, perfect)
    dt = lda.doc_topics(counts[:10])
    np.testing.assert_allclose(dt.sum(-1), 1.0, atol=1e-4)


def test_lda_svi_stream():
    """``test_pgm_models.py::test_lda_svi_stream`` on the port."""
    counts, _ = tsyn.lda_corpus(200, 40, 3, seed=9)
    lda = LDA(3, 40, seed=0, device="cpu")
    for i in range(0, 200, 20):
        lda.svi_step(counts[i:i + 20], n_total=200)
    assert np.isfinite(float(lda.perplexity_bound(counts[:50])))


def test_lda_init_is_a_gamma_draw_on_the_device():
    a = LDA(4, 500, seed=3, device="cpu")
    b = LDA(4, 500, seed=3, device="cpu")
    assert torch.equal(a.lam, b.lam)
    g = (a.lam - a.eta) * 100.0                  # Gamma(100, 1) draws
    assert abs(float(g.mean()) - 100.0) < 1.0
    assert abs(float(g.var()) - 100.0) < 10.0
