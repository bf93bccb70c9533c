"""``repro_torch.core.vmp`` / ``expfam`` / ``svi`` against ``repro.core`` on
the CPU, from the same numpy inputs and the same (carried-over) posterior.

Tolerances: local-step statistics rtol 1e-4 / atol 5e-4 (as the reference's
own backend-parity tests: float32 sums over a few hundred instances in
another order); responsibilities atol 1e-5; fitted posteriors rtol/atol
1e-3 (differences of ~1e-6 compound over the sweeps)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import (J, T, assert_params_close,  # noqa: E402
                           assert_stats_close, data, plates)
from repro.core import expfam as jef  # noqa: E402
from repro.core import svi as jsvi  # noqa: E402
from repro.core import vmp as jvmp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import expfam as tef  # noqa: E402
from repro_torch.core import svi as tsvi  # noqa: E402
from repro_torch.core import vmp as tvmp  # noqa: E402

MIXED = dict(n_features=5, latent_card=3, discrete_features=((3, 3), (4, 2)))


def _both_local(spec, xc, xd, mask, rf=None, chunk=None, seed=0,
                latent_mask=None):
    jcp, _, jinit, tcp, _, tinit = plates(seed, latent_mask, **spec)
    js, jr = jvmp.local_step(jcp, jinit, *J(xc, xd, mask, rf))
    ts, tr = tvmp.local_step(tcp, tinit, *T(xc, xd, mask, rf), chunk=chunk)
    return js, jr, ts, tr


@pytest.mark.parametrize("chunk", [None, 256, 100])   # 100: ragged chunk
def test_local_step_mixed_plate_masked_tail(chunk):
    xc, xd, mask = data(600, 3, 2, (3, 2), seed=1, masked_tail=75)
    js, jr, ts, tr = _both_local(MIXED, xc, xd, mask, chunk=chunk)
    assert_stats_close(js, ts, label=f"chunk={chunk}")
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)


@pytest.mark.parametrize("L,latent_card", [(1, 0), (2, 3), (8, 2)])
@pytest.mark.parametrize("chunk", [None, 128])
def test_local_step_latent_dim(L, latent_card, chunk):
    spec = dict(n_features=4, latent_card=latent_card, latent_dim=L)
    xc, xd, mask = data(300, 4, seed=4, masked_tail=40)
    js, jr, ts, tr = _both_local(spec, xc, xd, mask, chunk=chunk, seed=3)
    assert ts.reg.sxx_hh is not None                  # lazy [K, L, L] form
    assert tuple(ts.reg.sxx_hh.shape) == tuple(js.reg.sxx_hh.shape)
    assert_stats_close(js, ts, label=f"L={L}")
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)


def test_local_step_pure_discrete():
    spec = dict(n_features=2, latent_card=2,
                discrete_features=((0, 3), (1, 2)))
    xc, xd, mask = data(200, 0, 2, (3, 2), seed=5)
    js, jr, ts, tr = _both_local(spec, xc, xd, mask)
    assert float(ts.reg.sxx.abs().sum()) == 0.0       # inert regression
    assert_stats_close(js, ts, label="F==0")
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)


def test_local_step_nonuniform_latent_mask_dense_fallback():
    spec = dict(n_features=3, latent_card=2, latent_dim=3)
    xc, xd, mask = data(150, 3, seed=6)
    js, jr, ts, tr = _both_local(spec, xc, xd, mask, seed=2,
                                 latent_mask=np.eye(3, dtype=np.float32))
    assert ts.reg.sxx_hh is None and js.reg.sxx_hh is None
    assert_stats_close(js, ts, label="nonuniform mask")


@pytest.mark.parametrize("chunk", [None, 128])
def test_local_step_r_fixed(chunk):
    xc, xd, mask = data(600, 3, 2, (3, 2), seed=7, masked_tail=75)
    rf = np.eye(3, dtype=np.float32)[np.random.default_rng(9).integers(
        0, 3, 600)]
    js, jr, ts, tr = _both_local(MIXED, xc, xd, mask, rf=rf, chunk=chunk)
    assert_stats_close(js, ts, label="r_fixed")
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)


def test_local_step_observed_parents():
    spec = dict(n_features=3, latent_card=2,
                feature_parents=((), (0,), (0, 1)))
    xc, xd, mask = data(300, 3, seed=8)
    js, _, ts, _ = _both_local(spec, xc, xd, mask)
    assert_stats_close(js, ts, label="parents")


def test_compile_plate_matches_reference():
    for spec, lm in [(MIXED, None),
                     (dict(n_features=3, latent_card=2,
                           feature_parents=((), (0,), (0, 1))), None),
                     (dict(n_features=3, latent_card=2, latent_dim=3),
                      np.eye(3, dtype=np.float32))]:
        jcp, jprior, _, tcp, tprior, _ = plates(0, lm, **spec)
        assert tuple(tcp.layout) == tuple(jcp.layout)
        for name in ("parent_idx", "parent_mask", "latent_mask", "card_mask"):
            np.testing.assert_array_equal(getattr(tcp, name).numpy(),
                                          np.asarray(getattr(jcp, name)))
        np.testing.assert_array_equal(tvmp.design_mask(tcp).numpy(),
                                      np.asarray(jvmp.design_mask(jcp)))
        assert tcp.hh_shared == jvmp._latent_hh_shared(jcp)
        ported = tvmp.default_prior(tcp)
        assert_params_close(jprior, ported, rtol=0, atol=0)


def test_expfam_moments_and_kls_match_reference():
    _, jprior, jinit, _, tprior, tinit = plates(
        1, None, n_features=4, latent_card=3, latent_dim=2)
    jm = jef.mvnormalgamma_moments(jinit.reg)
    tm = tef.mvnormalgamma_moments(tinit.reg)
    for a, b in zip(jm, tm):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        tef.mvnormalgamma_kl(tinit.reg, tprior.reg).numpy(),
        np.asarray(jef.mvnormalgamma_kl(jinit.reg, jprior.reg)),
        rtol=1e-4, atol=1e-5)
    alpha = np.random.default_rng(0).uniform(0.5, 3, (4, 5)).astype(
        np.float32)
    np.testing.assert_allclose(
        tef.dirichlet_kl(tef.Dirichlet(*T(alpha)),
                         tef.Dirichlet(*T(alpha[::-1]))).numpy(),
        np.asarray(jef.dirichlet_kl(jef.Dirichlet(jnp.asarray(alpha)),
                                    jef.Dirichlet(jnp.asarray(alpha[::-1])))),
        rtol=1e-4, atol=1e-5)
    logp = np.log(np.random.default_rng(1).dirichlet(np.ones(4), 6)).astype(
        np.float32)
    np.testing.assert_allclose(
        tef.categorical_entropy(*T(logp)).numpy(),
        np.asarray(jef.categorical_entropy(jnp.asarray(logp))), rtol=1e-5)


def test_natural_coordinates_match_reference():
    _, _, jinit, _, _, tinit = plates(2, None, **MIXED)
    for a, b in zip(jsvi.to_natural(jinit), tsvi.to_natural(tinit)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    back = tsvi.from_natural(tsvi.to_natural(tinit))
    assert_params_close(jinit, back, rtol=1e-4, atol=1e-5)


def test_global_update_and_elbo_match_reference():
    jcp, jprior, jinit, tcp, tprior, tinit = plates(0, None, **MIXED)
    xc, xd, mask = data(400, 3, 2, (3, 2), seed=3, masked_tail=50)
    js, _ = jvmp.local_step(jcp, jinit, *J(xc, xd, mask))
    ts, _ = tvmp.local_step(tcp, tinit, *T(xc, xd, mask))
    jpost, tpost = jvmp.global_update(jprior, js), tvmp.global_update(tprior,
                                                                       ts)
    assert_params_close(jpost, tpost, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        float(tvmp.elbo(tcp, tprior, tpost, ts)),
        float(jvmp.elbo(jcp, jprior, jpost, js)), rtol=1e-4)


def test_lazy_and_dense_forms_feed_the_same_update():
    """The einsum backend keeps the leaf-shared latent block once as
    [K, L, L]; reg_dense rebuilds the dense [F, K, D, D] exactly."""
    jcp, jprior, jinit, tcp, tprior, tinit = plates(
        0, None, n_features=5, latent_card=3, latent_dim=4)
    xc, xd, mask = data(200, 5, seed=1)
    ts, _ = tvmp.local_step(tcp, tinit, *T(xc, xd, mask))
    lay = tcp.layout
    assert tuple(ts.reg.sxx.shape) == (lay.F, lay.K, 1 + lay.P, lay.D)
    dense = tef.reg_dense(ts.reg).sxx
    torch.testing.assert_close(dense, dense.transpose(-1, -2), rtol=0,
                               atol=1e-6)
    js, _ = jvmp.local_step(jcp, jinit, *J(xc, xd, mask))
    np.testing.assert_allclose(dense.numpy(),
                               np.asarray(jef.reg_dense(js.reg).sxx),
                               rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("spec,f,fd,cards", [
    (dict(n_features=3, latent_card=2), 3, 0, ()),
    (MIXED, 3, 2, (3, 2)),
    (dict(n_features=4, latent_card=2, latent_dim=2), 4, 0, ()),
])
def test_vmp_fit_with_injected_posterior(spec, f, fd, cards):
    """tol = 0 so both run the same number of sweeps."""
    jcp, jprior, jinit, tcp, tprior, tinit = plates(0, None, **spec)
    xc, xd, _ = data(500, f, fd, cards, seed=11)
    jst = jvmp.vmp_fit(jcp, jprior, jinit, *J(xc, xd), 8, 0.0)
    tst = tvmp.vmp_fit(tcp, tprior, tinit, *T(xc, xd), 8, 0.0)
    assert tst.sweep == int(jst.sweep)
    assert_params_close(jst.post, tst.post, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(tst.elbo), float(jst.elbo), rtol=1e-4)


def test_posterior_z_matches_reference():
    jcp, _, jinit, tcp, _, tinit = plates(0, None, **MIXED)
    xc, xd, _ = data(300, 3, 2, (3, 2), seed=12)
    jz = jvmp.posterior_z(jcp, jinit, *J(xc, xd))
    tz = tvmp.posterior_z(tcp, tinit, *T(xc, xd), chunk=128)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5)


def test_backend_follows_device_and_cuda_needs_a_card():
    _, _, _, tcp, _, tinit = plates(0, None, n_features=2, latent_card=2)
    xc, xd, mask = data(50, 2, seed=0)
    tvmp.local_step(tcp, tinit, *T(xc, xd, mask))          # einsum on CPU
    with pytest.raises(ValueError, match="CUDA"):
        tvmp.local_step(tcp, tinit, *T(xc, xd, mask), backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        tvmp.local_step(tcp, tinit, *T(xc, xd, mask), backend="pallas")


def test_symmetry_broken_is_seeded():
    _, _, _, _, tprior, _ = plates(0, None, **MIXED)
    a = tvmp.symmetry_broken(tprior, torch.Generator().manual_seed(3))
    b = tvmp.symmetry_broken(tprior, torch.Generator().manual_seed(3))
    c = tvmp.symmetry_broken(tprior, torch.Generator().manual_seed(4))
    assert torch.equal(a.reg.m, b.reg.m) and torch.equal(a.disc.alpha,
                                                         b.disc.alpha)
    assert not torch.equal(a.reg.m, c.reg.m)
    assert torch.equal(a.reg.K, tprior.reg.K)


def test_convert_round_trip():
    _, _, jinit, _, _, tinit = plates(5, None, **MIXED)
    back = convert.to_numpy(tinit)
    assert_params_close(jinit, convert.plate_params_from_numpy(back, "cpu"),
                        rtol=0, atol=0)
