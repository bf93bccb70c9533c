"""Conjugate exponential-family algebra in natural-parameter form
(counterpart of ``repro.core.expfam``): Bayesian updating (paper Eq. 3) is
addition of expected sufficient statistics to natural parameters.

Families: Dirichlet (mixture weights, multinomial leaves), the univariate
Normal-Gamma (a Gaussian's mean and precision), the multivariate
Normal-Gamma of the CLG node (regression weights and noise precision), and
Gaussian helpers for local continuous latents.  All functions are plain
tensor code; leading axes broadcast.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor

LOG2PI = math.log(2.0 * math.pi)
digamma = torch.special.digamma
gammaln = torch.lgamma


# ---------------------------------------------------------------------------
# Dirichlet / Categorical
# ---------------------------------------------------------------------------


class Dirichlet(NamedTuple):
    """Dirichlet in pseudo-count form; natural param = alpha - 1."""

    alpha: Tensor  # [..., K]


def dirichlet_expected_logprob(d: Dirichlet) -> Tensor:
    """E[log pi_k] under Dirichlet(alpha)."""
    return digamma(d.alpha) - digamma(d.alpha.sum(-1, keepdim=True))


def dirichlet_mean(d: Dirichlet) -> Tensor:
    return d.alpha / d.alpha.sum(-1, keepdim=True)


def dirichlet_logZ(d: Dirichlet) -> Tensor:
    return gammaln(d.alpha).sum(-1) - gammaln(d.alpha.sum(-1))


def dirichlet_kl(q: Dirichlet, p: Dirichlet) -> Tensor:
    """KL(q || p), summed over the last axis."""
    elp = dirichlet_expected_logprob(q)
    return (-dirichlet_logZ(q) + dirichlet_logZ(p)
            + ((q.alpha - p.alpha) * elp).sum(-1))


def dirichlet_update(prior: Dirichlet, counts: Tensor) -> Dirichlet:
    return Dirichlet(prior.alpha + counts)


def gamma_kl(a_q, b_q, a_p, b_p) -> Tensor:
    return ((a_q - a_p) * digamma(a_q) - gammaln(a_q) + gammaln(a_p)
            + a_p * (torch.log(b_q) - torch.log(b_p))
            + a_q * (b_p - b_q) / b_q)


# ---------------------------------------------------------------------------
# Normal-Gamma / univariate Gaussian (unknown mean and precision)
# ---------------------------------------------------------------------------


class NormalGamma(NamedTuple):
    """p(mu, lam) = N(mu | mu0, (kappa lam)^-1) Gamma(lam | a, b)."""

    mu0: Tensor
    kappa: Tensor
    a: Tensor
    b: Tensor


class GaussSuffStats(NamedTuple):
    """n = sum_i w_i, sx = sum_i w_i x_i, sx2 = sum_i w_i x_i^2."""

    n: Tensor
    sx: Tensor
    sx2: Tensor


def gauss_suffstats(x: Tensor, w: Tensor) -> GaussSuffStats:
    """x: [N, ...], w: [N, ...] responsibilities; reduces over axis 0."""
    return GaussSuffStats(n=w.sum(0), sx=(w * x).sum(0),
                          sx2=(w * x * x).sum(0))


def normalgamma_update(prior: NormalGamma, s: GaussSuffStats) -> NormalGamma:
    n = s.n
    kappa_n = prior.kappa + n
    mu_n = (prior.kappa * prior.mu0 + s.sx) / kappa_n
    a_n = prior.a + 0.5 * n
    # scatter around the weighted mean, guarded for n == 0
    xbar = s.sx / torch.clamp(n, min=1e-12)
    scatter = s.sx2 - n * xbar * xbar
    b_n = prior.b + 0.5 * (scatter + prior.kappa * n * (xbar - prior.mu0) ** 2
                           / kappa_n)
    return NormalGamma(mu_n, kappa_n, a_n, b_n)


class GaussMoments(NamedTuple):
    """Expected natural statistics of the Gaussian under a NormalGamma."""

    e_lam: Tensor      # E[lambda]
    e_loglam: Tensor   # E[log lambda]
    e_lammu: Tensor    # E[lambda mu]
    e_lammu2: Tensor   # E[lambda mu^2]


def normalgamma_moments(q: NormalGamma) -> GaussMoments:
    e_lam = q.a / q.b
    return GaussMoments(e_lam=e_lam, e_loglam=digamma(q.a) - torch.log(q.b),
                        e_lammu=e_lam * q.mu0,
                        e_lammu2=1.0 / q.kappa + e_lam * q.mu0 * q.mu0)


def gauss_expected_loglik(x: Tensor, m: GaussMoments) -> Tensor:
    """E_q[log N(x | mu, lambda^-1)] -- the VMP message of a Gaussian child."""
    return 0.5 * (m.e_loglam - LOG2PI - m.e_lam * x * x + 2.0 * x * m.e_lammu
                  - m.e_lammu2)


def normalgamma_kl(q: NormalGamma, p: NormalGamma) -> Tensor:
    """KL(q || p), elementwise."""
    e_lam = q.a / q.b
    kl_mu = 0.5 * (torch.log(q.kappa / p.kappa) + p.kappa / q.kappa - 1.0
                   + p.kappa * e_lam * (q.mu0 - p.mu0) ** 2)
    return kl_mu + gamma_kl(q.a, q.b, p.a, p.b)


# ---------------------------------------------------------------------------
# Multivariate Normal-Gamma — the CLG node (paper Eq. 2)
# ---------------------------------------------------------------------------


class MVNormalGamma(NamedTuple):
    """p(w, lam) = N(w | m, (lam K)^-1) Gamma(lam | a, b); w in R^D."""

    m: Tensor  # [..., D]
    K: Tensor  # [..., D, D]
    a: Tensor  # [...]
    b: Tensor  # [...]


class RegSuffStats(NamedTuple):
    """Weighted regression suff stats (the d-VMP message of a CLG node).

    With ``sxx_hh`` set, ``sxx`` holds only the top [..., Do, D] rows and
    ``sxx_hh`` the leaf-shared [K, L, L] latent-latent block, once;
    :func:`reg_dense` rebuilds the full symmetric [..., D, D] matrix."""

    sxx: Tensor
    sxy: Tensor
    syy: Tensor
    n: Tensor
    sxx_hh: Optional[Tensor] = None


def reg_dense(s: RegSuffStats) -> RegSuffStats:
    """Expand the lazy latent-block form to the full [..., D, D] sxx."""
    if s.sxx_hh is None:
        return s
    D, Do = s.sxx.shape[-1], s.sxx.shape[-2]
    L = D - Do
    oh = s.sxx[..., :, Do:]                               # [..., Do, L]
    hh = s.sxx_hh.expand(tuple(s.sxx.shape[:-2]) + (L, L))
    bot = torch.cat([oh.transpose(-1, -2), hh], dim=-1)
    return RegSuffStats(torch.cat([s.sxx, bot], dim=-2), s.sxy, s.syy, s.n,
                        None)


def reg_suffstats(x: Tensor, y: Tensor, w: Tensor) -> RegSuffStats:
    """x: [N, D] features, y: [N] target, w: [N, ...] responsibilities;
    the stats' trailing batch axes are w's."""
    sxx = torch.einsum("nd,ne,n...->...de", x, x, w)
    sxy = torch.einsum("nd,n,n...->...d", x, y, w)
    syy = torch.einsum("n,n,n...->...", y, y, w)
    return RegSuffStats(sxx, sxy, syy, w.sum(0))


def mvnormalgamma_update(prior: MVNormalGamma, s: RegSuffStats
                         ) -> MVNormalGamma:
    s = reg_dense(s)                     # the lazy latent block expands here
    K_n = prior.K + s.sxx
    km = torch.einsum("...de,...e->...d", prior.K, prior.m)
    rhs = km + s.sxy
    # the _ex forms skip the info check, which on a card is a host sync; a
    # singular K_n (never: prior K + a PSD sum) would give non-finite m_n,
    # which the streaming quarantine catches
    m_n = torch.linalg.solve_ex(K_n, rhs[..., None],
                                check_errors=False)[0][..., 0]
    a_n = prior.a + 0.5 * s.n
    quad_prior = torch.einsum("...d,...d->...", prior.m, km)
    quad_post = torch.einsum("...d,...de,...e->...", m_n, K_n, m_n)
    b_n = prior.b + 0.5 * (s.syy + quad_prior - quad_post)
    b_n = torch.clamp(b_n, min=1e-10)    # b must stay positive
    return MVNormalGamma(m_n, K_n, a_n, b_n)


class RegMoments(NamedTuple):
    e_lam: Tensor      # [...]
    e_loglam: Tensor   # [...]
    e_lamw: Tensor     # [..., D]     E[lam w]
    e_lamww: Tensor    # [..., D, D]  E[lam w w^T]


def mvnormalgamma_moments(q: MVNormalGamma) -> RegMoments:
    e_lam = q.a / q.b
    K_inv = torch.linalg.inv_ex(q.K, check_errors=False)[0]
    return RegMoments(
        e_lam=e_lam,
        e_loglam=digamma(q.a) - torch.log(q.b),
        e_lamw=e_lam[..., None] * q.m,
        e_lamww=K_inv + e_lam[..., None, None]
        * (q.m[..., :, None] * q.m[..., None, :]),
    )


def reg_expected_loglik(x: Tensor, y: Tensor, m: RegMoments) -> Tensor:
    """E_q[log N(y | w^T x, lam^-1)] for x: [N, D], y: [N]; the moments'
    batch axes broadcast to [N, ...]."""
    quad = torch.einsum("nd,...de,ne->n...", x, m.e_lamww, x)
    lin = torch.einsum("nd,...d->n...", x, m.e_lamw)
    y_ = y.reshape(tuple(y.shape) + (1,) * (quad.ndim - 1))
    return 0.5 * (m.e_loglam - LOG2PI - m.e_lam * y_ * y_ + 2.0 * y_ * lin
                  - quad)


def mvnormalgamma_kl(q: MVNormalGamma, p: MVNormalGamma) -> Tensor:
    """KL(q || p), elementwise over batch axes."""
    D = q.m.shape[-1]
    e_lam = q.a / q.b
    Kq_inv = torch.linalg.inv(q.K)
    dm = q.m - p.m
    _, logdet_q = torch.linalg.slogdet(q.K)
    _, logdet_p = torch.linalg.slogdet(p.K)
    tr = torch.einsum("...de,...ed->...", p.K, Kq_inv)
    quad = e_lam * torch.einsum("...d,...de,...e->...", dm, p.K, dm)
    kl_w = 0.5 * (logdet_q - logdet_p + tr + quad - D)
    return kl_w + gamma_kl(q.a, q.b, p.a, p.b)


def gaussian_kl_standard(mean: Tensor, cov: Tensor) -> Tensor:
    """KL( N(mean, cov) || N(0, I) ) with cov: [..., D, D]."""
    D = mean.shape[-1]
    _, logdet = torch.linalg.slogdet(cov)
    tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)
    return 0.5 * (tr + (mean * mean).sum(-1) - D - logdet)


def categorical_entropy(logp: Tensor) -> Tensor:
    """Entropy of a categorical given normalized log-probs [..., K]."""
    return -(torch.exp(logp) * logp).sum(-1)
