"""Batched conditional-Gaussian (CG) potential algebra -- the strong
junction tree's factor layer (Lauritzen 1992); counterpart of
``repro.infer_exact.cg_potentials``.

A CG potential has a *discrete* scope (named variables with cardinalities)
and a *continuous* scope (named heads).  Two dual representations:

* :class:`CGPotential` -- **canonical** characteristics ``(g, h, K)``:
  ``phi(d, x) = exp(g(d) + h(d)^T x - x^T K(d) x / 2)``.  Closed under
  combination (add), division (subtract), continuous-evidence reduction and
  EXACT integration of continuous variables -- everything the collect pass
  toward the strong root needs.  It represents CLG *conditionals*
  ``p(x | d, z)`` (K merely PSD), which moment form cannot.

* :class:`MomentPotential` -- **moment** characteristics ``(p, mu, Sigma)``
  per discrete configuration.  Marginalizing continuous variables is
  projection; marginalizing discrete variables is the *weak marginal*: the
  moment-matched single Gaussian per remaining configuration.

All tables carry a leading evidence-batch axis ``B``.  The moment-matching
hot loop runs the CUDA kernel ``repro_torch.kernels.factor_ops.cg_weak_marg``
with ``backend="cuda"``; the batched ``solve``/``slogdet``/``inv`` calls are
``torch.linalg`` (the JAX package leaves them to ``jnp.linalg`` too).  The
``_ex`` variants of ``solve``/``inv`` skip the singularity check, which
would synchronize with the card; a singular block gives non-finite values,
as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import factor_ops

Tensor = torch.Tensor

LOG_2PI = math.log(2.0 * math.pi)
NEG_INF = float("-inf")


class CGPotential(NamedTuple):
    """Canonical-form CG potential.  Shapes (B = evidence batch):

    g: [B, *cards]; h: [B, *cards, n]; K: [B, *cards, n, n], n = |cscope|.
    """

    dscope: Tuple[str, ...]
    cards: Tuple[int, ...]
    cscope: Tuple[str, ...]
    g: Tensor
    h: Tensor
    K: Tensor


class MomentPotential(NamedTuple):
    """Moment-form CG potential: logp [B, *cards]; mu [B, *cards, n];
    sigma [B, *cards, n, n]."""

    dscope: Tuple[str, ...]
    cards: Tuple[int, ...]
    cscope: Tuple[str, ...]
    logp: Tensor
    mu: Tensor
    sigma: Tensor


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _solve(A: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.solve_ex(A, b)[0]


def _inv(A: Tensor) -> Tensor:
    return torch.linalg.inv_ex(A)[0]


def _where0(mask: Tensor, t: Tensor) -> Tensor:
    return torch.where(mask, torch.zeros_like(t), t)


def _empty_gauss(g: Tensor) -> Tuple[Tensor, Tensor]:
    """The (h, K) of a potential with no continuous heads."""
    return g.new_zeros(g.shape + (0,)), g.new_zeros(g.shape + (0, 0))


# -- constructors -------------------------------------------------------------


def zeros(dscope: Tuple[str, ...], cards: Tuple[int, ...],
          cscope: Tuple[str, ...], B: int,
          device: torch.device = None) -> CGPotential:
    """Multiplicative-identity potential (g = 0, no Gaussian info)."""
    n = len(cscope)
    opts = dict(dtype=torch.float32, device=device)
    return CGPotential(dscope, cards, cscope,
                       torch.zeros((B,) + cards, **opts),
                       torch.zeros((B,) + cards + (n,), **opts),
                       torch.zeros((B,) + cards + (n, n), **opts))


def from_discrete_table(dscope: Tuple[str, ...], cards: Tuple[int, ...],
                        logp: Tensor) -> CGPotential:
    """Purely discrete potential from a log table [*cards] (B=1 slice)."""
    g = logp[None]
    return CGPotential(dscope, cards, (), g, *_empty_gauss(g))


def from_clg(alpha: Tensor, beta: Tensor, sigma2: Tensor,
             dscope: Tuple[str, ...], cards: Tuple[int, ...],
             cscope: Tuple[str, ...]) -> CGPotential:
    """Canonical form of a CLG CPD ``N(x; alpha(d) + beta(d)^T z, sigma2(d))``.

    ``cscope`` = (x, *z): the child variable first, then its continuous
    parents.  alpha/sigma2: [*cards]; beta: [*cards, C].
    """
    alpha = alpha.to(torch.float32).expand(cards)
    sigma2 = sigma2.to(torch.float32).expand(cards)
    C = len(cscope) - 1
    beta = beta.to(torch.float32).expand(cards + (C,))
    prec = 1.0 / sigma2
    # w^T [x, z] = x - beta^T z;  exponent = -(w^T u - alpha)^2 / (2 s2) + c
    w = torch.cat([alpha.new_ones(cards + (1,)), -beta], dim=-1)
    K = prec[..., None, None] * (w[..., :, None] * w[..., None, :])
    h = (alpha * prec)[..., None] * w
    g = -0.5 * (alpha ** 2 * prec + torch.log(2.0 * math.pi * sigma2))
    return CGPotential(dscope, cards, cscope, g[None], h[None], K[None])


# -- scope plumbing -----------------------------------------------------------


def _expand_discrete(t: Tensor, old: Tuple[str, ...], new: Tuple[str, ...],
                     new_cards: Tuple[int, ...], trailing: int) -> Tensor:
    """Broadcast a [B, *old_cards, *trail] table onto the discrete superset
    ``new`` (old ⊆ new), keeping ``trailing`` minor axes in place."""
    order = sorted(range(len(old)), key=lambda i: new.index(old[i]))
    nt = t.dim() - trailing
    perm = ((0,) + tuple(1 + i for i in order)
            + tuple(range(nt, t.dim())))
    t = t.permute(perm)
    for axis, v in enumerate(new):
        if v not in old:
            t = t.unsqueeze(1 + axis)
    target = (t.shape[0],) + tuple(new_cards) + tuple(
        t.shape[1 + len(new_cards):])
    return t.expand(target)


def _extend(p: CGPotential, dscope: Tuple[str, ...], cards: Tuple[int, ...],
            cscope: Tuple[str, ...]) -> CGPotential:
    """Embed ``p`` into the superset scopes (zero-pad the Gaussian part)."""
    g = _expand_discrete(p.g, p.dscope, dscope, cards, 0)
    n_new = len(cscope)
    h = g.new_zeros(g.shape + (n_new,))
    K = g.new_zeros(g.shape + (n_new, n_new))
    if p.cscope:
        cols = torch.tensor([cscope.index(v) for v in p.cscope],
                            device=g.device)
        h[..., cols] = _expand_discrete(p.h, p.dscope, dscope, cards, 1)
        K[..., cols[:, None], cols[None, :]] = _expand_discrete(
            p.K, p.dscope, dscope, cards, 2)
    return CGPotential(dscope, cards, cscope, g, h, K)


def _union_scopes(pots: Sequence[CGPotential]
                  ) -> Tuple[Tuple[str, ...], Tuple[int, ...],
                             Tuple[str, ...]]:
    card_of: Dict[str, int] = {}
    cvars: list = []
    for p in pots:
        for v, c in zip(p.dscope, p.cards):
            if v in card_of:
                if card_of[v] != c:
                    raise ValueError(f"cardinality clash for {v}")
            else:
                card_of[v] = c
        for v in p.cscope:
            if v not in cvars:
                cvars.append(v)
    dscope = tuple(sorted(card_of))
    return dscope, tuple(card_of[v] for v in dscope), tuple(sorted(cvars))


def combine(*pots: CGPotential) -> CGPotential:
    """Product of CG potentials: union scopes, add (g, h, K)."""
    dscope, cards, cscope = _union_scopes(pots)
    out = None
    for p in pots:
        q = _extend(p, dscope, cards, cscope)
        out = q if out is None else CGPotential(
            dscope, cards, cscope, out.g + q.g, out.h + q.h, out.K + q.K)
    return out


def divide(a: CGPotential, msg: CGPotential) -> CGPotential:
    """``a / msg`` (canonical subtraction); msg scopes ⊆ a scopes.

    Configurations dead in ``a`` (g = -inf) stay dead: -inf - (-inf) would
    be NaN, and a divisor can only be -inf where the dividend already is.
    """
    q = _extend(msg, a.dscope, a.cards, a.cscope)
    dead = torch.isneginf(a.g)
    g = torch.where(dead, a.g, a.g - q.g)
    h = _where0(dead[..., None], a.h - q.h)
    K = _where0(dead[..., None, None], a.K - q.K)
    return CGPotential(a.dscope, a.cards, a.cscope, g, h, K)


# -- evidence -----------------------------------------------------------------


def reduce_evidence(p: CGPotential, values: Dict[str, Tensor]
                    ) -> CGPotential:
    """Instantiate observed continuous heads to per-instance values [B].

    Exact in canonical form; the observed axes disappear from the scope.
    """
    obs = tuple(v for v in p.cscope if v in values)
    if not obs:
        return p
    keep = tuple(v for v in p.cscope if v not in obs)
    oi = torch.tensor([p.cscope.index(v) for v in obs], device=p.g.device)
    ki = torch.tensor([p.cscope.index(v) for v in keep], dtype=torch.int64,
                      device=p.g.device)
    nb = len(p.cards)
    x = torch.stack([torch.as_tensor(values[v]).to(torch.float32).reshape(-1)
                     for v in obs], dim=-1)                     # [B, do]
    x = x.reshape((x.shape[0],) + (1,) * nb + (len(obs),))
    h_o = p.h[..., oi]
    K_oo = p.K[..., oi[:, None], oi[None, :]]
    g = (p.g + (h_o * x).sum(-1)
         - 0.5 * (x[..., :, None] * K_oo * x[..., None, :]).sum((-2, -1)))
    if not keep:
        B = max(g.shape[0], x.shape[0])
        g = g.expand((B,) + tuple(g.shape[1:]))
        return CGPotential(p.dscope, p.cards, (), g, *_empty_gauss(g))
    K_uo = p.K[..., ki[:, None], oi[None, :]]
    h = p.h[..., ki] - (K_uo * x[..., None, :]).sum(-1)
    K = p.K[..., ki[:, None], ki[None, :]]
    B = max(g.shape[0], h.shape[0])
    g = g.expand((B,) + tuple(g.shape[1:]))
    h = h.expand((B,) + tuple(h.shape[1:]))
    K = K.expand((B,) + tuple(K.shape[1:]))
    return CGPotential(p.dscope, p.cards, keep, g, h, K)


def add_discrete_log(p: CGPotential, dscope: Tuple[str, ...],
                     cards: Tuple[int, ...], logp: Tensor) -> CGPotential:
    """Multiply in a purely discrete (batched) log table [B, *cards]."""
    q = CGPotential(dscope, cards, (), logp, *_empty_gauss(logp))
    return combine(p, q)


# -- marginalization ----------------------------------------------------------


def marginalize_cont(p: CGPotential, drop: Sequence[str]) -> CGPotential:
    """EXACT Gaussian integral over ``drop`` ⊆ cscope (strong operation).

    Valid when K restricted to ``drop`` is positive definite -- guaranteed
    during collect by the strong elimination order.
    """
    drop = tuple(v for v in p.cscope if v in set(drop))
    if not drop:
        return p
    keep = tuple(v for v in p.cscope if v not in drop)
    dev = p.g.device
    di = torch.tensor([p.cscope.index(v) for v in drop], device=dev)
    ki = torch.tensor([p.cscope.index(v) for v in keep], dtype=torch.int64,
                      device=dev)
    # dead configurations (g = -inf, from discrete-evidence indicators) can
    # carry arbitrary (even singular) K blocks after distribute-pass
    # division: mask them so slogdet/solve garbage cannot leak out as NaN
    dead = torch.isneginf(p.g)
    K_ii = p.K[..., di[:, None], di[None, :]]
    K_ii = torch.where(dead[..., None, None], _eye(len(drop), K_ii), K_ii)
    h_i = p.h[..., di]
    _, logdet = torch.linalg.slogdet(K_ii)           # PD by construction
    sol_h = _solve(K_ii, h_i[..., None])[..., 0]
    g = (p.g + 0.5 * (len(drop) * LOG_2PI - logdet)
         + 0.5 * (h_i * sol_h).sum(-1))
    g = torch.where(dead, p.g, g)
    if not keep:
        return CGPotential(p.dscope, p.cards, (), g, *_empty_gauss(g))
    K_ji = p.K[..., ki[:, None], di[None, :]]
    sol_K = _solve(K_ii, K_ji.transpose(-1, -2))       # K_ii^-1 K_ij
    h = p.h[..., ki] - (K_ji * sol_h[..., None, :]).sum(-1)
    K = p.K[..., ki[:, None], ki[None, :]] - K_ji @ sol_K
    K = 0.5 * (K + K.transpose(-1, -2))
    h = _where0(dead[..., None], h)
    K = torch.where(dead[..., None, None], _eye(len(keep), K), K)
    return CGPotential(p.dscope, p.cards, keep, g, h, K)


def marginalize_disc(p: CGPotential, drop: Sequence[str]) -> CGPotential:
    """logsumexp out discrete variables -- STRONG only when the continuous
    scope is empty (guaranteed on the collect pass by strongness)."""
    drop = tuple(v for v in p.dscope if v in set(drop))
    if not drop:
        return p
    if p.cscope:
        raise ValueError(
            "strong discrete marginalization with live continuous scope "
            f"{p.cscope} — use weak_marginalize")
    keep = tuple(v for v in p.dscope if v not in drop)
    axes = tuple(1 + p.dscope.index(v) for v in drop)
    cards = tuple(p.cards[p.dscope.index(v)] for v in keep)
    # surviving axes keep their relative order == sorted scope order
    g = torch.logsumexp(p.g, dim=axes)
    return CGPotential(keep, cards, (), g, *_empty_gauss(g))


# -- moment form --------------------------------------------------------------


def to_moment(p: CGPotential) -> MomentPotential:
    """Canonical -> moment.  Needs K positive definite per configuration
    (true for clique/sepset *beliefs*)."""
    n = len(p.cscope)
    if n == 0:
        return MomentPotential(p.dscope, p.cards, (), p.g, p.h, p.K)
    dead = torch.isneginf(p.g)
    K = torch.where(dead[..., None, None], _eye(n, p.K), p.K)
    _, logdet = torch.linalg.slogdet(K)
    mu = _solve(K, p.h[..., None])[..., 0]
    sigma = _inv(K)
    sigma = 0.5 * (sigma + sigma.transpose(-1, -2))
    logp = p.g + 0.5 * (n * LOG_2PI - logdet + (p.h * mu).sum(-1))
    logp = torch.where(dead, p.g, logp)
    mu = _where0(dead[..., None], mu)
    sigma = torch.where(dead[..., None, None], _eye(n, sigma), sigma)
    return MomentPotential(p.dscope, p.cards, p.cscope, logp, mu, sigma)


def to_canonical(m: MomentPotential) -> CGPotential:
    """Moment -> canonical.  Configurations with logp = -inf get an
    identity covariance stand-in (their weight keeps them inert)."""
    n = len(m.cscope)
    if n == 0:
        return CGPotential(m.dscope, m.cards, (), m.logp, m.mu, m.sigma)
    dead = torch.isneginf(m.logp)
    sigma = torch.where(dead[..., None, None], _eye(n, m.sigma), m.sigma)
    K = _inv(sigma)
    K = 0.5 * (K + K.transpose(-1, -2))
    h = (K @ m.mu[..., None])[..., 0]
    _, logdet_s = torch.linalg.slogdet(sigma)
    g = m.logp - 0.5 * (n * LOG_2PI + logdet_s + (h * m.mu).sum(-1))
    g = torch.where(dead, m.logp, g)
    return CGPotential(m.dscope, m.cards, m.cscope, g, h, K)


def moment_marginalize_cont(m: MomentPotential, drop: Sequence[str]
                            ) -> MomentPotential:
    """Drop continuous heads in moment form (exact: Gaussian projection)."""
    drop = tuple(v for v in m.cscope if v in set(drop))
    if not drop:
        return m
    keep = tuple(v for v in m.cscope if v not in drop)
    ki = torch.tensor([m.cscope.index(v) for v in keep], dtype=torch.int64,
                      device=m.mu.device)
    return MomentPotential(m.dscope, m.cards, keep, m.logp, m.mu[..., ki],
                           m.sigma[..., ki[:, None], ki[None, :]])


def moment_match(logp: Tensor, mu: Tensor, sigma: Tensor,
                 axes: Tuple[int, ...]) -> Tuple[Tensor, Tensor, Tensor]:
    """Collapse mixture axes to a single Gaussian with the same first and
    second moments (the weak marginal).  -inf weights contribute nothing;
    all-dead mixtures yield (logp=-inf, mu=0, sigma=I)."""
    n = mu.shape[-1]
    # torch reads an empty ``dim`` as "every axis": no axes is the identity
    lse = torch.logsumexp(logp, dim=axes, keepdim=True) if axes else logp
    safe = _where0(torch.isneginf(lse), lse)
    w = _where0(torch.isneginf(logp), torch.exp(logp - safe))
    total = lambda t: t.sum(axes) if axes else t
    mu_hat = total(w[..., None] * mu)
    second = total(w[..., None, None]
                   * (sigma + mu[..., :, None] * mu[..., None, :]))
    sigma_hat = second - mu_hat[..., :, None] * mu_hat[..., None, :]
    logp_hat = lse
    for a in sorted(axes, reverse=True):
        logp_hat = logp_hat.squeeze(a)
    dead = torch.isneginf(logp_hat)
    sigma_hat = torch.where(dead[..., None, None], _eye(n, sigma_hat),
                            sigma_hat)
    mu_hat = _where0(dead[..., None], mu_hat)
    return logp_hat, mu_hat, sigma_hat


def weak_marginalize(p: CGPotential, keep_disc: Sequence[str],
                     keep_cont: Sequence[str], *,
                     backend: str = "einsum") -> CGPotential:
    """Weak (moment-matched) marginal of a *belief* onto a sepset.

    Continuous drops are exact projections; discrete drops moment-match
    (the ``cg_weak_marg`` kernel with ``backend="cuda"``).  Returns
    canonical form (ready for division / combination).
    """
    keep_d = set(keep_disc)
    keep_c = set(keep_cont)
    drop_d = tuple(v for v in p.dscope if v not in keep_d)
    drop_c = tuple(v for v in p.cscope if v not in keep_c)
    if not drop_d:
        return marginalize_cont(p, drop_c) if drop_c else p
    if not p.cscope:
        return marginalize_disc(p, drop_d)
    m = to_moment(p)
    m = moment_marginalize_cont(m, drop_c)
    if not m.cscope:
        can = CGPotential(m.dscope, m.cards, (), m.logp, m.mu, m.sigma)
        return marginalize_disc(can, drop_d)
    # permute kept discrete axes ahead of dropped ones, then moment-match
    keep_ds = tuple(v for v in m.dscope if v in keep_d)
    perm_scope = keep_ds + drop_d
    perm = (0,) + tuple(1 + m.dscope.index(v) for v in perm_scope)
    nb = 1 + len(m.dscope)
    logp = m.logp.permute(perm)
    mu = m.mu.permute(perm + (nb,))
    sigma = m.sigma.permute(perm + (nb, nb + 1))
    axes = tuple(range(1 + len(keep_ds), 1 + len(m.dscope)))
    n = len(m.cscope)
    kcards = tuple(m.cards[m.dscope.index(v)] for v in keep_ds)
    if backend == "cuda" and axes:
        B = logp.shape[0]
        M = math.prod(kcards)
        N = math.prod(logp.shape[1 + len(kcards):])
        lp, muh, sigh = factor_ops.cg_weak_marg(
            logp.reshape(B, M, N).contiguous(),
            mu.reshape(B, M, N, n).contiguous(),
            sigma.reshape(B, M, N, n, n).contiguous())
        lp = lp.reshape((B,) + kcards)
        muh = muh.reshape((B,) + kcards + (n,))
        sigh = sigh.reshape((B,) + kcards + (n, n))
    else:
        lp, muh, sigh = moment_match(logp, mu, sigma, axes)
    out = MomentPotential(keep_ds, kcards, m.cscope, lp, muh, sigh)
    return to_canonical(out)


# -- shape-bucketed batching --------------------------------------------------
#
# Propagation issues one solve/slogdet (marginalize_cont) or one moment-match
# chain (weak_marginalize) PER CLIQUE.  Cliques at the same tree level are
# independent, and cliques of equal shape signature can ride the SAME stacked
# linalg call: each member's tables are permuted to a canonical layout (kept
# continuous heads first, kept discrete axes major), flattened, stacked along
# a pseudo batch axis and pushed through the ordinary scalar operation once,
# then unstacked and relabeled.


def _cfg(p: CGPotential) -> int:
    return math.prod(p.cards)


def _index(t: Tensor, order: Sequence[int], ndims: int) -> Tensor:
    """Reorder the last ``ndims`` (1 or 2) axes of ``t`` by ``order``."""
    o = torch.tensor(list(order), dtype=torch.int64, device=t.device)
    return t[..., o] if ndims == 1 else t[..., o[:, None], o[None, :]]


def marginalize_cont_many(
    items: Sequence[Tuple[CGPotential, Sequence[str]]]
) -> list:
    """Batched :func:`marginalize_cont` over same-shaped potentials.

    ``items``: (potential, continuous names to drop) pairs.  Potentials
    bucketed by (|cscope|, |drop|, n_configs, B) run ONE stacked
    solve/slogdet; singletons fall through to the scalar op.  Output order
    matches input order and every entry equals its scalar counterpart.
    """
    out: list = [None] * len(items)
    buckets: Dict[Tuple[int, int, int, int], list] = {}
    for i, (p, drop) in enumerate(items):
        dropt = tuple(v for v in p.cscope if v in set(drop))
        if not dropt:
            out[i] = p
            continue
        key = (len(p.cscope), len(dropt), _cfg(p), p.g.shape[0])
        buckets.setdefault(key, []).append((i, p, dropt))
    for (n, nd, cfg, B), members in buckets.items():
        if len(members) == 1:
            i, p, dropt = members[0]
            out[i] = marginalize_cont(p, dropt)
            continue
        nk = n - nd
        gs, hs, Ks, keeps = [], [], [], []
        for i, p, dropt in members:
            keep = tuple(v for v in p.cscope if v not in dropt)
            keeps.append(keep)
            order = [p.cscope.index(v) for v in keep + dropt]
            gs.append(p.g.reshape(B * cfg))
            hs.append(_index(p.h, order, 1).reshape(B * cfg, n))
            Ks.append(_index(p.K, order, 2).reshape(B * cfg, n, n))
        names = tuple(f"_c{j}" for j in range(n))
        q = CGPotential((), (), names, torch.cat(gs), torch.cat(hs),
                        torch.cat(Ks))
        m = marginalize_cont(q, names[nk:])
        g = m.g.reshape(len(members), B * cfg)
        h = m.h.reshape(len(members), B * cfg, nk)
        K = m.K.reshape(len(members), B * cfg, nk, nk)
        for j, (i, p, dropt) in enumerate(members):
            shp = (B,) + p.cards
            out[i] = CGPotential(
                p.dscope, p.cards, keeps[j], g[j].reshape(shp),
                h[j].reshape(shp + (nk,)), K[j].reshape(shp + (nk, nk)))
    return out


def weak_marginalize_many(
    items: Sequence[Tuple[CGPotential, Sequence[str], Sequence[str]]], *,
    backend: str = "einsum",
) -> list:
    """Batched :func:`weak_marginalize` over same-shaped beliefs.

    ``items``: (belief, keep_disc, keep_cont) triples.  Pure-continuous
    drops route through :func:`marginalize_cont_many`; table-only beliefs
    logsumexp per item; the general moment-matching path buckets by
    (|cscope|, kept heads, kept configs M, dropped configs N, B) and runs
    the to_moment / moment_match / to_canonical chain ONCE per bucket on
    stacked [S*B, M, N, ...] tables.
    """
    out: list = [None] * len(items)
    cont_idx: list = []
    cont_items: list = []
    buckets: Dict[Tuple[int, int, int, int, int], list] = {}
    for i, (p, keep_disc, keep_cont) in enumerate(items):
        keep_d, keep_c = set(keep_disc), set(keep_cont)
        drop_d = tuple(v for v in p.dscope if v not in keep_d)
        drop_c = tuple(v for v in p.cscope if v not in keep_c)
        if not drop_d:
            cont_idx.append(i)
            cont_items.append((p, drop_c))
            continue
        if not p.cscope:
            out[i] = marginalize_disc(p, drop_d)
            continue
        keep_ds = tuple(v for v in p.dscope if v in keep_d)
        kcards = tuple(p.cards[p.dscope.index(v)] for v in keep_ds)
        M = math.prod(kcards)
        N = _cfg(p) // M
        n = len(p.cscope)
        nkc = n - len(drop_c)
        key = (n, nkc, M, N, p.g.shape[0])
        buckets.setdefault(key, []).append((i, p, keep_ds, drop_d, drop_c))
    for i, r in zip(cont_idx, marginalize_cont_many(cont_items)):
        out[i] = r
    for (n, nkc, M, N, B), members in buckets.items():
        if len(members) == 1:
            i, p, keep_ds, drop_d, drop_c = members[0]
            out[i] = weak_marginalize(p, keep_ds,
                                      tuple(v for v in p.cscope
                                            if v not in set(drop_c)),
                                      backend=backend)
            continue
        gs, hs, Ks, metas = [], [], [], []
        for i, p, keep_ds, drop_d, drop_c in members:
            keep_cs = tuple(v for v in p.cscope if v not in set(drop_c))
            nb = 1 + len(p.dscope)
            perm = (0,) + tuple(1 + p.dscope.index(v)
                                for v in keep_ds + drop_d)
            corder = [p.cscope.index(v)
                      for v in keep_cs + tuple(v for v in p.cscope
                                               if v in set(drop_c))]
            gs.append(p.g.permute(perm).reshape(B, M, N))
            hs.append(_index(p.h.permute(perm + (nb,)), corder, 1)
                      .reshape(B, M, N, n))
            Ks.append(_index(p.K.permute(perm + (nb, nb + 1)), corder, 2)
                      .reshape(B, M, N, n, n))
            kcards = tuple(p.cards[p.dscope.index(v)] for v in keep_ds)
            metas.append((keep_ds, kcards, keep_cs))
        names = tuple(f"_c{j}" for j in range(n))
        q = CGPotential(("_keep", "_drop"), (M, N), names, torch.cat(gs),
                        torch.cat(hs), torch.cat(Ks))
        r = weak_marginalize(q, ("_keep",), names[:nkc], backend=backend)
        g = r.g.reshape(len(members), B, M)
        h = r.h.reshape(len(members), B, M, nkc)
        K = r.K.reshape(len(members), B, M, nkc, nkc)
        for j, (i, p, keep_ds, drop_d, drop_c) in enumerate(members):
            keep_ds_j, kcards, keep_cs = metas[j]
            shp = (B,) + kcards
            out[i] = CGPotential(
                keep_ds_j, kcards, keep_cs, g[j].reshape(shp),
                h[j].reshape(shp + (nkc,)), K[j].reshape(shp + (nkc, nkc)))
    return out


# -- queries ------------------------------------------------------------------


def discrete_table(p: CGPotential) -> Tensor:
    """Exact discrete log-marginal table [B, *cards] of a belief: integrate
    every continuous head, keep the full discrete scope."""
    return marginalize_cont(p, p.cscope).g


def log_norm(p: CGPotential) -> Tensor:
    """log of the potential's total mass: integrate continuous, sum
    discrete -> [B]."""
    g = marginalize_cont(p, p.cscope).g
    if g.dim() == 1:
        return g
    return torch.logsumexp(g, dim=tuple(range(1, g.dim())))
