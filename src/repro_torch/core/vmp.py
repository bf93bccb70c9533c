"""Variational Message Passing over the Fig.-3 plate family (counterpart of
``repro.core.vmp``):

    theta  ~ conjugate priors                       (global, shared)
    Z_i    ~ Cat(pi)                                (per-instance discrete latent)
    H_i    ~ N(0, I_L)                              (per-instance cont. latent)
    X_if   ~ N( w_{f,Z_i}^T d_if , lam_{f,Z_i}^-1 ) (continuous leaves; CLG Eq. 2)
    X_id   ~ Cat( theta_{d,Z_i} )                   (discrete leaves)

with the design vector d_if = [1, observed parents of f, H_i (masked)].

One sweep = local step (q(Z), q(H) and the expected sufficient statistics)
+ global step (conjugate natural-parameter update).  The suff-stats
reduction has two backends sharing one math path:

    "einsum"  plain torch.einsum (the reference; the leaf-shared
              latent-latent block is kept lazily as [K, L, L])
    "cuda"    the hand-written kernels of ``repro_torch.kernels.clg_stats``
              (L > 0 plates run the fused latent kernel, dense form)

The default follows the device of the data: "cuda" on a CUDA device,
"einsum" on the CPU.  ``chunk=`` runs the body over fixed-size instance
blocks and sums the stats, so no [N, F, K] intermediate is formed at full N.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import expfam as ef
from repro_torch.core.dag import PlateSpec
from repro_torch.obs import sink as obs_sink
from repro_torch.obs.metrics import LocalStepMetrics

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Parameter / statistics tuples
# ---------------------------------------------------------------------------


class PlateParams(NamedTuple):
    """Global variational posterior (and prior) over theta."""

    mix: ef.Dirichlet          # [K]
    reg: ef.MVNormalGamma      # [F, K, D]
    disc: ef.Dirichlet         # [Fd, K, C]


class PlateStats(NamedTuple):
    """Expected sufficient statistics — the d-VMP message."""

    counts: Tensor             # [K]
    reg: ef.RegSuffStats       # [F, K, ...]
    disc: Tensor               # [Fd, K, C]
    n: Tensor                  # scalar — #instances contributing
    local_elbo: Tensor         # scalar — sum of local ELBO terms


class PlateLayout(NamedTuple):
    F: int           # continuous leaves
    Fd: int          # discrete leaves
    K: int           # mixture components
    L: int           # continuous latent dim
    P: int           # max #observed parents
    D: int           # design dim = 1 + P + L
    C: int           # max discrete-leaf cardinality


def layout_of(spec: PlateSpec) -> PlateLayout:
    dm = spec.discrete_map
    F = spec.n_features - len(dm)
    Fd = len(dm)
    K = max(spec.latent_card, 1)
    L = spec.latent_dim
    P = max((len(spec.parent_idx(i)) for i in range(spec.n_features)),
            default=0)
    C = max(dm.values(), default=2)
    return PlateLayout(F=F, Fd=Fd, K=K, L=L, P=P, D=1 + P + L, C=C)


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledPlate:
    """Static tensors derived from the spec, on one device.

    Continuous leaves are re-indexed 0..F-1 and discrete leaves 0..Fd-1;
    the data provide ``xc: [N, F]`` and ``xd: [N, Fd]`` accordingly."""

    spec: PlateSpec
    layout: PlateLayout
    device: torch.device
    parent_idx: Tensor         # [F, P] int64 — indices into xc columns
    parent_mask: Tensor        # [F, P]
    latent_mask: Tensor        # [F, L]
    card_mask: Tensor          # [Fd, C]
    hh_shared: bool            # uniform latent mask (lazy [K, L, L] block)


def compile_plate(spec: PlateSpec, latent_mask=None,
                  device: devmod.DeviceLike = None) -> CompiledPlate:
    dev = devmod.resolve_device(device)
    lay = layout_of(spec)
    dm = spec.discrete_map
    cont_ids = [i for i in range(spec.n_features) if i not in dm]
    cont_pos = {orig: new for new, orig in enumerate(cont_ids)}
    shape = (max(lay.F, 1), max(lay.P, 1))
    pidx = np.zeros(shape, np.int64)
    pmask = np.zeros(shape, np.float32)
    for new_f, orig_f in enumerate(cont_ids):
        for j, p in enumerate(spec.parent_idx(orig_f)):
            if p in dm:
                raise ValueError("observed parents must be continuous features")
            pidx[new_f, j] = cont_pos[p]
            pmask[new_f, j] = 1.0
    lshape = (max(lay.F, 1), max(lay.L, 1))
    if latent_mask is None:
        lmask = np.ones(lshape, np.float32)
    else:
        lmask = np.asarray(latent_mask, np.float32).reshape(lshape)
    cmask = np.zeros((max(lay.Fd, 1), lay.C), np.float32)
    for new_d, (_, card) in enumerate(sorted(dm.items())):
        cmask[new_d, :card] = 1.0
    lm = lmask[:, :max(lay.L, 1)]
    as_t = lambda a: torch.as_tensor(a, device=dev)
    return CompiledPlate(
        spec=spec, layout=lay, device=dev, parent_idx=as_t(pidx),
        parent_mask=as_t(pmask), latent_mask=as_t(lmask),
        card_mask=as_t(cmask), hh_shared=bool((lm == lm[:1]).all()),
    )


def design_mask(cp: CompiledPlate) -> Tensor:
    """[F, D] — which design columns are live for each continuous leaf."""
    lay = cp.layout
    parts = [torch.ones((max(lay.F, 1), 1), device=cp.device)]
    if lay.P > 0:
        parts.append(cp.parent_mask[:, :lay.P])
    if lay.L > 0:
        parts.append(cp.latent_mask[:, :lay.L])
    return torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# Prior construction
# ---------------------------------------------------------------------------


def default_prior(cp: CompiledPlate, *, alpha0: float = 1.0,
                  reg_scale: float = 1.0, a0: float = 1.0, b0: float = 1.0
                  ) -> PlateParams:
    lay = cp.layout
    F, K, D, Fd, C = max(lay.F, 1), lay.K, lay.D, max(lay.Fd, 1), lay.C
    opts = dict(dtype=torch.float32, device=cp.device)
    mix = ef.Dirichlet(torch.full((K,), alpha0, **opts))
    eye = (torch.eye(D, **opts) / reg_scale).expand(F, K, D, D).contiguous()
    reg = ef.MVNormalGamma(
        m=torch.zeros((F, K, D), **opts), K=eye,
        a=torch.full((F, K), a0, **opts), b=torch.full((F, K), b0, **opts))
    disc = ef.Dirichlet(torch.full((Fd, K, C), alpha0, **opts)
                        * cp.card_mask[:, None, :] + 1e-12)
    return PlateParams(mix=mix, reg=reg, disc=disc)


def symmetry_broken(prior: PlateParams, generator: torch.Generator,
                    scale: float = 0.5) -> PlateParams:
    """Initial posterior: the prior with jittered regression means (breaks
    the label symmetry that makes CAVI stall at the uniform fixed point).
    The noise is drawn on the CPU from ``generator``, so a seed gives the
    same start on every device (not the JAX package's, which uses
    ``jax.random``)."""
    dev = prior.reg.m.device
    n1 = torch.randn(prior.reg.m.shape, generator=generator)
    n2 = torch.randn(prior.disc.alpha.shape, generator=generator)
    m = prior.reg.m + scale * n1.to(dev)
    disc = ef.Dirichlet(prior.disc.alpha * torch.exp(0.1 * n2.to(dev)))
    return PlateParams(mix=prior.mix, reg=prior.reg._replace(m=m), disc=disc)


# ---------------------------------------------------------------------------
# Local step — q(Z), q(H) and the expected sufficient statistics
# ---------------------------------------------------------------------------


def _observed_design(cp: CompiledPlate, xc: Tensor) -> Tensor:
    """[N, F, 1+P] observed part of the design vectors."""
    lay = cp.layout
    ones = torch.ones((xc.shape[0], max(lay.F, 1), 1), dtype=xc.dtype,
                      device=xc.device)
    if lay.P == 0:
        return ones
    gathered = xc[:, cp.parent_idx]            # [N, F, P]
    return torch.cat([ones, gathered * cp.parent_mask], dim=-1)


def _split_moments(cp: CompiledPlate, mom: ef.RegMoments):
    """Split regression moments into observed / latent blocks, masked."""
    Do = 1 + cp.layout.P
    dmask = design_mask(cp)                                    # [F, D]
    mm = dmask[:, None, :, None] * dmask[:, None, None, :]
    e_lamww = mom.e_lamww * mm
    e_lamw = mom.e_lamw * dmask[:, None, :]
    return (e_lamw[..., :Do], e_lamw[..., Do:], e_lamww[..., :Do, :Do],
            e_lamww[..., :Do, Do:], e_lamww[..., Do:, Do:])


def _reduce_reg(cp: CompiledPlate, obs: Tensor, y: Tensor, h_mean: Tensor,
                s_hh: Tensor, r: Tensor, backend: str):
    """Regression suff-stats over instances -> (sxx, sxx_hh, sxy, syy);
    ``sxx_hh`` is None for the dense [F, K, D, D] form, else the lazy
    [K, L, L] latent block (``sxx`` then holds the [F, K, Do, D] top).
    The einsum branches count ``<kernel>:einsum`` dispatches for obs; the
    kernel wrappers count their own route."""
    lay = cp.layout
    if lay.L == 0:
        if backend == "cuda":
            from repro_torch.kernels import clg_stats

            sxx, sxy, syy = clg_stats.clg_suffstats(obs, y, r)
        else:
            obs_sink.count_kernel("clg_suffstats:einsum")
            sxx = torch.einsum("nfa,nfb,nk->fkab", obs, obs, r)
            sxy = torch.einsum("nfa,nf,nk->fka", obs, y, r)
            syy = torch.einsum("nf,nf,nk->fk", y, y, r)
        return sxx, None, sxy, syy
    if backend == "cuda":
        from repro_torch.kernels import clg_stats

        sxx, sxy, syy = clg_stats.clg_suffstats_latent(
            obs, h_mean.contiguous(), y, r, s_hh.contiguous())
        return sxx, None, sxy, syy
    obs_sink.count_kernel("clg_suffstats_latent:einsum")
    sxx_oo = torch.einsum("nfa,nfb,nk->fkab", obs, obs, r)
    sxy_o = torch.einsum("nfa,nf,nk->fka", obs, y, r)
    syy = torch.einsum("nf,nf,nk->fk", y, y, r)
    sxx_oh = torch.einsum("nfa,nkl,nk->fkal", obs, h_mean, r)
    sxx_top = torch.cat([sxx_oo, sxx_oh], dim=-1)             # [F,K,Do,D]
    sxx_hh = (torch.einsum("nkl,nkm,nk->klm", h_mean, h_mean, r)
              + r.sum(0)[:, None, None] * s_hh)               # [K,L,L]
    sxy = torch.cat([sxy_o, torch.einsum("nkl,nf,nk->fkl", h_mean, y, r)],
                    dim=-1)
    if not cp.hh_shared:
        # per-leaf latent masks (CustomGlobalLocalModel): the masked hh
        # block is leaf-dependent — keep the dense matrix
        hh = sxx_hh[None].expand((max(lay.F, 1),) + tuple(sxx_hh.shape))
        bot = torch.cat([sxx_oh.transpose(-1, -2), hh], dim=-1)
        return torch.cat([sxx_top, bot], dim=-2), None, sxy, syy
    return sxx_top, sxx_hh, sxy, syy


def _reduce_disc(cp: CompiledPlate, xd: Tensor, r: Tensor, backend: str
                 ) -> Tensor:
    """Discrete-leaf one-hot count reduction -> [Fd, K, C]."""
    C = cp.layout.C
    if backend == "cuda":
        from repro_torch.kernels import clg_stats

        counts = clg_stats.clg_disc_counts(xd, r, C)
    else:
        from repro_torch.kernels import ref

        obs_sink.count_kernel("clg_disc_counts:einsum")
        counts = torch.einsum("nfc,nk->fkc", ref.one_hot_cmp(xd, C, r.dtype),
                              r)
    return counts * cp.card_mask[:, None, :]


def _local_step_body(cp: CompiledPlate, params: PlateParams, xc: Tensor,
                     xd: Tensor, mask: Tensor, r_fixed: Optional[Tensor],
                     backend: str) -> Tuple[PlateStats, Tensor]:
    lay = cp.layout
    N = xc.shape[0]
    K, L = lay.K, lay.L
    dev = xc.device
    opts = dict(dtype=torch.float32, device=dev)

    e_logpi = ef.dirichlet_expected_logprob(params.mix)        # [K]
    mom = ef.mvnormalgamma_moments(params.reg)                 # [F, K, ...]
    wo, wh, oo, oh, hh = _split_moments(cp, mom)
    if lay.F == 0:
        # pure-discrete model: keep the regression block inert (stats = 0)
        xc = torch.zeros((N, 1), **opts)
    xc = xc.contiguous()
    obs = _observed_design(cp, xc)                             # [N, F, Do]
    y = xc                                                     # [N, F]

    quad_oo = torch.einsum("nfa,fkab,nfb->nfk", obs, oo, obs)
    lin_o = torch.einsum("nfa,fka->nfk", obs, wo)

    if L > 0:
        # q(H_i | Z_i = k): Gaussian, shared across leaves
        A = torch.eye(L, **opts) + hh.sum(0)                   # [K, L, L]
        S = torch.linalg.inv(A)
        b = (torch.einsum("nf,fkl->nkl", y, wh)
             - torch.einsum("fkal,nfa->nkl", oh, obs))
        h_mean = torch.einsum("klm,nkm->nkl", S, b)            # [N, K, L]
        # E[hh^T | z=k] = S_k + E[h]E[h]^T: nothing [N, K, L, L] is formed
        quad_h = (torch.einsum("fklm,klm->fk", hh, S)[None]
                  + torch.einsum("fklm,nkl,nkm->nfk", hh, h_mean, h_mean))
        cross = 2.0 * torch.einsum("nfa,fkal,nkl->nfk", obs, oh, h_mean)
        lin_h = torch.einsum("nf,fkl,nkl->nfk", y, wh, h_mean) * 2.0
        _, logdet_s = torch.linalg.slogdet(S)                  # [K]
        tr_s = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)     # [K]
        kl_h = 0.5 * ((h_mean * h_mean).sum(-1)
                      + (tr_s - L - logdet_s)[None])           # [N, K]
    else:
        quad_h = torch.zeros((N, max(lay.F, 1), K), **opts)
        cross = lin_h = quad_h
        kl_h = torch.zeros((N, K), **opts)
        h_mean = torch.zeros((N, K, 1), **opts)
        S = torch.zeros((K, 1, 1), **opts)

    ll = 0.5 * (mom.e_loglam[None] - ef.LOG2PI
                - mom.e_lam[None] * (y * y)[..., None]
                + 2.0 * lin_o * y[..., None]
                + lin_h - quad_oo - cross - quad_h)            # [N, F, K]
    ll_cont = ll.sum(1) if lay.F > 0 else torch.zeros((N, K), **opts)

    if lay.Fd > 0:
        e_logtheta = ef.dirichlet_expected_logprob(params.disc)  # [Fd, K, C]
        e_t = e_logtheta.transpose(1, 2)                         # [Fd, C, K]
        f_idx = torch.arange(lay.Fd, device=dev)[None, :]
        ll_disc = e_t[f_idx, xd.long()].sum(1)                   # [N, K]
    else:
        ll_disc = torch.zeros((N, K), **opts)

    logits = e_logpi[None] + ll_cont + ll_disc - kl_h            # [N, K]
    if r_fixed is None:
        logr = torch.log_softmax(logits, dim=-1)
        r = torch.exp(logr) * mask[:, None]
    else:
        logr = torch.log(torch.clamp(r_fixed, min=1e-30))
        r = r_fixed * mask[:, None]
    r = r.contiguous()

    counts = r.sum(0)                                            # [K]
    sxx, sxx_hh, sxy, syy = _reduce_reg(cp, obs, y, h_mean, S, r, backend)
    nw = counts[None].expand(syy.shape)

    dmask = design_mask(cp)
    live = 1.0 if lay.F > 0 else 0.0  # inert regression block (pure-discrete)
    Do = sxx.shape[-2]                # = D dense, 1 + P lazy
    sxx = sxx * dmask[:, None, :Do, None] * dmask[:, None, None, :] * live
    if sxx_hh is not None:
        lmask = dmask[0, Do:]         # uniform across leaves (hh_shared)
        sxx_hh = sxx_hh * lmask[None, :, None] * lmask[None, None, :] * live
    sxy = sxy * dmask[:, None, :] * live
    reg_stats = ef.RegSuffStats(sxx=sxx, sxy=sxy, syy=syy * live,
                                n=nw * live, sxx_hh=sxx_hh)

    if lay.Fd > 0:
        disc_counts = _reduce_disc(cp, xd.to(torch.int32).contiguous(), r,
                                   backend)
    else:
        disc_counts = torch.zeros((1, K, lay.C), **opts)

    ent = ef.categorical_entropy(logr) * mask
    local_elbo = (r * logits).sum() + ent.sum()
    stats = PlateStats(counts=counts, reg=reg_stats, disc=disc_counts,
                       n=mask.sum(), local_elbo=local_elbo)
    return stats, r


def _add_stats(a: PlateStats, b: PlateStats) -> PlateStats:
    ra, rb = a.reg, b.reg
    hh = None if ra.sxx_hh is None else ra.sxx_hh + rb.sxx_hh
    reg = ef.RegSuffStats(ra.sxx + rb.sxx, ra.sxy + rb.sxy, ra.syy + rb.syy,
                          ra.n + rb.n, hh)
    return PlateStats(a.counts + b.counts, reg, a.disc + b.disc, a.n + b.n,
                      a.local_elbo + b.local_elbo)


def local_step(cp: CompiledPlate, params: PlateParams, xc: Tensor,
               xd: Tensor, mask: Tensor, r_fixed: Optional[Tensor] = None, *,
               backend: Optional[str] = None, chunk: Optional[int] = None,
               with_metrics: bool = False):
    """One local VMP step on a batch.

    xc: [N, F] continuous leaves; xd: [N, Fd] int discrete leaves;
    mask: [N] 1.0 for real instances (0.0 pads); r_fixed: [N, K] clamps q(Z)
    (supervised models).  ``backend`` None follows the device of ``xc``;
    ``chunk`` processes instances in blocks of that size and sums the stats.
    Both change only the reduction schedule, not the math.

    Returns the suff-stat message and the responsibilities r: [N, K]; with
    ``with_metrics=True`` also a :class:`~repro_torch.obs.metrics.
    LocalStepMetrics` whose ``chunk_n_eff`` holds each chunk's effective
    instances ([1] unchunked), a device tensor computed beside the stats."""
    if backend is None:
        backend = devmod.default_backend(xc.device)
    devmod.check_backend(backend, xc.device)
    N = xc.shape[0]
    if chunk is None or chunk >= N:
        stats, r = _local_step_body(cp, params, xc, xd, mask, r_fixed,
                                    backend)
        if with_metrics:
            return stats, r, LocalStepMetrics(chunk_n_eff=mask.sum()[None])
        return stats, r

    nchunks = -(-N // chunk)
    pad = nchunks * chunk - N
    if pad:
        xc = torch.cat([xc, xc.new_zeros((pad, xc.shape[1]))])
        xd = torch.cat([xd, xd.new_zeros((pad, xd.shape[1]))])
        mask = torch.cat([mask, mask.new_zeros(pad)])   # pads -> stats 0
        if r_fixed is not None:
            r_fixed = torch.cat([r_fixed,
                                 r_fixed.new_zeros((pad, r_fixed.shape[1]))])
    stats, rs = None, []
    for i in range(nchunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        st, r_c = _local_step_body(cp, params, xc[sl], xd[sl], mask[sl],
                                   None if r_fixed is None else r_fixed[sl],
                                   backend)
        stats = st if stats is None else _add_stats(stats, st)
        rs.append(r_c)
    if with_metrics:
        return stats, torch.cat(rs)[:N], LocalStepMetrics(
            chunk_n_eff=mask.view(nchunks, chunk).sum(1))
    return stats, torch.cat(rs)[:N]


# ---------------------------------------------------------------------------
# Global step — conjugate update, Bayesian updating Eq. (3)
# ---------------------------------------------------------------------------


def global_update(prior: PlateParams, stats: PlateStats) -> PlateParams:
    """posterior natural params = prior natural params + summed messages."""
    mix = ef.dirichlet_update(prior.mix, stats.counts)
    reg = ef.mvnormalgamma_update(prior.reg, stats.reg)
    disc = ef.Dirichlet(prior.disc.alpha + stats.disc)
    return PlateParams(mix=mix, reg=reg, disc=disc)


def global_kl(q: PlateParams, p: PlateParams, lay: PlateLayout) -> Tensor:
    kl = ef.dirichlet_kl(q.mix, p.mix)
    kl = kl + ef.mvnormalgamma_kl(q.reg, p.reg).sum()
    if lay.Fd > 0:
        # padded categories have alpha ~ 0 in both q and p -> kl 0
        kl = kl + ef.dirichlet_kl(ef.Dirichlet(q.disc.alpha + 1e-12),
                                  ef.Dirichlet(p.disc.alpha + 1e-12)).sum()
    return kl


def elbo(cp: CompiledPlate, prior: PlateParams, post: PlateParams,
         stats: PlateStats) -> Tensor:
    """local_elbo - KL(q(theta) || p(theta)) (see ``repro.core.vmp.elbo``)."""
    return stats.local_elbo - global_kl(post, prior, cp.layout)


# ---------------------------------------------------------------------------
# Batch VMP fit — sweeps to convergence
# ---------------------------------------------------------------------------


class VMPState(NamedTuple):
    post: PlateParams
    elbo: Tensor
    delta: Tensor
    sweep: int


def fit_loop(cp: CompiledPlate, prior: PlateParams, init: PlateParams,
             xc: Tensor, xd: Tensor, mask: Tensor, max_sweeps: int,
             tol: float, backend: Optional[str] = None,
             chunk: Optional[int] = None,
             reduce_stats: Optional[Callable[[PlateStats], PlateStats]] = None
             ) -> VMPState:
    """One unconditional sweep, then sweeps while ``sweep < max_sweeps`` and
    ``delta > tol * (|elbo| + 1)`` (one host read per sweep).
    ``reduce_stats`` runs between the local and the global step (d-VMP's
    all-reduce of the shards' stats)."""

    def sweep(state: VMPState) -> VMPState:
        stats, _ = local_step(cp, state.post, xc, xd, mask, backend=backend,
                              chunk=chunk)
        if reduce_stats is not None:
            stats = reduce_stats(stats)
        post = global_update(prior, stats)
        e = elbo(cp, prior, post, stats)
        return VMPState(post=post, elbo=e, delta=torch.abs(e - state.elbo),
                        sweep=state.sweep + 1)

    inf = torch.tensor(float("inf"), device=xc.device)
    state = sweep(VMPState(post=init, elbo=-inf, delta=inf, sweep=0))
    while (state.sweep < max_sweeps
           and bool(state.delta > tol * (torch.abs(state.elbo) + 1.0))):
        state = sweep(state)
    return state


def vmp_fit(cp: CompiledPlate, prior: PlateParams, init: PlateParams,
            xc: Tensor, xd: Tensor, max_sweeps: int = 100, tol: float = 1e-4,
            mask: Optional[Tensor] = None, backend: Optional[str] = None,
            chunk: Optional[int] = None) -> VMPState:
    """Run VMP sweeps on one data set until the ELBO converges."""
    if mask is None:
        mask = torch.ones(xc.shape[0], device=xc.device)
    return fit_loop(cp, prior, init, xc, xd, mask, max_sweeps, tol, backend,
                    chunk)


def posterior_z(cp: CompiledPlate, params: PlateParams, xc: Tensor,
                xd: Tensor, *, backend: Optional[str] = None,
                chunk: Optional[int] = None) -> Tensor:
    """q(Z | x) for a batch — the paper's getPosterior(HiddenVar)."""
    mask = torch.ones(xc.shape[0], device=xc.device)
    _, r = local_step(cp, params, xc, xd, mask, backend=backend, chunk=chunk)
    return r
