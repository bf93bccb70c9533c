"""Stochastic Variational Inference (Hoffman et al., 2013) -- paper §2.2
(counterpart of ``repro.core.svi``).

SVI replaces the full-data global update with a natural-gradient step on the
global variational parameters, computed from a minibatch scaled to the full
data size:

    eta_{t+1} = (1 - rho_t) eta_t + rho_t ( eta_prior + (N/B) * stats_batch )

where eta are the NATURAL coordinates of the conjugate families:

    Dirichlet      : alpha
    MVNormalGamma  : ( K, K m, a, b + 1/2 m^T K m )

the coordinates in which the conjugate update is addition of suff stats.
The E-step is ``vmp.local_step``, so on a card a step launches the CUDA
suff-stats kernels.  The step count stays on the device: a step reads
nothing back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import expfam as ef
from repro_torch.core import vmp as V
from repro_torch.core.vmp import CompiledPlate, PlateParams, PlateStats

Tensor = torch.Tensor


class NatParams(NamedTuple):
    mix: Tensor       # alpha
    reg_K: Tensor
    reg_Km: Tensor
    reg_a: Tensor
    reg_bq: Tensor    # b + 1/2 m^T K m
    disc: Tensor      # alpha


def to_natural(p: PlateParams) -> NatParams:
    km = torch.einsum("...de,...e->...d", p.reg.K, p.reg.m)
    quad = torch.einsum("...d,...d->...", p.reg.m, km)
    return NatParams(mix=p.mix.alpha, reg_K=p.reg.K, reg_Km=km,
                     reg_a=p.reg.a, reg_bq=p.reg.b + 0.5 * quad,
                     disc=p.disc.alpha)


def from_natural(n: NatParams) -> PlateParams:
    # solve_ex skips the info check, a host sync on a card (as in
    # expfam.mvnormalgamma_update); the solution's bits are solve's
    m = torch.linalg.solve_ex(n.reg_K, n.reg_Km[..., None],
                              check_errors=False)[0][..., 0]
    quad = torch.einsum("...d,...d->...", m, n.reg_Km)
    b = torch.clamp(n.reg_bq - 0.5 * quad, min=1e-10)
    return PlateParams(mix=ef.Dirichlet(n.mix),
                       reg=ef.MVNormalGamma(m=m, K=n.reg_K, a=n.reg_a, b=b),
                       disc=ef.Dirichlet(n.disc))


def stats_as_natural(stats: PlateStats) -> NatParams:
    """Suff stats expressed as a natural-coordinate increment."""
    reg = ef.reg_dense(stats.reg)        # expand the lazy latent block
    return NatParams(mix=stats.counts, reg_K=reg.sxx, reg_Km=reg.sxy,
                     reg_a=0.5 * stats.reg.n, reg_bq=0.5 * stats.reg.syy,
                     disc=stats.disc)


class SVIState(NamedTuple):
    nat: NatParams
    step: Tensor      # 0-dim int64, on the parameters' device


def svi_init(post: PlateParams) -> SVIState:
    return SVIState(nat=to_natural(post),
                    step=torch.zeros((), dtype=torch.int64,
                                     device=post.mix.alpha.device))


def svi_step(cp: CompiledPlate, prior: PlateParams, state: SVIState,
             xc, xd, n_total: float, *, tau: float = 1.0, kappa: float = 0.7,
             backend: Optional[str] = None, chunk: Optional[int] = None
             ) -> SVIState:
    """One natural-gradient step on the minibatch (xc, xd) (arrays or
    tensors; moved to the state's device); Robbins-Monro rate
    rho_t = (t + tau)^-kappa, kappa in (0.5, 1].

    ``backend``/``chunk`` select the suff-stats reduction schedule of the
    E-step (see :func:`repro_torch.core.vmp.local_step`); ``backend=None``
    follows the device."""
    dev = state.step.device
    xc = torch.as_tensor(xc).to(device=dev, dtype=torch.float32)
    xd = torch.as_tensor(xd).to(device=dev, dtype=torch.int32)
    B = xc.shape[0]
    post = from_natural(state.nat)
    stats, _ = V.local_step(cp, post, xc, xd,
                            torch.ones(B, device=dev), backend=backend,
                            chunk=chunk)
    scale = n_total / B
    target = NatParams(*(p + scale * s for p, s in
                         zip(to_natural(prior), stats_as_natural(stats))))
    rho = (state.step + tau) ** (-kappa)
    nat = NatParams(*((1.0 - rho) * cur + rho * tgt
                      for cur, tgt in zip(state.nat, target)))
    return SVIState(nat=nat, step=state.step + 1)


def svi_posterior(state: SVIState) -> PlateParams:
    return from_natural(state.nat)
