"""Natural coordinates of the plate posterior (counterpart of the part of
``repro.core.svi`` that the drift tempering needs):

    Dirichlet      : alpha
    MVNormalGamma  : ( K, K m, a, b + 1/2 m^T K m )

the coordinates in which the conjugate update is addition of suff stats.
The SVI optimizer itself comes with a later slice of the port."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import expfam as ef
from repro_torch.core.vmp import PlateParams

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
    m = torch.linalg.solve(n.reg_K, n.reg_Km[..., None])[..., 0]
    quad = torch.einsum("...d,...d->...", m, n.reg_Km)
    b = torch.clamp(n.reg_bq - 0.5 * quad, min=1e-10)
    return PlateParams(mix=ef.Dirichlet(n.mix),
                       reg=ef.MVNormalGamma(m=m, K=n.reg_K, a=n.reg_a, b=b),
                       disc=ef.Dirichlet(n.disc))
