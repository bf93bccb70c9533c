"""Brute-force enumeration oracle for exact inference on tiny networks
(counterpart of ``repro.infer_exact.brute``).

Independent of the factor algebra and junction tree: enumerates every joint
discrete configuration and, per configuration, composes the EXACT joint
Gaussian over the continuous variables (the linear-Gaussian system
``x = A x + b + e`` solved in closed form), so it covers the full CLG class
-- including unobserved continuous *internal* nodes with observed continuous
descendants, the case the strong junction tree exists for.  Discrete-only
scoring still goes through ``BayesianNetwork._node_logp`` (the same density
code the samplers use), so this cross-checks the whole ``infer_exact``
stack, not just the message passing.

Every function takes ``device`` (default: the device of the network's
CPDs) and computes there in fp32, as the reference does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.dag import BayesianNetwork, Variable

Tensor = torch.Tensor


def _device(bn: BayesianNetwork, device) -> torch.device:
    return bn.device if device is None else torch.device(device)


def _discrete_grid(bn: BayesianNetwork, device):
    dvars = [v for v in bn.order if v.is_discrete]
    names = tuple(v.name for v in dvars)
    cards = tuple(v.card for v in dvars)
    grids = torch.meshgrid(*[torch.arange(c, device=device) for c in cards],
                           indexing="ij") if cards else ()
    asg = {v.name: g.reshape(-1) for v, g in zip(dvars, grids)}
    n_cfg = asg[names[0]].shape[0] if names else 1
    return names, cards, asg, n_cfg


def _cont_joint(bn: BayesianNetwork, asg: Dict[str, Tensor], n_cfg: int,
                device) -> Tuple[Tuple[str, ...], Tensor, Tensor]:
    """Per-configuration joint Gaussian over ALL continuous variables.

    The CLG system is ``x = A(d) x + b(d) + e``, ``e ~ N(0, diag(s2(d)))``
    with A strictly lower-triangular in topological order, so
    ``mean = (I - A)^-1 b`` and ``cov = (I - A)^-1 diag(s2) (I - A)^-T``.
    Returns (names, mean [n_cfg, C], cov [n_cfg, C, C]).
    """
    cvars = [v for v in bn.order if not v.is_discrete]
    names = tuple(v.name for v in cvars)
    n = len(cvars)
    idx = {name: i for i, name in enumerate(names)}
    A = torch.zeros((n_cfg, n, n), device=device)
    b = torch.zeros((n_cfg, n), device=device)
    s2 = torch.zeros((n_cfg, n), device=device)
    for v in cvars:
        i = idx[v.name]
        parents = bn.dag.get_parents(v)
        dpa = [p for p in parents if p.is_discrete]
        cpa = [p for p in parents if not p.is_discrete]
        didx = tuple(asg[p.name].long() for p in dpa)
        cpd = bn.cpds[v.name]
        b[:, i] = cpd.alpha.to(device, torch.float32)[didx]
        s2[:, i] = cpd.sigma2.to(device, torch.float32)[didx]
        if cpa:
            beta = torch.broadcast_to(
                cpd.beta.to(device, torch.float32)[didx], (n_cfg, len(cpa)))
            for ci, p in enumerate(cpa):
                A[:, i, idx[p.name]] = beta[:, ci]
    I_A = torch.eye(n, device=device).expand(n_cfg, n, n) - A
    mean = torch.linalg.solve(I_A, b[..., None])[..., 0]
    M = torch.linalg.inv(I_A)
    cov = M @ (s2[..., None] * M.transpose(-1, -2))
    return names, mean, cov


def _evidence(evidence, device) -> Dict[str, Tensor]:
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in (evidence or {}).items()}


def enumerate_log_joint(
    bn: BayesianNetwork,
    evidence: Optional[Dict[str, float]] = None,
    device=None,
) -> Tuple[Tuple[str, ...], Tuple[int, ...], Tensor]:
    """Unnormalized log p(x_discrete, e) over the full discrete grid.

    Returns (names, cards, table [*cards]).  Observed continuous nodes
    contribute the density of the per-configuration joint-Gaussian marginal
    over the observed set; unobserved continuous nodes (internal or leaf)
    integrate out exactly.
    """
    device = _device(bn, device)
    evidence = _evidence(evidence, device)
    names, cards, asg, n_cfg = _discrete_grid(bn, device)
    on_bn = {k: t.to(bn.device) for k, t in asg.items()}
    total = torch.zeros(n_cfg, device=device)
    for v in bn.order:
        if not v.is_discrete:
            continue
        total = total + bn._node_logp(v, on_bn).to(device, torch.float32)
        if v.name in evidence:
            hit = asg[v.name] == evidence[v.name].long()
            total = torch.where(hit, total, -torch.inf)
    cnames = [v.name for v in bn.order
              if not v.is_discrete and v.name in evidence]
    if cnames:
        all_names, mean, cov = _cont_joint(bn, asg, n_cfg, device)
        oi = torch.tensor([all_names.index(n) for n in cnames],
                          device=device)
        x = torch.stack([evidence[n].reshape(()) for n in cnames])
        total = total + torch.distributions.MultivariateNormal(
            mean[:, oi], cov[:, oi[:, None], oi[None, :]]).log_prob(x)
    return names, cards, total.reshape(cards)


def brute_posterior(
    bn: BayesianNetwork,
    var: Variable,
    evidence: Optional[Dict[str, float]] = None,
    device=None,
) -> Tensor:
    """Normalized posterior table p(var | evidence) by full enumeration."""
    names, cards, table = enumerate_log_joint(bn, evidence, device)
    axis = names.index(var.name)
    other = tuple(i for i in range(len(names)) if i != axis)
    marg = torch.logsumexp(table, dim=other) if other else table
    return torch.exp(marg - torch.logsumexp(marg, 0))


def brute_log_evidence(
    bn: BayesianNetwork, evidence: Dict[str, float], device=None
) -> Tensor:
    """log p(e) by full enumeration."""
    _, _, table = enumerate_log_joint(bn, evidence, device)
    return torch.logsumexp(table.reshape(-1), 0)


def brute_posterior_mean_var(
    bn: BayesianNetwork,
    var: Variable,
    evidence: Optional[Dict[str, float]] = None,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """Exact posterior mean and variance of an unobserved continuous node.

    Per discrete configuration, conditions the joint Gaussian on the
    observed continuous values, then mixes the conditional moments with the
    configuration posterior -- the ground truth the strong junction tree's
    weak marginals must reproduce exactly.
    """
    device = _device(bn, device)
    ev = _evidence(evidence, device)
    name = var if isinstance(var, str) else var.name
    if name in ev:
        raise ValueError(f"{name!r} is observed")
    _, _, table = enumerate_log_joint(bn, evidence, device)
    logw = table.reshape(-1)
    w = torch.exp(logw - torch.logsumexp(logw, 0))
    _, _, asg, n_cfg = _discrete_grid(bn, device)
    all_names, mean, cov = _cont_joint(bn, asg, n_cfg, device)
    vi = all_names.index(name)
    onames = [n for n in all_names if n in ev]
    if onames:
        oi = torch.tensor([all_names.index(n) for n in onames],
                          device=device)
        x = torch.stack([ev[n].reshape(()) for n in onames])
        coo = cov[:, oi[:, None], oi[None, :]]
        cvo = cov[:, vi, oi]                              # [n_cfg, o]
        sol = torch.linalg.solve(coo, (x - mean[:, oi])[..., None])[..., 0]
        mu_c = mean[:, vi] + (cvo * sol).sum(-1)
        gain = torch.linalg.solve(coo, cvo[..., None])[..., 0]
        s2_c = cov[:, vi, vi] - (cvo * gain).sum(-1)
    else:
        mu_c, s2_c = mean[:, vi], cov[:, vi, vi]
    m = (w * mu_c).sum()
    second = (w * (s2_c + mu_c ** 2)).sum()
    return m, second - m ** 2
