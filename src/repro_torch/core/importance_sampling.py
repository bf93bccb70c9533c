"""Parallel importance sampling in CLG networks -- paper §2.2 / ref [19]
(counterpart of ``repro.core.importance_sampling``).

Likelihood weighting over a ``BayesianNetwork``: evidence nodes are clamped,
non-evidence nodes are sampled from their conditional given already-sampled
parents, and each particle carries weight prod_e p(e | parents).  All
particles advance node by node in lock-step, one batched draw a node, on the
sampler's device.  Randomness comes from a ``torch.Generator`` on that
device.  The queries reduce in a fixed order (no float atomics), so one seed
gives the same bits on every run.  ``run_inference(mesh=)`` splits the
particles over the data shards of a ``DeviceMesh`` (``core.dvmp``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import device as devmod
from repro_torch.core import dvmp
from repro_torch.core.dag import BayesianNetwork, Variable

Tensor = torch.Tensor


def _log_weights(bn: BayesianNetwork, asg: Dict[str, Tensor],
                 evidence: Dict[str, object]) -> Tensor:
    """log prod_e p(e | parents) of each particle, summed in ``bn.order``."""
    n = next(iter(asg.values())).shape[0]
    logw = torch.zeros(n, device=bn.device)
    for v in bn.order:
        if v.name in evidence:
            logw = logw + bn._node_logp(v, asg)
    return logw


def _sample_or_clamp(bn: BayesianNetwork, gen: torch.Generator, n: int,
                     evidence: Dict[str, object]
                     ) -> Tuple[Dict[str, Tensor], Tensor]:
    """Batched likelihood weighting on ``gen``'s device (which holds the
    network).  Returns (particles, log_weights)."""
    dev = gen.device
    ev = bn.evidence_tensors(evidence, dev)
    asg: Dict[str, Tensor] = {}
    for v in bn.order:
        if v.name in ev:
            asg[v.name] = ev[v.name].expand(n)
            continue
        parents = bn.dag.get_parents(v)
        dpa = [p for p in parents if p.is_discrete]
        cpa = [p for p in parents if not p.is_discrete]
        didx = tuple(asg[p.name].long() for p in dpa)
        cpd = bn.cpds[v.name]
        if v.is_discrete:
            table = cpd.table[didx] if dpa else cpd.table.expand(
                (n,) + tuple(cpd.table.shape))
            asg[v.name] = torch.multinomial(table, 1, generator=gen)[:, 0]
            continue
        pick = lambda t: t[didx] if dpa else t.expand((n,) + tuple(t.shape))
        mean = pick(cpd.alpha)
        if cpa:
            xc = torch.stack([asg[p.name] for p in cpa], -1)
            mean = mean + (pick(cpd.beta) * xc).sum(-1)
        noise = torch.randn(n, generator=gen, device=dev)
        asg[v.name] = mean + torch.sqrt(pick(cpd.sigma2)) * noise
    return asg, _log_weights(bn, asg, evidence)


class ImportanceSampling:
    """Paper §3.4 API: set model / evidence, run, query posteriors.

    Runs on ``device`` (the first card by default; ``"cpu"`` by name),
    which must hold the network."""

    def __init__(self, n_samples: int = 10_000, seed: int = 0,
                 device: devmod.DeviceLike = None) -> None:
        self.n_samples = n_samples
        self.device = devmod.resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.bn: Optional[BayesianNetwork] = None
        self.evidence: Dict[str, object] = {}
        self._particles: Optional[Dict[str, Tensor]] = None
        self._logw: Optional[Tensor] = None

    def set_model(self, bn: BayesianNetwork) -> None:
        if bn.device != self.device:
            raise ValueError(f"the network lives on {bn.device}, the "
                             f"sampler on {self.device}")
        self.bn = bn

    def set_evidence(self, evidence: Dict[str, float]) -> None:
        self.evidence = dict(evidence)

    def run_inference(self, mesh=None,
                      data_axes: Sequence[str] = ("data",)) -> None:
        """Draw ``n_samples`` weighted particles.

        With a ``DeviceMesh`` (every rank calling in the same state), the
        particles are split over the ``w`` data shards: one seed a shard is
        drawn from the sampler's generator (so every rank advances it the
        same way), shard r draws ``n_samples // w`` particles from a
        generator seeded ``seeds[r]`` on the sampler's device, and the
        blocks are gathered in shard order.  So the gathered particles are
        the concatenation, in shard order, of the single-process
        ``_sample_or_clamp`` draws with those seeds."""
        if mesh is None:
            self._particles, self._logw = _sample_or_clamp(
                self.bn, self.gen, self.n_samples, self.evidence)
            return
        axes = dvmp.check_mesh(mesh, data_axes)
        seeds = dvmp.shard_seeds(self.gen, dvmp.data_size(mesh, axes))
        gen = torch.Generator(device=self.device).manual_seed(
            seeds[dvmp.shard_index(mesh, axes)])
        part, logw = _sample_or_clamp(self.bn, gen, self.n_samples
                                      // len(seeds), self.evidence)
        self._particles = {k: dvmp.gather_rows(v, mesh, axes)
                           for k, v in part.items()}
        self._logw = dvmp.gather_rows(logw, mesh, axes)

    # -- queries -------------------------------------------------------------

    def _weights(self) -> Tensor:
        return torch.softmax(self._logw, 0)

    def posterior_discrete(self, var: Variable) -> Tensor:
        """Normalised posterior table of a discrete variable: a one-hot
        weighted sum over the particles, in a fixed order (a scatter-add's
        float atomics would not repeat their bits)."""
        w = self._weights()
        x = self._particles[var.name].long()
        hit = x[:, None] == torch.arange(var.card, device=x.device)
        return (w[:, None] * hit).sum(0)

    def posterior_mean_var(self, var: Variable) -> Tuple[Tensor, Tensor]:
        w = self._weights()
        x = self._particles[var.name]
        mean = (w * x).sum()
        return mean, (w * (x - mean) ** 2).sum()

    def effective_sample_size(self) -> Tensor:
        w = self._weights()
        return 1.0 / (w * w).sum()
