"""Scalable MAP / abductive inference -- paper §2.2 / ref [18]
(counterpart of ``repro.core.map_inference``).

The paper's scheme is map-reduce: scatter many candidate assignments
(Monte-Carlo starts), hill-climb each locally, reduce with max.  Here the
candidates are a batch dimension, the hill climb is ``n_passes`` passes of
coordinate ascent (each variable's ``c`` values scored as one batch of
``c * n`` states), and the reduce is an argmax -- over the data shards of a
``DeviceMesh`` when one is given.

Supported query: most probable joint configuration of the DISCRETE variables
of a CLG ``BayesianNetwork`` given (possibly continuous) evidence; continuous
non-evidence variables are set to their conditional mean given the current
configuration (ancestrally).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch import device as devmod
from repro_torch.core import dvmp
from repro_torch.core.dag import BayesianNetwork, Variable

Tensor = torch.Tensor


def _complete_continuous(bn: BayesianNetwork, asg: Dict[str, Tensor],
                         evidence: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Set non-evidence continuous vars to their conditional mean
    (ancestral)."""
    out = dict(asg)
    for v in bn.order:
        if v.is_discrete or v.name in evidence:
            continue
        parents = bn.dag.get_parents(v)
        dpa = [p for p in parents if p.is_discrete]
        cpa = [p for p in parents if not p.is_discrete]
        didx = tuple(out[p.name].long() for p in dpa)
        cpd = bn.cpds[v.name]
        mean = cpd.alpha[didx] if dpa else cpd.alpha.expand(
            out[bn.order[0].name].shape)
        if cpa:
            beta = cpd.beta[didx] if dpa else cpd.beta
            xc = torch.stack([out[p.name] for p in cpa], -1)
            mean = mean + (beta * xc).sum(-1)
        out[v.name] = mean
    return out


def _query_vars(bn: BayesianNetwork, evidence) -> List[Variable]:
    dvars = [v for v in bn.order if v.is_discrete and v.name not in evidence]
    if not dvars:
        raise ValueError("no discrete query variables")
    return dvars


def _score(bn: BayesianNetwork, dvars: List[Variable],
           ev: Dict[str, Tensor], states: Tensor) -> Tensor:
    """states: [n, Q] int64 -> log p(states, evidence, cont @ mean)."""
    n = states.shape[0]
    asg = {k: v.expand(n) for k, v in ev.items()}
    for i, v in enumerate(dvars):
        asg[v.name] = states[:, i]
    return bn.log_prob(_complete_continuous(bn, asg, ev))


def _starts(dvars: List[Variable], n: int, seed: int, dev: torch.device
            ) -> Tensor:
    """[n, Q] uniform initial states, a column a query variable, from a
    generator seeded ``seed`` on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.stack([torch.randint(v.card, (n,), generator=gen, device=dev)
                        for v in dvars], 1)


def _hill_climb(bn: BayesianNetwork, ev: Dict[str, Tensor], states: Tensor,
                n_passes: int) -> Tuple[Tensor, Tensor]:
    """Coordinate ascent from ``states`` ([n, Q] int64, one column a
    discrete non-evidence variable in ``bn.order``): each pass sets every
    variable in turn to its best value given the others (ties to the lowest
    value, as argmax does).  Returns (states, their log-probs); reads
    nothing back to the host."""
    dvars = _query_vars(bn, ev)
    n = states.shape[0]
    for _ in range(n_passes):
        for i, v in enumerate(dvars):
            c = v.card
            cand = states.repeat(c, 1)
            cand[:, i] = torch.arange(c, device=states.device
                                      ).repeat_interleave(n)
            pick = _score(bn, dvars, ev, cand).view(c, n).argmax(0)
            states = states.clone()
            states[:, i] = pick
    return states, _score(bn, dvars, ev, states)


def map_inference(bn: BayesianNetwork, evidence: Dict[str, float], *,
                  n_starts: int = 128, n_passes: int = 20, seed: int = 0,
                  mesh=None, data_axes: Sequence[str] = ("data",),
                  device: devmod.DeviceLike = None
                  ) -> Tuple[Dict[str, int], float]:
    """Returns (MAP assignment of discrete non-evidence vars, its log-prob).

    Runs on ``device`` (the first card by default), which must hold the
    network; the starts are drawn from a ``torch.Generator`` seeded with
    ``seed`` on that device.

    With a ``DeviceMesh`` (every rank calling with the same arguments),
    shard r of the ``w`` data shards climbs ``max(n_starts // w, 1)``
    starts seeded ``seeds[r]``, one seed a shard drawn from a CPU generator
    seeded ``seed``; the states and scores are gathered in shard order and
    the first maximum wins, as in the reference."""
    dev = devmod.resolve_device(device)
    if bn.device != dev:
        raise ValueError(f"the network lives on {bn.device}, not {dev}")
    ev = bn.evidence_tensors(evidence, dev)
    dvars = _query_vars(bn, ev)
    if mesh is None:
        states, best = _hill_climb(bn, ev, _starts(dvars, n_starts, seed,
                                                   dev), n_passes)
    else:
        axes = dvmp.check_mesh(mesh, data_axes)
        w = dvmp.data_size(mesh, axes)
        seeds = dvmp.shard_seeds(torch.Generator().manual_seed(seed), w)
        start = _starts(dvars, max(n_starts // w, 1),
                        seeds[dvmp.shard_index(mesh, axes)], dev)
        states, best = (dvmp.gather_rows(t, mesh, axes)
                        for t in _hill_climb(bn, ev, start, n_passes))
    idx = int(best.argmax())
    row = states[idx].tolist()
    assignment = {v.name: int(row[i]) for i, v in enumerate(dvars)}
    return assignment, float(best[idx])
