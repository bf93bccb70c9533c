"""The modeling language: variables, DAGs and (conditional linear Gaussian)
Bayesian networks -- paper §2.1 and Code Fragment 11 (counterpart of
``repro.core.dag``).

* ``BayesianNetwork`` -- a concrete CLG network (discrete multinomial nodes +
  continuous CLG nodes, Eq. 2) with materialized CPD tensors: joint
  log-density and ancestral sampling.  Exact inference
  (``repro_torch.infer_exact``) operates on it, and
  ``Model.to_bayesian_network()`` exports a fitted plate model as one.
* ``PlateSpec`` -- the Fig.-3 plate family the VMP engine compiles.

Structure (graphs, names) is static Python; parameters are torch tensors.
CPD tables keep their parents in ``get_parents`` order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

DISCRETE = "multinomial"
CONTINUOUS = "gaussian"


@dataclasses.dataclass(frozen=True)
class Variable:
    name: str
    kind: str  # DISCRETE | CONTINUOUS
    card: int = 0  # cardinality for discrete vars

    @property
    def is_discrete(self) -> bool:
        return self.kind == DISCRETE


class Variables:
    """Variable registry -- mirrors ``eu.amidst.core.variables.Variables``."""

    def __init__(self) -> None:
        self._vars: List[Variable] = []
        self._by_name: Dict[str, Variable] = {}

    def new_multinomial(self, name: str, card: int) -> Variable:
        return self._add(Variable(name, DISCRETE, card))

    def new_gaussian(self, name: str) -> Variable:
        return self._add(Variable(name, CONTINUOUS))

    def _add(self, v: Variable) -> Variable:
        if v.name in self._by_name:
            raise ValueError(f"duplicate variable {v.name!r}")
        self._vars.append(v)
        self._by_name[v.name] = v
        return v

    def by_name(self, name: str) -> Variable:
        return self._by_name[name]

    def __iter__(self):
        return iter(self._vars)

    def __len__(self) -> int:
        return len(self._vars)


class DAG:
    """Parent-set container over a ``Variables`` registry (Code Fragment 11)."""

    def __init__(self, variables: Variables) -> None:
        self.variables = variables
        self.parents: Dict[str, List[Variable]] = {v.name: [] for v in variables}

    def is_ancestor(self, anc: str, desc: str) -> bool:
        """True iff ``anc`` reaches ``desc`` along directed edges (reflexive);
        walks only ``desc``'s ancestor set."""
        stack, seen = [desc], set()
        while stack:
            u = stack.pop()
            if u == anc:
                return True
            if u in seen:
                continue
            seen.add(u)
            stack.extend(p.name for p in self.parents[u])
        return False

    def add_parent(self, child: Variable, parent: Variable) -> None:
        if parent.name == child.name:
            raise ValueError("self-loop")
        if any(p.name == parent.name for p in self.parents[child.name]):
            raise ValueError(
                f"duplicate edge {parent.name!r} -> {child.name!r}")
        # the new edge closes a cycle iff the child is already an ancestor
        # of the parent; checked before mutation, so a rejected edge leaves
        # the DAG untouched
        if self.is_ancestor(child.name, parent.name):
            raise ValueError(
                f"edge {parent.name!r} -> {child.name!r} creates a cycle")
        self.parents[child.name].append(parent)

    def remove_parent(self, child: Variable, parent: Variable) -> None:
        """Delete edge parent -> child (structure-search remove/reverse)."""
        pas = self.parents[child.name]
        for i, p in enumerate(pas):
            if p.name == parent.name:
                del pas[i]
                return
        raise ValueError(f"no edge {parent.name!r} -> {child.name!r}")

    def get_parents(self, v: Variable) -> List[Variable]:
        return self.parents[v.name]

    def topological_order(self) -> List[Variable]:
        """Parents before children, registry order breaking ties (iterative
        DFS: no recursion limit on deep chains)."""
        order: List[Variable] = []
        seen, mark = set(), set()
        for root in self.variables:
            if root.name in seen:
                continue
            mark.add(root.name)
            stack = [(root, iter(self.parents[root.name]))]
            while stack:
                v, it = stack[-1]
                for p in it:
                    if p.name in seen:
                        continue
                    if p.name in mark:
                        raise ValueError("cycle in DAG")
                    mark.add(p.name)
                    stack.append((p, iter(self.parents[p.name])))
                    break
                else:
                    stack.pop()
                    mark.discard(v.name)
                    seen.add(v.name)
                    order.append(v)
        return order


# ---------------------------------------------------------------------------
# Concrete CLG Bayesian network
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultinomialCPD:
    """p(X | discrete parents): table of shape parent_cards + [card]."""

    table: Tensor  # normalized along the last axis


@dataclasses.dataclass
class CLGCPD:
    """Eq. 2: N(z ; alpha(x_D) + beta(x_D)^T x_C, sigma2(x_D)).

    ``alpha``: [*parent_cards], ``beta``: [*parent_cards, C], ``sigma2``:
    [*parent_cards]; C = number of continuous parents (may be 0).
    """

    alpha: Tensor
    beta: Tensor
    sigma2: Tensor


class BayesianNetwork:
    """A CLG Bayesian network with materialized CPDs.

    ``assignments`` passed to :meth:`log_prob` map variable name -> value
    tensor; all value tensors share a leading batch shape.
    """

    def __init__(self, dag: DAG, cpds: Dict[str, object]) -> None:
        self.dag = dag
        self.cpds = cpds
        self.order = dag.topological_order()
        for v in self.order:
            if v.name not in cpds:
                raise ValueError(f"missing CPD for {v.name}")
            parents = dag.get_parents(v)
            if v.is_discrete and any(not p.is_discrete for p in parents):
                raise ValueError(
                    f"CLG restriction: discrete node {v.name} with continuous parent"
                )

    @property
    def device(self) -> torch.device:
        """The device that holds the CPD tensors."""
        cpd = next(iter(self.cpds.values()))
        return (cpd.table if isinstance(cpd, MultinomialCPD)
                else cpd.alpha).device

    # -- density ------------------------------------------------------------

    def log_prob(self, assignment: Dict[str, Tensor]) -> Tensor:
        total = 0.0
        for v in self.order:
            total = total + self._node_logp(v, assignment)
        return total

    def _node_logp(self, v: Variable, asg: Dict[str, Tensor]) -> Tensor:
        parents = self.dag.get_parents(v)
        dpa = [p for p in parents if p.is_discrete]
        cpa = [p for p in parents if not p.is_discrete]
        didx = tuple(asg[p.name].long() for p in dpa)
        cpd = self.cpds[v.name]
        if v.is_discrete:
            table = cpd.table[didx]  # [batch..., card] if dpa else [card]
            x = asg[v.name].long()
            if not dpa:
                return torch.log(table[x])
            return torch.log(torch.gather(table, -1, x[..., None])[..., 0])
        mean = cpd.alpha[didx]
        sigma2 = cpd.sigma2[didx]
        if cpa:
            beta = cpd.beta[didx]  # [..., C]
            xc = torch.stack([asg[p.name] for p in cpa], -1)
            mean = mean + (beta * xc).sum(-1)
        z = asg[v.name]
        return -0.5 * (torch.log(2 * math.pi * sigma2) + (z - mean) ** 2 / sigma2)

    def evidence_tensors(self, evidence: Dict[str, object],
                         device: torch.device) -> Dict[str, Tensor]:
        """Evidence values as 0-dim tensors on ``device``: int64 for a
        discrete node, float32 for a continuous one."""
        by_name = self.dag.variables.by_name
        return {k: torch.as_tensor(v).to(
                    device=device, dtype=torch.int64
                    if by_name(k).is_discrete else torch.float32)
                for k, v in evidence.items()}

    # -- ancestral sampling ---------------------------------------------------

    def sample(self, generator: torch.Generator, n: int) -> Dict[str, Tensor]:
        """``n`` joint samples, drawn on the generator's device."""
        dev = generator.device
        asg: Dict[str, Tensor] = {}
        for v in self.order:
            parents = self.dag.get_parents(v)
            dpa = [p for p in parents if p.is_discrete]
            cpa = [p for p in parents if not p.is_discrete]
            didx = tuple(asg[p.name] for p in dpa)
            cpd = self.cpds[v.name]
            if v.is_discrete:
                table = cpd.table.to(dev)
                table = table[didx] if dpa else table.expand(
                    (n,) + tuple(table.shape))
                asg[v.name] = torch.multinomial(table, 1, generator=generator
                                                )[:, 0]
                continue
            pick = lambda t: t.to(dev)[didx] if dpa else t.to(dev).expand(
                (n,) + tuple(t.shape))
            mean = pick(cpd.alpha)
            if cpa:
                xc = torch.stack([asg[p.name] for p in cpa], -1)
                mean = mean + (pick(cpd.beta) * xc).sum(-1)
            noise = torch.randn(n, generator=generator, device=dev)
            asg[v.name] = mean + torch.sqrt(pick(cpd.sigma2)) * noise
        return asg

    def __str__(self) -> str:  # paper Code Fragment 8 style print-out
        lines = ["Bayesian Network:"]
        for v in self.order:
            parents = self.dag.get_parents(v)
            pstr = ", ".join(p.name for p in parents)
            head = f"P({v.name}" + (f" | {pstr})" if parents else ")")
            cpd = self.cpds[v.name]
            if v.is_discrete:
                lines.append(f"{head} follows a Multinomial")
                lines.append(f"  {np.asarray(cpd.table.cpu())}")
            else:
                lines.append(f"{head} follows a Normal|Multinomial (CLG)")
                lines.append(
                    f"  alpha={np.asarray(cpd.alpha.cpu())} "
                    f"beta={np.asarray(cpd.beta.cpu())}"
                    f" sigma2={np.asarray(cpd.sigma2.cpu())}"
                )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Plate family compiled by the VMP engine (paper Fig. 3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlateSpec:
    """Fig.-3 plate model, the class of structures the learning engine accepts.

    n_features        number of observed leaves X_i (continuous unless listed
                      in ``discrete_features`` with its cardinality)
    latent_card       cardinality of the per-instance discrete latent Z_i
                      (0 = no discrete latent; 1 behaves as "no mixture")
    latent_dim        dimension of the per-instance continuous latent H_i
                      (0 = none), standard-normal prior, linear-Gaussian
                      children (FA/PPCA family)
    feature_parents   for each observed leaf, indices of observed continuous
                      features acting as CLG parents; empty for plain leaves
    discrete_features map feature index -> cardinality for multinomial leaves
    """

    n_features: int
    latent_card: int = 0
    latent_dim: int = 0
    feature_parents: Tuple[Tuple[int, ...], ...] = ()
    discrete_features: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        if self.feature_parents and len(self.feature_parents) != self.n_features:
            raise ValueError("feature_parents must list every feature")

    @property
    def discrete_map(self) -> Dict[int, int]:
        return dict(self.discrete_features)

    def parent_idx(self, i: int) -> Tuple[int, ...]:
        if not self.feature_parents:
            return ()
        return self.feature_parents[i]
