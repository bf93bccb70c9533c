"""Greedy hill-climbing structure search with batched family scoring
(counterpart of ``repro.learn_structure.search``).

The classic score-based search (add / remove / reverse one edge, take the
best positive improvement, repeat) arranged so the device does the heavy
lifting: because the Bayesian scores decompose over families, an operator's
delta touches at most two families, and every family score is cached by
``(child, parent set)`` -- one iteration evaluates ONLY the cache-miss
families of its whole candidate neighborhood, all in batched kernel calls
(``scores.disc_family_scores`` / ``scores.clg_family_scores``).

Acyclicity is guarded by ``DAG.is_ancestor``, touching only the candidate's
ancestor set.  The CLG restriction (no continuous parent of a discrete
child) is enforced on the operator set, so any reachable state is a valid
CLG network.  The search itself is host control flow, move for move the
JAX package's; the data go to ``device`` once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch import device as devmod
from repro_torch.core.dag import BayesianNetwork, DAG
from repro_torch.data.stream import Attribute, Batch
from repro_torch.learn_structure import scores as S

FamilyKey = Tuple[str, FrozenSet[str]]


@dataclasses.dataclass
class SearchResult:
    parents: Dict[str, Tuple[str, ...]]   # child name -> parent names
    score: float                          # total decomposable score
    n_iters: int
    n_scored: int                         # families evaluated (cache misses)
    trace: List[Tuple[str, str, str, float]]  # (op, parent, child, delta)
    bn: Optional[BayesianNetwork] = None


class _Scorer:
    """Cache of family scores, filled by batched device calls."""

    def __init__(self, batch: Batch, attributes: Sequence[Attribute], *,
                 ess: float, kappa: float, a0: float, b0: float,
                 backend: str, device) -> None:
        self.batch = S.batch_to(batch, device)
        self.vs, self.col = S.variables_of(attributes)
        self.cards = [a.card for a in attributes if a.kind == S.FINITE]
        self.ess, self.kappa, self.a0, self.b0 = ess, kappa, a0, b0
        self.backend, self.device = backend, device
        self.cache: Dict[FamilyKey, float] = {}
        self.n_scored = 0

    def ensure(self, keys) -> None:
        """Score every cache-miss family, batched by child kind."""
        disc: List[Tuple[FamilyKey, S.DiscFamily]] = []
        cont: List[Tuple[FamilyKey, S.ContFamily]] = []
        for key in keys:
            if key in self.cache:
                continue
            child, pset = key
            pa = sorted(pset)
            if self.vs.by_name(child).is_discrete:
                disc.append((key, (self.col[child][1],
                                   tuple(self.col[p][1] for p in pa))))
            else:
                cpa = tuple(self.col[p][1] for p in pa
                            if self.col[p][0] == "c")
                dpa = tuple(self.col[p][1] for p in pa
                            if self.col[p][0] == "d")
                cont.append((key, (self.col[child][1], cpa, dpa)))
        if disc:
            got = S.disc_family_scores(
                self.batch.xd, [f for _, f in disc], self.cards,
                mask=self.batch.mask, ess=self.ess, backend=self.backend,
                device=self.device)
            for (key, _), sc in zip(disc, got):
                self.cache[key] = float(sc)
        if cont:
            got = S.clg_family_scores(
                self.batch.xc, self.batch.xd, [f for _, f in cont],
                self.cards, mask=self.batch.mask, kappa=self.kappa,
                a0=self.a0, b0=self.b0, backend=self.backend,
                device=self.device)
            for (key, _), sc in zip(cont, got):
                self.cache[key] = float(sc)
        self.n_scored += len(disc) + len(cont)

    def __getitem__(self, key: FamilyKey) -> float:
        return self.cache[key]


def hill_climb(data, attributes: Sequence[Attribute], *,
               max_parents: int = 2, ess: float = 1.0, kappa: float = 1.0,
               a0: float = 1.0, b0: float = 1.0, max_iters: int = 200,
               min_delta: float = 1e-4, backend: Optional[str] = None,
               device: devmod.DeviceLike = None,
               init_parents: Optional[Dict[str, Sequence[str]]] = None,
               fit: bool = True) -> SearchResult:
    """Greedy add/remove/reverse hill-climbing over CLG structures.

    ``data`` is a ``Batch`` or ``DataStream`` (the window, in the streaming
    setting); ``init_parents`` warm-starts the search (e.g. the previous
    structure after a drift signal).  Returns the learned parent sets, the
    final score, and (``fit=True``) the conjugate-fitted
    ``BayesianNetwork`` ready for ``infer_exact`` / serving.
    """
    dev, backend = S.placement(device, backend)
    scorer = _Scorer(S.as_batch(data), attributes, ess=ess, kappa=kappa,
                     a0=a0, b0=b0, backend=backend, device=dev)
    vs = scorer.vs
    names = [v.name for v in vs]
    dag = DAG(vs)
    if init_parents:
        for child, pas in init_parents.items():
            for p in pas:
                dag.add_parent(vs.by_name(child), vs.by_name(p))

    def pa_set(n: str) -> FrozenSet[str]:
        return frozenset(p.name for p in dag.parents[n])

    def kind_ok(parent: str, child: str) -> bool:
        # CLG restriction: a discrete child takes only discrete parents
        return not (vs.by_name(child).is_discrete
                    and not vs.by_name(parent).is_discrete)

    scorer.ensure({(n, pa_set(n)) for n in names})
    total = sum(scorer[(n, pa_set(n))] for n in names)
    trace: List[Tuple[str, str, str, float]] = []

    it = 0
    for it in range(1, max_iters + 1):
        # -- enumerate the legal neighborhood --------------------------------
        cands: List[Tuple[str, str, str]] = []
        for v in names:
            pv = pa_set(v)
            for u in names:
                if u == v:
                    continue
                if u in pv:
                    cands.append(("remove", u, v))
                    # reverse u->v: the new edge v->u must be kind-legal,
                    # respect u's fan-in, and close no cycle through
                    # another u ~> v path
                    if (kind_ok(v, u)
                            and len(dag.parents[u]) < max_parents):
                        dag.remove_parent(vs.by_name(v), vs.by_name(u))
                        ok = not dag.is_ancestor(u, v)
                        dag.add_parent(vs.by_name(v), vs.by_name(u))
                        if ok:
                            cands.append(("reverse", u, v))
                elif (kind_ok(u, v) and len(pv) < max_parents
                        and not dag.is_ancestor(v, u)):
                    cands.append(("add", u, v))

        # -- batch-score the cache misses, pick the best delta ---------------
        needed = set()
        for op, u, v in cands:
            pv = pa_set(v)
            if op == "add":
                needed.add((v, pv | {u}))
            elif op == "remove":
                needed.add((v, pv - {u}))
            else:
                needed.add((v, pv - {u}))
                needed.add((u, pa_set(u) | {v}))
        scorer.ensure(needed)

        best, best_delta = None, min_delta
        for op, u, v in cands:
            pv = pa_set(v)
            if op == "add":
                delta = scorer[(v, pv | {u})] - scorer[(v, pv)]
            elif op == "remove":
                delta = scorer[(v, pv - {u})] - scorer[(v, pv)]
            else:
                pu = pa_set(u)
                delta = (scorer[(v, pv - {u})] - scorer[(v, pv)]
                         + scorer[(u, pu | {v})] - scorer[(u, pu)])
            if delta > best_delta:
                best, best_delta = (op, u, v), delta
        if best is None:
            break

        op, u, v = best
        if op == "add":
            dag.add_parent(vs.by_name(v), vs.by_name(u))
        elif op == "remove":
            dag.remove_parent(vs.by_name(v), vs.by_name(u))
        else:
            dag.remove_parent(vs.by_name(v), vs.by_name(u))
            dag.add_parent(vs.by_name(u), vs.by_name(v))
        total += best_delta
        trace.append((op, u, v, best_delta))

    parents = {n: tuple(p.name for p in dag.parents[n]) for n in names}
    bn = None
    if fit:
        bn = S.fit_cpds(attributes, {n: list(p) for n, p in parents.items()},
                        scorer.batch, ess=ess, kappa=kappa, a0=a0, b0=b0,
                        backend=backend, device=dev)
    return SearchResult(parents=parents, score=total, n_iters=it,
                        n_scored=scorer.n_scored, trace=trace, bn=bn)
