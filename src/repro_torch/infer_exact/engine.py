"""JunctionTreeEngine -- native exact inference for CLG Bayesian networks
(counterpart of ``repro.infer_exact.engine``).

Replaces the AMIDST paper's HUGIN link (§2.2) with the same
``set_model / set_evidence / run_inference / posterior_*`` surface.

Two-pass (collect/distribute) belief propagation on the compiled clique
tree.  All tables carry a leading evidence-batch axis, so ``set_evidence``
with ``[B]``-shaped value arrays propagates B query instances through the
tree at once -- the serving path batches requests that share an evidence
*schema* (set of observed names) onto this axis.

Two pipelines, chosen statically from the network:

  * **discrete pipeline** -- networks whose continuous nodes have no
    continuous parents (mixtures, naive Bayes, ...).  Continuous CLG nodes
    are handled by analytic conditioning on their discrete parents.  Tables
    are discrete factors (``factors.py``); absorption and marginalization
    run the ``log_product`` / ``log_marginalize`` kernels on a card.

  * **strong pipeline** (Lauritzen 1992) -- any network with a continuous-
    continuous edge.  The clique tree is strongly triangulated and rooted
    (``graph.py``); potentials are conditional-Gaussian tables
    (``cg_potentials.py``).  Collect uses EXACT strong marginalization,
    distribute uses weak (moment-matched) marginals -- the ``cg_weak_marg``
    kernel on a card -- so every clique ends up holding the true weak
    marginal of the posterior.

The engine runs on one device (``device=None`` is the first CUDA card and
raises without one; pass ``device="cpu"`` for the CPU).  The backend follows
the device: ``"cuda"`` kernels on a card, the plain PyTorch path
(``"einsum"``) on the CPU; the plain path runs on a card only when named.
"""

from __future__ import annotations

import math
import time
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core.dag import BayesianNetwork, Variable
from repro_torch.infer_exact import cg_potentials as CG
from repro_torch.infer_exact import factors as F
from repro_torch.infer_exact.graph import (JunctionTree, compile_junction_tree,
                                           compile_strong_junction_tree)
from repro_torch.obs import sink as obs
from repro_torch.obs.trace import span
from repro_torch.serve.plan import PlanCache, PlanKey

Tensor = torch.Tensor


def _needs_strong(bn: BayesianNetwork) -> bool:
    """Strong pipeline iff some continuous node has a continuous parent."""
    for v in bn.order:
        if v.is_discrete:
            continue
        if any(not p.is_discrete for p in bn.dag.get_parents(v)):
            return True
    return False


class JunctionTreeEngine:
    """Paper §3.4 inference API, exact flavor."""

    def __init__(self, bn: Optional[BayesianNetwork] = None, *,
                 backend: Optional[str] = None,
                 device: devmod.DeviceLike = None,
                 bucketed: bool = True,
                 plan_cache: Optional[PlanCache] = None,
                 network_version: int = 0) -> None:
        self.device = devmod.resolve_device(device)
        self.backend = devmod.check_backend(
            backend or devmod.default_backend(self.device), self.device)
        # strong pipeline: batch per-clique solve/slogdet/weak-marginal calls
        # through shape buckets per tree level (False = one call per clique,
        # the reference schedule; results agree -- tested)
        self.bucketed = bucketed
        self.bn: Optional[BayesianNetwork] = None
        self.jt: Optional[JunctionTree] = None
        self.evidence: Dict[str, Tensor] = {}
        self._beliefs: Optional[Tuple] = None
        self._logz: Optional[Tensor] = None
        self._batched = False
        # propagation plans live in a PlanCache keyed on (network_version,
        # pipeline, schema, batch, dtypes), shared with the serving tier
        self.plans = plan_cache if plan_cache is not None else PlanCache()
        self.network_version = network_version
        self.last_run: Optional[Dict[str, object]] = None
        if bn is not None:
            self.set_model(bn, network_version=network_version)

    # -- compilation ---------------------------------------------------------

    def set_model(self, bn: BayesianNetwork, *,
                  network_version: Optional[int] = None) -> None:
        """(Re)compile the junction tree for ``bn``.

        ``network_version`` stamps the plan keys of every propagation plan
        built for this network; re-setting a model without an explicit
        version bumps it, so plans of the old network never serve the new
        one.
        """
        if network_version is not None:
            self.network_version = network_version
        elif self.bn is not None:
            self.network_version += 1
        self.bn = bn
        self.strong = _needs_strong(bn)
        self.jt = (compile_strong_junction_tree(bn) if self.strong
                   else compile_junction_tree(bn))
        self._card = {v.name: v.card for v in bn.order if v.is_discrete}
        self._cont = {v.name for v in bn.order if not v.is_discrete}
        # canonical (sorted) scopes per clique -- the propagation's output
        # layout
        self._scopes: Tuple[Tuple[str, ...], ...] = tuple(
            tuple(sorted(c - self._cont)) for c in self.jt.cliques)
        self._cscopes: Tuple[Tuple[str, ...], ...] = tuple(
            tuple(sorted(c & self._cont)) for c in self.jt.cliques)
        # home clique of every CPD / lambda factor
        self._home: Dict[str, Optional[int]] = {}
        for v in bn.order:
            if self.strong:
                fam = {v.name} | {p.name for p in bn.dag.get_parents(v)}
                self._home[v.name] = self.jt.smallest_containing(fam)
                continue
            dpa = {p.name for p in bn.dag.get_parents(v) if p.is_discrete}
            if v.is_discrete:
                self._home[v.name] = self.jt.smallest_containing({v.name} | dpa)
            else:
                self._home[v.name] = (
                    self.jt.smallest_containing(dpa) if dpa else 0)
        # message schedule: DFS from the root, children -> root then back
        root = self.jt.root
        adj: Dict[int, List[Tuple[int, Tuple[str, ...]]]] = {
            i: [] for i in range(len(self.jt.cliques))}
        for (a, b), s in zip(self.jt.edges, self.jt.sepsets):
            sep = tuple(sorted(s))
            adj[a].append((b, sep))
            adj[b].append((a, sep))
        seen = {root}
        stack: List[Tuple[int, int, Tuple[str, ...]]] = [
            (c, root, s) for c, s in adj[root]]
        pre: List[Tuple[int, int, Tuple[str, ...]]] = []
        while stack:
            u, p, s = stack.pop()
            if u in seen:
                continue
            seen.add(u)
            pre.append((u, p, s))
            for w, sw in adj[u]:
                if w not in seen:
                    stack.append((w, u, sw))
        self._collect = tuple(reversed(pre))     # post-order: leaves first
        self._distribute = tuple(pre)            # root outward
        # CPD tensors on the engine's device, once per network
        self._cpd = {
            v.name: (bn.cpds[v.name].table.to(self.device, torch.float32),)
            if v.is_discrete else tuple(
                getattr(bn.cpds[v.name], f).to(self.device, torch.float32)
                for f in ("alpha", "beta", "sigma2"))
            for v in bn.order}
        self._beliefs = None

    # -- evidence / propagation ----------------------------------------------

    def set_evidence(self, evidence: Dict[str, object]) -> None:
        """Observed values by name: scalars or [B] arrays.  Discrete values
        (floats are accepted, as the serving tier sends them) are checked
        against the cardinality and cast to int32; continuous values are
        float32."""
        ev: Dict[str, Tensor] = {}
        by_name = ({v.name: v for v in self.bn.order}
                   if self.bn is not None else {})
        for k, a in evidence.items():
            vals = np.asarray(a.cpu() if isinstance(a, Tensor) else a)
            if self.bn is not None:
                if k not in by_name:
                    raise ValueError(f"unknown evidence variable {k!r}")
                v = by_name[k]
                if v.is_discrete:
                    if vals.size and ((vals < 0) | (vals >= v.card)).any():
                        raise ValueError(
                            f"evidence for {k!r} outside [0, {v.card})")
                    vals = vals.astype(np.int32)
                else:
                    vals = vals.astype(np.float32)
            ev[k] = torch.from_numpy(np.ascontiguousarray(vals)).to(
                self.device)
        self.evidence = ev
        self._beliefs = None

    def _plan_levels(self) -> List[int]:
        """Clique count per tree depth (root = level 0) -- the shape of the
        propagation plan, reported by the ``jt_plan`` event."""
        depth = {self.jt.root: 0}
        for u, p, _ in self._distribute:     # preorder: parent before child
            depth[u] = depth[p] + 1
        levels = [0] * (max(depth.values()) + 1 if depth else 1)
        for d in depth.values():
            levels[d] += 1
        return levels

    def run_inference(self) -> None:
        """Propagate the (batched) evidence through the tree.

        Zero-probability evidence is reported as ``log_evidence() == -inf``
        (posteriors are then 0/0 = NaN -- check the evidence first).

        Plans are built once per ``(schema, batch, dtypes)`` key;
        ``self.last_run`` records ``{"cache_hit", "compile_us",
        "execute_us", "batch", "pipeline"}`` (``compile_us``: the time the
        plan's build took; ``execute_us``: host time of the propagation, which
        returns before the card has finished).  With ``repro_torch.obs`` on,
        a new plan emits a ``jt_plan`` event (clique counts per tree level);
        at TRACE, ``jt.compile`` / ``jt.execute`` spans are emitted and the
        execute span synchronizes the card, so it measures the propagation
        and not its enqueueing.  Below TRACE nothing synchronizes.
        """
        names = tuple(sorted(self.evidence))
        vals = []
        B = 1
        for n in names:
            a = self.evidence[n].reshape(-1)
            B = max(B, a.shape[0])
            vals.append(a)
        sizes = {v.shape[0] for v in vals if v.shape[0] > 1}
        if len(sizes) > 1:
            raise ValueError(
                f"evidence batch lengths disagree: {sorted(sizes)}")
        self._batched = any(v.shape[0] > 1 for v in vals)
        vals = tuple(v.expand(B) for v in vals)
        pipeline = "strong" if self.strong else "discrete"
        key = PlanKey(self.network_version, f"jt-{pipeline}", names, (B,),
                      tuple(str(v.dtype) for v in vals))
        cache_hit = self.plans.peek(key) is not None
        compile_us = 0.0
        # a plan a hot swap dropped since the peek is built again
        plan = self.plans.get(key) if cache_hit else None
        if plan is None:
            cache_hit = False
            prop = self._propagate_strong if self.strong else self._propagate

            def build():
                with span("jt.compile", schema=",".join(names), batch=B,
                          pipeline=pipeline):
                    return partial(prop, names)

            plan = self.plans.get(key, build)
            compile_us = plan.compile_us
            if obs.enabled():
                obs.emit("jt_plan", pipeline=pipeline,
                         n_cliques=len(self.jt.cliques),
                         levels=self._plan_levels(),
                         bucketed=self.bucketed, batch=B,
                         schema=",".join(names))
        self._run_names = names
        t0 = time.perf_counter_ns()
        with span("jt.execute", schema=",".join(names), batch=B,
                  pipeline=pipeline, cache_hit=cache_hit):
            out = plan.run(vals)
            if obs.enabled(obs.TRACE) and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._beliefs, self._logz = out
        execute_us = (time.perf_counter_ns() - t0) / 1e3
        self.last_run = {"cache_hit": cache_hit, "compile_us": compile_us,
                         "execute_us": execute_us, "batch": B,
                         "pipeline": pipeline}

    # ======================= discrete pipeline ==============================

    def _cpd_factor(self, v: Variable) -> F.Factor:
        """log CPD table of a discrete node as a Factor (parents-major)."""
        dpa = [p.name for p in self.bn.dag.get_parents(v) if
               self._card.get(p.name) is not None]
        scope = tuple(dpa) + (v.name,)
        cards = tuple(self._card[n] for n in scope)
        return F.Factor(scope, cards, torch.log(self._cpd[v.name][0]))

    def _lambda_factor(self, v: Variable, ev: Dict[str, Tensor],
                       B: int) -> F.Factor:
        """Evidence likelihood of an observed continuous node over its
        discrete parents (analytic CLG conditioning).  Continuous parents
        cannot occur here -- those networks compile the strong pipeline."""
        dpa = [p for p in self.bn.dag.get_parents(v) if p.is_discrete]
        alpha, _, sigma2 = self._cpd[v.name]             # [*dcards]
        mean = alpha.expand((B,) + tuple(alpha.shape))
        x = ev[v.name].reshape((B,) + (1,) * alpha.dim())
        ll = -0.5 * (torch.log(2 * math.pi * sigma2)
                     + (x - mean) ** 2 / sigma2)
        scope = tuple(p.name for p in dpa)
        cards = tuple(self._card[n] for n in scope)
        return F.Factor(scope, cards, ll)

    def _potentials(self, names: Tuple[str, ...],
                    values: Tuple[Tensor, ...]) -> List[F.Factor]:
        """Batched clique log-potentials with evidence folded in."""
        B = values[0].shape[0] if values else 1
        ev = dict(zip(names, values))
        pots: List[F.Factor] = []
        for scope in self._scopes:
            cards = tuple(self._card[n] for n in scope)
            pots.append(F.Factor(scope, cards, torch.zeros(
                (B,) + cards, device=self.device)))

        def add(ci: int, f: F.Factor) -> None:
            pots[ci] = F.product([pots[ci], f])

        for v in self.bn.order:
            if v.is_discrete:
                add(self._home[v.name], self._cpd_factor(v))
                if v.name in ev:
                    add(self.jt.smallest_containing({v.name}),
                        F.indicator(v.name, v.card, ev[v.name]))
            elif v.name in ev:
                add(self._home[v.name], self._lambda_factor(v, ev, B))
        return pots

    def _propagate(self, names: Tuple[str, ...], values: Tuple[Tensor, ...]
                   ) -> Tuple[Tuple[Tensor, ...], Tensor]:
        pots = self._potentials(names, values)
        be = self.backend
        msgs: Dict[Tuple[int, int], F.Factor] = {}
        # collect: leaves -> root
        for u, p, sep in self._collect:
            f = pots[u]
            for w, _, _ in self._collect:
                if (w, u) in msgs:
                    f = F.absorb(f, msgs[(w, u)], backend=be)
            msgs[(u, p)] = F.marginalize(f, sep, backend=be)
        # distribute: root -> leaves
        for u, p, sep in self._distribute:
            f = pots[p]
            for (a, b), m in list(msgs.items()):
                if b == p and a != u:
                    f = F.absorb(f, m, backend=be)
            msgs[(p, u)] = F.marginalize(f, sep, backend=be)
        # beliefs
        beliefs: List[Tensor] = []
        logz = None
        for i, scope in enumerate(self._scopes):
            f = pots[i]
            for (a, b), m in msgs.items():
                if b == i:
                    f = F.absorb(f, m, backend=be)
            table = F._permute(f, scope)
            beliefs.append(table)
            if i == self.jt.root:
                # the normalizer is a plain logsumexp (outside any kernel in
                # the JAX package too)
                logz = F.marginalize(F.Factor(scope, f.cards, table), ()).logp
        return tuple(beliefs), logz

    # ======================= strong pipeline ================================

    def _run_cscopes(self, names: Tuple[str, ...]
                     ) -> Tuple[Tuple[str, ...], ...]:
        """Per-clique continuous scope once observed heads are instantiated
        (static per evidence schema)."""
        obs = set(names)
        return tuple(tuple(v for v in cs if v not in obs)
                     for cs in self._cscopes)

    def _strong_potentials(self, names: Tuple[str, ...],
                           values: Tuple[Tensor, ...]
                           ) -> List[CG.CGPotential]:
        B = values[0].shape[0] if values else 1
        ev = dict(zip(names, values))
        cscopes = self._run_cscopes(names)
        pots = [CG.zeros(scope, tuple(self._card[n] for n in scope), cs, B,
                         self.device)
                for scope, cs in zip(self._scopes, cscopes)]

        def add(ci: int, q: CG.CGPotential) -> None:
            pots[ci] = CG.combine(pots[ci], q)

        for v in self.bn.order:
            parents = self.bn.dag.get_parents(v)
            raw_dpa = tuple(p.name for p in parents if p.is_discrete)
            dpa = tuple(sorted(raw_dpa))
            dcards = tuple(self._card[n] for n in dpa)
            if v.is_discrete:
                # CPD tables are laid out in RAW get_parents order; label the
                # factor accordingly and let _permute reorder to sorted scope
                raw_cards = tuple(self._card[n] for n in raw_dpa)
                f = F.Factor(raw_dpa + (v.name,), raw_cards + (v.card,),
                             torch.log(self._cpd[v.name][0]))
                scope = tuple(sorted(f.scope))
                q = CG.from_discrete_table(
                    scope, tuple(self._card[n] for n in scope),
                    F._permute(f, scope))
                add(self._home[v.name], q)
                if v.name in ev:
                    ind = F.indicator(v.name, v.card, ev[v.name])
                    ci = self.jt.smallest_containing({v.name})
                    pots[ci] = CG.add_discrete_log(
                        pots[ci], (v.name,), (v.card,), ind.logp)
                continue
            # continuous CLG node: canonical CPD over (v, *cont parents),
            # permuted so discrete-parent axes follow the sorted convention
            cpa = [p.name for p in parents if not p.is_discrete]
            alpha, beta, sigma2 = self._cpd[v.name]
            if raw_dpa != dpa:                   # permute table axes
                perm = tuple(raw_dpa.index(n) for n in dpa)
                alpha = alpha.permute(perm)
                sigma2 = sigma2.permute(perm)
                beta = beta.permute(perm + (len(raw_dpa),))
            q = CG.from_clg(alpha, beta, sigma2, dpa, dcards,
                            (v.name,) + tuple(cpa))
            q = CG.reduce_evidence(q, {k: ev[k] for k in (v.name, *cpa)
                                       if k in ev})
            add(self._home[v.name], q)
        return pots

    def _propagate_strong(self, names: Tuple[str, ...],
                          values: Tuple[Tensor, ...]):
        """Level-ordered two-pass propagation.

        Cliques at the same tree depth are independent given the previous
        level, so their canonical-form linalg is batched through shape
        buckets (``bucketed=False`` restores the per-clique schedule).
        """
        pots = self._strong_potentials(names, values)
        cscopes = self._run_cscopes(names)
        be = self.backend
        root = self.jt.root
        children: Dict[int, List[int]] = {}
        for u, p, _ in self._collect:
            children.setdefault(p, []).append(u)
        depth = {root: 0}
        for u, p, _ in self._distribute:     # preorder: parent before child
            depth[u] = depth[p] + 1
        by_level: Dict[int, List[Tuple[int, int, Tuple[str, ...]]]] = {}
        for u, p, sep in self._collect:
            by_level.setdefault(depth[u], []).append((u, p, sep))
        nmsg: Dict[Tuple[int, int], CG.CGPotential] = {}
        absorbed: List[CG.CGPotential] = list(pots)
        # collect: deepest level -> root, EXACT strong marginals: integrate
        # the continuous residual, then sum the (now table-only) discrete one
        for lev in sorted(by_level, reverse=True):
            entries = by_level[lev]
            items = []
            for u, p, sep in entries:
                f = absorbed[u]
                for w in children.get(u, ()):
                    f = CG.combine(f, nmsg[(w, u)])
                absorbed[u] = f
                sep_c = {v for v in cscopes[u] if v in set(sep)}
                items.append(
                    (f, tuple(v for v in f.cscope if v not in sep_c)))
            ms = (CG.marginalize_cont_many(items) if self.bucketed
                  else [CG.marginalize_cont(f_, d_) for f_, d_ in items])
            for (u, p, sep), m in zip(entries, ms):
                sep_d = {v for v in self._scopes[u] if v in set(sep)}
                nmsg[(u, p)] = CG.marginalize_disc(
                    m, tuple(v for v in m.dscope if v not in sep_d))
        beliefs: List[Optional[CG.CGPotential]] = [None] * len(pots)
        f = absorbed[root]
        for w in children.get(root, ()):
            f = CG.combine(f, nmsg[(w, root)])
        beliefs[root] = f
        logz = CG.log_norm(f)
        # distribute: root -> leaves, WEAK (moment-matched) marginals; all
        # edges leaving one level share one bucketed weak-marginal pass
        by_plevel: Dict[int, List[Tuple[int, int, Tuple[str, ...]]]] = {}
        for u, p, sep in self._distribute:
            by_plevel.setdefault(depth[p], []).append((u, p, sep))
        for lev in sorted(by_plevel):
            entries = by_plevel[lev]
            items = []
            for u, p, sep in entries:
                sep_set = set(sep)
                sep_d = tuple(v for v in self._scopes[p] if v in sep_set)
                sep_c = tuple(v for v in cscopes[p] if v in sep_set)
                items.append((beliefs[p], sep_d, sep_c))
            stars = (CG.weak_marginalize_many(items, backend=be)
                     if self.bucketed
                     else [CG.weak_marginalize(b_, d_, c_, backend=be)
                           for b_, d_, c_ in items])
            for (u, p, sep), star in zip(entries, stars):
                down = CG.divide(star, nmsg[(u, p)])
                beliefs[u] = CG.combine(absorbed[u], down)
        flat = tuple((b.g, b.h, b.K) for b in beliefs)
        return flat, logz

    def _strong_belief(self, ci: int) -> CG.CGPotential:
        g, h, K = self._beliefs[ci]
        return CG.CGPotential(
            self._scopes[ci],
            tuple(self._card[n] for n in self._scopes[ci]),
            self._run_cscopes(self._run_names)[ci], g, h, K)

    # -- queries -------------------------------------------------------------

    def _require_run(self) -> None:
        if self._beliefs is None:
            raise RuntimeError("call run_inference() first")

    def _joint(self, names: Tuple[str, ...]) -> Tensor:
        """Normalized joint log-posterior over discrete ``names``."""
        ci = self.jt.smallest_containing(set(names))
        scope = self._scopes[ci]
        cards = tuple(self._card[n] for n in scope)
        if self.strong:
            table = CG.discrete_table(self._strong_belief(ci))
        else:
            table = self._beliefs[ci]
        f = F.Factor(scope, cards, table)
        f = F.normalize(F.marginalize(f, names))
        return F._permute(f, names)

    def _maybe_squeeze(self, a: Tensor) -> Tensor:
        return a if self._batched else a[0]

    def posterior_discrete(self, var) -> Tensor:
        """p(var | e): [card], or [B, card] under batched evidence."""
        self._require_run()
        name = var.name if isinstance(var, Variable) else str(var)
        return self._maybe_squeeze(torch.exp(self._joint((name,))))

    def posterior_mean_var(self, var: Variable) -> Tuple[Tensor, Tensor]:
        """Posterior mean/variance of an unobserved continuous node -- the
        exact moments of its posterior mixture."""
        self._require_run()
        if var.name in self.evidence:
            raise ValueError(f"{var.name!r} is observed")
        if self.strong:
            return self._strong_mean_var(var)
        dpa = [p for p in self.bn.dag.get_parents(var) if p.is_discrete]
        alpha, _, sigma2 = self._cpd[var.name]
        B = self._logz.shape[0]
        if dpa:
            w = torch.exp(self._joint(tuple(p.name for p in dpa)))
        else:
            w = alpha.new_ones((B,) + (1,) * alpha.dim())
        mu = alpha.expand((B,) + tuple(alpha.shape))
        axes = tuple(range(1, mu.dim()))
        if axes:
            mean = (w * mu).sum(axes)
            second = (w * (sigma2 + mu ** 2)).sum(axes)
        else:
            mean, second = w * mu, w * (sigma2 + mu ** 2)
        return (self._maybe_squeeze(mean),
                self._maybe_squeeze(second - mean ** 2))

    def _strong_mean_var(self, var: Variable) -> Tuple[Tensor, Tensor]:
        """Exact mixture moments from the clique belief holding ``var``."""
        cscopes = self._run_cscopes(self._run_names)
        ci = None
        for i, cs in enumerate(cscopes):
            if var.name in cs:
                if ci is None or len(cs) + len(self._scopes[i]) < (
                        len(cscopes[ci]) + len(self._scopes[ci])):
                    ci = i
        if ci is None:
            raise ValueError(f"{var.name!r} not in any clique "
                             "(is it observed?)")
        m = CG.to_moment(self._strong_belief(ci))
        iv = m.cscope.index(var.name)
        axes = tuple(range(1, m.logp.dim()))
        # collapse the whole mixture onto the single head: the shared
        # moment-matching (same -inf/dead-config rules as distribute)
        _, mu, sg = CG.moment_match(
            m.logp, m.mu[..., iv:iv + 1],
            m.sigma[..., iv:iv + 1, iv:iv + 1], axes)
        return (self._maybe_squeeze(mu[..., 0]),
                self._maybe_squeeze(sg[..., 0, 0]))

    def log_evidence(self) -> Tensor:
        """log p(e) -- exact model evidence of the observed values."""
        self._require_run()
        return self._maybe_squeeze(self._logz)
