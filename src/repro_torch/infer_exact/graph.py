"""Junction-tree compilation: moralize, triangulate, build, verify
(counterpart of ``repro.infer_exact.graph``, the same algorithm with the
same ``sorted()`` tie-breaks, so cliques, edges, sepsets and the message
schedule are those of the JAX package).

All static Python over the ``DAG`` of ``repro_torch.core.dag`` -- this runs
once per network at engine construction and produces the hashable structure
the propagation follows.

Pipeline (Lauritzen–Spiegelhalter):

  1. *Moralize* the discrete subgraph: connect every discrete node to its
     discrete parents and marry those parents pairwise.  The discrete-parent
     set of each **continuous** CLG node is married too, so the evidence
     likelihood lambda(d_pa) of an observed continuous leaf — and the joint
     needed to query an unobserved one — always fits inside one clique.
  2. *Triangulate* with the min-fill heuristic, collecting elimination
     cliques; keep the maximal ones.
  3. Build the tree as a maximum-weight spanning tree over pairwise sepset
     sizes (Kruskal; zero-weight edges permitted so disconnected moral
     graphs still yield a single tree — empty sepsets exchange only the
     subtree normalizer, which cancels on normalization).
  4. Verify the running-intersection property: for every variable the
     cliques containing it must induce a connected subtree.

For CLG networks with continuous-continuous edges the engine instead uses
:func:`compile_strong_junction_tree` (Lauritzen 1992): the FULL moral graph
(continuous nodes included), a *strong* elimination order that eliminates
every continuous variable before any discrete one, and a clique tree
directed toward a strong root — for every clique, either its residual
toward the root is all-continuous (an exact Gaussian integral) or its
sepset is all-discrete (a plain sum over a table).  That property is what
lets collect-phase messages stay exact and confines moment matching (weak
marginals) to the distribute pass.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

from repro_torch.core.dag import BayesianNetwork


@dataclasses.dataclass(frozen=True)
class JunctionTree:
    """Compiled clique-tree structure (no parameters, fully static).

    ``root`` is the propagation root (index 0 for the weak/discrete
    pipeline; the strong root for :func:`compile_strong_junction_tree`).
    ``continuous`` is empty for the discrete pipeline.
    """

    cliques: Tuple[FrozenSet[str], ...]
    # tree edges: (i < j) pairs for the discrete pipeline; DIRECTED
    # (child, parent) pairs toward ``root`` for strong trees — direction is
    # load-bearing (verify_strong, the engine's collect/distribute order)
    edges: Tuple[Tuple[int, int], ...]
    sepsets: Tuple[FrozenSet[str], ...]         # aligned with edges
    elimination_order: Tuple[str, ...]
    fill_in_count: int
    root: int = 0
    continuous: FrozenSet[str] = frozenset()

    def neighbors(self, i: int) -> List[Tuple[int, FrozenSet[str]]]:
        out = []
        for (a, b), s in zip(self.edges, self.sepsets):
            if a == i:
                out.append((b, s))
            elif b == i:
                out.append((a, s))
        return out

    def smallest_containing(self, names: Set[str]) -> int:
        """Index of the smallest clique containing every name (error if none)."""
        best, best_size = -1, None
        for i, c in enumerate(self.cliques):
            if names <= c and (best_size is None or len(c) < best_size):
                best, best_size = i, len(c)
        if best < 0:
            raise ValueError(f"no clique contains {sorted(names)}")
        return best


def moral_scopes(bn: BayesianNetwork) -> List[Set[str]]:
    """One scope per factor that must land inside a clique."""
    scopes: List[Set[str]] = []
    for v in bn.order:
        dpa = {p.name for p in bn.dag.get_parents(v) if p.is_discrete}
        if v.is_discrete:
            scopes.append({v.name} | dpa)
        elif dpa:
            scopes.append(dpa)       # lambda(d_pa) of a continuous CLG node
    return scopes


def moralize(bn: BayesianNetwork) -> Dict[str, Set[str]]:
    """Undirected moral graph over the *discrete* variables."""
    adj: Dict[str, Set[str]] = {
        v.name: set() for v in bn.order if v.is_discrete}
    for scope in moral_scopes(bn):
        nodes = sorted(scope)
        for i, a in enumerate(nodes):
            for b in nodes[i + 1:]:
                adj[a].add(b)
                adj[b].add(a)
    return adj


def _min_fill_eliminate(
    adj: Dict[str, Set[str]], priority: Set[str] = frozenset()
) -> Tuple[List[FrozenSet[str]], Tuple[str, ...], int]:
    """Min-fill elimination.  Vertices in ``priority`` are eliminated before
    all others (the strong-order constraint; empty = plain min-fill).
    Returns (per-vertex elimination cliques in CREATION order, elimination
    order, #fill edges); ``sorted()`` calls make tie-breaks stable."""
    g = {v: set(ns) for v, ns in adj.items()}
    order: List[str] = []
    cliques: List[FrozenSet[str]] = []
    fills = 0

    def fill_cost(v: str) -> int:
        ns = sorted(g[v])
        c = 0
        for i, a in enumerate(ns):
            for b in ns[i + 1:]:
                if b not in g[a]:
                    c += 1
        return c

    while g:
        cand = sorted(v for v in g if v in priority) or sorted(g)
        v = min(cand, key=fill_cost)
        ns = sorted(g[v])
        cliques.append(frozenset([v] + ns))
        for i, a in enumerate(ns):
            for b in ns[i + 1:]:
                if b not in g[a]:
                    g[a].add(b)
                    g[b].add(a)
                    fills += 1
        for a in ns:
            g[a].discard(v)
        del g[v]
        order.append(v)
    return cliques, tuple(order), fills


def min_fill_triangulate(
    adj: Dict[str, Set[str]]
) -> Tuple[List[FrozenSet[str]], Tuple[str, ...], int]:
    """Min-fill elimination; returns (maximal cliques, order, #fill edges)."""
    cliques, order, fills = _min_fill_eliminate(adj)
    maximal = [c for c in cliques
               if not any(c < other for other in cliques)]
    # dedupe while preserving order
    seen: Set[FrozenSet[str]] = set()
    uniq = []
    for c in maximal:
        if c not in seen:
            seen.add(c)
            uniq.append(c)
    return uniq, tuple(order), fills


def spanning_tree(cliques: Sequence[FrozenSet[str]]
                  ) -> Tuple[Tuple[Tuple[int, int], ...],
                             Tuple[FrozenSet[str], ...]]:
    """Max-weight spanning tree over |C_i ∩ C_j| (Kruskal + union-find)."""
    n = len(cliques)
    if n == 1:
        return (), ()
    cand = sorted(
        ((len(cliques[i] & cliques[j]), i, j)
         for i in range(n) for j in range(i + 1, n)),
        key=lambda t: (-t[0], t[1], t[2]))
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    edges: List[Tuple[int, int]] = []
    seps: List[FrozenSet[str]] = []
    for w, i, j in cand:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
            edges.append((i, j))
            seps.append(cliques[i] & cliques[j])
            if len(edges) == n - 1:
                break
    return tuple(edges), tuple(seps)


def verify_running_intersection(
    cliques: Sequence[FrozenSet[str]],
    edges: Sequence[Tuple[int, int]],
) -> None:
    """Raise if some variable's cliques do not form a connected subtree."""
    names = set().union(*cliques) if cliques else set()
    adj: Dict[int, List[int]] = {i: [] for i in range(len(cliques))}
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    for name in names:
        holders = [i for i, c in enumerate(cliques) if name in c]
        # BFS inside the induced subgraph
        seen = {holders[0]}
        stack = [holders[0]]
        while stack:
            u = stack.pop()
            for w in adj[u]:
                if w not in seen and name in cliques[w]:
                    seen.add(w)
                    stack.append(w)
        if seen != set(holders):
            raise AssertionError(
                f"running intersection violated for {name!r}: "
                f"cliques {holders} not connected")


def compile_junction_tree(bn: BayesianNetwork) -> JunctionTree:
    """Full pipeline: moralize -> min-fill -> spanning tree -> verify."""
    adj = moralize(bn)
    if not adj:
        raise ValueError("network has no discrete variables")
    cliques, order, fills = min_fill_triangulate(adj)
    edges, seps = spanning_tree(cliques)
    verify_running_intersection(cliques, edges)
    return JunctionTree(cliques=tuple(cliques), edges=edges, sepsets=seps,
                        elimination_order=order, fill_in_count=fills)


# ---------------------------------------------------------------------------
# Strong junction tree (Lauritzen 1992) — CLG networks with cont-cont edges
# ---------------------------------------------------------------------------


def moralize_full(bn: BayesianNetwork) -> Dict[str, Set[str]]:
    """Undirected moral graph over ALL variables (discrete + continuous)."""
    adj: Dict[str, Set[str]] = {v.name: set() for v in bn.order}
    for v in bn.order:
        family = sorted({v.name} | {p.name for p in bn.dag.get_parents(v)})
        for i, a in enumerate(family):
            for b in family[i + 1:]:
                adj[a].add(b)
                adj[b].add(a)
    return adj


def strong_triangulate(
    adj: Dict[str, Set[str]], continuous: Set[str]
) -> Tuple[List[FrozenSet[str]], Tuple[str, ...], int]:
    """Min-fill elimination constrained to a STRONG order: every continuous
    variable is eliminated before any discrete one.  Returns EVERY
    elimination clique (one per vertex, birth order — the strong-root tree
    is built over all of them and subset cliques contracted away; pruning
    before building breaks the RIP attachment), the elimination order and
    the fill-in count."""
    return _min_fill_eliminate(adj, continuous)


def strong_root_tree(
    cliques: Sequence[FrozenSet[str]],
    order: Sequence[str],
) -> Tuple[List[FrozenSet[str]], Tuple[Tuple[int, int], ...],
           Tuple[FrozenSet[str], ...], int]:
    """Directed clique tree with a strong root, from the per-vertex
    elimination cliques (birth order, aligned with ``order``).

    Construction: clique ``K_i`` (formed when eliminating ``e_i``) attaches
    to the elimination clique of the FIRST-eliminated vertex of its sepset
    ``S_i = K_i \\ {e_i}`` — the classic Lauritzen–Spiegelhalter tree, for
    which ``S_i = K_i ∩ K_parent`` and the running intersection property
    hold by the perfect-elimination argument.  Cliques with empty sepsets
    (disconnected components) attach to the last-born clique.  Non-maximal
    cliques are then contracted into their superset neighbor; by the
    junction property the surviving sepsets are unchanged, so RIP and the
    strong-root property are preserved.  With a strong elimination order
    the surviving root is at the all-discrete end of the tree.

    Returns (maximal_cliques, edges (child, parent), sepsets, root_index).
    """
    n = len(cliques)
    pos = {v: i for i, v in enumerate(order)}
    parent: List[int] = [-1] * n
    root = n - 1
    for i in range(n):
        sep = cliques[i] - {order[i]}
        if i == root:
            parent[i] = -1
        elif sep:
            parent[i] = pos[min(sep, key=lambda v: pos[v])]
        else:
            parent[i] = root
    children: Dict[int, Set[int]] = {i: set() for i in range(n)}
    for i in range(n):
        if parent[i] >= 0:
            children[parent[i]].add(i)

    alive = set(range(n))

    def _drop(child: int, keeper: int) -> None:
        """Merge ``child`` into adjacent ``keeper`` (child ⊆ keeper)."""
        for c in children[child]:
            if c != keeper:
                parent[c] = keeper
                children[keeper].add(c)
        p = parent[child]
        if p == keeper:
            children[keeper].discard(child)
        elif p >= 0:                     # keeper was a child of `child`
            children[p].discard(child)
            children[p].add(keeper)
            parent[keeper] = p
        else:                            # `child` was the root
            parent[keeper] = -1
        alive.discard(child)

    changed = True
    while changed:
        changed = False
        for i in sorted(alive):
            p = parent[i]
            if p < 0:
                continue
            if cliques[i] <= cliques[p]:
                _drop(i, p)
                changed = True
                break
            if cliques[p] < cliques[i]:
                _drop(p, i)
                changed = True
                break

    idx = {old: new for new, old in enumerate(sorted(alive))}
    out_cliques = [cliques[i] for i in sorted(alive)]
    edges: List[Tuple[int, int]] = []
    seps: List[FrozenSet[str]] = []
    new_root = -1
    for i in sorted(alive):
        if parent[i] < 0:
            new_root = idx[i]
        else:
            edges.append((idx[i], idx[parent[i]]))
            seps.append(cliques[i] & cliques[parent[i]])
    return out_cliques, tuple(edges), tuple(seps), new_root


def verify_strong(
    cliques: Sequence[FrozenSet[str]],
    edges: Sequence[Tuple[int, int]],
    sepsets: Sequence[FrozenSet[str]],
    continuous: Set[str],
) -> None:
    """Raise unless every directed edge (child -> parent) has an
    all-continuous residual or an all-discrete sepset — the strong-root
    property that makes collect-phase marginalization exact."""
    for (child, _), sep in zip(edges, sepsets):
        residual = cliques[child] - sep
        if residual <= continuous:
            continue
        if not (sep & continuous):
            continue
        raise AssertionError(
            f"strong-root property violated at clique {sorted(cliques[child])}"
            f": residual {sorted(residual)} has discrete vars and sepset "
            f"{sorted(sep)} has continuous vars")


def compile_strong_junction_tree(bn: BayesianNetwork) -> JunctionTree:
    """Strong pipeline: full moral graph -> strong min-fill -> strong-root
    directed tree -> verify RIP + the strong-root property."""
    continuous = {v.name for v in bn.order if not v.is_discrete}
    adj = moralize_full(bn)
    if not adj:
        raise ValueError("empty network")
    elim_cliques, order, fills = strong_triangulate(adj, continuous)
    cliques, edges, seps, root = strong_root_tree(elim_cliques, order)
    verify_running_intersection(cliques, edges)
    verify_strong(cliques, edges, seps, continuous)
    return JunctionTree(cliques=tuple(cliques), edges=edges, sepsets=seps,
                        elimination_order=order, fill_in_count=fills,
                        root=root, continuous=frozenset(continuous))
