"""Structure-recovery metrics shared by tests and ``chip_smoke.py``
(counterpart of ``repro.learn_structure.metrics``)."""

from __future__ import annotations

from typing import Dict, Iterable, Set, Union

from repro_torch.core.dag import BayesianNetwork

EdgeSource = Union[BayesianNetwork, Dict, Iterable]


def undirected_edges(structure: EdgeSource) -> Set[frozenset]:
    """The undirected skeleton of a structure given as a
    ``BayesianNetwork``, a ``{child: parent names}`` dict, or an iterable
    of (parent, child) pairs."""
    if isinstance(structure, BayesianNetwork):
        return {frozenset((p.name, c))
                for c, ps in structure.dag.parents.items() for p in ps}
    if isinstance(structure, dict):
        return {frozenset((p, c)) for c, ps in structure.items() for p in ps}
    return {frozenset(e) for e in structure}


def skeleton_f1(true_structure: EdgeSource, got_structure: EdgeSource
                ) -> float:
    """F1 between undirected skeletons."""
    t, g = undirected_edges(true_structure), undirected_edges(got_structure)
    if not t and not g:
        return 1.0          # an edgeless graph, exactly recovered
    tp = len(t & g)
    prec = tp / max(len(g), 1)
    rec = tp / max(len(t), 1)
    return 2 * prec * rec / max(prec + rec, 1e-12)
