"""Score-based structure learning from streaming sufficient statistics
(counterpart of ``repro.learn_structure``).

* :mod:`scores` -- decomposable Bayesian family scores (BDeu for discrete
  families, NIG evidence for CLG families) from batched counts: one
  ``family_counts`` kernel call scores every candidate family of bounded
  fan-in; plus :func:`scores.fit_cpds`, the conjugate materializer from
  structure to ``BayesianNetwork``.
* :mod:`chowliu` -- batched pairwise (conditional) mutual information +
  maximum spanning tree: Chow-Liu trees and TAN classifiers.
* :mod:`search` -- greedy add/remove/reverse hill-climbing with family-
  score caching and ``DAG.is_ancestor`` acyclicity guards.
* :mod:`stream_adapt` -- the streaming loop: windowed suff-stats feed the
  scores online, Page-Hinkley drift on the batch log-likelihood triggers
  re-search, and the adapted network flows into ``infer_exact`` / serving
  unchanged.

Entry points run on the first CUDA card unless the caller passes
``device="cpu"``; on a card, discrete counting goes through the
``family_counts`` CUDA kernel and CLG moments through ``clg_suffstats``.
"""

from repro_torch.learn_structure.chowliu import chow_liu, predict_class, tan
from repro_torch.learn_structure.metrics import skeleton_f1, undirected_edges
from repro_torch.learn_structure.scores import (clg_family_scores,
                                                cpds_from_stats,
                                                disc_family_scores, fit_cpds,
                                                nig_evidence, structure_stats)
from repro_torch.learn_structure.search import SearchResult, hill_climb
from repro_torch.learn_structure.stream_adapt import AdaptiveStructure

__all__ = [
    "AdaptiveStructure",
    "SearchResult",
    "chow_liu",
    "clg_family_scores",
    "cpds_from_stats",
    "disc_family_scores",
    "fit_cpds",
    "hill_climb",
    "nig_evidence",
    "predict_class",
    "skeleton_f1",
    "structure_stats",
    "tan",
    "undirected_edges",
]
