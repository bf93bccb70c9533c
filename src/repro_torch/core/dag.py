"""The plate family compiled by the VMP engine (paper Fig. 3): a copy of
``repro.core.dag.PlateSpec``.  ``Variables``/``DAG``/CPDs and
``BayesianNetwork`` come with the exact-inference slice of the port."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


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
