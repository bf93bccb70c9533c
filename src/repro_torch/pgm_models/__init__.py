"""The static model zoo of the port (paper Table 2, left column).

Every model follows the paper's API: ``Model(attributes)``,
``update_model(stream_or_batch)`` (initial learning AND Bayesian updating,
Eq. 3), ``get_model()``, ``posterior_z(...)``.  Dynamic models and LDA come
with later slices.
"""

from repro_torch.pgm_models.base import Model
from repro_torch.pgm_models.static import (
    BayesianLinearRegression,
    CustomGlobalLocalModel,
    FactorAnalysis,
    GaussianDiscriminantAnalysis,
    GaussianMixture,
    MixtureOfFA,
    MultivariateGaussian,
    NaiveBayes,
    NaiveBayesClassifier,
)

__all__ = [
    "Model", "BayesianLinearRegression", "CustomGlobalLocalModel",
    "FactorAnalysis", "GaussianDiscriminantAnalysis", "GaussianMixture",
    "MixtureOfFA", "MultivariateGaussian", "NaiveBayes",
    "NaiveBayesClassifier",
]
