"""The static model zoo of the port (paper Table 2, left column).

Every model follows the paper's API: ``Model(attributes)``,
``update_model(stream_or_batch)`` (initial learning AND Bayesian updating,
Eq. 3), ``get_model()``, ``posterior_z(...)``.  The dynamic models (Table 2,
right column) take sequence data (``pgm_models.dynamic``); ``LDA`` takes
bag-of-words count matrices (``pgm_models.lda``).
"""

from repro_torch.pgm_models.base import Model
from repro_torch.pgm_models.dynamic import (
    AutoRegressiveHMM,
    DynamicNaiveBayes,
    FactorialHMMModel,
    HiddenMarkovModel,
    InputOutputHMM,
    KalmanFilter,
    SwitchingLDS,
    forward_backward,
    seq_stream_fit,
)
from repro_torch.pgm_models.lda import LDA
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
    "NaiveBayesClassifier", "AutoRegressiveHMM", "DynamicNaiveBayes",
    "FactorialHMMModel", "HiddenMarkovModel", "InputOutputHMM",
    "KalmanFilter", "SwitchingLDS", "forward_backward", "seq_stream_fit",
    "LDA",
]
