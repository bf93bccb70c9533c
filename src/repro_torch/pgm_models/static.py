"""Static latent-variable models — paper Table 2, left column (counterpart
of ``repro.pgm_models.static``)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import vmp
from repro_torch.core.dag import PlateSpec
from repro_torch.data.stream import Attribute, Batch, FINITE, REAL
from repro_torch.pgm_models.base import Model


def _split_attrs(attributes: Sequence[Attribute]):
    cont = [a for a in attributes if a.kind == REAL]
    disc = [a for a in attributes if a.kind == FINITE]
    return cont, disc


class GaussianMixture(Model):
    """Diagonal Gaussian mixture with a global discrete latent (CF 7)."""

    def __init__(self, attributes, n_states: int = 2, **kw):
        self.n_states = n_states
        super().__init__(attributes, **kw)

    def build_spec(self):
        cont, disc = _split_attrs(self.attributes)
        if disc:
            raise ValueError("GaussianMixture expects continuous attributes")
        return PlateSpec(n_features=len(cont), latent_card=self.n_states), None


class MultivariateGaussian(Model):
    """Full-covariance Gaussian via the CLG chain rule:
    p(x) = prod_f N(x_f | w^T [1, x_<f]) — a dense upper-triangular CLG DAG."""

    def build_spec(self):
        cont, _ = _split_attrs(self.attributes)
        F = len(cont)
        parents = tuple(tuple(range(f)) for f in range(F))
        return PlateSpec(n_features=F, latent_card=0,
                         feature_parents=parents), None

    def joint_mean(self) -> np.ndarray:
        """Implied joint mean via ancestral substitution."""
        m = self.posterior.reg.m.cpu().numpy()
        mu = np.zeros(self.cp.layout.F)
        for f in range(self.cp.layout.F):
            w = m[f, 0]
            mu[f] = w[0] + sum(w[1 + j] * mu[j] for j in range(f))
        return mu


class NaiveBayes(Model):
    """Unsupervised NB (latent class) over mixed continuous/discrete leaves."""

    def __init__(self, attributes, n_states: int = 2, **kw):
        self.n_states = n_states
        super().__init__(attributes, **kw)

    def build_spec(self):
        cont, disc = _split_attrs(self.attributes)
        # discrete leaves are indexed AFTER continuous in (xc | xd) layout
        dmap = tuple((len(cont) + j, a.card) for j, a in enumerate(disc))
        return PlateSpec(n_features=len(cont) + len(disc),
                         latent_card=self.n_states,
                         discrete_features=dmap), None


class NaiveBayesClassifier(NaiveBayes):
    """Supervised NB: the last discrete attribute is the observed class."""

    def __init__(self, attributes, **kw):
        _, disc = _split_attrs(attributes)
        if not disc:
            raise ValueError("needs a class attribute (FINITE_SET, last)")
        self.class_card = disc[-1].card
        # the class column is consumed as the label -> not a leaf
        feats = [a for a in attributes if a is not disc[-1]]
        super().__init__(feats, n_states=self.class_card, **kw)

    def supervised_r(self, batch: Batch) -> Optional[torch.Tensor]:
        # label column = LAST discrete column of the incoming batch
        eye = torch.eye(self.class_card, device=self.device)
        return eye[batch.xd[:, -1].long()]

    def update_model(self, data, **kw) -> float:
        b = self._as_batch(data)
        r = self.supervised_r(b)
        stats, _ = vmp.local_step(self.cp, self.posterior, b.xc,
                                  b.xd[:, :-1].contiguous(), b.mask, r,
                                  backend=self.backend, chunk=self.chunk)
        post = vmp.global_update(self._chained_prior, stats)
        e = float(vmp.elbo(self.cp, self._chained_prior, post, stats))
        self.posterior = post
        self._chained_prior = post
        self.n_seen += int(b.mask.sum())
        return e

    def predict(self, data) -> torch.Tensor:
        b = self._as_batch(data)
        xd = b.xd[:, :-1] if b.xd.shape[1] else b.xd
        return vmp.posterior_z(self.cp, self.posterior, b.xc, xd.contiguous(),
                               backend=self.backend,
                               chunk=self.chunk).argmax(-1)


class GaussianDiscriminantAnalysis(NaiveBayesClassifier):
    """GDA = supervised Gaussian class-conditionals (diagonal covariances)."""


class BayesianLinearRegression(Model):
    """Last REAL attribute regressed on all other REAL attributes."""

    def build_spec(self):
        cont, _ = _split_attrs(self.attributes)
        F = len(cont)
        parents = tuple(tuple(range(F - 1)) if f == F - 1 else ()
                        for f in range(F))
        return PlateSpec(n_features=F, latent_card=0,
                         feature_parents=parents), None

    def coefficients(self) -> np.ndarray:
        """[bias, w_1..w_d] posterior mean of the regression weights."""
        m = self.posterior.reg.m[-1, 0].cpu().numpy()
        return m[: 1 + self.cp.layout.P]

    def predict(self, x) -> torch.Tensor:
        w = torch.as_tensor(self.coefficients(), device=self.device)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return w[0] + x @ w[1:]


class FactorAnalysis(Model):
    """x = W h + mu + eps with h ~ N(0, I_L) — PPCA when noise is tied."""

    def __init__(self, attributes, n_hidden: int = 2, **kw):
        self.n_hidden = n_hidden
        super().__init__(attributes, **kw)

    def build_spec(self):
        cont, _ = _split_attrs(self.attributes)
        return PlateSpec(n_features=len(cont), latent_card=0,
                         latent_dim=self.n_hidden), None

    def loading_matrix(self) -> np.ndarray:
        """[F, L] posterior-mean factor loadings."""
        return self.posterior.reg.m[:, 0, 1 + self.cp.layout.P:].cpu().numpy()


class MixtureOfFA(Model):
    """Mixture of factor analysers: the discrete latent selects the loading."""

    def __init__(self, attributes, n_states: int = 2, n_hidden: int = 2, **kw):
        self.n_states = n_states
        self.n_hidden = n_hidden
        super().__init__(attributes, **kw)

    def build_spec(self):
        cont, _ = _split_attrs(self.attributes)
        return PlateSpec(n_features=len(cont), latent_card=self.n_states,
                         latent_dim=self.n_hidden), None


class CustomGlobalLocalModel(Model):
    """The paper's Code-Fragment-11 custom model: a global multinomial hidden
    variable plus ONE local Gaussian hidden parent per observed leaf,
    realized as latent_dim = F with a diagonal latent mask."""

    def __init__(self, attributes, n_states: int = 2, **kw):
        self.n_states = n_states
        super().__init__(attributes, **kw)

    def build_spec(self):
        cont, _ = _split_attrs(self.attributes)
        F = len(cont)
        return PlateSpec(n_features=F, latent_card=self.n_states,
                         latent_dim=F), np.eye(F, dtype=np.float32)
