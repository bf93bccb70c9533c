"""Latent Dirichlet Allocation -- paper module 'lda' ("allows text processing
by means of the latent Dirichlet allocation model") (counterpart of
``repro.pgm_models.lda``).

Batch variational Bayes (Blei et al. 2003) over bag-of-words count matrices:
the document E-step is a fixed number of vectorized mean-field updates over
all documents at once (dense [D, V, T] responsibilities, as in the JAX
package), and an SVI path takes natural-gradient steps on minibatches of
documents (Hoffman et al. 2013).  A model lives on one device: the first
card by default, ``device="cpu"`` by name.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as devmod

Tensor = torch.Tensor
digamma = torch.special.digamma

# documents an E-step chunk holds: chunk * V * T float32 elements stay
# under 2^28 (1 GiB a [chunk, V, T] tensor); documents are independent, so
# chunking changes only the order of the topic-word sums
ESTEP_ELEMS = 1 << 28


def _e_log(x: Tensor) -> Tensor:
    """E[log p] under Dirichlet(x) along the last axis."""
    return digamma(x) - digamma(x.sum(-1, keepdim=True))


class LDA:
    def __init__(self, n_topics: int, vocab: int, *, alpha: float = 0.3,
                 eta: float = 0.1, seed: int = 0,
                 device: devmod.DeviceLike = None):
        self.T, self.V = n_topics, vocab
        self.alpha, self.eta = alpha, eta
        self.device = devmod.resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        conc = torch.full((n_topics, vocab), 100.0, device=self.device)
        # topic-word variational Dirichlet (global)
        self.lam = eta + torch._standard_gamma(conc, generator=gen) / 100.0
        self._step = 0

    def _counts(self, counts) -> Tensor:
        return torch.as_tensor(counts).to(device=self.device,
                                          dtype=torch.float32)

    # -- E-step: per-document mean-field, fully vectorized ----------------------

    @staticmethod
    def _doc_estep(lam: Tensor, counts: Tensor, alpha: float,
                   iters: int = 50):
        """counts: [D, V] -> (gamma [D, T], expected topic-word stats
        [T, V]); documents in chunks of at most ESTEP_ELEMS / (V T)."""
        D, V = counts.shape
        T = lam.shape[0]
        e_logbeta_t = _e_log(lam).T                                  # [V, T]
        step = max(1, ESTEP_ELEMS // (V * T))
        gammas, stats = [], None
        for lo in range(0, D, step):
            c = counts[lo:lo + step]
            gamma = torch.full((c.shape[0], T), alpha, device=c.device
                               ) + c.sum(-1, keepdim=True) / T
            for _ in range(iters):
                # phi[d, v, t] ∝ exp(e_logtheta[d, t] + e_logbeta[t, v])
                phi = torch.softmax(_e_log(gamma)[:, None, :] + e_logbeta_t,
                                    -1)                           # [d, V, T]
                gamma = alpha + torch.einsum("dv,dvt->dt", c, phi)
            phi = torch.softmax(_e_log(gamma)[:, None, :] + e_logbeta_t, -1)
            part = torch.einsum("dv,dvt->tv", c, phi)
            gammas.append(gamma)
            stats = part if stats is None else stats + part
        return torch.cat(gammas), stats

    # -- learning ---------------------------------------------------------------

    def update_model(self, counts, *, sweeps: int = 30) -> float:
        """Batch VB. Repeated calls = Bayesian updating over document
        batches."""
        counts = self._counts(counts)
        for _ in range(sweeps):
            gamma, stats = self._doc_estep(self.lam, counts, self.alpha)
            self.lam = self.eta + stats  # conjugate global update
        self.gamma = gamma
        return float(self.perplexity_bound(counts))

    def svi_step(self, counts, n_total: int, *, tau: float = 64.0,
                 kappa: float = 0.7) -> None:
        """One SVI natural-gradient step on a minibatch of documents."""
        counts = self._counts(counts)
        _, stats = self._doc_estep(self.lam, counts, self.alpha)
        rho = (self._step + tau) ** (-kappa)
        target = self.eta + (n_total / counts.shape[0]) * stats
        self.lam = (1 - rho) * self.lam + rho * target
        self._step += 1

    # -- queries ------------------------------------------------------------------

    def topics(self) -> np.ndarray:
        return (self.lam / self.lam.sum(-1, keepdim=True)).cpu().numpy()

    def doc_topics(self, counts) -> np.ndarray:
        gamma, _ = self._doc_estep(self.lam, self._counts(counts), self.alpha)
        return (gamma / gamma.sum(-1, keepdim=True)).cpu().numpy()

    def perplexity_bound(self, counts) -> Tensor:
        """Quick predictive bound: sum_d sum_v c_dv log sum_t theta beta."""
        counts = self._counts(counts)
        gamma, _ = self._doc_estep(self.lam, counts, self.alpha)
        theta = gamma / gamma.sum(-1, keepdim=True)
        beta = self.lam / self.lam.sum(-1, keepdim=True)
        probs = theta @ beta                                   # [D, V]
        return (counts * torch.log(torch.clamp(probs, min=1e-12))).sum()
