"""Synthetic data generators (the subset of ``repro.data.synthetic`` that
the streaming-VMP path and ``chip_smoke.py`` use).  Numpy only, seeded."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.data.stream import Attribute, DataStream, FINITE, REAL


def gmm_stream(n: int, k: int, f: int, seed: int = 0, sep: float = 4.0,
               noise: float = 0.7) -> Tuple[DataStream, np.ndarray, np.ndarray]:
    """K-component diagonal GMM; returns (stream, true_means, labels)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-sep, sep, size=(k, f)).astype(np.float32)
    z = rng.integers(0, k, size=n)
    x = means[z] + noise * rng.standard_normal((n, f)).astype(np.float32)
    attrs = [Attribute(f"GaussianVar{i}", REAL) for i in range(f)]
    return DataStream.from_arrays(attrs, x), means, z


def drift_stream(n_per_phase: int, f: int, seed: int = 0
                 ) -> Tuple[DataStream, int]:
    """Two-phase stream with an abrupt mean shift (concept drift) halfway."""
    rng = np.random.default_rng(seed)
    mu1 = rng.uniform(-2, 2, f).astype(np.float32)
    mu2 = mu1 + 6.0
    x1 = mu1 + rng.standard_normal((n_per_phase, f)).astype(np.float32)
    x2 = mu2 + rng.standard_normal((n_per_phase, f)).astype(np.float32)
    attrs = [Attribute(f"GaussianVar{i}", REAL) for i in range(f)]
    return DataStream.from_arrays(attrs, np.concatenate([x1, x2])), n_per_phase


def nb_stream(n: int, classes: int, f_cont: int, f_disc: int, card: int = 3,
              seed: int = 0) -> Tuple[DataStream, np.ndarray]:
    """Naive-Bayes data: class -> continuous + discrete children (the class
    is the last discrete column).  The categories are drawn by inverse CDF
    on one uniform per instance and feature, so this stream is not the JAX
    package's (which draws one ``rng.choice`` per value)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    means = rng.uniform(-3, 3, (classes, f_cont)).astype(np.float32)
    xc = means[y] + 0.8 * rng.standard_normal((n, f_cont)).astype(np.float32)
    tables = rng.dirichlet(np.ones(card) * 0.5, size=(classes, f_disc))
    cdf = np.cumsum(tables, axis=-1)                 # [classes, f_disc, card]
    u = rng.random((n, f_disc))
    xd = np.zeros((n, f_disc), np.int32)
    for j in range(f_disc):
        c = (u[:, j, None] > cdf[y, j]).sum(-1)
        xd[:, j] = np.minimum(c, card - 1)
    attrs = ([Attribute(f"G{i}", REAL) for i in range(f_cont)]
             + [Attribute(f"D{i}", FINITE, card) for i in range(f_disc)]
             + [Attribute("Class", FINITE, classes)])
    xd_full = np.concatenate([xd, y[:, None].astype(np.int32)], axis=1)
    return DataStream.from_arrays(attrs, xc, xd_full), y


def fa_stream(n: int, f: int, l: int, seed: int = 0, noise: float = 0.3
              ) -> Tuple[DataStream, np.ndarray]:
    """Factor-analysis data: x = W h + mu + eps, h ~ N(0, I_l)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((f, l)).astype(np.float32)
    mu = rng.uniform(-1, 1, f).astype(np.float32)
    h = rng.standard_normal((n, l)).astype(np.float32)
    x = h @ W.T + mu + noise * rng.standard_normal((n, f)).astype(np.float32)
    attrs = [Attribute(f"X{i}", REAL) for i in range(f)]
    return DataStream.from_arrays(attrs, x), W
