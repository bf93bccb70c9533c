"""Synthetic data generators (the subset of ``repro.data.synthetic`` that
the streaming-VMP path, exact inference, structure learning, the temporal
models, SVI, LDA, the chaos tests and ``chip_smoke.py`` use).  Numpy draws
from a seed; the sequence generators, ``regression_stream``, ``lda_corpus``
and ``poison_stream``'s rows give the JAX package's arrays and the ground-truth networks its CPD arrays, bit for
bit.  ``bn_stream`` samples through a
``torch.Generator``, so its draws are not the JAX package's."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.data.stream import (Attribute, DataStream,
                                     DynamicDataStream, FINITE, REAL)


def poison_stream(stream: DataStream, rate: float, seed: int = 0
                  ) -> DataStream:
    """Wrap ``stream`` with seeded NaN corruption: each row of each chunk
    independently goes fully NaN with probability ``rate`` (the JAX
    package's draws: the same rows of the same chunks go NaN).

    The counterpart of ``DataStream(validate=True)`` and the streaming
    drivers' non-finite quarantine: feed a poisoned stream through either
    and the dropped / skipped counts match the injected corruption."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"rate must be in [0, 1], got {rate}")
    rng = np.random.default_rng(seed)

    def src():
        for xc, xd in stream.chunks():
            xc = np.array(xc, np.float32)
            if xc.shape[1]:
                rows = rng.random(xc.shape[0]) < rate
                xc[rows] = np.nan
            yield xc, np.asarray(xd)

    return DataStream(stream.attributes, src,
                      n_instances=stream.n_instances)


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


def regression_stream(n: int, d: int, seed: int = 0, noise: float = 0.5
                      ) -> Tuple[DataStream, np.ndarray]:
    """Bayesian-linear-regression data: y = w^T x + b + eps."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(d).astype(np.float32)
    b = 0.7
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = x @ w + b + noise * rng.standard_normal(n).astype(np.float32)
    attrs = ([Attribute(f"X{i}", REAL) for i in range(d)]
             + [Attribute("Y", REAL)])
    return (DataStream.from_arrays(attrs, np.concatenate([x, y[:, None]], 1)),
            np.concatenate([w, [b]]).astype(np.float32))


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


# -- sequence data (dynamic models): numpy only, the JAX package's draws ------


def hmm_sequences(s: int, t: int, states: int, f: int, seed: int = 0
                  ) -> Tuple[DynamicDataStream, np.ndarray, np.ndarray, np.ndarray]:
    """Gaussian-emission HMM sequences; returns stream + true params."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.ones(states) * 0.3, size=states)
    # make transitions sticky so states are identifiable
    trans = 0.2 * trans + 0.8 * np.eye(states)
    init = np.ones(states) / states
    means = (np.arange(states)[:, None] * 4.0
             + rng.uniform(-1, 1, (states, f))).astype(np.float32)
    xs = np.zeros((s, t, f), np.float32)
    zs = np.zeros((s, t), np.int64)
    for i in range(s):
        z = rng.choice(states, p=init)
        for j in range(t):
            zs[i, j] = z
            xs[i, j] = means[z] + 0.5 * rng.standard_normal(f)
            z = rng.choice(states, p=trans[z])
    attrs = [Attribute(f"G{i}", REAL) for i in range(f)]
    return DynamicDataStream(attrs, xs), trans.astype(np.float32), means, zs


def lds_sequences(s: int, t: int, dim_h: int, f: int, seed: int = 0
                  ) -> Tuple[DynamicDataStream, np.ndarray, np.ndarray]:
    """Linear dynamical system: h_t = A h_{t-1} + w, x_t = C h_t + v."""
    rng = np.random.default_rng(seed)
    # stable A
    A = rng.standard_normal((dim_h, dim_h)) * 0.3
    A = 0.9 * A / np.abs(np.linalg.eigvals(A)).max()  # spectral radius 0.9
    C = rng.standard_normal((f, dim_h)).astype(np.float32)
    xs = np.zeros((s, t, f), np.float32)
    for i in range(s):
        h = rng.standard_normal(dim_h)
        for j in range(t):
            h = A @ h + 0.3 * rng.standard_normal(dim_h)
            xs[i, j] = C @ h + 0.2 * rng.standard_normal(f)
    attrs = [Attribute(f"G{i}", REAL) for i in range(f)]
    return DynamicDataStream(attrs, xs), A.astype(np.float32), C


def hmm_stream(n_batches: int, s: int, t: int, states: int, f: int,
               switch_at: Optional[int] = None, shift: float = 6.0,
               seed: int = 0):
    """Stream of HMM sequence batches with a mid-stream regime switch.

    ``n_batches`` batches of ``s`` sequences x ``t`` steps from a sticky
    Gaussian-emission HMM; from batch ``switch_at`` on (default: halfway)
    every emission mean jumps by ``shift`` — the temporal analog of
    ``drift_stream``/``bn_stream(n_chunks=...)`` for the ``seq_stream_fit``
    drift tests.  Returns (batches, attrs, switch_at) where ``batches`` is
    a list of equal-shape ``DynamicDataStream``s (one per arriving batch).
    """
    if switch_at is None:
        switch_at = n_batches // 2
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.ones(states) * 0.3, size=states)
    trans = 0.2 * trans + 0.8 * np.eye(states)
    init = np.ones(states) / states
    means = (np.arange(states)[:, None] * 4.0
             + rng.uniform(-1, 1, (states, f))).astype(np.float32)
    attrs = [Attribute(f"G{i}", REAL) for i in range(f)]
    batches = []
    for b in range(n_batches):
        mu = means + (shift if b >= switch_at else 0.0)
        xs = np.zeros((s, t, f), np.float32)
        for i in range(s):
            z = rng.choice(states, p=init)
            for j in range(t):
                xs[i, j] = mu[z] + 0.5 * rng.standard_normal(f)
                z = rng.choice(states, p=trans[z])
        batches.append(DynamicDataStream(attrs, xs))
    return batches, attrs, switch_at


def slds_stream(n_batches: int, s: int, t: int, dim_h: int, f: int,
                switch_at: Optional[int] = None, seed: int = 0):
    """Stream of switching-LDS sequence batches with a mid-stream regime
    switch: every sequence alternates between two dynamics matrices (a slow
    rotation and its reverse) at a per-sequence midpoint, and from batch
    ``switch_at`` on the emission map is re-drawn (the stream-level drift).
    Returns (batches, attrs, A_true [2, dim_h, dim_h], switch_at)."""
    if switch_at is None:
        switch_at = n_batches // 2
    rng = np.random.default_rng(seed)
    th = 0.5
    rot = np.eye(dim_h)
    rot[:2, :2] = 0.95 * np.array([[np.cos(th), -np.sin(th)],
                                   [np.sin(th), np.cos(th)]])
    A_true = np.stack([rot, rot.T]).astype(np.float32)   # [2, L, L]
    C1 = rng.standard_normal((f, dim_h)).astype(np.float32)
    C2 = rng.standard_normal((f, dim_h)).astype(np.float32)
    attrs = [Attribute(f"G{i}", REAL) for i in range(f)]
    batches = []
    for b in range(n_batches):
        C = C2 if b >= switch_at else C1
        xs = np.zeros((s, t, f), np.float32)
        for i in range(s):
            h = rng.standard_normal(dim_h)
            for j in range(t):
                A = A_true[0] if j < t // 2 else A_true[1]
                h = A @ h + 0.1 * rng.standard_normal(dim_h)
                xs[i, j] = C @ h + 0.1 * rng.standard_normal(f)
        batches.append(DynamicDataStream(attrs, xs))
    return batches, attrs, A_true, switch_at


# -- ground-truth structures --------------------------------------------------


def random_discrete_bn(n_vars: int, card: int = 3, max_parents: int = 2,
                       seed: int = 0, conc: float = 0.25, tree: bool = False,
                       device: devmod.DeviceLike = None):
    """Random discrete Bayesian network with bounded fan-in.

    Node ``D{i}`` draws its parents uniformly from ``D{0..i-1}`` (at most
    ``max_parents``; exactly one when ``tree=True``).  Each parent's value
    shifts a chunk of the child's probability mass to a distinct mode (plus
    ``conc`` of Dirichlet noise), so every edge carries detectable
    dependence.  Returns the port's ``BayesianNetwork``."""
    from repro_torch.core.dag import (BayesianNetwork, DAG, MultinomialCPD,
                                      Variables)

    dev = devmod.resolve_device(device)
    rng = np.random.default_rng(seed)
    vs = Variables()
    nodes = [vs.new_multinomial(f"D{i}", card) for i in range(n_vars)]
    dag = DAG(vs)
    cpds = {}
    for i, v in enumerate(nodes):
        if tree:
            n_pa = 1 if i > 0 else 0
        else:
            n_pa = int(rng.integers(0, min(max_parents, i) + 1))
        pa = sorted(rng.choice(i, size=n_pa, replace=False)) if n_pa else []
        for p in pa:
            dag.add_parent(v, nodes[p])
        q = card ** len(pa)
        noise = rng.dirichlet(np.ones(card), size=q)
        table = conc * noise
        if pa:
            # per-parent mode weights: first parent strongest, all > noise
            w = np.array([2.0 ** -k for k in range(len(pa))])
            w = w / w.sum() * (1.0 - conc)
            offset = rng.integers(0, card, size=len(pa))
            for j in range(q):
                digits = [(j // card ** (len(pa) - 1 - k)) % card
                          for k in range(len(pa))]
                for k, d in enumerate(digits):
                    table[j, (d + offset[k]) % card] += w[k]
        else:
            table += (1.0 - conc) * rng.dirichlet(np.full(card, 0.8))
        table = table / table.sum(-1, keepdims=True)
        cpds[v.name] = MultinomialCPD(torch.from_numpy(
            table.astype(np.float32).reshape((card,) * len(pa) + (card,))
        ).to(dev))
    return BayesianNetwork(dag, cpds)


def clg_tree_bn(n_vars: int, seed: int = 0, beta_lo: float = 0.8,
                beta_hi: float = 1.4, noise: float = 0.4,
                device: devmod.DeviceLike = None):
    """Random linear-Gaussian tree: ``G{i}`` regresses on one earlier node
    with |beta| in [beta_lo, beta_hi]."""
    from repro_torch.core.dag import BayesianNetwork, CLGCPD, DAG, Variables

    dev = devmod.resolve_device(device)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)
    vs = Variables()
    nodes = [vs.new_gaussian(f"G{i}") for i in range(n_vars)]
    dag = DAG(vs)
    cpds = {nodes[0].name: CLGCPD(f32(float(rng.uniform(-1, 1))),
                                  f32([]), f32(1.0))}
    for i in range(1, n_vars):
        p = int(rng.integers(0, i))
        dag.add_parent(nodes[i], nodes[p])
        beta = float(rng.uniform(beta_lo, beta_hi) * rng.choice([-1.0, 1.0]))
        cpds[nodes[i].name] = CLGCPD(
            f32(float(rng.uniform(-1, 1))), f32([beta]),
            f32(float(noise * (0.5 + rng.random()))))
    return BayesianNetwork(dag, cpds)


def bn_stream(bn, n: int, seed: int = 0, n_chunks: int = 1) -> DataStream:
    """Sample ``n`` instances from a ``BayesianNetwork`` into a
    ``DataStream`` (continuous variables -> REAL/xc columns, discrete ->
    FINITE/xd, both in registry order).  Draws on the device that holds the
    network's CPDs, from ``torch.Generator(device).manual_seed(seed)``.
    ``n_chunks > 1`` splits the rows into that many source chunks so the
    stream drives the streaming / drift-adaptation paths."""
    asg = bn.sample(torch.Generator(device=bn.device).manual_seed(seed), n)
    attrs: List[Attribute] = []
    cc, dd = [], []
    for v in bn.dag.variables:
        if v.is_discrete:
            attrs.append(Attribute(v.name, FINITE, v.card))
            dd.append(asg[v.name].to(torch.int32))
        else:
            attrs.append(Attribute(v.name, REAL))
            cc.append(asg[v.name].to(torch.float32))
    xc = (torch.stack(cc, 1).cpu().numpy() if cc
          else np.zeros((n, 0), np.float32))
    xd = (torch.stack(dd, 1).cpu().numpy() if dd
          else np.zeros((n, 0), np.int32))
    if n_chunks <= 1:
        return DataStream.from_arrays(attrs, xc, xd)
    bounds = np.linspace(0, n, n_chunks + 1).astype(int)

    def src():
        for a, b in zip(bounds, bounds[1:]):
            yield xc[a:b], xd[a:b]

    return DataStream(attrs, src, n_instances=n)


def lda_corpus(n_docs: int, vocab: int, topics: int, doc_len: int = 80,
               seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Bag-of-words corpus from an LDA generative model (the JAX package's
    draws, one ``rng.choice`` a token).

    Returns (counts [n_docs, vocab], true_topics [topics, vocab])."""
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.ones(vocab) * 0.1, size=topics)
    counts = np.zeros((n_docs, vocab), np.float32)
    for d in range(n_docs):
        theta = rng.dirichlet(np.ones(topics) * 0.3)
        zs = rng.choice(topics, size=doc_len, p=theta)
        for z in zs:
            w = rng.choice(vocab, p=beta[z])
            counts[d, w] += 1
    return counts, beta.astype(np.float32)
