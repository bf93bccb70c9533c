"""Chow-Liu trees and TAN classifiers from batched pairwise statistics
(counterpart of ``repro.learn_structure.chowliu``).

The Chow-Liu algorithm is the classic "structure learning as counting"
entry point: the maximum-likelihood tree over the variables is the maximum
spanning tree of the pairwise mutual-information graph, so the whole
learner is (1) every pairwise joint histogram in ONE ``family_counts``
call, (2) MI per pair, (3) a host-side MST, (4) conjugate CPD fitting.

* **discrete features** -- MI from the pairwise joint counts; the TAN
  variant (Friedman et al. 1997) conditions on the class: the conditional
  MI ``I(Xi; Xj | Y)`` comes from the triple counts (again one kernel
  call), the MST over it becomes the class-augmenting tree, and the class
  is wired as a parent of every feature.

* **continuous features** -- Gaussian MI ``-0.5 log(1 - rho^2)`` from the
  (masked) correlation matrix, on the host; the resulting directed tree is
  a CLG network (each child regresses on its tree parent).

Both return plain ``(edges, BayesianNetwork)``; the network has conjugate
posterior-mean CPDs (``scores.fit_cpds``) on ``device`` (the first card
unless the caller names another) and drops straight into ``infer_exact`` /
``PGMQueryEngine``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core.dag import BayesianNetwork
from repro_torch.data.stream import Attribute, Batch, FINITE
from repro_torch.learn_structure import scores as S


def pairwise_mi_discrete(xd, cards: Sequence[int], *, mask=None,
                         cond: Optional[Tuple[int, int]] = None,
                         backend: Optional[str] = None,
                         device: devmod.DeviceLike = None) -> np.ndarray:
    """[Fd, Fd] (conditional) mutual information between discrete columns.

    ``cond=(col, card)`` computes ``I(Xi; Xj | X_col)`` instead -- the TAN
    weight -- by treating the conditioning column as a shared "parent" in
    the family code.  All pairs ride one ``family_counts`` call.
    """
    Fd = len(cards)
    pairs = [(i, j) for i in range(Fd) for j in range(i + 1, Fd)
             if cond is None or (i != cond[0] and j != cond[0])]
    if not pairs:
        return np.zeros((Fd, Fd))
    dev, backend = S.placement(device, backend)
    xd = S.to_device(xd, dev, torch.int32)
    mask = None if mask is None else S.to_device(mask, dev, torch.float32)
    fams = [(i, (j,) if cond is None else (j, cond[0])) for i, j in pairs]
    strides, r, q, C = S.family_strides(fams, cards)
    counts = S.batched_family_counts(xd, strides, C, mask, backend=backend
                                     ).cpu().numpy().astype(np.float64)
    mi = np.zeros((Fd, Fd))
    for m, (i, j) in enumerate(pairs):
        ci, cj = cards[i], cards[j]
        nz = cond[1] if cond is not None else 1
        # code layout (child minor, first parent most significant):
        # cond is None:  x_i + ci * x_j            -> reshape [cj, ci]
        # cond = z:      x_i + ci * (x_z + cz*x_j) -> reshape [cj, cz, ci]
        tab = counts[m, : ci * cj * nz].reshape(cj, nz, ci)
        tot = tab.sum()
        if tot <= 0:
            continue
        p = tab / tot                                   # [cj, cz, ci]
        pz = p.sum((0, 2), keepdims=True)               # [1, cz, 1]
        p_iz = p.sum(0, keepdims=True)                  # [1, cz, ci]
        p_jz = p.sum(2, keepdims=True)                  # [cj, cz, 1]
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(p > 0, p * pz / np.maximum(p_iz * p_jz, 1e-300),
                             1.0)
            val = float((p * np.log(np.where(p > 0, ratio, 1.0))).sum())
        mi[i, j] = mi[j, i] = max(val, 0.0)
    return mi


def pairwise_mi_gaussian(xc, *, mask=None) -> np.ndarray:
    """[F, F] Gaussian mutual information ``-0.5 log(1 - rho^2)`` from the
    masked sample correlation matrix (host float64)."""
    x = np.asarray(torch.as_tensor(xc).cpu(), np.float64)
    w = (np.ones(x.shape[0]) if mask is None
         else np.asarray(torch.as_tensor(mask).cpu(), np.float64))
    n = max(w.sum(), 1.0)
    mu = (w[:, None] * x).sum(0) / n
    xm = (x - mu) * np.sqrt(w)[:, None]
    cov = xm.T @ xm / n
    sd = np.sqrt(np.maximum(np.diag(cov), 1e-12))
    rho = cov / np.outer(sd, sd)
    rho2 = np.clip(rho * rho, 0.0, 1.0 - 1e-12)
    mi = -0.5 * np.log1p(-rho2)
    np.fill_diagonal(mi, 0.0)
    return mi


def max_spanning_tree(weights: np.ndarray) -> List[Tuple[int, int]]:
    """Prim's algorithm on a dense weight matrix; returns V-1 undirected
    edges of the maximum-weight spanning tree."""
    V = weights.shape[0]
    if V <= 1:
        return []
    in_tree = np.zeros(V, bool)
    in_tree[0] = True
    best, best_from = weights[0].astype(np.float64), np.zeros(V, np.int64)
    best[0] = -np.inf
    edges = []
    for _ in range(V - 1):
        v = int(np.argmax(np.where(in_tree, -np.inf, best)))
        edges.append((int(best_from[v]), v))
        in_tree[v] = True
        upd = weights[v] > best
        best = np.where(upd & ~in_tree, weights[v], best)
        best_from = np.where(upd & ~in_tree, v, best_from)
    return edges


def _direct_from_root(edges: Sequence[Tuple[int, int]], root: int
                      ) -> List[Tuple[int, int]]:
    """Orient undirected tree edges away from ``root`` -> (parent, child)."""
    adj: Dict[int, List[int]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    out, seen, stack = [], {root}, [root]
    while stack:
        u = stack.pop()
        for v in adj.get(u, []):
            if v not in seen:
                seen.add(v)
                out.append((u, v))
                stack.append(v)
    return out


def chow_liu(data, attributes: Sequence[Attribute], *, root: int = 0,
             ess: float = 1.0, backend: Optional[str] = None,
             device: devmod.DeviceLike = None, **fit_kw
             ) -> Tuple[List[Tuple[str, str]], BayesianNetwork]:
    """Chow-Liu tree over the stream's features (all-discrete or
    all-continuous).  Returns the directed (parent, child) name edges and
    the fitted ``BayesianNetwork``."""
    batch = S.as_batch(data)
    kinds = {a.kind for a in attributes}
    if len(kinds) != 1:
        raise ValueError("chow_liu needs all-discrete or all-continuous "
                         f"features, got mixed kinds {sorted(kinds)}")
    if not 0 <= root < len(attributes):
        raise ValueError(f"root {root} out of range for "
                         f"{len(attributes)} attributes")
    dev, backend = S.placement(device, backend)
    names = [a.name for a in attributes]
    if kinds == {FINITE}:
        batch = S.batch_to(batch, dev)
        cards = [a.card for a in attributes]
        mi = pairwise_mi_discrete(batch.xd, cards, mask=batch.mask,
                                  backend=backend, device=dev)
    else:
        mi = pairwise_mi_gaussian(batch.xc, mask=batch.mask)
    directed = _direct_from_root(max_spanning_tree(mi), root)
    parents = {n: [] for n in names}
    for u, v in directed:
        parents[names[v]].append(names[u])
    bn = S.fit_cpds(attributes, parents, batch, ess=ess, backend=backend,
                    device=dev, **fit_kw)
    return [(names[u], names[v]) for u, v in directed], bn


def tan(data, attributes: Sequence[Attribute], class_name: str, *,
        root: int = 0, ess: float = 1.0, backend: Optional[str] = None,
        device: devmod.DeviceLike = None, **fit_kw
        ) -> Tuple[List[Tuple[str, str]], BayesianNetwork]:
    """Tree-augmented naive Bayes: class -> every feature, plus the maximum
    spanning tree of the class-conditional MI ``I(Xi; Xj | class)`` over
    the discrete features, rooted at feature ``root``.

    Continuous features ride along naive-Bayes style (class parent only);
    the augmenting tree spans the discrete features -- the counting part is
    one triple-count ``family_counts`` call.
    """
    feats = [a for a in attributes if a.name != class_name]
    cls = next(a for a in attributes if a.name == class_name)
    if cls.kind != FINITE:
        raise ValueError(f"class attribute {class_name!r} must be FINITE")
    dev, backend = S.placement(device, backend)
    cards = [a.card for a in attributes if a.kind == FINITE]
    disc_feats = [a for a in feats if a.kind == FINITE]
    # xd columns: FINITE attributes in attribute order
    dcol = {a.name: i for i, a in
            enumerate(a for a in attributes if a.kind == FINITE)}
    batch = S.batch_to(S.as_batch(data), dev)
    parents: Dict[str, List[str]] = {a.name: [] for a in attributes}
    for a in feats:
        parents[a.name].append(class_name)
    edges: List[Tuple[str, str]] = [(class_name, a.name) for a in feats]
    if len(disc_feats) >= 2:
        if not 0 <= root < len(disc_feats):
            raise ValueError(f"root {root} out of range for "
                             f"{len(disc_feats)} discrete features")
        mi = pairwise_mi_discrete(batch.xd, cards, mask=batch.mask,
                                  cond=(dcol[class_name], cls.card),
                                  backend=backend, device=dev)
        cols = [dcol[a.name] for a in disc_feats]
        sub = mi[np.ix_(cols, cols)]
        for u, v in _direct_from_root(max_spanning_tree(sub), root):
            parents[disc_feats[v].name].append(disc_feats[u].name)
            edges.append((disc_feats[u].name, disc_feats[v].name))
    bn = S.fit_cpds(attributes, parents, batch, ess=ess, backend=backend,
                    device=dev, **fit_kw)
    return edges, bn


def predict_class(bn: BayesianNetwork, class_name: str,
                  batch: Batch, attributes: Sequence[Attribute]
                  ) -> torch.Tensor:
    """argmax_c p(class = c | features) under the learned network --
    evaluated in one vectorized log-prob sweep per class value, on the
    network's device."""
    var = bn.dag.variables.by_name(class_name)
    _, col = S.variables_of(attributes)
    xc, xd, _ = S.batch_to(batch, bn.device)
    N = xc.shape[0]
    asg = {}
    for a in attributes:
        kind, c = col[a.name]
        asg[a.name] = xc[:, c] if kind == "c" else xd[:, c]
    lps = []
    for c in range(var.card):
        asg[class_name] = torch.full((N,), c, dtype=torch.int32,
                                     device=bn.device)
        lps.append(bn.log_prob(asg))
    return torch.stack(lps, -1).argmax(-1)
