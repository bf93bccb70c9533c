"""Decomposable Bayesian family scores from sufficient statistics
(counterpart of ``repro.learn_structure.scores``).

A score-based structure learner only ever asks one question: "how well does
family (child, parent set) explain the data?"  For conjugate models the
answer is the closed-form marginal likelihood of the family, computed from
the family's sufficient statistics alone -- so scoring is a counting
problem, and counting is what the batched kernels are for:

* **Discrete child, discrete parents** -- the BDeu score (Heckerman et al.):
  the Dirichlet-multinomial evidence with the equivalent-sample-size prior
  ``alpha_jk = ess / (q r)``.  Counts for ALL candidate families come from
  ONE ``family_counts`` call (``backend="cuda"``: the hand-written kernel;
  ``"einsum"``: its plain version ``kernels.ref.family_counts_ref``).

* **Continuous child, continuous + discrete parents (CLG, Eq. 2)** -- the
  Normal-Gamma / MVNormalGamma evidence: per discrete parent configuration
  the Bayesian linear regression of the child on ``[1, x_parents]`` under
  the conjugate NIG prior has closed-form log marginal likelihood
  (:func:`nig_evidence`).  The per-(family, configuration) regression
  moments come from the ``clg_suffstats`` kernel with the configuration
  one-hot as the responsibility matrix, over chunks of instances whose
  moments add in float64 (:func:`group_moments`; the JAX package sums all
  instances in float32, which is too coarse for these scores at 2^20
  instances).

Both scores decompose over families, so hill-climbing deltas touch only the
families an operator changes.  Zero-padding candidate designs to a common
width is *exactly* evidence-invariant, so ragged candidate sets batch into
one device call.

Column convention (matches ``data.stream.DataStream``): discrete variables
live in ``xd`` columns with cardinalities ``cards``; continuous variables
in ``xc`` columns.  A ``Batch`` holds numpy arrays (or tensors): the public
functions move ``xd``, ``xc`` and ``mask`` to ``device`` (the first card
unless the caller names another) once, and ``backend=None`` is the device's
default (``"cuda"`` on a card, ``"einsum"`` on the CPU).
:func:`fit_cpds` materializes a learned structure as a ``BayesianNetwork``
with conjugate posterior-mean CPDs on that device -- the object that flows
into ``infer_exact`` and ``PGMQueryEngine``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core.dag import (BayesianNetwork, CLGCPD, DAG,
                                  MultinomialCPD, Variables)
from repro_torch.data.stream import Attribute, Batch, DataStream, FINITE, REAL
from repro_torch.kernels import clg_stats, family_counts, ref

Tensor = torch.Tensor

LOG2PI = math.log(2.0 * math.pi)
MOMENT_CHUNK = 1 << 14    # instances per float64 partial of CLG moments

# family over xd columns: (child_col, parent_cols); parent order is
# irrelevant to the score, significant only for table axis layout
DiscFamily = Tuple[int, Tuple[int, ...]]
# family of a continuous child: (child_xc_col, cont_parent_xc_cols,
# disc_parent_xd_cols)
ContFamily = Tuple[int, Tuple[int, ...], Tuple[int, ...]]


def as_batch(data) -> Batch:
    """Coerce a learner's ``data`` argument (Batch or DataStream)."""
    return data.collect() if isinstance(data, DataStream) else data


def placement(device: devmod.DeviceLike, backend: Optional[str]
              ) -> Tuple[torch.device, str]:
    """(device, backend) of an entry point: ``None`` -> the first card and
    the device's default backend."""
    dev = devmod.resolve_device(device)
    return dev, devmod.check_backend(backend or devmod.default_backend(dev),
                                     dev)


def to_device(x, dev: torch.device, dtype: torch.dtype) -> Tensor:
    """A numpy array or tensor as a contiguous tensor on ``dev`` (no copy
    when it is one already)."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()                # e.g. a view of another framework's array
    return torch.as_tensor(x).to(device=dev, dtype=dtype).contiguous()


def batch_to(batch: Batch, dev: torch.device) -> Batch:
    """The batch's columns and mask as tensors on ``dev``."""
    return Batch(to_device(batch.xc, dev, torch.float32),
                 to_device(batch.xd, dev, torch.int32),
                 to_device(batch.mask, dev, torch.float32))


# ---------------------------------------------------------------------------
# family config codes / counts
# ---------------------------------------------------------------------------


def family_strides(families: Sequence[DiscFamily], cards: Sequence[int]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Mixed-radix stride matrix for a batch of discrete families.

    Child minor, first parent most significant: the flat code of family
    ``(ch, (p1..pk))`` is ``x_ch + r*(x_pk + c_pk*(... x_p1))`` so
    ``counts.reshape(c_p1, .., c_pk, r)`` is the family's joint table.

    Returns (strides [M, Fd], r [M] child cards, q [M] parent-config
    counts, Cmax).
    """
    Fd = len(cards)
    M = len(families)
    strides = np.zeros((M, Fd), np.int32)
    r = np.zeros(M, np.int32)
    q = np.zeros(M, np.int32)
    for m, (ch, pa) in enumerate(families):
        strides[m, ch] = 1
        r[m] = cards[ch]
        s = int(cards[ch])
        for p in reversed(pa):
            strides[m, p] = s
            s *= int(cards[p])
        q[m] = s // int(cards[ch])
    Cmax = int((r * q).max()) if M else 1
    return strides, r, q, Cmax


def batched_family_counts(xd: Tensor, strides: np.ndarray, C: int,
                          mask: Optional[Tensor] = None, *,
                          backend: str) -> Tensor:
    """Joint-config counts [M, C] for every family in one device call
    (``xd`` and ``mask`` are tensors on one device)."""
    w = (torch.ones(xd.shape[0], dtype=torch.float32, device=xd.device)
         if mask is None else mask.to(torch.float32))
    s = torch.as_tensor(strides, dtype=torch.int32, device=xd.device)
    if backend == "cuda":
        return family_counts.family_counts(xd, s, w, C)
    return ref.family_counts_ref(xd, s, w, C)


# ---------------------------------------------------------------------------
# BDeu (discrete families)
# ---------------------------------------------------------------------------


def bdeu_from_counts(counts: Tensor, r: np.ndarray, q: np.ndarray, *,
                     ess: float = 1.0) -> Tensor:
    """BDeu log score per family from flat joint counts.

    counts: [M, C] child-minor flat tables (padded configs exactly zero);
    r/q: per-family child cardinality and parent-config count.  Zero-count
    cells contribute ``lgamma(alpha) - lgamma(alpha) = 0`` so the padding
    needs no masking; only the child-card reshape forces bucketing by r.
    """
    M, C = counts.shape
    dev = counts.device
    scores = torch.zeros(M, dtype=torch.float32, device=dev)
    for rv in np.unique(r):
        sel_np = np.nonzero(r == rv)[0]
        sel = torch.as_tensor(sel_np, device=dev)
        rv = int(rv)
        Cb = int(-(-C // rv)) * rv                 # pad C to a multiple of r
        cb = counts[sel]
        if Cb > C:
            cb = torch.nn.functional.pad(cb, (0, Cb - C))
        n_ijk = cb.reshape(len(sel_np), Cb // rv, rv)        # [Mb, j, k]
        n_ij = n_ijk.sum(-1)                                 # [Mb, j]
        qb = torch.as_tensor(q[sel_np].astype(np.float32), device=dev)[:, None]
        a_j = ess / qb
        a_jk = ess / (qb * rv)
        s = ((torch.lgamma(a_j) - torch.lgamma(a_j + n_ij)).sum(-1)
             + (torch.lgamma(a_jk[..., None] + n_ijk)
                - torch.lgamma(a_jk[..., None])).sum((-1, -2)))
        scores[sel] = s.to(torch.float32)
    return scores


def disc_family_scores(xd, families: Sequence[DiscFamily],
                       cards: Sequence[int], *, mask=None, ess: float = 1.0,
                       backend: Optional[str] = None,
                       device: devmod.DeviceLike = None) -> np.ndarray:
    """BDeu scores for all candidate discrete families in one device call."""
    if not families:
        return np.zeros(0, np.float64)
    dev, backend = placement(device, backend)
    xd = to_device(xd, dev, torch.int32)
    mask = None if mask is None else to_device(mask, dev, torch.float32)
    strides, r, q, C = family_strides(families, cards)
    counts = batched_family_counts(xd, strides, C, mask, backend=backend)
    return bdeu_from_counts(counts, r, q, ess=ess).cpu().numpy().astype(
        np.float64)


# ---------------------------------------------------------------------------
# NIG evidence (continuous CLG families)
# ---------------------------------------------------------------------------


def nig_evidence(sxx: Tensor, sxy: Tensor, syy: Tensor, n: Tensor, *,
                 kappa: float = 1.0, a0: float = 1.0, b0: float = 1.0
                 ) -> Tensor:
    """Log marginal likelihood of Bayesian linear regression under the
    conjugate NIG prior ``m0 = 0, K0 = kappa I, Gamma(a0, b0)``.

    Batched over the leading axes of the regression moments (``sxx``
    [..., D, D]).  This is the continuous-family counterpart of BDeu: the
    evidence of the ``expfam.MVNormalGamma`` update.
    """
    D = sxx.shape[-1]
    K0 = kappa * torch.eye(D, dtype=sxx.dtype, device=sxx.device)
    Kn = K0 + sxx
    mn = torch.linalg.solve(Kn, sxy[..., None])[..., 0]
    an = a0 + 0.5 * n
    bn = b0 + 0.5 * (syy - torch.einsum("...d,...de,...e->...", mn, Kn, mn))
    bn = bn.clamp_min(1e-10)
    _, logdet_n = torch.linalg.slogdet(Kn)
    logdet_0 = D * math.log(kappa)
    return (-0.5 * n * LOG2PI + 0.5 * (logdet_0 - logdet_n)
            + a0 * math.log(b0) - an * torch.log(bn)
            + torch.lgamma(an) - math.lgamma(a0))


def _config_onehot(xd: Tensor, disc_pa: Tuple[int, ...],
                   cards: Sequence[int]) -> Tuple[Tensor, int]:
    """One-hot [N, q] of the joint configuration of ``disc_pa`` columns
    (first parent most significant -- the fit_cpds reshape convention)."""
    N = xd.shape[0]
    if not disc_pa:
        return torch.ones((N, 1), dtype=torch.float32, device=xd.device), 1
    code = torch.zeros(N, dtype=torch.int32, device=xd.device)
    for p in disc_pa:
        code = code * int(cards[p]) + xd[:, p].to(torch.int32)
    q = int(np.prod([cards[p] for p in disc_pa]))
    return ref.one_hot_cmp(code, q), q


def group_design(xc: Tensor, xd: Tensor, fams: Sequence[ContFamily],
                 cards: Sequence[int], mask: Optional[Tensor]
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """(d [N, M, Dmax], y [N, M], r [N, q]) of families sharing one discrete
    parent set: designs ``[1, x_parents]`` zero-padded to a common width,
    gathered on the device, and the config one-hot (times the mask) as
    responsibilities -- the inputs of one ``clg_suffstats`` call for the
    whole group (the wrapper splits a row too wide for one launch by
    families)."""
    r, _ = _config_onehot(xd, fams[0][2], cards)
    if mask is not None:
        r = r * mask.to(torch.float32)[:, None]
    dev = xc.device
    Dmax = 1 + max(len(f[1]) for f in fams)
    idx = np.zeros((len(fams), Dmax - 1), np.int64)
    live = np.zeros((len(fams), Dmax - 1), bool)
    for m, (_, cont_pa, _) in enumerate(fams):
        idx[m, :len(cont_pa)] = cont_pa
        live[m, :len(cont_pa)] = True
    d = torch.ones((xc.shape[0], len(fams), Dmax), dtype=torch.float32,
                   device=dev)
    if Dmax > 1:
        d[:, :, 1:] = torch.where(torch.as_tensor(live, device=dev),
                                  xc[:, torch.as_tensor(idx, device=dev)],
                                  0.0)
    y = xc[:, torch.as_tensor([f[0] for f in fams], device=dev)]  # [N, M]
    return d, y, r


def group_moments(d: Tensor, y: Tensor, r: Tensor, backend: str
                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """float64 regression moments (sxx, sxy, syy, n) of a group.

    The instances go in chunks of :data:`MOMENT_CHUNK` whose moments add in
    float64: on the ``"cuda"`` backend one ``clg_suffstats_chunks`` launch
    gives every chunk's float32 moments, on ``"einsum"`` the plain einsum
    runs chunk by chunk on float64 inputs.  NIG scores need it: the
    residual ``syy - m' K m`` is a small difference of large sums, and
    float32 moments of all N = 2^20 instances in one pass move family scores
    by tens of nats (one einsum, accumulating along N, by hundreds), enough
    to keep or drop edges whose true score change is a few nats."""
    if backend == "cuda":
        parts = clg_stats.clg_suffstats_chunks(d, y, r, MOMENT_CHUNK)
        sxx, sxy, syy = (t.double().sum(0) for t in parts)
    else:
        acc = None
        for i in range(0, d.shape[0], MOMENT_CHUNK):
            sl = slice(i, i + MOMENT_CHUNK)
            part = ref.clg_suffstats_ref(d[sl].double(), y[sl].double(),
                                         r[sl].double())
            acc = part if acc is None else tuple(a + t for a, t in
                                                 zip(acc, part))
        sxx, sxy, syy = acc
    n = r.double().sum(0)[None].expand(syy.shape)           # [M, q]
    return sxx, sxy, syy, n


def clg_family_scores(xc, xd, families: Sequence[ContFamily],
                      cards: Sequence[int], *, mask=None,
                      kappa: float = 1.0, a0: float = 1.0, b0: float = 1.0,
                      backend: Optional[str] = None,
                      device: devmod.DeviceLike = None) -> np.ndarray:
    """NIG-evidence scores for continuous CLG families.

    Families sharing a discrete parent set batch into one suff-stats kernel
    call (their configuration one-hot is shared); the per-configuration
    evidences sum into the family score.
    """
    scores = np.zeros(len(families), np.float64)
    if not families:
        return scores
    dev, backend = placement(device, backend)
    xc = to_device(xc, dev, torch.float32)
    xd = to_device(xd, dev, torch.int32)
    mask = None if mask is None else to_device(mask, dev, torch.float32)
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for m, (_, _, disc_pa) in enumerate(families):
        groups.setdefault(tuple(sorted(disc_pa)), []).append(m)
    for disc_pa, idxs in groups.items():
        fams = [(families[m][0], families[m][1], disc_pa) for m in idxs]
        sxx, sxy, syy, n = group_moments(
            *group_design(xc, xd, fams, cards, mask), backend)
        ev = nig_evidence(sxx, sxy, syy, n, kappa=kappa, a0=a0, b0=b0)
        scores[np.asarray(idxs)] = ev.sum(-1).cpu().numpy().astype(np.float64)
    return scores


# ---------------------------------------------------------------------------
# structure <-> stream plumbing
# ---------------------------------------------------------------------------


def variables_of(attributes: Sequence[Attribute]
                 ) -> Tuple[Variables, Dict[str, Tuple[str, int]]]:
    """Build the Variables registry of a stream's attributes plus the
    name -> ("c"|"d", column) map (DataStream column order: REAL columns
    into xc, FINITE columns into xd, each by attribute order)."""
    vs = Variables()
    col: Dict[str, Tuple[str, int]] = {}
    ci = di = 0
    for a in attributes:
        if a.kind == REAL:
            vs.new_gaussian(a.name)
            col[a.name] = ("c", ci)
            ci += 1
        elif a.kind == FINITE:
            vs.new_multinomial(a.name, a.card)
            col[a.name] = ("d", di)
            di += 1
        else:
            raise ValueError(f"unknown attribute kind {a.kind!r}")
    return vs, col


def structure_stats(attributes: Sequence[Attribute],
                    parents: Dict[str, Sequence[str]], batch: Batch, *,
                    backend: Optional[str] = None,
                    device: devmod.DeviceLike = None) -> Dict[str, object]:
    """Sufficient statistics of ``batch`` for every family of a fixed
    structure: ``{"disc": counts [Md, C] | None, "cont": {child name ->
    (sxx [q,D,D], sxy [q,D], syy [q], n [q])}}``, tensors on ``device``
    (float32 counts, float64 moments: see :func:`group_moments`).

    Stats are ADDITIVE in the instances, so a streaming window maintains
    them incrementally: add an arriving chunk's stats, subtract an evicted
    chunk's (``AdaptiveStructure``), and build CPDs from the running sum
    with :func:`cpds_from_stats` -- per-batch cost O(batch), not O(window).
    """
    dev, backend = placement(device, backend)
    vs, col = variables_of(attributes)
    cards = [a.card for a in attributes if a.kind == FINITE]
    xc, xd, mask = batch_to(batch, dev)
    disc_fams: List[DiscFamily] = []
    for v in vs:
        if v.is_discrete:
            dpa = [col[p][1] for p in parents.get(v.name, ())]
            disc_fams.append((col[v.name][1], tuple(dpa)))
    disc = None
    if disc_fams:
        strides, _, _, C = family_strides(disc_fams, cards)
        disc = batched_family_counts(xd, strides, C, mask, backend=backend)
    cont: Dict[str, Tuple] = {}
    for v in vs:
        if v.is_discrete:
            continue
        pas = [vs.by_name(p) for p in parents.get(v.name, ())]
        dpa = tuple(col[p.name][1] for p in pas if p.is_discrete)
        cpa = tuple(col[p.name][1] for p in pas if not p.is_discrete)
        sxx, sxy, syy, n = group_moments(*group_design(
            xc, xd, [(col[v.name][1], cpa, dpa)], cards, mask), backend)
        cont[v.name] = (sxx[0], sxy[0], syy[0], n[0])
    return {"disc": disc, "cont": cont}


def cpds_from_stats(attributes: Sequence[Attribute],
                    parents: Dict[str, Sequence[str]],
                    stats: Dict[str, object], *, ess: float = 1.0,
                    kappa: float = 1.0, a0: float = 1.0, b0: float = 1.0
                    ) -> BayesianNetwork:
    """Build the conjugate posterior-mean ``BayesianNetwork`` of a
    structure from :func:`structure_stats` output (possibly a running sum
    of per-chunk stats), with float32 CPDs on the stats' device.  Discrete
    tables are smoothed on the host in float32, as the JAX package does;
    CLG weights are solved in float64 from the float64 moments."""
    vs, col = variables_of(attributes)
    cards = [a.card for a in attributes if a.kind == FINITE]
    dag = DAG(vs)
    for child, pas in parents.items():
        for p in pas:
            dag.add_parent(vs.by_name(child), vs.by_name(p))
    leaves = [stats["disc"]] + [t for st in stats["cont"].values()
                                for t in st]
    dev = next(t.device for t in leaves if t is not None)

    cpds: Dict[str, object] = {}
    disc_children = [v for v in vs if v.is_discrete]
    if disc_children:
        counts = stats["disc"].cpu().numpy()
        for m, v in enumerate(disc_children):
            dpa = [col[p.name][1] for p in dag.get_parents(v)]
            rv = cards[col[v.name][1]]
            pa_cards = [cards[p] for p in dpa]
            qv = int(np.prod(pa_cards)) if pa_cards else 1
            tab = counts[m, : rv * qv]
            tab = tab.reshape(*pa_cards, rv) + ess / (rv * qv)
            cpds[v.name] = MultinomialCPD(torch.from_numpy(
                tab / tab.sum(-1, keepdims=True)).to(dev))

    for v in vs:
        if v.is_discrete:
            continue
        pas = dag.get_parents(v)
        dpa = tuple(col[p.name][1] for p in pas if p.is_discrete)
        cpa = tuple(col[p.name][1] for p in pas if not p.is_discrete)
        sxx, sxy, syy, n = stats["cont"][v.name]
        K0 = kappa * torch.eye(sxx.shape[-1], dtype=sxx.dtype, device=dev)
        Kn = K0 + sxx                                        # [q, D, D]
        mn = torch.linalg.solve(Kn, sxy[..., None])[..., 0]  # [q, D]
        an = a0 + 0.5 * n
        bn = b0 + 0.5 * (syy - torch.einsum("qd,qde,qe->q", mn, Kn, mn))
        bn = bn.clamp_min(1e-10)
        pa_cards = tuple(cards[p] for p in dpa)
        alpha = mn[:, 0].reshape(pa_cards)
        beta = mn[:, 1:].reshape(pa_cards + (len(cpa),))
        sigma2 = (bn / an).reshape(pa_cards)
        cpds[v.name] = CLGCPD(alpha=alpha.float(), beta=beta.float(),
                              sigma2=sigma2.float())
    return BayesianNetwork(dag, cpds)


def fit_cpds(attributes: Sequence[Attribute],
             parents: Dict[str, Sequence[str]], batch: Batch, *,
             ess: float = 1.0, kappa: float = 1.0, a0: float = 1.0,
             b0: float = 1.0, backend: Optional[str] = None,
             device: devmod.DeviceLike = None) -> BayesianNetwork:
    """Materialize a learned structure as a ``BayesianNetwork`` with
    conjugate posterior-mean CPDs fitted on ``batch``.

    ``parents`` maps child name -> parent names; discrete children take
    Dirichlet(ess/(q r))-smoothed tables, continuous children per-config
    NIG posterior means (weights ``m_n``, variance ``b_n / a_n`` -- the
    same point estimate ``Model.to_bayesian_network`` exports).  The
    result flows straight into ``infer_exact`` / ``PGMQueryEngine``.
    (One-shot composition of :func:`structure_stats` +
    :func:`cpds_from_stats`; the streaming path keeps the stats and updates
    them incrementally instead.)
    """
    stats = structure_stats(attributes, parents, batch, backend=backend,
                            device=device)
    return cpds_from_stats(attributes, parents, stats, ess=ess, kappa=kappa,
                           a0=a0, b0=b0)
