"""Dynamic latent-variable models -- paper Table 2, right column
(counterpart of ``repro.pgm_models.dynamic``).

All models operate on sequence data ([B, T, ...]: a ``SequenceBatch``, a
``DynamicDataStream`` or arrays) and are learnt by variational Bayesian EM:

  * HMM family -- E-step = masked forward-backward, batched over sequences;
    M-step = conjugate Dirichlet / MVNormalGamma updates from expected
    counts.  AR-HMM and IO-HMM reuse the CLG emission (regression on the
    previous observation / an exogenous input).
  * Factorial HMM -- chain-parallel structured VB (Jacobi sweeps).
  * Kalman filter (LDS) -- E-step = Kalman smoothing; M-step = linear
    regressions for the transition and emission rows.
  * Switching LDS -- structured mean field q(s)q(h): factored-frontier pass
    for the switch chain, Kalman smoothing under averaged dynamics,
    regression M-step per switch state.

Streaming (Eq. 3) works as in the static case: :func:`seq_stream_fit`
replays sequence batches with the Page-Hinkley drift gate, prior tempering
and the non-finite quarantine of ``core.streaming``.

**Sweep loops.**  Every ``update_model`` defaults to ``fused=True``: all
sweeps run with the reference's convergence HOLD kept on the device
(``torch.where`` on an ``active`` flag, no host read a sweep), so the
:class:`TemporalFitMetrics` columns have one entry a sweep, as the
reference's fused ``lax.scan`` gives.  ``fused=False`` is the host loop
that reads each sweep's ELBO and breaks at convergence; the two adopt the
same sweeps.  The time recursions are Python loops over T whose steps read
nothing back to the host; the batched linear algebra inside them uses the
``_ex`` forms, which skip the info check (a host sync on a card).

**Suff-stats backends.**  The HMM-family and fHMM M-steps take
``backend="einsum" | "cuda"`` (``None``: the model's, which follows its
device as ``Model``'s does); ``"cuda"`` routes the responsibility-weighted
regression moments through ``kernels.clg_stats.clg_seq_suffstats``, one
launch of the ``clg_suffstats`` kernel a sweep (one a chain for the fHMM).

Not here: the reference's trace counters (``trace_counts``, ``_strong``:
jit retrace and donation accounting, which eager PyTorch has no use for)
and its telemetry events (observability is not ported yet).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import expfam as ef
from repro_torch.core.factored_frontier import (Factorial2TBN,
                                                factored_frontier_filter,
                                                predictive_posterior)
from repro_torch.core.streaming import (INFO_KEYS, drift_gate, drift_init,
                                        tree_finite, tree_leaves, tree_map)
from repro_torch.data.stream import Attribute, REAL, SequenceBatch
from repro_torch.kernels import clg_stats
from repro_torch.obs import sink as obs_sink
from repro_torch.obs.metrics import TemporalFitMetrics

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# sweep loops: the device hold and the host loop with break
# ---------------------------------------------------------------------------

Step = Callable[[object], Tuple[object, Tensor]]


def _hold_loop(step: Step, state, sweeps: int, tol: float):
    """``sweeps`` sweeps of ``step(state) -> (new_state, elbo)``.  Once
    ``|e - last| < tol (|e| + 1)`` the state stops being adopted: the
    converging sweep's update is still taken (the host loop breaks after
    it), then the state is held.  Returns (state, last, metrics)."""
    dev = tree_leaves(state)[0].device
    last = torch.tensor(-math.inf, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    elbo, delta, act = [], [], []
    for _ in range(sweeps):
        new, e = step(state)
        conv = (e - last).abs() < tol * (e.abs() + 1.0)
        active = ~done
        state = tree_map(lambda a, b: torch.where(active, a, b), new, state)
        elbo.append(torch.where(active, e, last))
        delta.append(torch.where(active, (e - last).abs(), 0.0))
        act.append(active)
        last = torch.where(active & ~conv, e, last)
        done = done | conv
    return state, last, TemporalFitMetrics(
        torch.stack(elbo), torch.stack(delta), torch.stack(act))


def _host_loop(step: Step, state, sweeps: int, tol: float):
    """The eager loop: one host read of the ELBO a sweep, break at
    convergence (the reference's ``fused=False``)."""
    last, elbos, deltas = -math.inf, [], []
    for _ in range(sweeps):
        state, e = step(state)
        e = float(e)
        elbos.append(e)
        deltas.append(abs(e - last))
        if abs(e - last) < tol * (abs(e) + 1.0):
            break
        last = e
    return state, last, TemporalFitMetrics(
        np.asarray(elbos), np.asarray(deltas), np.ones(len(elbos), bool))


def _sweep_loop(step: Step, state, sweeps: int, tol: float, fused: bool):
    state, last, metrics = (_hold_loop if fused else _host_loop)(
        step, state, sweeps, tol)
    return state, float(last), metrics


def _emit_fit_event(name: str, elbo, metrics: TemporalFitMetrics) -> None:
    """One ``temporal_fit`` event for a finished fit (obs on only: the
    metric columns are read back here, after the fit)."""
    if not obs_sink.enabled():
        return
    host = lambda a: np.asarray(a.cpu() if isinstance(a, Tensor) else a)
    act, dl = host(metrics.active), host(metrics.delta)
    k = int(act.sum())
    obs_sink.emit("temporal_fit", model=name, sweeps=k, elbo=float(elbo),
                  delta=float(dl[max(k - 1, 0)]) if dl.size else 0.0)


def _as_seq(data, device: torch.device) -> Tuple[Tensor, Tensor]:
    """(xc [B, T, F], mask [B, T]) float32 on ``device`` from a
    ``DynamicDataStream``, a ``SequenceBatch`` (or anything with ``collect``
    or with ``xc`` and ``mask`` fields) or an [B, T, F] array."""
    if hasattr(data, "collect"):
        data = data.collect()
    if hasattr(data, "xc") and hasattr(data, "mask"):
        xc, mask = data.xc, data.mask
    else:
        xc, mask = data, None
    to = lambda a: (a if isinstance(a, torch.Tensor)
                    else torch.from_numpy(_writable(a))).to(
                        device=device, dtype=torch.float32)
    xc = to(xc)
    mask = (torch.ones(xc.shape[:2], device=device) if mask is None
            else to(mask))
    return xc, mask


def _writable(a) -> np.ndarray:
    a = np.asarray(a)
    return a if a.flags.writeable else a.copy()


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _backend_of(model, backend: Optional[str]) -> str:
    """The suff-stats backend of a fit: the model's unless named."""
    return (model.backend if backend is None
            else devmod.check_backend(backend, model.device))


def _solve(A: Tensor, B: Tensor) -> Tensor:
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def _inv(A: Tensor) -> Tensor:
    return torch.linalg.inv_ex(A, check_errors=False)[0]


# ---------------------------------------------------------------------------
# masked forward-backward (shared by the HMM family and the fHMM)
# ---------------------------------------------------------------------------


def forward_backward(log_init: Tensor, log_trans: Tensor, loglik: Tensor,
                     mask: Tensor):
    """Batched over leading axes: loglik [..., T, S], mask [..., T];
    log_init [S] and log_trans [S, S] (or leading axes that broadcast
    against loglik's, e.g. [C, 1, S] for C chains of B sequences).

    Returns (gamma [..., T, S], xi_sum [..., S, S], loglik [...]).

    Padding semantics: masked steps HOLD the forward/backward state, their
    loglik values are never read (``where``-gated, so NaN/garbage padding
    is safe), and no transition is counted into or out of a padded step
    (``xi`` is masked by ``mask[t] * mask[t+1]``).  A LEFT-padded sequence
    seeds the recursion from ``log_init`` alone at its first observed step
    -- the ``started`` flag below, one a sequence -- rather than applying a
    spurious transition out of the padding.  A fully masked sequence has
    loglik 0."""
    S = loglik.shape[-1]
    T = loglik.shape[-2]
    lead = loglik.shape[:-2]
    obs = mask > 0                                       # [..., T]
    ll = torch.where(obs[..., None], loglik, 0.0)        # NaN-safe padding
    log_init = log_init.expand(lead + (S,))
    loga = log_init
    started = torch.zeros(lead, dtype=torch.bool, device=loglik.device)
    logas = []
    for t in range(T):
        m_t = obs[..., t, None]
        trans_in = torch.logsumexp(loga[..., :, None] + log_trans, dim=-2)
        # the first observed step seeds from the initial distribution alone
        new = (torch.where(started[..., None], trans_in, log_init)
               + ll[..., t, :])
        loga = torch.where(m_t, new, loga)               # hold over padding
        started = started | m_t[..., 0]
        logas.append(loga)
    logas = torch.stack(logas, -2)                       # [..., T, S]
    logZ = torch.where(obs.any(-1), torch.logsumexp(logas[..., -1, :], -1),
                       0.0)

    logb = torch.zeros_like(log_init)
    logbs = [logb]
    for t in range(T - 1, 0, -1):
        new = torch.logsumexp(
            log_trans + (ll[..., t, :] + logb)[..., None, :], dim=-1)
        logb = torch.where(obs[..., t, None], new, logb)
        logbs.append(logb)
    logbs = torch.stack(logbs[::-1], -2)                 # [..., T, S]

    gamma = torch.softmax(logas + logbs, -1) * mask[..., None]
    # xi_t(i,j) ∝ a_t(i) T(i,j) l_{t+1}(j) b_{t+1}(j)
    logxi = (logas[..., :-1, :, None] + log_trans[..., None, :, :]
             + (ll[..., 1:, :] + logbs[..., 1:, :])[..., None, :])
    logxi = logxi - torch.logsumexp(logxi, dim=(-2, -1), keepdim=True)
    xi = torch.exp(logxi) * (mask[..., 1:] * mask[..., :-1])[..., None, None]
    return gamma, xi.sum(-3), logZ


# ---------------------------------------------------------------------------
# HMM with (optionally regression-) Gaussian emissions
# ---------------------------------------------------------------------------


class HMMPosterior(NamedTuple):
    init: ef.Dirichlet        # [S]
    trans: ef.Dirichlet       # [S, S] rows
    emis: ef.MVNormalGamma    # [F, S, D] regression emission per feature/state


# -- class-agnostic step functions: every _HMMBase subclass reduces to a
#    (design d [B,T,F,D], target y [B,T,F]) pair ------------------------------


def _hmm_loglik(post: HMMPosterior, d: Tensor, y: Tensor) -> Tensor:
    """[B, T, S] expected emission log-lik summed over features."""
    mom = ef.mvnormalgamma_moments(post.emis)     # [F, S, ...]
    quad = torch.einsum("btfa,fsac,btfc->btfs", d, mom.e_lamww, d)
    lin = torch.einsum("btfa,fsa->btfs", d, mom.e_lamw)
    ll = 0.5 * (mom.e_loglam - ef.LOG2PI - mom.e_lam * (y * y)[..., None]
                + 2.0 * y[..., None] * lin - quad)
    return ll.sum(2)


def _hmm_estep(post: HMMPosterior, d: Tensor, y: Tensor, mask: Tensor):
    """Returns (gamma [B,T,S], xi [B,S,S], logZ [B])."""
    log_init = ef.dirichlet_expected_logprob(post.init)
    log_trans = ef.dirichlet_expected_logprob(post.trans)
    return forward_backward(log_init, log_trans, _hmm_loglik(post, d, y),
                            mask)


def _hmm_mstep(prior: HMMPosterior, gamma: Tensor, xi: Tensor, d: Tensor,
               y: Tensor, mask: Tensor, backend: str = "einsum"
               ) -> HMMPosterior:
    init = ef.Dirichlet(prior.init.alpha + gamma[:, 0].sum(0))
    trans = ef.Dirichlet(prior.trans.alpha + xi.sum(0))
    w = gamma * mask[..., None]                   # [B, T, S]
    if backend == "cuda":
        sxx, sxy, syy = clg_stats.clg_seq_suffstats(d, y, w)
    else:
        sxx = torch.einsum("btfa,btfc,bts->fsac", d, d, w)
        sxy = torch.einsum("btfa,btf,bts->fsa", d, y, w)
        syy = torch.einsum("btf,btf,bts->fs", y, y, w)
    n = w.sum((0, 1))[None].expand(syy.shape)
    emis = ef.mvnormalgamma_update(
        prior.emis, ef.RegSuffStats(sxx, sxy, syy, n))
    return HMMPosterior(init=init, trans=trans, emis=emis)


def _hmm_fit(prior: HMMPosterior, post: HMMPosterior, d: Tensor, y: Tensor,
             mask: Tensor, *, sweeps: int, tol: float, backend: str,
             fused: bool = True):
    """One VB-EM fit for the whole HMM family.  Returns (post, last elbo,
    TemporalFitMetrics)."""
    return _sweep_loop(
        lambda p: _hmm_step(prior, p, d, y, mask, backend), post, sweeps,
        tol, fused)


def _hmm_step(prior, post, d, y, mask, backend):
    """One sweep: E-step under ``post``, M-step against ``prior``; returns
    (new posterior, ELBO)."""
    gamma, xi, logZ = _hmm_estep(post, d, y, mask)
    return _hmm_mstep(prior, gamma, xi, d, y, mask, backend), logZ.sum()


def _hmm_filter_predict(post: HMMPosterior, d: Tensor, y: Tensor,
                        mask: Tensor, horizon: int):
    """Filtered beliefs + h-step predictive for a sequence batch.

    Returns (beliefs [B,T,S], last [B,S]) where ``last`` is the filtered
    distribution at the final step rolled ``horizon`` steps forward with no
    evidence (paper Code Fragment 14).  A pure function of the posterior."""
    ll = _hmm_loglik(post, d, y)
    init = torch.softmax(ef.dirichlet_expected_logprob(post.init), -1)
    trans = torch.softmax(ef.dirichlet_expected_logprob(post.trans), -1)
    model = Factorial2TBN(init=init[None], trans=trans[None])
    beliefs = factored_frontier_filter(model, ll[:, :, None, :],
                                       mask)[0][:, :, 0]
    last = beliefs[:, -1]
    if horizon > 0:
        last = predictive_posterior(model, last[:, None], horizon)[:, 0]
    return beliefs, last


def _temporal_serve(post: HMMPosterior, d: Tensor, y: Tensor, mask: Tensor,
                    *, horizon: int):
    """The temporal query program of ``PGMQueryEngine(mode="temporal")``:
    the posterior is an argument, so a swapped or refitted model is never
    served stale."""
    return _hmm_filter_predict(post, d, y, mask, horizon)


class _HMMBase:
    """Shared machinery; subclasses define the emission design vector.

    Lives on one device (``None``: the first card; ``"cpu"`` for the plain
    path); ``backend=None`` is the device's suff-stats backend."""

    design_dim = 1  # bias only (plain Gaussian emission)

    def __init__(self, attributes, n_states: int = 2, *, seed: int = 0,
                 alpha0: float = 1.0, a0: float = 1.0, b0: float = 1.0,
                 backend: Optional[str] = None,
                 device: devmod.DeviceLike = None) -> None:
        self.attributes = list(attributes)
        self.device = dev = devmod.resolve_device(device)
        self.backend = devmod.check_backend(
            backend or devmod.default_backend(dev), dev)
        self.F = self._n_emissions()
        self.S = S = n_states
        F, D = self.F, self.design_dim
        full = lambda shape, v: torch.full(shape, float(v), device=dev)
        self.prior = HMMPosterior(
            init=ef.Dirichlet(full((S,), alpha0)),
            trans=ef.Dirichlet(full((S, S), alpha0)),
            emis=ef.MVNormalGamma(
                m=torch.zeros(F, S, D, device=dev),
                K=torch.eye(D, device=dev).expand(F, S, D, D).clone(),
                a=full((F, S), a0), b=full((F, S), b0)))
        # drawn on the CPU, so every device starts from the same means
        g = torch.Generator().manual_seed(seed)
        m0 = self.prior.emis.m + torch.randn(F, S, D, generator=g).to(dev)
        self.posterior = self.prior._replace(
            emis=self.prior.emis._replace(m=m0))
        self._chained_prior = self.prior
        self._warm = False

    def _n_emissions(self) -> int:
        return len([a for a in self.attributes if a.kind == REAL])

    # -- emission design: [B, T, F, D] / target: [B, T, F] -------------------

    def _design(self, xc: Tensor) -> Tensor:
        B, T, F = xc.shape
        return torch.ones(B, T, F, 1, dtype=xc.dtype, device=xc.device)

    def _emission_target(self, xc: Tensor) -> Tensor:
        return xc

    def _estep(self, post: HMMPosterior, xc: Tensor, mask: Tensor):
        return _hmm_estep(post, self._design(xc), self._emission_target(xc),
                          mask)

    def _warm_start(self, xc: Tensor) -> None:
        """Data-driven symmetry breaking: bias term <- random observed
        frames (first fit only; numpy's ``default_rng(13)`` picks them, as
        in the reference)."""
        if self._warm:
            return
        self._warm = True
        rng = np.random.default_rng(13)
        frames_all = xc[..., : self.F]   # emission columns (IOHMM: no input)
        B, T, F = frames_all.shape
        picks = torch.as_tensor(rng.integers(0, B * T, self.S),
                                device=xc.device)
        frames = frames_all.reshape(B * T, F)[picks]              # [S, F]
        m0 = self.posterior.emis.m.clone()
        m0[:, :, 0] = frames.T
        self.posterior = self.posterior._replace(
            emis=self.posterior.emis._replace(m=m0))

    # -- public API -----------------------------------------------------------

    def update_model(self, data, *, sweeps: int = 30, tol: float = 1e-5,
                     fused: bool = True, backend: Optional[str] = None
                     ) -> float:
        """Fit/refine on ``data`` (Eq. 3 across calls); returns the last
        ELBO.  ``self.fit_metrics`` holds the per-sweep columns."""
        xc, mask = _as_seq(data, self.device)
        self._warm_start(xc)
        post, last, metrics = _hmm_fit(
            self._chained_prior, self.posterior, self._design(xc),
            self._emission_target(xc), mask, sweeps=sweeps, tol=tol,
            backend=_backend_of(self, backend), fused=fused)
        self.posterior = post
        self._chained_prior = post     # Eq. 3
        self.fit_metrics = metrics
        _emit_fit_event(type(self).__name__, last, metrics)
        return last

    def filtered_posterior(self, xc, mask=None) -> Tensor:
        """[B, T, S] filtering distributions (Code Fragment 14 analog)."""
        xc, mask = _as_seq(xc if mask is None else SequenceBatch(xc, None,
                                                                 mask),
                           self.device)
        beliefs, _ = _hmm_filter_predict(
            self.posterior, self._design(xc), self._emission_target(xc),
            mask, 0)
        return beliefs

    def predictive(self, xc, horizon: int, mask=None) -> Tensor:
        """[B, S] state distribution ``horizon`` steps past the end of each
        sequence (getPredictivePosterior)."""
        xc, mask = _as_seq(xc if mask is None else SequenceBatch(xc, None,
                                                                 mask),
                           self.device)
        _, last = _hmm_filter_predict(
            self.posterior, self._design(xc), self._emission_target(xc),
            mask, horizon)
        return last

    def viterbi_states(self, xc) -> Tensor:
        xc, mask = _as_seq(xc, self.device)
        g, _, _ = self._estep(self.posterior, xc, mask)
        return g.argmax(-1)

    def state_means(self) -> np.ndarray:
        """[S, F] emission means (bias term of the regression)."""
        return self.posterior.emis.m[:, :, 0].T.cpu().numpy()


class HiddenMarkovModel(_HMMBase):
    """Plain Gaussian-emission HMM."""


class AutoRegressiveHMM(_HMMBase):
    """Emission mean = w_s^T [1, x_{t-1,f}] (per feature) -- AR(1) per
    state."""

    design_dim = 2

    def _design(self, xc):
        B, T, F = xc.shape
        prev = torch.cat([xc.new_zeros(B, 1, F), xc[:, :-1]], 1)
        return torch.stack([torch.ones_like(prev), prev], -1)   # [B,T,F,2]


class InputOutputHMM(_HMMBase):
    """Emission mean = w_s^T [1, u_t] with exogenous input u (the last REAL
    column)."""

    design_dim = 2

    def _n_emissions(self) -> int:
        return super()._n_emissions() - 1   # the input is not an emission

    def _split(self, xc):
        return xc[..., :-1], xc[..., -1]

    def _emission_target(self, xc):
        # contiguous: the cuda suff-stats route reads it in place
        return self._split(xc)[0].contiguous()

    def _design(self, xc):
        y, u = self._split(xc)
        B, T, F = y.shape
        ones = xc.new_ones(B, T, F, 1)
        return torch.cat([ones, u[..., None, None].expand(B, T, F, 1)], -1)


class DynamicNaiveBayes(_HMMBase):
    """Dynamic NB = HMM whose hidden class smooths over time; emissions are
    NB-style independent Gaussians -- structurally the plain HMM (the
    paper's dynamic NB is exactly this 2TBN)."""


# ---------------------------------------------------------------------------
# sequence-batch streaming (Eq. 3 over sequence-batch streams)
# ---------------------------------------------------------------------------


def _temper_hmm(params: HMMPosterior, base: HMMPosterior,
                rho: float) -> HMMPosterior:
    """Forgetting for the HMM posterior: geometric interpolation toward the
    base prior -- Dirichlet alphas and the MVNormalGamma (K, K m, a, b)
    blocks are lerped, then the mean is recovered from the mixed precision
    (the temporal analog of ``streaming._temper``)."""
    lerp = lambda a, b: rho * a + (1.0 - rho) * b
    K = lerp(params.emis.K, base.emis.K)
    Km = lerp(torch.einsum("...ac,...c->...a", params.emis.K, params.emis.m),
              torch.einsum("...ac,...c->...a", base.emis.K, base.emis.m))
    m = _solve(K, Km[..., None])[..., 0]
    emis = ef.MVNormalGamma(m=m, K=K, a=lerp(params.emis.a, base.emis.a),
                            b=lerp(params.emis.b, base.emis.b))
    return HMMPosterior(
        init=ef.Dirichlet(lerp(params.init.alpha, base.init.alpha)),
        trans=ef.Dirichlet(lerp(params.trans.alpha, base.trans.alpha)),
        emis=emis)


def seq_stream_fit(model: _HMMBase, batches, *, sweeps: int = 10,
                   tol: float = 1e-5, drift_threshold: float = 5.0,
                   forget: float = 0.3, backend: Optional[str] = None
                   ) -> Dict[str, Tensor]:
    """Replay a stream of sequence batches (the temporal ``stream_fit``).

    Per batch: score the incoming sequences under the current posterior
    (per-frame loglik), run the Page-Hinkley drift gate (tempering the
    chained prior on a firing), fit with the held sweep loop, and chain the
    posterior (Eq. 3).  A batch whose score, ELBO or posterior is not
    finite is quarantined: posterior, chained prior and Page-Hinkley state
    are held, as if the batch was never seen.  ``model`` is any
    ``_HMMBase`` subclass; it is updated in place, and the per-batch
    columns (``elbo, score, ph, drifted, n_eff, rho, sweeps,
    quarantined``) are returned as a dict of [n_batches] tensors.

    ``batches``: equal-shape ``SequenceBatch``es or ``DynamicDataStream``s
    (e.g. ``DynamicDataStream.batches(B)``, which pads the tail batch)."""
    batches = list(batches)
    if not batches:
        raise ValueError("seq_stream_fit needs at least one batch")
    backend = _backend_of(model, backend)
    dev = model.device
    model._warm_start(_as_seq(batches[0], dev)[0])
    base = model.prior
    prior0, post0, dstate0 = model._chained_prior, model.posterior, \
        drift_init(dev)
    n_drifts = torch.zeros((), dtype=torch.int64, device=dev)
    n_quar = torch.zeros((), dtype=torch.int64, device=dev)
    zero = torch.zeros((), device=dev)
    cols = {k: [] for k in INFO_KEYS}
    for batch in batches:
        xc, mask = _as_seq(batch, dev)
        d, y = model._design(xc), model._emission_target(xc)
        n_eff = mask.sum()
        _, _, logZ = _hmm_estep(post0, d, y, mask)
        score = logZ.sum() / torch.clamp(n_eff, min=1.0)
        prior, dstate, ph, drifted = drift_gate(
            dstate0, score, prior0, _temper_hmm(prior0, base, forget),
            drift_threshold=drift_threshold)
        post, last, fm = _hold_loop(
            lambda p: _hmm_step(prior, p, d, y, mask, backend), post0,
            sweeps, tol)
        healthy = torch.isfinite(score) & torch.isfinite(last) \
            & tree_finite(post)
        drifted = drifted & healthy
        sel = lambda new, old: tree_map(
            lambda a, b: torch.where(healthy, a, b), new, old)
        info = dict(
            elbo=torch.where(healthy, last, zero),
            score=torch.where(healthy, score, zero),
            ph=torch.where(healthy, ph, zero),
            drifted=drifted, n_eff=n_eff,
            rho=torch.where(drifted, torch.full_like(zero, forget),
                            torch.ones_like(zero)),
            sweeps=fm.active.sum(), quarantined=~healthy)
        for k in INFO_KEYS:
            cols[k].append(info[k])
        prior0 = sel(post, prior0)      # Eq. 3: posterior becomes the prior
        post0 = sel(post, post0)
        dstate0 = sel(dstate, dstate0)
        n_drifts = n_drifts + drifted.long()
        n_quar = n_quar + (~healthy).long()
    model.posterior = post0
    model._chained_prior = post0
    model.n_drifts = int(n_drifts)
    model.n_quarantined = int(n_quar)
    info = {k: torch.stack(v) for k, v in cols.items()}
    if obs_sink.enabled():
        obs_sink.emit_stream_events(info)
        obs_sink.emit_kernel_counts(site="seq_stream_fit")
    return info


# ---------------------------------------------------------------------------
# factorial HMM -- chain-parallel structured VB
# ---------------------------------------------------------------------------


def _fhmm_sweep(means: Tensor, log_trans: Tensor, log_init: Tensor,
                noise: Tensor, gammas: Tensor, xc: Tensor, mask: Tensor,
                backend: str):
    """One Jacobi sweep over ALL chains at once.

    Every chain's residual is computed from the PREVIOUS sweep's gammas and
    means, the per-chain forward-backward runs batched over (chains,
    sequences), and the M-step is one responsibility-weighted regression a
    chain (einsum, or one ``clg_seq_suffstats`` launch a chain).  The
    residual and weights are built chain-major, [C, B, T, ...], so each
    chain's slice is contiguous for the kernel.  gammas [B, T, C, S] in
    and out, as the reference keeps them."""
    B, T, F = xc.shape
    C, S = means.shape[0], means.shape[1]
    contrib = torch.einsum("btcs,csf->cbtf", gammas, means)
    resid = (xc[None] - (contrib.sum(0, keepdim=True) - contrib)).contiguous()
    diff = resid[:, :, :, None, :] - means[:, None, None]    # [C,B,T,S,F]
    ll = (-(0.5 / noise) * (diff ** 2).sum(-1)
          - 0.5 * F * torch.log(2 * math.pi * noise))       # [C,B,T,S]
    g, xi, logZ = forward_backward(log_init[:, None], log_trans[:, None], ll,
                                   mask.expand(C, B, T))
    w = (g * mask[..., None]).contiguous()                   # [C,B,T,S]
    if backend == "cuda":
        ones = xc.new_ones(B, T, F, 1)
        num = torch.stack([
            clg_stats.clg_seq_suffstats(ones, resid[c], w[c])[1][..., 0].T
            for c in range(C)])                              # [C,S,F]
    else:
        num = torch.einsum("cbts,cbtf->csf", w, resid)
    denom = torch.clamp(w.sum((1, 2)), min=1e-6)[..., None]  # [C,S,1]
    means_new = num / denom
    xs_sum = xi.sum(1)                                       # [C,S,S]
    log_trans_new = (
        torch.log(torch.clamp(xs_sum + 1.0, min=1e-6))
        - torch.log(torch.clamp(xs_sum.sum(-1, keepdim=True) + S, min=1e-6)))
    return means_new, log_trans_new, g.permute(1, 2, 0, 3), logZ.sum()


def _fhmm_fit(params, log_init: Tensor, noise: Tensor, xc: Tensor,
              mask: Tensor, *, sweeps: int, tol: float, backend: str,
              fused: bool = True):
    """params (means, log_trans, gammas) -> (means, log_trans, gammas,
    last elbo, TemporalFitMetrics)."""

    def step(state):
        *new, e = _fhmm_sweep(*state[:2], log_init, noise, state[2], xc,
                              mask, backend)
        return tuple(new), e

    (means, log_trans, gammas), last, metrics = _sweep_loop(
        step, tuple(params), sweeps, tol, fused)
    return means, log_trans, gammas, last, metrics


class FactorialHMMModel:
    """Factorial HMM: C independent chains, joint Gaussian emission.

    Learnt with the factored-frontier mean field: each chain's E-step sees
    the residual of the other chains' expected contributions (standard VB
    for fHMM, Ghahramani & Jordan 1997).  Chain updates are JACOBI (all
    chains from the previous sweep's state), which lets every chain run
    through one batched forward-backward."""

    def __init__(self, attributes, n_chains: int = 2, n_states: int = 2,
                 *, seed: int = 0, backend: Optional[str] = None,
                 device: devmod.DeviceLike = None) -> None:
        self.F = len([a for a in attributes if a.kind == REAL])
        self.C, self.S = n_chains, n_states
        self.device = dev = devmod.resolve_device(device)
        self.backend = devmod.check_backend(
            backend or devmod.default_backend(dev), dev)
        g = torch.Generator().manual_seed(seed)
        self.means = torch.randn(self.C, self.S, self.F, generator=g).to(dev)
        self.log_trans = torch.log(
            torch.full((self.C, self.S, self.S), 1.0 / n_states, device=dev))
        self.log_init = torch.log(
            torch.full((self.C, self.S), 1.0 / n_states, device=dev))
        self.noise = torch.tensor(1.0, device=dev)

    def update_model(self, data, *, sweeps: int = 15, tol: float = 0.0,
                     fused: bool = True, backend: Optional[str] = None
                     ) -> float:
        xc, mask = _as_seq(data, self.device)          # [B,T,F], [B,T]
        B, T, _ = xc.shape
        backend = _backend_of(self, backend)
        gammas = torch.full((B, T, self.C, self.S), 1.0 / self.S,
                            device=self.device)
        (self.means, self.log_trans, self.gammas, last,
         self.fit_metrics) = _fhmm_fit(
            (self.means, self.log_trans, gammas), self.log_init, self.noise,
            xc, mask, sweeps=sweeps, tol=tol, backend=backend, fused=fused)
        _emit_fit_event(type(self).__name__, last, self.fit_metrics)
        return last


# ---------------------------------------------------------------------------
# Kalman filter (LDS) and switching LDS
# ---------------------------------------------------------------------------


def _kalman_smooth(A: Tensor, C: Tensor, q: Tensor, r: Tensor, xs: Tensor,
                   mask: Tensor):
    """Masked Kalman smoother, batched over sequences.

    xs [B, T, F], mask [B, T] -> (means [B, T, L], covs [B, T, L, L], pair
    moments [B, T-1, L, L], loglik [B]).  Masked steps run the time update
    only (predict, no correction, no loglik contribution); their
    observation values are never read.  The reference's arithmetic: an
    explicit inverse of the innovation covariance."""
    B, T, F = xs.shape
    L = A.shape[0]
    I_L = torch.eye(L, dtype=xs.dtype, device=xs.device)
    Q = q * I_L
    R = r * torch.eye(F, dtype=xs.dtype, device=xs.device)
    At, Ct = A.T, C.T
    obs = mask > 0
    m = xs.new_zeros(B, L)
    P = I_L.expand(B, L, L)
    fm, fP, pm, pP, Ss, Sinvs, innovs = [], [], [], [], [], [], []
    for t in range(T):
        o = obs[:, t]
        mp = m @ At                                  # A m
        Pp = A @ P @ At + Q
        S = C @ Pp @ Ct + R
        Sinv = _inv(S)
        Kg = Pp @ Ct @ Sinv
        innov = torch.where(o[:, None], xs[:, t], 0.0) - mp @ Ct
        m = torch.where(o[:, None], mp + (Kg @ innov[..., None])[..., 0], mp)
        P = torch.where(o[:, None, None], (I_L - Kg @ C) @ Pp, Pp)
        fm.append(m)
        fP.append(P)
        pm.append(mp)
        pP.append(Pp)
        Ss.append(S)
        Sinvs.append(Sinv)
        innovs.append(innov)
    # the loglik terms, batched over T after the recursion
    logdet = torch.linalg.slogdet(torch.stack(Ss, 1))[1]          # [B, T]
    innov = torch.stack(innovs, 1)
    quad = torch.einsum("btf,btfg,btg->bt", innov, torch.stack(Sinvs, 1),
                        innov)
    ll = -torch.where(obs, 0.5 * (logdet + quad + F * ef.LOG2PI), 0.0).sum(1)

    fm, fP = torch.stack(fm, 1), torch.stack(fP, 1)
    pm, pP = torch.stack(pm, 1), torch.stack(pP, 1)
    # RTS gains for every step at once (they depend on the filter only)
    J = fP[:, :-1] @ At @ _inv(pP[:, 1:])              # [B, T-1, L, L]
    ms, Ps = fm[:, -1], fP[:, -1]
    sm, sP, pair = [ms], [Ps], []
    for t in range(T - 2, -1, -1):
        Jt = J[:, t]
        pair.append(Jt @ Ps)                         # Cov(h_t, h_{t+1})
        ms = fm[:, t] + (Jt @ (ms - pm[:, t + 1])[..., None])[..., 0]
        Ps = fP[:, t] + Jt @ (Ps - pP[:, t + 1]) @ Jt.mT
        sm.append(ms)
        sP.append(Ps)
    pair = (torch.stack(pair[::-1], 1) if pair
            else xs.new_zeros(B, 0, L, L))
    return torch.stack(sm[::-1], 1), torch.stack(sP[::-1], 1), pair, ll


def _sum_bt(w: Tensor, x: Tensor) -> Tensor:
    """sum_{b,t} w[b,t] x[b,t,...]"""
    return torch.einsum("bt,bt...->...", w, x)


def _kf_mstep(sm: Tensor, sP: Tensor, pair: Tensor, xs: Tensor,
              mask: Tensor):
    """Masked LDS M-step (regressions + noise)."""
    B, T, L = sm.shape
    F = xs.shape[-1]
    I_L = torch.eye(L, dtype=sm.dtype, device=sm.device)
    w = mask
    wl = mask[:, 1:] * mask[:, :-1]
    Ehh = sP + sm[..., :, None] * sm[..., None, :]            # [B,T,L,L]
    Ehh_lag = pair + sm[:, :-1, :, None] * sm[:, 1:, None, :]
    # transition regression: h_t on h_{t-1}
    A = _solve(_sum_bt(wl, Ehh[:, :-1]) + I_L, _sum_bt(wl, Ehh_lag)).T
    # emission regression: x_t on h_t
    Hxy = torch.einsum("bt,btl,btf->lf", w, sm, xs)
    C = _solve(_sum_bt(w, Ehh) + I_L, Hxy).T
    # noise variances
    n = torch.clamp(w.sum(), min=1.0)
    nl = torch.clamp(wl.sum(), min=1.0)
    resid = xs - torch.einsum("fl,btl->btf", C, sm)
    r = torch.clamp(
        _sum_bt(w, resid ** 2).sum() / (n * F)
        + torch.einsum("fl,lm,fm->", C, _sum_bt(w, sP), C) / (n * F),
        min=1e-4)
    dyn = sm[:, 1:] - torch.einsum("lm,btm->btl", A, sm[:, :-1])
    q = torch.clamp(_sum_bt(wl, dyn ** 2).sum() / (nl * L), min=1e-4)
    return A, C, q, r


def _kf_fit(params, xs: Tensor, mask: Tensor, *, sweeps: int, tol: float,
            fused: bool = True):
    """params (A, C, q, r) -> (A, C, q, r, smoothed means, last elbo,
    TemporalFitMetrics)."""

    def step(state):
        sm, sP, pair, lls = _kalman_smooth(*state[:4], xs, mask)
        return _kf_mstep(sm, sP, pair, xs, mask) + (sm,), lls.sum()

    B, T, _ = xs.shape
    sm0 = xs.new_zeros(B, T, params[0].shape[0])
    (A, C, q, r, sm), last, metrics = _sweep_loop(
        step, tuple(params) + (sm0,), sweeps, tol, fused)
    return A, C, q, r, sm, last, metrics


class KalmanFilter:
    """Linear dynamical system learnt by EM (Code Fragment 10).

    h_t = A h_{t-1} + w,  x_t = C h_t + v; q(h_{1:T}) from Kalman smoothing
    at the current (A, C, q, r)."""

    def __init__(self, attributes, n_hidden: int = 2, *, seed: int = 0,
                 device: devmod.DeviceLike = None) -> None:
        self.F = len([a for a in attributes if a.kind == REAL])
        self.L = L = n_hidden
        self.device = dev = devmod.resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.A = (0.5 * torch.eye(L)
                  + 0.01 * torch.randn(L, L, generator=g)).to(dev)
        self.C = torch.randn(self.F, L, generator=g).to(dev)
        self.q = torch.tensor(0.3, device=dev)   # process noise var
        self.r = torch.tensor(0.3, device=dev)   # obs noise var
        self._warm = False

    def set_num_hidden(self, n: int) -> "KalmanFilter":
        self.__init__([Attribute(f"G{i}", REAL) for i in range(self.F)], n,
                      device=self.device)
        return self

    def _warm_start(self, xs: np.ndarray) -> None:
        """PCA warm start on the host (numpy, as the reference): C <- the
        top-L principal axes, A <- the lag-1 regression of their scores."""
        if self._warm:
            return
        self._warm = True
        B, T, F = xs.shape
        L = self.L
        flat = xs.reshape(B * T, F)
        flat = flat - flat.mean(0)
        _, _, vt = np.linalg.svd(flat, full_matrices=False)
        C0 = vt[:L].T                            # [F, L]
        sc = (flat @ C0).reshape(B, T, L)
        xlag = sc[:, :-1].reshape(-1, L)
        xnext = sc[:, 1:].reshape(-1, L)
        A0 = np.linalg.lstsq(xlag, xnext, rcond=None)[0].T
        self.C = torch.as_tensor(C0, dtype=torch.float32).to(self.device)
        self.A = torch.as_tensor(A0, dtype=torch.float32).to(self.device)

    def update_model(self, data, *, sweeps: int = 25, tol: float = 0.0,
                     fused: bool = True) -> float:
        if hasattr(data, "collect"):
            data = data.collect()
        xs, mask = _as_seq(data, self.device)
        self._warm_start(_host(getattr(data, "xc", data)))
        (self.A, self.C, self.q, self.r, self.smoothed, last,
         self.fit_metrics) = _kf_fit(
            (self.A, self.C, self.q, self.r), xs, mask, sweeps=sweeps,
            tol=tol, fused=fused)
        _emit_fit_event(type(self).__name__, last, self.fit_metrics)
        return last

    def get_model(self):
        return {"A": self.A, "C": self.C, "q": self.q, "r": self.r}

    def filtered_states(self, xs) -> Tensor:
        """[B, T, L] smoothed state means of fully observed sequences."""
        xs, mask = _as_seq(xs, self.device)
        return _kalman_smooth(self.A, self.C, self.q, self.r, xs, mask)[0]


def _slds_sweep(A: Tensor, C: Tensor, q: Tensor, r: Tensor,
                log_trans: Tensor, resp: Tensor, xs: Tensor, mask: Tensor):
    """One structured-VB sweep: q(h) under switch-averaged dynamics, q(s)
    from innovation logliks via the masked factored-frontier filter, then
    a STATE-BATCHED M-step (one [S]-batched linear solve)."""
    B, T, F = xs.shape
    S, L = A.shape[0], A.shape[1]
    I_L = torch.eye(L, dtype=xs.dtype, device=xs.device)
    w_all = resp * mask[..., None]
    Abar = torch.einsum("bts,slm->lm", w_all, A) / torch.clamp(mask.sum(),
                                                               min=1.0)
    sm, sP, pair, lls = _kalman_smooth(Abar, C, q, r, xs, mask)
    e = lls.sum()
    # q(s): innovation loglik per switch state
    pred = torch.einsum("slm,btm->btsl", A, sm[:, :-1])
    innov = sm[:, 1:, None, :] - pred                 # [B,T-1,S,L]
    loglik = -0.5 * (innov ** 2).sum(-1) / q
    loglik = torch.cat([xs.new_zeros(B, 1, S), loglik], 1)
    model = Factorial2TBN(init=torch.full((1, S), 1.0 / S, device=xs.device),
                          trans=torch.exp(log_trans)[None])
    resp2 = factored_frontier_filter(model, loglik[:, :, None, :],
                                     mask)[0][:, :, 0]
    # M-step: per-switch-state transition regression, batched over S
    Ehh = sP + sm[..., :, None] * sm[..., None, :]
    Ehh_lag = pair + sm[:, :-1, :, None] * sm[:, 1:, None, :]
    wl = mask[:, 1:] * mask[:, :-1]
    ws = resp2[:, 1:] * wl[..., None]                 # [B,T-1,S]
    Sxx = torch.einsum("bts,btlm->slm", ws, Ehh[:, :-1]) + I_L
    Sxy = torch.einsum("bts,btlm->slm", ws, Ehh_lag)
    A2 = _solve(Sxx, Sxy).transpose(-1, -2)
    # shared emission + noises (as in KalmanFilter)
    Hxy = torch.einsum("bt,btl,btf->lf", mask, sm, xs)
    C2 = _solve(_sum_bt(mask, Ehh) + I_L, Hxy).T
    n = torch.clamp(mask.sum(), min=1.0)
    nl = torch.clamp(wl.sum(), min=1.0)
    resid = xs - torch.einsum("fl,btl->btf", C2, sm)
    r2 = torch.clamp(_sum_bt(mask, resid ** 2).sum() / (n * F), min=1e-4)
    dyn = sm[:, 1:] - torch.einsum("bts,slm,btm->btl", resp2[:, 1:], A2,
                                   sm[:, :-1])
    q2 = torch.clamp(_sum_bt(wl, dyn ** 2).sum() / (nl * L), min=1e-4)
    return A2, C2, q2, r2, resp2, sm, e


def _slds_fit(params, log_trans: Tensor, xs: Tensor, mask: Tensor, *,
              sweeps: int, tol: float, fused: bool = True):
    """params (A, C, q, r, resp) -> (A, C, q, r, resp, smoothed means,
    last elbo, TemporalFitMetrics)."""

    def step(state):
        *new, e = _slds_sweep(*state[:4], log_trans, state[4], xs, mask)
        return tuple(new), e

    B, T, _ = xs.shape
    sm0 = xs.new_zeros(B, T, params[0].shape[1])
    (A, C, q, r, resp, sm), last, metrics = _sweep_loop(
        step, tuple(params) + (sm0,), sweeps, tol, fused)
    return A, C, q, r, resp, sm, last, metrics


class SwitchingLDS:
    """Switching LDS: discrete switch s_t selects the dynamics matrix A_s.

    Structured mean field: q(s) (factored frontier over the switch chain,
    using expected innovation likelihoods) x q(h) (Kalman smoothing under
    switch-averaged dynamics); M-step = responsibility-weighted
    regressions."""

    def __init__(self, attributes, n_states: int = 2, n_hidden: int = 2,
                 *, seed: int = 0, device: devmod.DeviceLike = None) -> None:
        self.F = len([a for a in attributes if a.kind == REAL])
        self.S, self.L = S, L = n_states, n_hidden
        self.device = dev = devmod.resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.A = (0.5 * torch.eye(L)[None]
                  + 0.3 * torch.randn(S, L, L, generator=g)).to(dev)
        self.C = torch.randn(self.F, L, generator=g).to(dev)
        self.q = torch.tensor(0.3, device=dev)
        self.r = torch.tensor(0.3, device=dev)
        self.log_trans = torch.log(0.9 * torch.eye(S, device=dev) + 0.1 / S)

    def update_model(self, data, *, sweeps: int = 10, tol: float = 0.0,
                     fused: bool = True) -> float:
        xs, mask = _as_seq(data, self.device)
        B, T, _ = xs.shape
        resp = torch.full((B, T, self.S), 1.0 / self.S, device=self.device)
        (self.A, self.C, self.q, self.r, self.resp, self.smoothed, last,
         self.fit_metrics) = _slds_fit(
            (self.A, self.C, self.q, self.r, resp), self.log_trans, xs, mask,
            sweeps=sweeps, tol=tol, fused=fused)
        _emit_fit_event(type(self).__name__, last, self.fit_metrics)
        return last
