"""Batch-streaming Bayesian learning — paper §2.3 (counterpart of
``repro.core.streaming``).

* Bayesian updating (Eq. 3): the posterior after batch t-1 is the prior for
  batch t.
* Streaming variational Bayes: each batch is fitted with VMP sweeps against
  the chained prior.
* Concept drift: a Page-Hinkley test on the per-instance ELBO of each new
  batch under the current posterior; on drift the prior is tempered toward
  the base prior.
* Non-finite quarantine: a batch whose score, ELBO or posterior is not
  finite is skipped, with every piece of carried state held bit-exactly.

Two drivers share one step body (:func:`_stream_step`):
:func:`stream_update` (one call per arriving batch) and :func:`stream_fit`
(a host loop over T stacked batches, moved to the device a window at a
time).  ``stream_update(mesh=)`` fits each batch with d-VMP sweeps over a
``DeviceMesh`` (``repro_torch.core.dvmp``); ``stream_fit`` has no mesh
path, as in the reference.

With ``repro_torch.obs`` on, both drivers emit the info columns as
``stream_batch`` / ``drift`` / ``quarantine`` events and a
``kernel_dispatch`` snapshot AFTER the fit (one read of the columns); the
fit itself is the same at every obs level.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core import svi
from repro_torch.core import vmp as V
from repro_torch.core.vmp import CompiledPlate, PlateParams

Tensor = torch.Tensor

INFO_KEYS = ("elbo", "score", "ph", "drifted", "n_eff", "rho", "sweeps",
             "quarantined")   # the StreamBatchMetrics columns


def tree_map(fn, *trees):
    """Map ``fn`` over the tensor leaves of equal-structure trees of
    (named) tuples and dicts; None leaves stay None."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple):
        parts = [tree_map(fn, *p) for p in zip(*trees)]
        return type(t0)(*parts) if hasattr(t0, "_fields") else tuple(parts)
    return fn(*trees)


def tree_leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in tree_leaves(part)]
    return [tree]


class DriftState(NamedTuple):
    """Page-Hinkley statistics on the per-instance held-out ELBO."""

    mean: Tensor
    cum: Tensor
    cum_min: Tensor
    t: Tensor


def drift_init(device=None) -> DriftState:
    z = torch.zeros((), device=device)
    return DriftState(mean=z, cum=z.clone(), cum_min=z.clone(),
                      t=torch.zeros((), dtype=torch.int64, device=device))


def drift_update(state: DriftState, score: Tensor, *, delta: float = 0.05
                 ) -> Tuple[DriftState, Tensor]:
    """score = mean per-instance E_q[log p(x)] of the new batch BEFORE the
    update.  Returns (new_state, Page-Hinkley statistic)."""
    t = state.t + 1
    mean = state.mean + (score - state.mean) / t
    cum = state.cum + (mean - score - delta)   # drops in score push cum up
    cum_min = torch.minimum(state.cum_min, cum)
    return DriftState(mean=mean, cum=cum, cum_min=cum_min, t=t), cum - cum_min


def drift_gate(dstate: DriftState, score: Tensor, chained, tempered, *,
               drift_threshold: float):
    """Page-Hinkley test + prior selection: where-selects the tempered prior
    when the detector fires and resets its statistics.
    Returns ``(prior, new_dstate, ph, drifted)``."""
    dstate, ph = drift_update(dstate, score)
    drifted = ph > drift_threshold
    prior = tree_map(lambda a, b: torch.where(drifted, a, b), tempered,
                     chained)
    dstate = tree_map(lambda r, k: torch.where(drifted, r, k),
                      drift_init(score.device), dstate)
    return prior, dstate, ph, drifted


class StreamState(NamedTuple):
    prior: PlateParams     # chained prior (Eq. 3 accumulation)
    post: PlateParams      # current posterior
    drift: DriftState
    n_seen: Tensor
    n_drifts: Tensor
    n_quarantined: Tensor  # batches skipped by the non-finite gate


def stream_init(prior: PlateParams, init: PlateParams) -> StreamState:
    """Fresh stream state.  The global params are copied (they are tiny), so
    the state owns its tensors and never aliases the caller's."""
    dev = prior.mix.alpha.device
    copy = lambda tree: tree_map(torch.clone, tree)
    zero_i = torch.zeros((), dtype=torch.int64, device=dev)
    return StreamState(prior=copy(prior), post=copy(init),
                       drift=drift_init(dev),
                       n_seen=torch.zeros((), device=dev),
                       n_drifts=zero_i, n_quarantined=zero_i.clone())


def tree_finite(tree) -> Tensor:
    """0-dim bool: every floating leaf of ``tree`` is finite."""
    oks = [torch.isfinite(leaf).all() for leaf in tree_leaves(tree)
           if leaf.is_floating_point()]
    return torch.stack(oks).all()


def _temper(params: PlateParams, base: PlateParams, rho: float
            ) -> PlateParams:
    """Forgetting: geometric interpolation toward the base prior in natural
    coordinates (the power prior used on drift)."""
    nat, nat0 = svi.to_natural(params), svi.to_natural(base)
    return svi.from_natural(
        tree_map(lambda a, b: rho * a + (1.0 - rho) * b, nat, nat0))


def _stream_step(cp: CompiledPlate, base_prior: PlateParams,
                 state: StreamState, xc: Tensor, xd: Tensor, mask: Tensor,
                 drift_threshold: float, forget: float,
                 backend: Optional[str], chunk: Optional[int], fit_fn
                 ) -> Tuple[StreamState, Dict[str, Tensor]]:
    """score -> (maybe) drift -> Bayesian update -> quarantine gate.

    THE step body of both drivers.  ``fit_fn(prior, post) -> (post, elbo,
    sweeps)`` runs the inner VMP fit."""
    n_eff = mask.sum()
    stats_pre, _ = V.local_step(cp, state.post, xc, xd, mask,
                                backend=backend, chunk=chunk)
    score = stats_pre.local_elbo / torch.clamp(n_eff, min=1.0)
    prior, dstate, ph, drifted = drift_gate(
        state.drift, score, state.prior,
        _temper(state.prior, base_prior, forget),
        drift_threshold=drift_threshold)

    post, e, fit_sweeps = fit_fn(prior, state.post)

    # non-finite quarantine: the update is computed unconditionally, then
    # the carried state is selected wholesale, so an unhealthy batch leaves
    # posterior, chained prior and Page-Hinkley state exactly as they were
    healthy = torch.isfinite(score) & torch.isfinite(e) & tree_finite(post)
    drifted = drifted & healthy
    sel = lambda new, old: tree_map(
        lambda a, b: torch.where(healthy, a, b), new, old)
    zero = torch.zeros((), device=n_eff.device)
    new_state = StreamState(
        prior=sel(post, state.prior),  # Eq. 3: posterior -> next prior
        post=sel(post, state.post),
        drift=sel(dstate, state.drift),
        n_seen=state.n_seen + torch.where(healthy, n_eff, zero),
        n_drifts=state.n_drifts + drifted.long(),
        n_quarantined=state.n_quarantined + (~healthy).long(),
    )
    info = dict(
        elbo=torch.where(healthy, e, zero),
        score=torch.where(healthy, score, zero),
        ph=torch.where(healthy, ph, zero),
        drifted=drifted, n_eff=n_eff,
        rho=torch.where(drifted, torch.full_like(zero, forget),
                        torch.ones_like(zero)),
        sweeps=torch.tensor(fit_sweeps, device=n_eff.device),
        quarantined=~healthy,
    )
    return new_state, info


def stream_update(cp: CompiledPlate, base_prior: PlateParams,
                  state: StreamState, xc: Tensor, xd: Tensor, *,
                  sweeps: int = 20, tol: float = 1e-4,
                  drift_threshold: float = 5.0, forget: float = 0.3,
                  mesh=None, data_axes: Sequence[str] = ("data",),
                  backend: Optional[str] = None,
                  chunk: Optional[int] = None, mask: Optional[Tensor] = None,
                  ) -> Tuple[StreamState, Dict[str, Tensor]]:
    """Process one arriving batch: score -> (maybe) drift -> Bayesian
    update against ``state.prior`` (yesterday's posterior).

    With a ``DeviceMesh`` (every rank calling with the same batch), the
    fit is ``sweeps`` calls of ``dvmp.dvmp_one_sweep`` with no tolerance
    test, and ``info["sweeps"]`` reports ``sweeps``, as the reference does;
    the score, drift test, tempering and quarantine stay on the whole
    batch."""
    if mask is None:
        mask = torch.ones(xc.shape[0], device=xc.device)

    if mesh is None:
        def fit_fn(prior, post):
            fit = V.vmp_fit(cp, prior, post, xc, xd, sweeps, tol, mask,
                            backend, chunk)
            return fit.post, fit.elbo, fit.sweep
    else:
        from repro_torch.core import dvmp

        axes = dvmp.check_mesh(mesh, data_axes)

        def fit_fn(prior, post):
            e = torch.tensor(float("-inf"), device=xc.device)
            for _ in range(sweeps):
                post, e = dvmp.dvmp_one_sweep(cp, prior, post, xc, xd, mask,
                                              mesh, axes, backend, chunk)
            return post, e, sweeps

    new_state, info = _stream_step(cp, base_prior, state, xc, xd, mask,
                                   drift_threshold, forget, backend, chunk,
                                   fit_fn)
    if obs.enabled():
        obs.emit_stream_events(info)
        obs.emit_kernel_counts(site="stream_update")
    return new_state, info


def stream_fit(cp: CompiledPlate, base_prior: PlateParams,
               state: StreamState, xcs, xds, masks=None, *,
               sweeps: int = 20, tol: float = 1e-4,
               drift_threshold: float = 5.0, forget: float = 0.3,
               backend: Optional[str] = None, chunk: Optional[int] = None,
               window: Optional[int] = None,
               ) -> Tuple[StreamState, Dict[str, Tensor]]:
    """Replay T stacked batches: xcs [T, B, F], xds [T, B, Fd], masks [T, B]
    (None = all real), numpy arrays or tensors.

    Equivalent to T calls of :func:`stream_update` (same step body).
    ``window=w`` moves w batches to the device at a time, so only O(w * B)
    of the stream is resident there; ``None`` moves the whole stack at once.
    Returns the final state and per-batch info columns of leading dim T:
    ``elbo, score, ph, drifted, n_eff, rho, sweeps, quarantined``."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    dev = cp.device
    T = xcs.shape[0]
    w = T if window is None else window
    to_dev = lambda a, dt: torch.as_tensor(a).to(device=dev, dtype=dt)
    cols = {k: [] for k in INFO_KEYS}
    for t0 in range(0, T, w):
        xc_w = to_dev(xcs[t0:t0 + w], torch.float32)
        xd_w = to_dev(xds[t0:t0 + w], torch.int32)
        m_w = (torch.ones(xc_w.shape[:2], device=dev) if masks is None
               else to_dev(masks[t0:t0 + w], torch.float32))
        for i in range(xc_w.shape[0]):
            xc, xd, mask = xc_w[i], xd_w[i], m_w[i]

            def fit_fn(prior, post):
                fit = V.fit_loop(cp, prior, post, xc, xd, mask, sweeps, tol,
                                 backend, chunk)
                return fit.post, fit.elbo, fit.sweep

            state, info = _stream_step(cp, base_prior, state, xc, xd, mask,
                                       drift_threshold, forget, backend,
                                       chunk, fit_fn)
            for k in INFO_KEYS:
                cols[k].append(info[k])
    info = {k: torch.stack(v) for k, v in cols.items()}
    if obs.enabled():
        obs.emit_stream_events(info)
        obs.emit_kernel_counts(site="stream_fit")
    return state, info
