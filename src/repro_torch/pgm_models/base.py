"""Model — the paper's ``latentvariablemodels.staticmodels.Model`` analog
(counterpart of ``repro.pgm_models.base``).

Subclasses override :meth:`build_spec` (the paper's ``buildDAG()``) to
return a ``PlateSpec`` (+ optional latent mask).  ``update_model`` accepts a
``DataStream``, a ``Batch`` or a raw array and runs batch VMP, or streaming
Bayesian updating for a multi-chunk stream and for repeated calls (Eq. 3).

A model lives on one device: ``device=None`` is the first CUDA card (and
raises without one); pass ``device="cpu"`` for the plain CPU path.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import dvmp
from repro_torch.core import expfam as ef
from repro_torch.core import vmp
from repro_torch.core.dag import (BayesianNetwork, CLGCPD, DAG, MultinomialCPD,
                                  PlateSpec, Variables)
from repro_torch.data.stream import Attribute, Batch, DataStream


class Model:
    def __init__(self, attributes: Sequence[Attribute], *, seed: int = 0,
                 backend: Optional[str] = None, chunk: Optional[int] = None,
                 device: devmod.DeviceLike = None, **prior_kwargs) -> None:
        self.attributes = list(attributes)
        self.device = devmod.resolve_device(device)
        spec, latent_mask = self.build_spec()
        self.spec = spec
        self.cp = vmp.compile_plate(spec, latent_mask, self.device)
        self.prior = vmp.default_prior(self.cp, **prior_kwargs)
        self.posterior = vmp.symmetry_broken(
            self.prior, torch.Generator().manual_seed(seed))
        self._chained_prior = self.prior  # Eq. 3 accumulator
        self.n_seen = 0
        # suff-stats backend: None -> the kernels on a card, einsum on CPU
        self.backend = devmod.check_backend(
            backend or devmod.default_backend(self.device), self.device)
        self.chunk = chunk
        # per-batch info columns of the last multi-chunk stream fit
        # (``streaming.stream_fit``: elbo, drifted, quarantined, ...)
        self.last_stream_info = None

    # -- to be overridden ------------------------------------------------------

    def build_spec(self) -> Tuple[PlateSpec, Optional[np.ndarray]]:
        raise NotImplementedError

    def supervised_r(self, batch: Batch) -> Optional[torch.Tensor]:
        """Fixed responsibilities [N, K] for supervised models."""
        return None

    # -- data plumbing ----------------------------------------------------------

    def _as_batch(self, data) -> Batch:
        """A Batch of tensors on the model's device."""
        if isinstance(data, DataStream):
            data = data.collect()
        if not isinstance(data, Batch):
            xc = np.asarray(data, np.float32)
            data = Batch(xc, np.zeros((xc.shape[0], 0), np.int32),
                         np.ones(xc.shape[0], np.float32))
        to = lambda a, dt: torch.as_tensor(a).to(device=self.device, dtype=dt)
        return Batch(to(data.xc, torch.float32), to(data.xd, torch.int32),
                     to(data.mask, torch.float32))

    # -- learning (paper Code Fragments 7, 9, 12) --------------------------------

    def update_model(self, data, *, sweeps: int = 100, tol: float = 1e-5,
                     mesh=None, data_axes: Sequence[str] = ("data",),
                     stream_window: Optional[int] = None) -> float:
        """Fit/refine the posterior on ``data``; returns the ELBO.

        Repeated calls implement Bayesian updating (Eq. 3).  A multi-chunk
        ``DataStream`` routes through ``streaming``: equal-shape chunks are
        stacked and replayed by ``stream_fit`` (``stream_window=w`` moves w
        chunks to the device at a time), ragged chunks go through the
        per-batch ``stream_update`` loop.  Single-chunk streams, raw arrays
        and ``Batch``es take the one-shot VMP fit.

        With a ``DeviceMesh`` (every rank calling with the same data), the
        data is one batch (a stream is collected), the unsupervised fit is
        ``dvmp.dvmp_fit`` over ``data_axes`` with the model's backend and
        chunk, and the supervised closed form stays one local step on the
        whole batch, with no collective."""
        if mesh is not None:
            data_axes = dvmp.check_mesh(mesh, data_axes)
        if (mesh is None and isinstance(data, DataStream)
                and type(self).supervised_r is Model.supervised_r):
            chunks = [(np.asarray(xc, np.float32), np.asarray(xd, np.int32))
                      for xc, xd in data.chunks()]
            if len(chunks) > 1:
                return self._update_model_stream(chunks, sweeps=sweeps,
                                                 tol=tol, window=stream_window)
            if chunks:
                # reuse the single chunk (sources need not be restartable)
                xc, xd = chunks[0]
                data = Batch(xc, xd, np.ones(xc.shape[0], np.float32))
        batch = self._as_batch(data)
        prior = self._chained_prior
        r_fixed = self.supervised_r(batch)
        if r_fixed is not None:
            # conjugate closed form: one local step + global update
            stats, _ = vmp.local_step(self.cp, self.posterior, batch.xc,
                                      batch.xd, batch.mask, r_fixed,
                                      backend=self.backend, chunk=self.chunk)
            post = vmp.global_update(prior, stats)
            e = float(vmp.elbo(self.cp, prior, post, stats))
        elif mesh is None:
            st = vmp.vmp_fit(self.cp, prior, self.posterior, batch.xc,
                             batch.xd, sweeps, tol, batch.mask, self.backend,
                             self.chunk)
            post, e = st.post, float(st.elbo)
        else:
            st = dvmp.dvmp_fit(self.cp, prior, self.posterior, batch.xc,
                               batch.xd, mesh, data_axes, sweeps, tol,
                               mask=batch.mask, backend=self.backend,
                               chunk=self.chunk)
            post, e = st.post, float(st.elbo)
        self.posterior = post
        self._chained_prior = post      # Eq. 3: posterior -> next prior
        self.n_seen += int(batch.mask.sum())
        return e

    def _update_model_stream(self, chunks, *, sweeps: int, tol: float,
                             window: Optional[int] = None) -> float:
        """Streaming Bayesian updating over pre-chunked host data."""
        from repro_torch.core import streaming

        state = streaming.stream_init(self._chained_prior, self.posterior)
        if len({(xc.shape, xd.shape) for xc, xd in chunks}) == 1:
            xcs = np.stack([xc for xc, _ in chunks])
            xds = np.stack([xd for _, xd in chunks])
            state, info = streaming.stream_fit(
                self.cp, self.prior, state, xcs, xds, sweeps=sweeps, tol=tol,
                backend=self.backend, chunk=self.chunk, window=window)
            e = float(info["elbo"][-1])
        else:
            for xc, xd in chunks:
                b = self._as_batch(Batch(xc, xd,
                                         np.ones(xc.shape[0], np.float32)))
                state, info = streaming.stream_update(
                    self.cp, self.prior, state, b.xc, b.xd, sweeps=sweeps,
                    tol=tol, backend=self.backend, chunk=self.chunk)
            e = float(info["elbo"])
        self.last_stream_info = info
        self.posterior = state.post
        self._chained_prior = state.post
        self.n_seen += int(state.n_seen)
        return e

    # -- queries -----------------------------------------------------------------

    def posterior_z(self, data) -> torch.Tensor:
        batch = self._as_batch(data)
        return vmp.posterior_z(self.cp, self.posterior, batch.xc, batch.xd,
                               backend=self.backend, chunk=self.chunk)

    def get_model(self) -> vmp.PlateParams:
        return self.posterior

    # -- exact inference (infer_exact junction tree -- HUGIN-link replacement)

    def to_bayesian_network(self) -> BayesianNetwork:
        """Export the posterior-mean point estimate as a concrete CLG
        ``BayesianNetwork`` on the model's device.

        Node names: the latent is ``"Z"`` (present when ``latent_card > 1``);
        feature ``i`` of the spec is ``"X{i}"``.  Models with a continuous
        latent ``H`` (FA/PPCA family) are not expressible as a finite node
        set and raise ``NotImplementedError``.
        """
        lay = self.cp.layout
        if self.spec.latent_dim > 0:
            raise NotImplementedError(
                "continuous latent H has no finite-node BN export")
        spec, p = self.spec, self.posterior
        dm = spec.discrete_map
        vs = Variables()
        z = vs.new_multinomial("Z", lay.K) if lay.K > 1 else None
        feats = {}
        for i in range(spec.n_features):
            feats[i] = (vs.new_multinomial(f"X{i}", dm[i]) if i in dm
                        else vs.new_gaussian(f"X{i}"))
        dag = DAG(vs)
        cpds = {}
        if z is not None:
            cpds["Z"] = MultinomialCPD(ef.dirichlet_mean(p.mix))
        cont_ids = [i for i in range(spec.n_features) if i not in dm]
        sigma2 = p.reg.b / p.reg.a                       # [F, K] E-style var
        for f, orig in enumerate(cont_ids):
            v = feats[orig]
            if z is not None:
                dag.add_parent(v, z)
            pa = spec.parent_idx(orig)
            for pi in pa:
                dag.add_parent(v, feats[pi])
            m = p.reg.m[f]                               # [K, 1 + P]
            alpha, beta = m[:, 0], m[:, 1:1 + len(pa)]
            s2 = sigma2[f]
            if z is None:                                # no discrete parent
                alpha, beta, s2 = alpha[0], beta[0], s2[0]
            cpds[v.name] = CLGCPD(alpha=alpha, beta=beta, sigma2=s2)
        for new_d, (orig, card) in enumerate(sorted(dm.items())):
            v = feats[orig]
            if z is not None:
                dag.add_parent(v, z)
            alpha = p.disc.alpha[new_d, :, :card]        # [K, card]
            table = alpha / alpha.sum(-1, keepdim=True)
            cpds[v.name] = MultinomialCPD(table if z is not None
                                          else table[0])
        return BayesianNetwork(dag, cpds)

    def posterior_exact(self, data, *, backend: Optional[str] = None
                        ) -> torch.Tensor:
        """Exact p(Z | x) through the junction-tree engine on the model's
        device (``backend=None``: the device's default, the CUDA kernels on
        a card).

        ``data`` is either an evidence dict (name -> scalar or [B] array,
        names as in :meth:`to_bayesian_network`) or anything
        :meth:`posterior_z` accepts, whose rows become one batched
        propagation.  For plate models with a single discrete latent this
        agrees with :meth:`posterior_z` up to VMP convergence.
        """
        from repro_torch.infer_exact import JunctionTreeEngine

        if self.cp.layout.K <= 1:
            raise ValueError("model has no discrete latent to query")
        bn = self.to_bayesian_network()
        if isinstance(data, dict):
            evidence = data
        else:
            batch = self._as_batch(data)
            dm = self.spec.discrete_map
            cont_ids = [i for i in range(self.spec.n_features)
                        if i not in dm]
            evidence = {f"X{orig}": batch.xc[:, f]
                        for f, orig in enumerate(cont_ids)}
            for new_d, (orig, _) in enumerate(sorted(dm.items())):
                evidence[f"X{orig}"] = batch.xd[:, new_d]
        eng = JunctionTreeEngine(bn, backend=backend, device=self.device)
        eng.set_evidence(evidence)
        eng.run_inference()
        return eng.posterior_discrete(bn.dag.variables.by_name("Z"))

    def __str__(self) -> str:
        p = self.posterior
        lay = self.cp.layout
        lines = [f"{type(self).__name__} (Bayesian posterior):"]
        if lay.K > 1:
            w = (p.mix.alpha / p.mix.alpha.sum()).cpu().numpy()
            lines.append(f"P(Hidden) follows a Multinomial\n  {w}")
        for f in range(lay.F):
            mu = p.reg.m[f, :, 0].cpu().numpy()
            var = (p.reg.b[f] / p.reg.a[f]).cpu().numpy()
            lines.append(f"P(X{f} | ...) follows a Normal|Multinomial")
            for k in range(lay.K):
                lines.append(f"  Normal [ mu = {mu[k]:.6f}, var = "
                             f"{var[k]:.6f} ] | {{Hidden = {k}}}")
        return "\n".join(lines)
