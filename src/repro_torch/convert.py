"""Carry weights and state across between the JAX package and the port.

The JAX package's parameter pytrees (``PlateParams``, ``StreamState``) are
read field by field from anything array-like (numpy arrays, or arrays that
convert with ``np.asarray``), so this module imports nothing of JAX.  The
tests use it to start both packages from the same posterior: the JAX
package seeds its initial posterior with ``jax.random``, which PyTorch
cannot reproduce.  :func:`bayesian_network_from_numpy` builds the port's
``BayesianNetwork`` from plain structure and CPD arrays, so a network of
the JAX package can be carried across too; the ``*_from_numpy`` functions of
the temporal models carry an HMM posterior and the fHMM, Kalman and
switching-LDS parameters (the JAX package draws their initial means and
matrices with ``jax.random`` too), and :func:`lda_params_from_numpy` an
LDA's initial topic-word Dirichlet.  :func:`lm_params_from_numpy`
and :func:`load_lm_checkpoint` carry a language model's parameters across
(a parameter tree, or the flat-key npz that ``repro.train.checkpoint.save``
writes), so a JAX checkpoint serves in the port.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import dag as dagmod
from repro_torch.core import expfam as ef
from repro_torch.core.streaming import DriftState, StreamState
from repro_torch.core.vmp import PlateParams


def _t(a, dev: torch.device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(a)).to(device=dev, dtype=dtype)


def plate_params_from_numpy(tree, device: devmod.DeviceLike = None
                            ) -> PlateParams:
    """The port's ``PlateParams`` from the JAX package's (or any tree with
    fields ``mix.alpha``, ``reg.{m,K,a,b}``, ``disc.alpha``)."""
    dev = devmod.resolve_device(device)
    reg = ef.MVNormalGamma(*(_t(getattr(tree.reg, f), dev)
                             for f in ("m", "K", "a", "b")))
    return PlateParams(mix=ef.Dirichlet(_t(tree.mix.alpha, dev)), reg=reg,
                       disc=ef.Dirichlet(_t(tree.disc.alpha, dev)))


def stream_state_from_numpy(tree, device: devmod.DeviceLike = None
                            ) -> StreamState:
    """The port's ``StreamState`` from the JAX package's."""
    dev = devmod.resolve_device(device)
    d = tree.drift
    drift = DriftState(mean=_t(d.mean, dev), cum=_t(d.cum, dev),
                       cum_min=_t(d.cum_min, dev),
                       t=_t(d.t, dev, torch.int64))
    return StreamState(
        prior=plate_params_from_numpy(tree.prior, dev),
        post=plate_params_from_numpy(tree.post, dev), drift=drift,
        n_seen=_t(tree.n_seen, dev),
        n_drifts=_t(tree.n_drifts, dev, torch.int64),
        n_quarantined=_t(tree.n_quarantined, dev, torch.int64))


def to_numpy(tree):
    """The same named-tuple structure with numpy leaves, for comparison."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return type(tree)(*(to_numpy(part) for part in tree))


def bayesian_network_from_numpy(
        variables: Sequence[Tuple[str, str, int]],
        parents: Mapping[str, Sequence[str]],
        cpds: Mapping[str, Mapping[str, object]],
        device: devmod.DeviceLike = None) -> dagmod.BayesianNetwork:
    """The port's ``BayesianNetwork`` from plain structure and arrays.

    variables  (name, kind, card) in registry order; kind is
               ``"multinomial"`` or ``"gaussian"`` (card ignored for it)
    parents    name -> parent names, in the order the CPD arrays use
    cpds       name -> ``{"table": ...}`` for a discrete node or
               ``{"alpha": ..., "beta": ..., "sigma2": ...}`` for a CLG one
    """
    dev = devmod.resolve_device(device)
    vs = dagmod.Variables()
    for name, kind, card in variables:
        if kind == dagmod.DISCRETE:
            vs.new_multinomial(name, int(card))
        elif kind == dagmod.CONTINUOUS:
            vs.new_gaussian(name)
        else:
            raise ValueError(f"unknown kind {kind!r} of {name!r}")
    dag = dagmod.DAG(vs)
    for name, pas in parents.items():
        for pa in pas:
            dag.add_parent(vs.by_name(name), vs.by_name(pa))
    out: Dict[str, object] = {}
    for name, arrays in cpds.items():
        if "table" in arrays:
            out[name] = dagmod.MultinomialCPD(_t(arrays["table"], dev))
        else:
            out[name] = dagmod.CLGCPD(*(_t(arrays[k], dev)
                                        for k in ("alpha", "beta", "sigma2")))
    return dagmod.BayesianNetwork(dag, out)


# -- temporal models (pgm_models.dynamic) -------------------------------------


def hmm_posterior_from_numpy(tree, device: devmod.DeviceLike = None):
    """The port's ``HMMPosterior`` from the JAX package's (fields
    ``init.alpha``, ``trans.alpha``, ``emis.{m,K,a,b}``)."""
    from repro_torch.pgm_models.dynamic import HMMPosterior

    dev = devmod.resolve_device(device)
    emis = ef.MVNormalGamma(*(_t(getattr(tree.emis, f), dev)
                              for f in ("m", "K", "a", "b")))
    return HMMPosterior(init=ef.Dirichlet(_t(tree.init.alpha, dev)),
                        trans=ef.Dirichlet(_t(tree.trans.alpha, dev)),
                        emis=emis)


def fhmm_params_from_numpy(means, log_trans, log_init, noise,
                           device: devmod.DeviceLike = None):
    """(means [C, S, F], log_trans [C, S, S], log_init [C, S], noise) of a
    ``FactorialHMMModel`` as tensors on ``device``."""
    dev = devmod.resolve_device(device)
    return tuple(_t(a, dev) for a in (means, log_trans, log_init, noise))


def lds_params_from_numpy(A, C, q, r, device: devmod.DeviceLike = None):
    """(A [L, L], C [F, L], q, r) of a ``KalmanFilter`` on ``device``."""
    dev = devmod.resolve_device(device)
    return tuple(_t(a, dev) for a in (A, C, q, r))


def slds_params_from_numpy(A, C, q, r, log_trans,
                           device: devmod.DeviceLike = None):
    """(A [S, L, L], C [F, L], q, r, log_trans [S, S]) of a
    ``SwitchingLDS`` on ``device``."""
    dev = devmod.resolve_device(device)
    return tuple(_t(a, dev) for a in (A, C, q, r, log_trans))


def lda_params_from_numpy(lam, device: devmod.DeviceLike = None
                          ) -> torch.Tensor:
    """An ``LDA``'s topic-word Dirichlet ``lam`` [T, V] on ``device`` (the
    JAX package draws it with ``jax.random.gamma``)."""
    return _t(lam, devmod.resolve_device(device))


# -- language models ------------------------------------------------------------


def lm_params_from_numpy(tree: Mapping[str, Any], cfg,
                         device: devmod.DeviceLike = None, *,
                         trainable: bool = False, ep_shards: int = 1):
    """The port's :class:`repro_torch.nn.transformer.LM` from the JAX
    package's parameter dict as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``): same keys, with the
    leading ``[L]`` axis of ``params["blocks"]`` (and of whisper's
    ``params["enc_blocks"]``) unstacked into one module per layer.  The
    mixture-of-experts weights keep the reference's EP layout of
    ``ep_shards`` shards (``init_model(ep_shards=)``: [s, E_loc, d,
    ff_loc]); one shard runs on one device, ``s`` shards on a mesh whose
    model axis has ``s`` ranks (``sharding.shard_params``), and
    ``transformer.with_ep_shards`` relays them.  Weights are held in fp32,
    frozen unless ``trainable``."""
    from repro_torch.nn import transformer as T

    T.check_arch(cfg)
    dev = devmod.resolve_device(device)
    if cfg.arch_type == "moe":
        s = np.shape(tree["blocks"]["moe"]["w_gate"])[1]
        if s != ep_shards:
            raise ValueError(f"the experts are in the layout of {s} shards, "
                             f"ep_shards={ep_shards}")

    def groups(tree_, index=None):
        return {g: {k: _t(np.asarray(v, np.float32) if index is None
                          else np.asarray(v[index], np.float32), dev)
                    for k, v in leaves.items()}
                for g, leaves in tree_.items()}

    def unstack(key, n_layers, block_cls):
        n = {len(np.asarray(v)) for leaves in tree[key].values()
             for v in leaves.values()}
        if n != {n_layers}:
            raise ValueError(f"{key} hold {sorted(n)} layers, {cfg.name} "
                             f"has {n_layers}")
        return [block_cls(cfg, groups(tree[key], i)) for i in range(n_layers)]

    block_cls = {"dense": T.DenseBlock, "vlm": T.DenseBlock,
                 "moe": T.MoEBlock, "ssm": T.MambaBlock,
                 "hybrid": T.MambaBlock, "audio": T.DecoderBlock}
    blocks = unstack("blocks", cfg.n_layers, block_cls[cfg.arch_type])
    top = groups({k: tree[k] for k in ("embed", "final_norm", "lm_head",
                                       "enc_pos", "dec_pos") if k in tree})
    shared = T.DenseBlock(cfg, groups(tree["shared_attn"])) \
        if "shared_attn" in tree else None
    audio = {}
    if cfg.arch_type == "audio":
        audio = dict(enc_pos=top["enc_pos"], dec_pos=top["dec_pos"],
                     enc_blocks=unstack("enc_blocks", cfg.encoder.n_layers,
                                        T.EncoderBlock))
    return T.LM(cfg, top["embed"], blocks, top["final_norm"],
                lm_head=top.get("lm_head"), shared_attn=shared, **audio
                ).requires_grad_(trainable)


def load_lm_checkpoint(path: str, cfg, device: devmod.DeviceLike = None,
                       ep_shards: int = 1):
    """An LM from the flat-key npz that ``repro.train.checkpoint.save``
    writes (keys are tree paths joined by ``"\\x1f"``)."""
    from repro_torch.train.checkpoint import load_dicts

    return lm_params_from_numpy(load_dicts(path), cfg, device,
                                ep_shards=ep_shards)
