"""Partition specs for parameters, optimizer and decode states (counterpart
of ``repro.sharding.specs``).

Logical layout, mesh ``("data", "model")``:

  TRAIN  -- FSDP(``data``) x TP(``model``):
    d_model-indexed weight dims  -> ``data``   (ZeRO weight sharding)
    head/ff/expert/vocab dims    -> ``model``  (tensor parallel)
    optimizer moments inherit the parameter specs.
  TRAIN_FSDP -- every weight sharded over every axis, no tensor parallelism.
  SERVE / DECODE -- TP(``model``) only; the KV cache's sequence dim is split
    over ``model`` (context parallel, ``attention.attention_decode_ctx_
    parallel``), SSM decode states over heads.

A spec is a tuple with one entry a dim: ``None`` (replicated), an axis name,
or a tuple of axis names (the dim split over their product, row-major), as
``jax.sharding.PartitionSpec`` holds them.  Specs are matched to parameters
by NAME (the leaf and its group: ``blocks.3.moe.w_gate`` -> ``moe/w_gate``,
else ``w_gate``), so one table covers every architecture.  The port's
``blocks`` are one module a layer, so its specs are the reference's with
the stacked leaves' leading ``None`` dropped.

Pure functions of shapes and names: nothing here touches a process group.
:func:`param_shapes` gives a model's parameters on the ``meta`` device
(no memory), which is what the specs of a model too large for one card are
computed from.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]
MODES = ("train", "train_fsdp", "serve", "decode")


def _rules(fsdp: Axis, model: Optional[str]) -> Dict[str, Spec]:
    """name -> spec of the (non-layer) dims."""
    return {
        # embeddings
        "table": (model, fsdp),
        "pos": (fsdp, None),
        # norms
        "scale": (None,), "bias": (None,),
        # attention [d, H, hd] / [H, hd, d]: q heads split; k/v head counts
        # are usually below the model size, so k/v stay replicated
        "wq": (fsdp, model, None),
        "wk": (fsdp, None, None),
        "wv": (fsdp, None, None),
        "wo": (model, None, fsdp),
        # dense mlp
        "w_gate": (fsdp, model),
        "w_up": (fsdp, model),
        "w_down": (model, fsdp),
        "b_up": (model,), "b_down": (None,),
        # moe (EP layout [s, E_loc, d, ff_loc]); router replicated
        "router": (None, None),
        "moe/w_gate": (model, None, fsdp, None),
        "moe/w_up": (model, None, fsdp, None),
        "moe/w_down": (model, None, None, fsdp),
        # mamba2
        "w_z": (fsdp, model), "w_x": (fsdp, model),
        "w_B": (fsdp, None), "w_C": (fsdp, None),
        "w_dt": (fsdp, model),
        "conv_x": (None, model), "conv_b_x": (model,),
        "conv_bc": (None, None), "conv_b_bc": (None,),
        "A_log": (model,), "D": (model,), "dt_bias": (model,),
        "norm_scale": (model,),
        "w_out": (model, fsdp),
    }


def axes_of(entry: Axis) -> Tuple[str, ...]:
    """The axis names of one spec entry (``()`` for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def fix_spec(spec: Spec, shape: Tuple[int, ...],
             axis_sizes: Optional[Mapping[str, int]]) -> Spec:
    """Drop axis names on dims they do not divide evenly (-> replicated):
    granite's vocab of 49155 splits over no even model axis."""
    if axis_sizes is None:
        return tuple(spec)
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        size = 1
        for a in axes_of(ax):
            size *= axis_sizes.get(a, 1)
        fixed.append(ax if ax is not None and dim % size == 0 else None)
    return tuple(fixed[: len(shape)])


def _shapes(params) -> Dict[str, Tuple[int, ...]]:
    if isinstance(params, torch.nn.Module):
        return {k: tuple(p.shape) for k, p in params.named_parameters()}
    return {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}


def param_specs(params, cfg=None, mode: str = "train", *,
                data_axes: Tuple[str, ...] = ("data",),
                model_axis: str = "model",
                axis_sizes: Optional[Mapping[str, int]] = None
                ) -> Dict[str, Spec]:
    """``{parameter name: spec}`` of ``params`` (an ``LM``, or a mapping of
    names to tensors or shapes), in the parameters' order.

    mode: ``train`` (FSDP + TP), ``train_fsdp`` (every weight over every
    axis, no TP), ``serve`` / ``decode`` (TP).  ``axis_sizes``: the mesh's
    axis sizes, for :func:`fix_spec`.  ``cfg`` is taken for the reference's
    signature; the table does not depend on it."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if mode == "train_fsdp":
        fsdp: Axis = tuple(data_axes) + (model_axis,)
        model: Optional[str] = None
    else:
        fsdp = data_axes[-1] if mode == "train" else None
        model = model_axis
    rules = _rules(fsdp, model)
    out = {}
    for key, shape in _shapes(params).items():
        parts = key.split(".")
        name = parts[-1]
        qual = f"{parts[-2]}/{name}" if len(parts) > 1 else name
        spec = rules.get(qual, rules.get(name))
        if spec is None or len(spec) != len(shape):
            out[key] = (None,) * len(shape)       # unknown names: replicated
            continue
        out[key] = fix_spec(spec, shape, axis_sizes)
    return out


def train_state_specs(state, cfg=None, *, data_axes=("data",),
                      model_axis="model", axis_sizes=None, mode="train"):
    """``TrainState`` / ``VBTrainState`` specs: the optimizer's trees
    mirror the parameter specs; counters are ``()``."""
    from repro_torch.bayes import vb_optimizer as vb
    from repro_torch.train import optimizer as opt

    pspec = param_specs(state.params, cfg, mode, data_axes=data_axes,
                        model_axis=model_axis, axis_sizes=axis_sizes)
    if hasattr(state, "opt"):                     # AdamW TrainState
        return type(state)(params=pspec,
                           opt=opt.AdamWState(m=pspec, v=pspec, step=()),
                           step=())
    return type(state)(params=pspec,
                       vb=vb.VBState(mean=pspec, fisher=pspec,
                                     prior_mean=pspec, prior_prec=pspec,
                                     step=()),
                       step=())


def decode_state_specs(state, cfg=None, *, data_axes=("data",),
                       model_axis="model", axis_sizes=None):
    """``DecodeState`` specs, one entry a layer: KV caches [B, C, Hkv, D]
    with the batch over ``data_axes`` and the cache's SEQUENCE over
    ``model_axis`` (context parallel); SSM states split by head."""
    dp = data_axes[0] if len(data_axes) == 1 else tuple(data_axes)

    def fx(spec, t):
        return fix_spec(spec, tuple(t.shape), axis_sizes)

    def kv(cache):
        return type(cache)(k=fx((dp, model_axis, None, None), cache.k),
                           v=fx((dp, model_axis, None, None), cache.v),
                           length=())

    def ssm(st):
        return type(st)(h=fx((dp, model_axis, None, None), st.h),
                        conv_x=fx((dp, None, model_axis), st.conv_x),
                        conv_bc=fx((dp, None, None), st.conv_bc))

    def each(xs, fn):
        return None if xs is None else [fn(x) for x in xs]

    return type(state)(
        kv=each(state.kv, kv), ssm=each(state.ssm, ssm),
        shared_kv=each(state.shared_kv, kv),
        enc_kv=each(state.enc_kv,
                    lambda e: tuple(fx((dp, None, None, None), t)
                                    for t in e)))


def param_shapes(cfg, *, ep_shards: int = 1, trainable: bool = False):
    """The ``LM`` of ``cfg`` on the ``meta`` device: every parameter's name
    and shape, no memory (``init_model`` with ``layers.META_GEN``)."""
    from repro_torch.nn import layers as L
    from repro_torch.nn import transformer as T

    return T.init_model(L.META_GEN, cfg, ep_shards=ep_shards,
                        trainable=trainable)
