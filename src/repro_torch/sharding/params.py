"""A model's parameters laid out over a ``("data", "model")`` mesh.

* :func:`shard_tensor` / :func:`gather_tensor` -- one tensor's block on
  this rank, and the whole tensor back (a zero-filled ``all_reduce``);
* :func:`shard_params` -- an ``LM`` of local blocks from a whole one;
* :func:`init_sharded` -- the same blocks drawn directly, one layer at a
  time, for a model no card holds whole (mixtral-8x7b: 187 GB in fp32);
* :func:`gather_params` -- the whole model back, leaf by leaf, in the
  mesh-free expert layout: checkpoints and tests read it;
* :func:`empty_sharded` -- the blocks' shapes as empty tensors (fake ones
  under ``FakeTensorMode``: the dry run's parameters, never drawn).

Each local parameter carries its spec as ``param.shard_spec``; the model
code reads it to gather FSDP dims (``collectives.gather_fsdp``) and the
optimizer to sum norms over the axes that split a parameter.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.sharding import collectives as C
from repro_torch.sharding.specs import Spec, axes_of, param_shapes, \
    param_specs

Tensor = torch.Tensor


def axis_sizes(mesh) -> Dict[str, int]:
    return {a: C.axis_size(mesh, a) for a in mesh.mesh_dim_names}


def shard_tensor(full: Tensor, spec: Spec, mesh) -> Tensor:
    """This rank's block of ``full`` under ``spec`` (a contiguous copy).
    Every split dim must divide by its axes' size (``fix_spec`` replicates
    the others)."""
    out = full
    for d, entry in enumerate(spec):
        axes = axes_of(entry)
        if not axes:
            continue
        n = C.axes_size(mesh, axes)
        if full.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(full.shape)} does not split "
                             f"over {axes} ({n} ranks)")
        b = full.shape[d] // n
        out = out.narrow(d, C.axes_index(mesh, axes) * b, b)
    return out.clone(memory_format=torch.contiguous_format)


def place(local: Tensor, spec: Spec, mesh) -> Tensor:
    """A zero-filled tensor of the whole shape holding ``local`` where this
    rank's block lies: summed over the ranks that split it, the whole
    tensor."""
    shape, index = list(local.shape), []
    for d, entry in enumerate(spec):
        axes = axes_of(entry)
        shape[d] *= C.axes_size(mesh, axes)
        index.append(slice(C.axes_index(mesh, axes) * local.shape[d],
                           (C.axes_index(mesh, axes) + 1) * local.shape[d]))
    full = local.new_zeros(shape)
    full[tuple(index)] = local
    return full


def gather_tensor(local: Tensor, spec: Spec, mesh) -> Tensor:
    """The whole tensor from every rank's block under ``spec`` (every rank
    gets it): :func:`place`, then one ``all_reduce`` an axis that splits
    it."""
    axes = tuple(a for e in spec for a in axes_of(e))
    return C.all_reduce_(place(local, spec, mesh), mesh, axes, "gather")


def _set(lm: nn.Module, name: str, t: Tensor, requires_grad: bool) -> None:
    mod, leaf = name.rsplit(".", 1)
    lm.get_submodule(mod)[leaf] = nn.Parameter(t, requires_grad=requires_grad)


def _tag(lm: nn.Module, specs: Dict[str, Spec]) -> nn.Module:
    for k, p in lm.named_parameters():
        p.shard_spec = specs[k]
    return lm


def mesh_specs(params, sh, mode: str) -> Dict[str, Spec]:
    """``param_specs`` of ``params`` in ``mode`` on ``sh``'s mesh (its data
    axes other than the model axis, and its axis sizes)."""
    return param_specs(params, None, mode, data_axes=tuple(
        a for a in sh.data_axes if a != sh.model_axis),
        model_axis=sh.model_axis, axis_sizes=axis_sizes(sh.mesh))


def shard_params(params: nn.Module, specs: Dict[str, Spec], mesh
                 ) -> nn.Module:
    """A new ``LM`` holding this rank's block of each parameter of
    ``params`` (on its device), each tagged with its spec; the experts
    must already be in the mesh's EP layout (``ep_shards`` = the model
    axis's size)."""
    from repro_torch.nn import layers as L
    from repro_torch.nn import transformer as T

    local = T.init_model(L.META_GEN, params.cfg)
    for k, p in params.named_parameters():
        _set(local, k, shard_tensor(p.detach(), specs[k], mesh),
             p.requires_grad)
    return _tag(local, specs)


def _layout(cfg, sh, mode: str):
    """(experts' EP shards, specs by name) of ``cfg``'s parameters in
    ``mode`` on ``sh``'s mesh: the experts over the model axis, except
    under ``train_fsdp`` (one shard, gathered)."""
    ep_shards = 1 if (cfg.moe is None or mode == "train_fsdp") \
        else C.axis_size(sh.mesh, sh.model_axis)
    return ep_shards, mesh_specs(param_shapes(cfg, ep_shards=ep_shards), sh,
                                 mode)


def init_sharded(gen: torch.Generator, cfg, sh, mode: str = "serve",
                 dtype=torch.float32, *, trainable: bool = False
                 ) -> nn.Module:
    """This rank's blocks of ``init_model(gen, cfg, ep_shards=...)``'s
    weights under ``param_specs(mode)``, drawn a layer at a time (every
    rank draws the same numbers from the same seed and keeps its block).
    The experts are laid out over the model axis (one shard under
    ``train_fsdp``, which gathers them)."""
    from repro_torch.nn import transformer as T

    mesh = sh.mesh
    ep_shards, specs = _layout(cfg, sh, mode)
    lm = T.init_model(gen, cfg, dtype, trainable=trainable,
                      ep_shards=ep_shards,
                      place=lambda k, t: shard_tensor(t, specs[k], mesh))
    return _tag(lm, specs)


def local_shape(shape, spec: Spec, mesh) -> tuple:
    """The shape of this rank's block of a tensor of ``shape`` under
    ``spec`` (each split dim over its axes' size)."""
    return tuple(n // C.axes_size(mesh, axes_of(e)) if e is not None else n
                 for n, e in zip(shape, spec))


def empty_sharded(cfg, sh, mode: str = "serve", dtype=torch.float32,
                  device=None, *, trainable: bool = False) -> nn.Module:
    """:func:`init_sharded`'s blocks as empty tensors on ``device``, each
    tagged with its spec: their shapes alone (under ``FakeTensorMode``,
    fake tensors without storage)."""
    ep_shards, specs = _layout(cfg, sh, mode)
    lm = param_shapes(cfg, ep_shards=ep_shards)
    for k, p in list(lm.named_parameters()):
        _set(lm, k, torch.empty(local_shape(p.shape, specs[k], sh.mesh),
                                dtype=dtype, device=device), trainable)
    return _tag(lm, specs)


@torch.no_grad()
def gather_params(params: nn.Module, mesh, *, keep: bool = True
                  ) -> Optional[nn.Module]:
    """The whole ``LM`` from every rank's blocks on the host, leaf by leaf
    (each is gathered on its card, then moved to the CPU), with the
    experts in the mesh-free layout of one shard.  Every rank takes part;
    only ranks with ``keep`` build the result (``None`` elsewhere): rank 0
    alone, for a checkpoint of a model no host holds four times."""
    from repro_torch.nn import layers as L
    from repro_torch.nn import transformer as T

    full = T.init_model(L.META_GEN, params.cfg) if keep else None
    for k, p in params.named_parameters():
        spec = getattr(p, "shard_spec", (None,) * p.dim())
        t = gather_tensor(p.detach(), spec, mesh)
        if keep:
            _set(full, k, t.cpu(), p.requires_grad)
        del t
    return T.with_ep_shards(full, 1) if keep else None
