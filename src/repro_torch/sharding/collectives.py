"""Collectives of the LM mesh paths, over ``torch.distributed``.

The JAX package lets GSPMD insert collectives where its sharding pins ask
for them; the port is explicit SPMD, one process a rank: each rank holds
its blocks of the parameters (``sharding.specs``) and the model code calls
these where GSPMD would insert a collective.

* :func:`copy_to_model` -- identity forward, ``all_reduce`` backward: where
  a tensor replicated over ``model`` enters a head-, ff-, expert- or
  vocab-split region;
* :func:`reduce_from_model` -- ``all_reduce`` forward, identity backward:
  after ``wo``, ``w_down``, ``w_out``, the expert combine and the
  vocab-parallel lookups (Megatron's pair).  With the two, a weight
  replicated over ``model`` gets the same gradient on every model rank;
* :func:`gather_fsdp` -- a block's FSDP-split weights gathered over their
  data axes just before the block runs, the gradients summed back to each
  rank's block (a reduce-scatter) in the backward; under remat the
  recomputation gathers again, and no full copy is kept;
* :func:`mean_over_data` -- the loss (and the router's aux terms) averaged
  over the data shards: ``all_reduce`` forward, ``1/n`` backward, so that
  summing the ranks' gradients (:func:`sync_grads`) gives the gradient of
  the global mean;
* :func:`gather_dim` -- a dim gathered whole (decode's heads, logits);
* :func:`split_to_model` / :func:`gather_from_model` -- this rank's block
  of a dim replicated over ``model`` (the backward gathers the blocks'
  gradients), and the blocks gathered whole (the backward keeps this
  rank's block): the sequence of context-parallel attention.

Every collective is an ``all_reduce`` (SUM, or MAX for the decode
combine's and the loss's maxima); a gather is an ``all_reduce`` of a
zero-filled buffer in which each rank writes its block, so the same code
runs on NCCL and on gloo over CUDA tensors, which offers only
``all_reduce`` and ``broadcast`` (``core.dvmp`` does the same).  An axis
tuple is reduced one axis at a time; a block of a tuple of axes is
row-major over them.  The calls and bytes are counted by kind in
:data:`COLLECTIVES`.

An axis of size 1 splits nothing: the model code takes the mesh-free route
for the dims it names, so a 1 x 1 mesh gives the mesh-free bits (except
the expert combine, which rounds to bf16 as the reference's mesh route
does).  Which collectives a rank issues depends only on the mesh's shape
and the parameters' shapes, never on the rank, so every rank issues the
same sequence, under remat too.  The process group's timeout bounds each
call; a failed call raises.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding.specs import Spec, axes_of

Tensor = torch.Tensor

KINDS = ("all_reduce", "max", "gather")
COLLECTIVES: Dict[str, Dict[str, int]] = {
    k: {"calls": 0, "bytes": 0} for k in KINDS}


def reset_collectives() -> None:
    for c in COLLECTIVES.values():
        c["calls"] = c["bytes"] = 0


def collectives() -> Dict[str, Dict[str, int]]:
    """A copy of the counts: ``{kind: {"calls": n, "bytes": b}}``."""
    return {k: dict(v) for k, v in COLLECTIVES.items()}


# ---------------------------------------------------------------------------
# mesh geometry
# ---------------------------------------------------------------------------


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axes_size(mesh, axes: Sequence[str]) -> int:
    return math.prod(axis_size(mesh, a) for a in axes)


def axes_index(mesh, axes: Sequence[str]) -> int:
    """This rank's block along ``axes``, row-major (``P((a, b))``)."""
    i = 0
    for a in axes:
        i = i * axis_size(mesh, a) + mesh.get_local_rank(a)
    return i


def tp_size(sh) -> int:
    """Ranks the model axis splits heads / ff / experts / vocab over: its
    size, or 1 without a mesh or when it is one of the data axes (pure
    FSDP)."""
    if sh.mesh is None or sh.model_axis in sh.data_axes:
        return 1
    return axis_size(sh.mesh, sh.model_axis)


def tp_rank(sh) -> int:
    return 0 if tp_size(sh) == 1 else sh.mesh.get_local_rank(sh.model_axis)


def tp_split(t: Tensor, dim: int, sh) -> bool:
    """Whether ``t``'s ``dim`` is split over a tensor-parallel model axis of
    more than one rank (its ``shard_spec``; a tensor with none is whole)."""
    if sh is None or tp_size(sh) == 1:
        return False
    spec = getattr(t, "shard_spec", None)
    return spec is not None and spec[dim] == sh.model_axis


def data_size(sh) -> int:
    return 1 if sh.mesh is None else axes_size(sh.mesh, sh.data_axes)


def data_block(x: Tensor, sh) -> Tensor:
    """This rank's contiguous block of ``x``'s rows (the batch dim) over the
    data axes; all of ``x`` when the rows do not split evenly (tiny decode
    batches stay replicated over data, as in the reference)."""
    n = data_size(sh)
    if n == 1 or x.shape[0] % n:
        return x
    b = x.shape[0] // n
    i = axes_index(sh.mesh, sh.data_axes)
    return x[i * b:(i + 1) * b]


def batch_split(rows: int, sh) -> bool:
    n = data_size(sh)
    return n > 1 and rows % n == 0


# ---------------------------------------------------------------------------
# counted collectives (no autograd)
# ---------------------------------------------------------------------------


def all_reduce_(t: Tensor, mesh, axes: Sequence[str], kind: str = "all_reduce"
                ) -> Tensor:
    """``t`` summed (``kind`` "max": maximised) over ``axes`` in place."""
    op = dist.ReduceOp.MAX if kind == "max" else dist.ReduceOp.SUM
    for a in axes:
        dist.all_reduce(t, op=op, group=mesh.get_group(a))
        COLLECTIVES[kind]["calls"] += 1
        COLLECTIVES[kind]["bytes"] += t.numel() * t.element_size()
    return t


def gather_dim(local: Tensor, dim: int, mesh, axes: Sequence[str]) -> Tensor:
    """The blocks of every rank along ``axes`` concatenated on ``dim``."""
    n = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = n * axes_size(mesh, axes)
    full = local.new_zeros(shape)
    full.narrow(dim, axes_index(mesh, axes) * n, n).copy_(local)
    return all_reduce_(full, mesh, axes, "gather")


# ---------------------------------------------------------------------------
# autograd functions
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh, (ctx.axis,)), \
            None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_(x.contiguous().clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n = axes_size(mesh, axes)
        return all_reduce_(x.clone(), mesh, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        n = x.shape[dim] // axis_size(mesh, axis)
        return x.narrow(dim, mesh.get_local_rank(axis) * n, n)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g.contiguous(), ctx.dim, ctx.mesh, (ctx.axis,)), \
            None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return gather_dim(x.contiguous(), dim, mesh, (axis,))

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // axis_size(ctx.mesh, ctx.axis)
        i = ctx.mesh.get_local_rank(ctx.axis)
        return g.narrow(ctx.dim, i * n, n), None, None, None


def split_to_model(x: Tensor, dim: int, sh) -> Tensor:
    """This rank's block of ``x``'s ``dim`` (which must divide) over
    ``model``; the backward gathers every rank's block of the gradient,
    so a tensor replicated over ``model`` gets its whole gradient."""
    return _SplitTo.apply(x, sh.mesh, sh.model_axis, dim)


def gather_from_model(x: Tensor, dim: int, sh) -> Tensor:
    """The ranks' blocks of ``dim`` over ``model`` gathered whole; the
    backward keeps this rank's block of the (replicated) gradient."""
    return _GatherFrom.apply(x, sh.mesh, sh.model_axis, dim)


def copy_to_model(x: Tensor, sh) -> Tensor:
    """Identity forward; the backward sums the gradient over ``model``."""
    return _CopyTo.apply(x, sh.mesh, sh.model_axis)


def reduce_from_model(x: Tensor, sh) -> Tensor:
    """``x`` summed over ``model`` (in its dtype); identity backward."""
    return _ReduceFrom.apply(x, sh.mesh, (sh.model_axis,))


def sum_over_data(x: Tensor, sh) -> Tensor:
    """``x`` summed over the data axes; identity backward (a global sum
    whose gradient each rank takes for its own terms)."""
    if data_size(sh) == 1:
        return x
    return _ReduceFrom.apply(x, sh.mesh, tuple(sh.data_axes))


def mean_over_data(x: Tensor, sh) -> Tensor:
    """The mean of ``x`` over the data shards (``pmean``); backward 1/n."""
    if data_size(sh) == 1:
        return x
    return _MeanOver.apply(x, sh.mesh, tuple(sh.data_axes))


class _VocabLogZ(torch.autograd.Function):
    """logsumexp over a vocabulary split over ``model``: the max and the
    sum of exponentials all-reduced; the backward is logsumexp's,
    g exp(l - logz), on each rank's own columns."""

    @staticmethod
    def forward(ctx, logits, mesh, axis):
        m = logits.amax(-1, keepdim=True)
        all_reduce_(m, mesh, (axis,), "max")
        m.masked_fill_(m.abs() == math.inf, 0.0)
        s = (logits - m).exp().sum(-1)
        all_reduce_(s, mesh, (axis,))
        logz = s.log() + m[..., 0]
        ctx.save_for_backward(logits, logz)
        return logz

    @staticmethod
    def backward(ctx, g):
        logits, logz = ctx.saved_tensors
        return g[..., None] * (logits - logz[..., None]).exp(), None, None


def vocab_logsumexp(logits: Tensor, sh) -> Tensor:
    return _VocabLogZ.apply(logits, sh.mesh, sh.model_axis)


# ---------------------------------------------------------------------------
# FSDP gathers
# ---------------------------------------------------------------------------


def fsdp_dims(spec: Spec, sh) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
    """(dim, axes) of each dim of ``spec`` split over data axes of more
    than one rank -- the dims gathered before use.  A dim naming the
    tensor-parallel model axis stays split."""
    out = []
    for d, entry in enumerate(spec):
        axes = axes_of(entry)
        if not axes:
            continue
        if sh.model_axis in axes and sh.model_axis not in sh.data_axes:
            if axes != (sh.model_axis,):
                raise ValueError(f"spec {spec}: the model axis is tensor "
                                 f"parallel here but shares a dim with "
                                 f"{axes}")
            continue
        if axes_size(sh.mesh, axes) > 1:
            out.append((d, axes))
    return tuple(out)


class _GatherFsdp(torch.autograd.Function):
    """Leaves gathered whole along their FSDP dim: one zero-filled buffer
    and one ``all_reduce`` an axis for the lot; the backward sums the
    gradients over the same axes and keeps each rank's block."""

    @staticmethod
    def forward(ctx, mesh, axes, dims, *locals_):
        ctx.mesh, ctx.axes, ctx.dims = mesh, axes, dims
        ctx.shapes = [t.shape for t in locals_]
        i, n = axes_index(mesh, axes), axes_size(mesh, axes)
        fulls = []
        for t, d in zip(locals_, dims):
            shape = list(t.shape)
            shape[d] *= n
            fulls.append(shape)
        sizes = [math.prod(s) for s in fulls]
        buf = locals_[0].new_zeros(sum(sizes))
        outs = list(buf.split(sizes))
        for k, (t, d) in enumerate(zip(locals_, dims)):
            outs[k] = outs[k].view(fulls[k])
            outs[k].narrow(d, i * t.shape[d], t.shape[d]).copy_(t)
        all_reduce_(buf, mesh, axes, "gather")
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        mesh, axes = ctx.mesh, ctx.axes
        i = axes_index(mesh, axes)
        n = axes_size(mesh, axes)
        sizes = [math.prod(s) * n for s in ctx.shapes]
        ref = next(g for g in grads if g is not None)
        buf = ref.new_zeros(sum(sizes))
        parts = buf.split(sizes)
        for g, p in zip(grads, parts):
            if g is not None:
                p.copy_(g.reshape(-1))
        all_reduce_(buf, mesh, axes)
        out = []
        for p, s, d in zip(parts, ctx.shapes, ctx.dims):
            full = list(s)
            full[d] *= n
            out.append(p.view(full).narrow(d, i * s[d], s[d]))
        return (None, None, None) + tuple(out)


def gather_fsdp(p, sh):
    """The parameter group ``p`` (a mapping, nested) with every leaf split
    over data axes (its ``shard_spec``; ``sharding.shard_params`` sets it)
    gathered whole, as a nested dict; ``p`` itself when no leaf is.  A
    gathered leaf's ``shard_spec`` is its own with the gathered dim
    whole."""
    if sh is None or sh.mesh is None:
        return p
    leaves = []

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, torch.Tensor):
                spec = getattr(v, "shard_spec", None)
                dims = fsdp_dims(spec, sh) if spec is not None else ()
                if len(dims) > 1:
                    raise ValueError(f"{path + (k,)}: more than one FSDP dim")
                if dims:
                    leaves.append((path + (k,), v, dims[0]))
            else:
                walk(v, path + (k,))

    walk(p, ())
    if not leaves:
        return p
    out = _copy_tree(p)
    groups: Dict[Tuple[Tuple[str, ...], torch.dtype], list] = {}
    for path, t, (d, axes) in leaves:
        groups.setdefault((axes, t.dtype), []).append((path, t, d))
    for (axes, _), items in groups.items():
        fulls = _GatherFsdp.apply(sh.mesh, axes, tuple(d for _, _, d in items),
                                  *(t for _, t, _ in items))
        for (path, t, d), full in zip(items, fulls):
            full.shard_spec = tuple(None if i == d else e
                                    for i, e in enumerate(t.shard_spec))
            node = out
            for k in path[:-1]:
                node = node[k]
            node[path[-1]] = full
    return out


def _copy_tree(node):
    return {k: (v if isinstance(v, torch.Tensor) else _copy_tree(v))
            for k, v in node.items()}


# ---------------------------------------------------------------------------
# gradients and norms across the mesh
# ---------------------------------------------------------------------------


def split_axes(spec: Spec, mesh) -> Tuple[str, ...]:
    """The axes of more than one rank that split a tensor of ``spec``."""
    return tuple(a for e in spec for a in axes_of(e)
                 if axis_size(mesh, a) > 1)


def sync_grads(grads: Dict[str, Tensor], params: Dict[str, Tensor], sh
               ) -> Dict[str, Tensor]:
    """Sum each gradient over the data axes its parameter is replicated on
    (the data-parallel step; the axes that split it were summed by the
    FSDP gathers' backward), one flat fp32 ``all_reduce`` a set of axes."""
    if data_size(sh) == 1:
        return grads
    groups: Dict[Tuple[str, ...], list] = {}
    for k, p in params.items():
        split = split_axes(getattr(p, "shard_spec", ()), sh.mesh)
        axes = tuple(a for a in sh.data_axes
                     if a not in split and axis_size(sh.mesh, a) > 1)
        if axes:
            groups.setdefault(axes, []).append(k)
    for axes, keys in groups.items():
        flat = torch.cat([grads[k].float().reshape(-1) for k in keys])
        all_reduce_(flat, sh.mesh, axes)
        for k, part in zip(keys, flat.split([grads[k].numel()
                                             for k in keys])):
            grads[k] = part.view(grads[k].shape).to(grads[k].dtype)
    return grads


def sharded_sum(values: Dict[str, Tensor], params: Dict[str, Tensor], mesh
                ) -> Tensor:
    """sum over parameters of ``values[k]`` (each a 0-dim partial sum over
    this rank's block), each summed over the axes that split its parameter
    and counted once where it is replicated: the global norm's and the
    posterior KL's sum on a mesh.  In ``values``' order within a set of
    axes; one ``all_reduce`` a set."""
    groups: Dict[Tuple[str, ...], list] = {}
    for k in values:
        spec = getattr(params[k], "shard_spec", ())
        groups.setdefault(split_axes(spec, mesh) if mesh is not None
                          else (), []).append(values[k])
    total = None
    for axes, vals in groups.items():
        s = sum(vals)
        if axes:
            s = all_reduce_(s.clone().reshape(1), mesh, axes)[0]
        total = s if total is None else total + s
    return total
