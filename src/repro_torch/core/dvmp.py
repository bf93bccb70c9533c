"""d-VMP -- distributed Variational Message Passing [Masegosa et al., 2016]
(counterpart of ``repro.core.dvmp``).

In the Fig.-3 plate family every global parameter node receives, per VMP
sweep, a message that is the SUM over instances of per-instance expected
sufficient statistics, while the local posteriors q(Z_i), q(H_i) depend
only on the instance's own data and the current global posterior:

    rank r:  stats_r = local_step(theta, data block r)       (embarrassing)
    all   :  stats   = all_reduce_sum(stats_r)                (one collective)
    rank r:  theta'  = conjugate_update(prior, stats)         (replicated)

The JAX package runs this as one controller's ``shard_map`` with a
``psum`` of the ``PlateStats`` pytree.  Here it is SPMD over
``torch.distributed``: one process a rank, and a
``torch.distributed.device_mesh.DeviceMesh`` with named dims in place of
``jax.sharding.Mesh``; ``data_axes`` names the dims data is split over.

The calling convention keeps the reference's signatures:

* every rank calls with the SAME global arrays (``xc [N, F]``, ...), in the
  same order, with the same arguments;
* a rank computes on its own contiguous block of rows, the layout of
  ``shard_map``'s ``P(data_axes)`` (block index row-major over
  ``data_axes``; :func:`shard_rows`);
* results are replicated: the same bits on every rank.

The sweep's collective is ONE ``all_reduce(SUM)`` of one flat float32
buffer of the stats' leaves per data axis (:func:`_all_reduce_stats`).  So
the ELBO that ends the loop is computed from the same bits on every rank,
and every rank stops on the same sweep.  Gathers (``dvmp_posterior_z``'s
rows, ``DvmpMetrics.shard_n``, the samplers' blocks) are an ``all_reduce``
of a zero-filled buffer in which each rank writes its own block: it works
on every backend (gloo has no ``all_gather`` of CUDA tensors) and adding
zeros keeps each block's bits.

The backend and the rendezvous are the caller's (``init_process_group`` /
``init_device_mesh``); nothing here picks or switches one, and a failed
collective raises.  The reference's program caches (``_fit_program``,
``_sweep_program``, ``_posterior_z_program``) are jit artefacts: the port
has no compile step, so they have no twin.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import vmp as V
from repro_torch.core.streaming import tree_leaves, tree_map
from repro_torch.core.vmp import CompiledPlate, PlateParams, PlateStats
from repro_torch.obs.metrics import DvmpMetrics

Tensor = torch.Tensor

# d-VMP's collectives, counted as the kernel wrappers count launches: the
# stats all-reduce (calls, one a data axis, and bytes) and the gathers
COLLECTIVES = {"all_reduce": 0, "bytes": 0, "gather": 0, "gather_bytes": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


# ---------------------------------------------------------------------------
# Mesh geometry
# ---------------------------------------------------------------------------


def check_mesh(mesh, data_axes: Sequence[str]) -> Tuple[str, ...]:
    """``data_axes`` as a tuple; raises ``TypeError`` unless ``mesh`` is a
    ``DeviceMesh`` and ``ValueError`` unless it names every data axis."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    axes = tuple(data_axes)
    names = mesh.mesh_dim_names or ()
    if not axes or any(a not in names for a in axes):
        raise ValueError(f"data_axes {axes} are not dims of the mesh "
                         f"{names}")
    return axes


def _dim_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def data_size(mesh: DeviceMesh, data_axes: Sequence[str]) -> int:
    """Number of data shards: the product of the data dims' sizes."""
    return math.prod(_dim_size(mesh, a) for a in data_axes)


def shard_index(mesh: DeviceMesh, data_axes: Sequence[str]) -> int:
    """This rank's block, row-major over ``data_axes`` (``P(data_axes)``)."""
    i = 0
    for a in data_axes:
        i = i * _dim_size(mesh, a) + mesh.get_local_rank(a)
    return i


def shard_rows(x: Tensor, mesh: DeviceMesh, data_axes: Sequence[str]
               ) -> Tensor:
    """This rank's contiguous block of ``x``'s rows, as a view.  N must be
    a multiple of the data size (as ``shard_map`` requires); pad with a
    zero mask (``DataStream.sharded_batches``) otherwise."""
    w = data_size(mesh, data_axes)
    n = x.shape[0]
    if n % w:
        raise ValueError(f"{n} rows do not split into {w} equal shards; "
                         f"pad the batch to a multiple of {w}")
    b = n // w
    i = shard_index(mesh, data_axes)
    return x[i * b:(i + 1) * b]


def shard_seeds(gen: torch.Generator, n_shards: int) -> list:
    """One seed a shard drawn from ``gen`` (every rank advances ``gen`` the
    same way), as the reference splits one key into a key a shard."""
    return torch.randint(0, 2 ** 62, (n_shards,), generator=gen,
                         device=gen.device).tolist()


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _all_reduce_stats(stats: PlateStats, mesh: DeviceMesh,
                      data_axes: Sequence[str]) -> PlateStats:
    """The d-VMP collective: the non-None leaves of ``stats`` flattened
    into one float32 buffer, summed by one ``all_reduce`` a data axis, and
    split back into the leaves."""
    leaves = tree_leaves(stats)
    for leaf in leaves:
        if leaf.dtype != torch.float32:
            raise TypeError(f"PlateStats leaf of dtype {leaf.dtype}; the "
                            f"collective sums one float32 buffer")
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    for a in data_axes:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.get_group(a))
        COLLECTIVES["all_reduce"] += 1
        COLLECTIVES["bytes"] += flat.numel() * flat.element_size()
    parts = iter(flat.split([leaf.numel() for leaf in leaves]))
    return tree_map(lambda leaf: next(parts).view(leaf.shape), stats)


def gather_rows(block: Tensor, mesh: DeviceMesh,
                data_axes: Sequence[str]) -> Tensor:
    """Every shard's ``block`` ([n, ...], the same n on every rank) stacked
    in shard order, on every rank."""
    n = block.shape[0]
    i = shard_index(mesh, data_axes)
    out = block.new_zeros((data_size(mesh, data_axes) * n,)
                          + tuple(block.shape[1:]))
    out[i * n:(i + 1) * n] = block
    for a in data_axes:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group(a))
        COLLECTIVES["gather"] += 1
        COLLECTIVES["gather_bytes"] += out.numel() * out.element_size()
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def dvmp_fit(cp: CompiledPlate, prior: PlateParams, init: PlateParams,
             xc: Tensor, xd: Tensor, mesh: DeviceMesh,
             data_axes: Sequence[str] = ("data",), max_sweeps: int = 100,
             tol: float = 1e-4, mask: Optional[Tensor] = None,
             backend: Optional[str] = None, chunk: Optional[int] = None,
             with_metrics: bool = False):
    """Distributed VMP fit: ``vmp.fit_loop`` on this rank's block of rows
    with the stats all-reduced between the local and the global step.

    xc: [N, F], xd: [N, Fd] on every rank -- N must divide by the data size;
    ``mask`` pads ragged global batches.  Returns the replicated
    ``VMPState`` (and, with ``with_metrics``, a :class:`DvmpMetrics`).
    At one shard the result is ``vmp_fit``'s bits; over several it agrees
    with it up to float reduction order."""
    axes = check_mesh(mesh, data_axes)
    if mask is None:
        mask = torch.ones(xc.shape[0], device=xc.device)
    xc_s, xd_s, m_s = (shard_rows(a, mesh, axes) for a in (xc, xd, mask))
    st = V.fit_loop(cp, prior, init, xc_s, xd_s, m_s, max_sweeps, tol,
                    backend, chunk,
                    reduce_stats=lambda s: _all_reduce_stats(s, mesh, axes))
    if not with_metrics:
        return st
    shard_n = gather_rows(m_s.sum()[None], mesh, axes)
    return st, DvmpMetrics(shard_n=shard_n, sweeps=st.sweep)


def dvmp_one_sweep(cp: CompiledPlate, prior: PlateParams, post: PlateParams,
                   xc: Tensor, xd: Tensor, mask: Tensor, mesh: DeviceMesh,
                   data_axes: Sequence[str] = ("data",),
                   backend: Optional[str] = None, chunk: Optional[int] = None
                   ) -> Tuple[PlateParams, Tensor]:
    """One distributed sweep -> ``(post, elbo)``: the building block of
    streaming VB over a mesh (``streaming.stream_update(mesh=)``)."""
    axes = check_mesh(mesh, data_axes)
    xc_s, xd_s, m_s = (shard_rows(a, mesh, axes) for a in (xc, xd, mask))
    stats, _ = V.local_step(cp, post, xc_s, xd_s, m_s, backend=backend,
                            chunk=chunk)
    stats = _all_reduce_stats(stats, mesh, axes)
    new = V.global_update(prior, stats)
    return new, V.elbo(cp, prior, new, stats)


def dvmp_posterior_z(cp: CompiledPlate, post: PlateParams, xc: Tensor,
                     xd: Tensor, mesh: DeviceMesh,
                     data_axes: Sequence[str] = ("data",),
                     backend: Optional[str] = None,
                     chunk: Optional[int] = None) -> Tensor:
    """Replica-sharded q(Z | x), the serving tier's query path: each rank
    answers its block of rows with ``local_step`` and the blocks are
    gathered, so every rank returns the full [N, K].  Rows are
    ``vmp.posterior_z``'s; N must divide by the data size."""
    axes = check_mesh(mesh, data_axes)
    xc_s, xd_s = (shard_rows(a, mesh, axes) for a in (xc, xd))
    mask = torch.ones(xc_s.shape[0], device=xc_s.device)
    _, r = V.local_step(cp, post, xc_s, xd_s, mask, backend=backend,
                        chunk=chunk)
    return gather_rows(r, mesh, axes)

