"""Device meshes for d-VMP and the LM mesh paths (counterpart of
``repro.launch.mesh``).

The JAX package builds a ``jax.sharding.Mesh`` over one controller's
devices; here a mesh is a ``torch.distributed`` ``DeviceMesh`` over the
ranks of a launched job, one process a rank.  The caller's
``init_process_group`` (or the launcher's environment) chooses the backend
and the rendezvous; nothing here picks or switches one.

Functions, not module-level constants, so importing this module touches no
process group.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS_NAMES = ("pod", "data")


def data_axes_of(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The mesh dims that data is split over: those named ``pod`` or
    ``data``, in mesh order."""
    return tuple(a for a in mesh.mesh_dim_names or ()
                 if a in DATA_AXIS_NAMES)


def make_host_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """A ``("data", "model")`` mesh of CPU ranks (tests, CPU examples).
    The process group must be up with ``data * model`` ranks."""
    return init_device_mesh("cpu", (data, model),
                            mesh_dim_names=("data", "model"))


def make_lm_mesh(data: int, model: int, device_type: str = "cuda", *,
                 pods: int = 1) -> DeviceMesh:
    """The ``("data", "model")`` mesh of the LM mesh paths over the launched
    job's ``data * model`` ranks (row-major: rank r is data r // model,
    model r % model), or with ``pods > 1`` ``("pod", "data", "model")`` over
    ``pods * data * model`` ranks (``("pod", "data")`` the data axes); raises
    unless the world is that size."""
    dims = (data, model) if pods == 1 else (pods, data, model)
    names = ("data", "model") if pods == 1 else ("pod", "data", "model")
    world = dist.get_world_size()
    if world != math.prod(dims):
        raise ValueError(f"a {' x '.join(map(str, dims))} mesh needs "
                         f"{math.prod(dims)} ranks, the world has {world}")
    return init_device_mesh(device_type, dims, mesh_dim_names=names)


# the JAX package's production LM meshes (the dry run's): (data, model),
# and 2 pods of them, (pod, data, model)
LM_PRODUCTION = {False: (16, 16), True: (2, 16, 16)}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The launched job's ranks on ``device_type``: ``("data",)`` over the
    world size, or with ``multi_pod`` ``("pod", "data")`` of (nodes, ranks
    a node), ranks a node from the launcher's ``LOCAL_WORLD_SIZE`` (else
    the node's card count, or the whole world on the CPU).  ``device_type="cpu"`` lays the same mesh over
    gloo ranks, as the JAX package's dry run lays it over host devices.

    The JAX package's production mesh is a 16 x 16 (x 2 pods) TPU v5e
    slice with a ``model`` axis; that shape does not describe a GPU job,
    whose ranks are its cards, so the port's mesh is the world itself.
    Each rank should have called ``torch.cuda.set_device`` for its card."""
    world = dist.get_world_size()
    if not multi_pod:
        return init_device_mesh(device_type, (world,),
                                mesh_dim_names=("data",))
    per_node = int(os.environ.get(
        "LOCAL_WORLD_SIZE",
        torch.cuda.device_count() if device_type == "cuda" else world))
    if per_node < 1 or world % per_node:
        raise ValueError(f"world size {world} is not a whole number of "
                         f"nodes of {per_node} ranks")
    return init_device_mesh(device_type, (world // per_node, per_node),
                            mesh_dim_names=("pod", "data"))
