"""Checkpointing: flat-key npz round trip for trees of tensors (the port's
counterpart of ``repro.train.checkpoint``, in the same file format).

A tree is NamedTuples, dicts, lists / tuples and leaves (tensors, numpy
arrays, scalars); ``None`` is an empty subtree.  A leaf's key joins its
path with ``"\\x1f"``: a NamedTuple field gives ``.name``, a dict key
``name`` and a sequence index ``i`` -- the keys ``jax.tree_util`` paths
give in the JAX package, so each package reads the other's files.
:func:`save_lm` writes a language model's parameters, gathered whole from a
mesh's ranks (rank 0 writes), so that a mesh-free load and the reference
read the file.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Tree = Any

_SEP = "\x1f"  # unit separator: safe key joiner


def _leaves(tree: Tree, path: Tuple[str, ...] = ()
            ) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the JAX package's flattening order (dict keys
    sorted, NamedTuple fields in order)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], path + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in _leaves(getattr(tree, f), path + ("." + f,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves(v, path + (str(i),))]
    return [(_SEP.join(path), tree)]


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    """{key: numpy array} of every leaf (tensors are read back to the
    host: one copy a leaf)."""
    return {k: _host(leaf) for k, leaf in _leaves(tree)}


def _rebuild(like: Tree, get, path: Tuple[str, ...] = ()) -> Tree:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, get, path + (str(k),)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), get, path + ("." + f,))
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, get, path + (str(i),))
                          for i, v in enumerate(like))
    return get(_SEP.join(path), like)


def save(path: str, tree: Tree) -> None:
    """Atomic npz snapshot of ``tree`` (written beside, then renamed)."""
    tmp = path + ".tmp.npz"  # savez keeps the name when it ends with .npz
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)


def load(path: str, like: Tree) -> Tree:
    """Restore into the structure of ``like``: each leaf is shape-checked
    and placed on ``like``'s device in ``like``'s dtype (a tensor leaf), or
    cast to its dtype (a numpy leaf).  The JAX package's int32 counters
    load into the port's int64 ones and the other way round."""
    with np.load(path) as data:
        def get(key: str, leaf: Any) -> Any:
            arr = data[key]
            shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
            if arr.shape != shape:
                raise ValueError(f"{key}: shape {arr.shape} != {shape}")
            if isinstance(leaf, torch.Tensor):
                return torch.from_numpy(np.array(arr)).to(
                    device=leaf.device, dtype=leaf.dtype)
            return np.asarray(arr, np.asarray(leaf).dtype)

        return _rebuild(like, get)


def load_dicts(path: str) -> Dict[str, Any]:
    """The nested dicts of numpy arrays a file of a dict tree holds, read
    without a ``like`` tree (an LM's parameters: every key a dict path)."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            *parts, leaf = key.split(_SEP)
            node = tree
            for part in parts:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return tree


def save_lm(path: str, params, mesh=None) -> None:
    """An ``LM``'s parameter tree (``transformer.params_tree``) to ``path``.
    With ``mesh`` every rank holds blocks (``sharding.shard_params``) and
    takes part in gathering each leaf; rank 0 writes the whole model, in
    the mesh-free expert layout."""
    import torch.distributed as dist

    from repro_torch.nn import transformer as T
    from repro_torch.sharding import gather_params

    if mesh is None:
        save(path, T.params_tree(params))
        return
    keep = dist.get_rank() == 0
    full = gather_params(params, mesh, keep=keep)
    if keep:
        save(path, T.params_tree(full))
