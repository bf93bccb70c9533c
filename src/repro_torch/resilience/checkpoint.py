"""Posterior checkpoint/restore for the streaming path (the port's
counterpart of ``repro.resilience.checkpoint``, in the same file format).

The ``train.checkpoint`` flat-key npz round trip with a JSON metadata
block (batch counter, network version, reason) and a retention-managed
directory of snapshots, wired into ``core.streaming.stream_fit`` as
:func:`checkpointed_stream_fit` / :func:`resume_stream_fit`.  The port
resumes a checkpoint the JAX package wrote and the other way round (the
keys are the same; integer counters change width on the way).

The resume guarantee is **bit-identical** within the port: every batch
runs the same step body whatever the segment it sits in, and the
checkpoint holds the full carried :class:`~repro_torch.core.streaming.
StreamState` (posterior, chained prior, Page-Hinkley drift state,
counters), whose float32 tensors the npz round trip keeps exactly -- so
replaying batches ``t..T`` from a snapshot taken at ``t`` gives the
tensors the uninterrupted ``0..T`` run would have.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import sink as obs
from repro_torch.train.checkpoint import _flatten, load as _load_tree

PyTree = Any

_META_KEY = "__meta__"          # reserved npz key: JSON metadata as uint8
_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.npz$")


def save(path: str, tree: PyTree, meta: Optional[Dict[str, Any]] = None
         ) -> None:
    """Atomic flat-key npz snapshot of ``tree`` plus a JSON ``meta`` block.

    Same wire format as ``train.checkpoint.save`` with one reserved key
    (``__meta__``) — files written by the old saver load fine (empty
    meta)."""
    flat = _flatten(tree)
    if _META_KEY in flat:       # a pytree key colliding with the reserved one
        raise ValueError(f"tree flattens onto reserved key {_META_KEY!r}")
    flat[_META_KEY] = np.frombuffer(
        json.dumps(meta or {}).encode("utf-8"), dtype=np.uint8)
    tmp = path + ".tmp.npz"     # savez keeps the name when it ends with .npz
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load(path: str, like: PyTree) -> Tuple[PyTree, Dict[str, Any]]:
    """Restore ``(tree, meta)``; the tree lands in the structure of
    ``like``, on its devices and in its dtypes (shape-checked by
    ``train.checkpoint.load``)."""
    tree = _load_tree(path, like)
    with np.load(path) as data:
        meta = (json.loads(bytes(data[_META_KEY]).decode("utf-8"))
                if _META_KEY in data else {})
    return tree, meta


class CheckpointManager:
    """Retention-managed directory of streaming-state snapshots.

    Parameters
    ----------
    directory   where ``ckpt_{t:08d}.npz`` files live
    every       periodic policy: snapshot each time ``t`` advances by this
                many batches (0 disables the periodic trigger)
    on_drift    also snapshot when the caller reports a drift firing —
                drift points are exactly where the posterior lurches, so
                they are the states worth keeping
    keep        retention: prune to the newest ``keep`` snapshots
    network_version
                stamped into each snapshot's meta so serving-tier restores
                can refuse a stale structure
    """

    def __init__(self, directory: str, *, every: int = 0,
                 on_drift: bool = False, keep: int = 3,
                 network_version: int = 0) -> None:
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.directory = directory
        self.every = int(every)
        self.on_drift = bool(on_drift)
        self.keep = int(keep)
        self.network_version = int(network_version)
        self._last_t: Optional[int] = None
        os.makedirs(directory, exist_ok=True)

    # -- write side -----------------------------------------------------------

    def path_for(self, t: int) -> str:
        return os.path.join(self.directory, f"ckpt_{t:08d}.npz")

    def save(self, t: int, state: PyTree, *, reason: str = "periodic",
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Unconditionally snapshot ``state`` after batch ``t``."""
        path = self.path_for(t)
        meta = {"t": int(t), "reason": reason, "format": 1,
                "network_version": self.network_version}
        if extra:
            meta.update(extra)
        save(path, state, meta)
        self._last_t = int(t)
        self._prune()
        if obs.enabled():
            obs.emit("checkpoint", t=int(t), path=path, reason=reason)
            from repro_torch.obs import agg
            agg.REGISTRY.counter("checkpoint_total", reason=reason).inc()
        return path

    def maybe_save(self, t: int, state: PyTree, *,
                   drifted: bool = False) -> Optional[str]:
        """Apply the periodic / on-drift policy; returns the path written
        (or None when neither trigger fires)."""
        if drifted and self.on_drift:
            return self.save(t, state, reason="drift")
        if self.every > 0 and (self._last_t is None
                               or t - self._last_t >= self.every):
            return self.save(t, state, reason="periodic")
        return None

    def _prune(self) -> None:
        paths = self.paths()
        for p in paths[:-self.keep]:
            os.remove(p)

    # -- read side ------------------------------------------------------------

    def paths(self) -> List[str]:
        """Snapshot paths, oldest first."""
        out = []
        for name in os.listdir(self.directory):
            if _CKPT_RE.match(name):
                out.append(os.path.join(self.directory, name))
        return sorted(out)

    def latest(self) -> Optional[str]:
        paths = self.paths()
        return paths[-1] if paths else None

    def restore(self, like: PyTree
                ) -> Optional[Tuple[PyTree, Dict[str, Any]]]:
        """Load the newest snapshot into the structure of ``like``.
        Returns ``(state, meta)`` or None when the directory is empty."""
        path = self.latest()
        if path is None:
            return None
        return load(path, like)


# -- stream_fit integration ----------------------------------------------------


def checkpointed_stream_fit(cp, base_prior, state, xcs, xds, masks=None, *,
                            manager: CheckpointManager, start: int = 0,
                            **stream_kw):
    """``stream_fit`` with checkpoints: replay batches ``start..T`` in
    segments of ``manager.every`` batches, snapshotting the full carried
    state after each segment (and, with ``manager.on_drift``, after a
    segment containing a drift firing).

    The segmented replay is bit-identical to one unsegmented ``stream_fit``
    (the same step body, the state crossing the boundary exactly), so
    checkpointing costs a segment one read of its drift column, the
    state's copy to the host and the npz write, never accuracy.  Returns
    ``(state, info)`` like ``stream_fit`` (info columns concatenated on
    the device).
    """
    import torch

    from repro_torch.core import streaming

    T = xcs.shape[0]
    if not 0 <= start <= T:
        raise ValueError(f"start {start} outside [0, {T}]")
    every = manager.every if manager.every > 0 else T - start
    infos = []
    t = start
    while t < T:
        hi = min(t + every, T)
        m = None if masks is None else masks[t:hi]
        state, info = streaming.stream_fit(
            cp, base_prior, state, xcs[t:hi], xds[t:hi], m, **stream_kw)
        infos.append(info)
        t = hi
        drifted = bool(info["drifted"].any())      # one read a segment
        if (drifted and manager.on_drift) or manager.every > 0 or t == T:
            manager.save(t, state,
                         reason="drift" if drifted and manager.on_drift
                         else "periodic")
    if not infos:
        return state, {}
    info = {k: torch.cat([i[k] for i in infos]) for k in infos[0]}
    return state, info


def resume_stream_fit(cp, base_prior, like_state, xcs, xds, masks=None, *,
                      manager: CheckpointManager, **stream_kw):
    """Crash recovery: restore the newest snapshot (falling back to
    ``like_state`` at t=0 when none exists) and continue the replay from
    the recorded batch counter.  Returns ``(state, info)`` covering only
    the batches actually replayed."""
    restored = manager.restore(like_state)
    if restored is None:
        state, start = like_state, 0
    else:
        state, meta = restored
        start = int(meta.get("t", 0))
        if meta.get("network_version",
                    manager.network_version) != manager.network_version:
            raise ValueError(
                f"checkpoint network_version {meta.get('network_version')} "
                f"!= manager's {manager.network_version}")
    return checkpointed_stream_fit(cp, base_prior, state, xcs, xds, masks,
                                   manager=manager, start=start, **stream_kw)
