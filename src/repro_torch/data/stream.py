"""DataStream and DynamicDataStream — paper §3.1 (counterpart of
``repro.data.stream``).

A ``DataStream`` presents data as a sequence of chunks ``(xc, xd)`` or of
fixed-shape batches ``Batch(xc, xd, mask)`` without materializing more than
one batch.  Everything here stays numpy on the host; a learner moves what it
consumes to its own device.
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, Iterator, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.obs import agg
from repro_torch.obs import sink as obs

REAL = "REAL"
FINITE = "FINITE_SET"


@dataclasses.dataclass(frozen=True)
class Attribute:
    name: str
    kind: str          # REAL | FINITE_SET
    card: int = 0      # for FINITE_SET

    def __str__(self) -> str:
        return f"{self.name} {self.kind}"


class Batch(NamedTuple):
    xc: np.ndarray     # [B, F]  continuous columns (float32)
    xd: np.ndarray     # [B, Fd] discrete columns (int32)
    mask: np.ndarray   # [B]     1.0 = real instance, 0.0 = padding


class DataStream:
    """A (possibly unbounded) stream of instances with fixed attributes."""

    def __init__(self, attributes: Sequence[Attribute],
                 source: Callable[[], Iterator[Tuple[np.ndarray, np.ndarray]]],
                 n_instances: Optional[int] = None,
                 validate: bool = False) -> None:
        self.attributes = list(attributes)
        self._source = source
        self.n_instances = n_instances
        self.cont_idx = [i for i, a in enumerate(self.attributes)
                         if a.kind == REAL]
        self.disc_idx = [i for i, a in enumerate(self.attributes)
                         if a.kind == FINITE]
        # validate=True screens every chunk: a wrong column count raises;
        # non-finite xc rows and out-of-range xd rows are dropped + counted
        self.validate = validate
        self.quarantined = 0                       # rows dropped, total
        self.chunk_quarantine: List[int] = []      # rows dropped per chunk

    # -- constructors ---------------------------------------------------------

    @staticmethod
    def from_arrays(attributes: Sequence[Attribute], xc: np.ndarray,
                    xd: Optional[np.ndarray] = None,
                    validate: bool = False) -> "DataStream":
        xc = np.asarray(xc, np.float32)
        if xd is None:
            xd = np.zeros((xc.shape[0], 0), np.int32)
        xd = np.asarray(xd, np.int32)

        def src():
            yield xc, xd

        return DataStream(attributes, src, n_instances=xc.shape[0],
                          validate=validate)

    @staticmethod
    def concat(streams: Sequence["DataStream"]) -> "DataStream":
        if not streams:
            raise ValueError("concat of zero streams")
        for i, s in enumerate(streams[1:], start=1):
            if s.attributes != streams[0].attributes:
                raise ValueError(
                    f"concat: stream {i} attribute schema "
                    f"{[str(a) for a in s.attributes]} does not match "
                    f"stream 0 {[str(a) for a in streams[0].attributes]}")

        def src():
            for s in streams:
                yield from s._source()

        n = None
        if all(s.n_instances is not None for s in streams):
            n = sum(s.n_instances for s in streams)
        return DataStream(streams[0].attributes, src, n_instances=n)

    # -- iteration --------------------------------------------------------------

    def _validate_chunk(self, ci: int, xc: np.ndarray, xd: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Schema-check one chunk; drop non-finite / out-of-range rows.
        Returns ``(clean_xc, clean_xd, n_dropped)``."""
        xc = np.asarray(xc)
        xd = np.asarray(xd)
        F, Fd = len(self.cont_idx), len(self.disc_idx)
        if xc.ndim != 2 or xc.shape[1] != F:
            raise ValueError(f"chunk {ci}: xc shape {xc.shape} does not "
                             f"match schema ({F} REAL attributes)")
        if xd.ndim != 2 or xd.shape[1] != Fd:
            raise ValueError(f"chunk {ci}: xd shape {xd.shape} does not "
                             f"match schema ({Fd} FINITE_SET attributes)")
        ok = np.isfinite(xc).all(axis=1) if F else np.ones(len(xc), bool)
        for j, i in enumerate(self.disc_idx):
            card = self.attributes[i].card
            ok &= (xd[:, j] >= 0) & (xd[:, j] < card)
        dropped = int((~ok).sum())
        return xc[ok], xd[ok], dropped

    def _iter(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if not self.validate:
            yield from self._source()
            return
        for ci, (xc, xd) in enumerate(self._source()):
            xc, xd, dropped = self._validate_chunk(ci, xc, xd)
            self.quarantined += dropped
            self.chunk_quarantine.append(dropped)
            if dropped and obs.enabled():
                obs.emit("quarantine", t=ci, site="data", dropped=dropped)
                agg.REGISTRY.counter("quarantine_total", site="data"
                                     ).inc(dropped)
            yield xc, xd

    def chunks(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """The stream's native (xc, xd) chunks, as the source yields them
        (screened first with ``validate=True``)."""
        yield from self._iter()

    def batches(self, batch_size: int) -> Iterator[Batch]:
        """Fixed-shape batches; the ragged tail is zero-padded and masked."""
        buf_c: List[np.ndarray] = []
        buf_d: List[np.ndarray] = []
        have = 0
        F, Fd = len(self.cont_idx), len(self.disc_idx)
        for xc, xd in self._iter():
            buf_c.append(xc)
            buf_d.append(xd)
            have += xc.shape[0]
            while have >= batch_size:
                cc = np.concatenate(buf_c) if len(buf_c) > 1 else buf_c[0]
                dd = np.concatenate(buf_d) if len(buf_d) > 1 else buf_d[0]
                buf_c, buf_d = [cc[batch_size:]], [dd[batch_size:]]
                have = buf_c[0].shape[0]
                yield Batch(cc[:batch_size], dd[:batch_size],
                            np.ones(batch_size, np.float32))
        if have > 0:
            cc = np.concatenate(buf_c) if len(buf_c) > 1 else buf_c[0]
            dd = np.concatenate(buf_d) if len(buf_d) > 1 else buf_d[0]
            pad = batch_size - have
            yield Batch(
                np.concatenate([cc, np.zeros((pad, F), np.float32)]),
                np.concatenate([dd, np.zeros((pad, Fd), np.int32)]),
                np.concatenate([np.ones(have, np.float32),
                                np.zeros(pad, np.float32)]))

    def sharded_batches(self, batch_size: int, n_shards: int
                        ) -> Iterator[Batch]:
        """Batches whose leading dim divides the data shards of a mesh:
        ``batch_size`` rounded up to a multiple of ``n_shards`` (padded
        rows have mask 0)."""
        yield from self.batches(-(-batch_size // n_shards) * n_shards)

    def collect(self, limit: Optional[int] = None) -> Batch:
        """The whole stream as one batch (small data only)."""
        cs, ds, n = [], [], 0
        for xc, xd in self._iter():
            cs.append(xc)
            ds.append(xd)
            n += xc.shape[0]
            if limit and n >= limit:
                break
        xc, xd = np.concatenate(cs), np.concatenate(ds)
        if limit:
            xc, xd = xc[:limit], xd[:limit]
        return Batch(xc, xd, np.ones(xc.shape[0], np.float32))

    def __str__(self) -> str:
        return "\n".join(str(a) for a in self.attributes)


# -- dynamic (sequence) data: paper §3.1 dynamic streams -----------------------


class SequenceBatch(NamedTuple):
    """[B, T, ...] sequence data with SEQUENCE_ID/TIME_ID semantics (numpy;
    a model moves what it consumes to its own device)."""

    xc: np.ndarray     # [B, T, F]
    xd: np.ndarray     # [B, T, Fd]
    mask: np.ndarray   # [B, T]  1.0 = observed step, 0.0 = padding


class DynamicDataStream:
    """Sequences of equal length T (ragged sequences are right-padded)."""

    def __init__(self, attributes: Sequence[Attribute], xc: np.ndarray,
                 xd: Optional[np.ndarray] = None,
                 mask: Optional[np.ndarray] = None) -> None:
        self.attributes = list(attributes)
        self.xc = np.asarray(xc, np.float32)           # [S, T, F]
        self.xd = (np.asarray(xd, np.int32) if xd is not None
                   else np.zeros(self.xc.shape[:2] + (0,), np.int32))
        self.mask = (np.asarray(mask, np.float32) if mask is not None
                     else np.ones(self.xc.shape[:2], np.float32))

    def batches(self, batch_size: int) -> Iterator[SequenceBatch]:
        """Batches of ``batch_size`` sequences; the tail batch is padded
        with all-zero, fully masked sequences."""
        S = self.xc.shape[0]
        for i in range(0, S, batch_size):
            sl = slice(i, i + batch_size)
            xc, xd, m = self.xc[sl], self.xd[sl], self.mask[sl]
            pad = batch_size - xc.shape[0]
            if pad:
                xc = np.concatenate(
                    [xc, np.zeros((pad,) + xc.shape[1:], xc.dtype)])
                xd = np.concatenate(
                    [xd, np.zeros((pad,) + xd.shape[1:], xd.dtype)])
                m = np.concatenate([m, np.zeros((pad,) + m.shape[1:],
                                                m.dtype)])
            yield SequenceBatch(xc, xd, m)

    def collect(self) -> SequenceBatch:
        return SequenceBatch(self.xc, self.xd, self.mask)
