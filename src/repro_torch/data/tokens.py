"""LM token pipeline (counterpart of ``repro.data.tokens``).

Synthetic-but-structured corpora, drawn with numpy's generators exactly as
the reference draws them (the same seed gives the same tokens and the
same ``enc_stub`` frames in both packages):

* ``markov_sequence`` / ``markov_sequence_fast`` -- an order-1 Markov chain
  over the vocab, each context with ``branch`` likely successors;
* ``drift_corpus`` -- two Markov regimes concatenated (the streaming-VB
  trainer's drift response);
* ``TokenStream`` -- fixed-shape ``TrainBatch``es from one long token
  array, as tensors on an explicit device.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train.step import TrainBatch


def _markov_tables(vocab: int, branch: int, seed: int):
    rng = np.random.default_rng(seed)
    # each context maps to `branch` likely successors (sparse structure)
    succ = rng.integers(0, vocab, size=(vocab, branch))
    probs = rng.dirichlet(np.ones(branch) * 0.5, size=vocab)
    return succ, probs


def markov_sequence(n: int, vocab: int, seed: int = 0, branch: int = 8
                    ) -> np.ndarray:
    succ, probs = _markov_tables(vocab, branch, seed)
    rng = np.random.default_rng(seed + 1)
    out = np.empty(n, np.int32)
    s = rng.integers(0, vocab)
    for i in range(n):
        out[i] = s
        s = succ[s, rng.choice(probs.shape[1], p=probs[s])]
    return out


def markov_sequence_fast(n: int, vocab: int, seed: int = 0, branch: int = 8
                         ) -> np.ndarray:
    """The same chain with the uniform draws made up front (the state
    dependency stays a loop)."""
    succ, probs = _markov_tables(vocab, branch, seed)
    rng = np.random.default_rng(seed + 1)
    cum = probs.cumsum(1)
    u = rng.random(n)
    out = np.empty(n, np.int32)
    s = int(rng.integers(0, vocab))
    for i in range(n):
        out[i] = s
        k = np.searchsorted(cum[s], u[i])
        s = succ[s, min(k, branch - 1)]
    return out


class TokenStream:
    """Yields fixed-shape TrainBatch from one long token array, on
    ``device`` (``None``: ``cuda:0``, raising without a card)."""

    def __init__(self, tokens: np.ndarray, batch: int, seq: int,
                 enc_stub: Optional[Tuple[int, int]] = None, seed: int = 0,
                 device: DeviceLike = None):
        self.tokens = tokens
        self.batch, self.seq = batch, seq
        self.enc_stub = enc_stub  # (enc_len, d_model) for audio archs
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

    def batches(self, n_steps: int) -> Iterator[TrainBatch]:
        n = len(self.tokens) - self.seq - 1
        for _ in range(n_steps):
            starts = self.rng.integers(0, n, self.batch)
            toks = np.stack([self.tokens[s: s + self.seq] for s in starts])
            labs = np.stack([self.tokens[s + 1: s + self.seq + 1]
                             for s in starts])
            enc = None
            if self.enc_stub:
                el, d = self.enc_stub
                enc = self.rng.standard_normal(
                    (self.batch, el, d)).astype(np.float32)
            dev = self.device
            yield TrainBatch(
                tokens=torch.from_numpy(toks).to(dev),
                labels=torch.from_numpy(labs).to(dev),
                enc_input=None if enc is None else torch.from_numpy(enc).to(
                    dev))


def drift_corpus(n_per_phase: int, vocab: int, seed: int = 0) -> np.ndarray:
    a = markov_sequence_fast(n_per_phase, vocab, seed=seed)
    b = markov_sequence_fast(n_per_phase, vocab, seed=seed + 777)
    return np.concatenate([a, b])
