"""The general traffic generator: token corpora, training batches and
prefill prompts from ``--seed`` and a traffic file's parameters.

The corpus is an order-1 Markov chain over the vocabulary, each context
with ``branch`` likely successors (a copy of the program's
``data.tokens.markov_sequence_fast``, the same tokens for the same seed).
Training batches and prompts are windows of it at starts drawn from the
seed; every seed gives the same sizes, only the tokens differ.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Iterator, Tuple

import numpy as np
import torch


def markov_corpus(n: int, vocab: int, seed: int, branch: int = 8
                  ) -> np.ndarray:
    """``n`` int32 tokens of the chain seeded by ``seed``."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, branch))
    probs = rng.dirichlet(np.ones(branch) * 0.5, size=vocab)
    rng = np.random.default_rng(seed + 1)
    cum = probs.cumsum(1).tolist()
    succ = succ.tolist()
    u = rng.random(n).tolist()
    out = np.empty(n, np.int32)
    s = int(rng.integers(0, vocab))
    last = branch - 1
    for i in range(n):
        out[i] = s
        s = succ[s][min(bisect_left(cum[s], u[i]), last)]
    return out


class Windows:
    """Rows of ``seq`` (+1 for the labels) tokens of a corpus at starts
    drawn from the seed; ``take(rows)`` returns the next ``rows`` windows
    as an int64 array [rows, seq + 1]."""

    def __init__(self, corpus: np.ndarray, seq: int, seed: int):
        self.corpus, self.seq = corpus, seq
        self.rng = np.random.default_rng(seed + 2)
        if len(corpus) <= seq + 1:
            raise ValueError(f"a corpus of {len(corpus)} tokens holds no "
                             f"window of {seq + 1}")

    def take(self, rows: int) -> np.ndarray:
        starts = self.rng.integers(0, len(self.corpus) - self.seq - 1, rows)
        return np.stack([self.corpus[s:s + self.seq + 1]
                         for s in starts]).astype(np.int64)


def corpus_for(traffic: dict, vocab: int, seed: int) -> np.ndarray:
    c = traffic["corpus"]
    if c["generator"] != "markov":
        raise ValueError(f"unknown corpus generator {c['generator']!r}")
    return markov_corpus(c["tokens"], vocab, seed, c["branch"])


def train_batches(traffic: dict, vocab: int, seed: int, device
                  ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Endless (tokens, labels) pairs [batch, seq] on ``device``."""
    win = Windows(corpus_for(traffic, vocab, seed), traffic["seq"], seed)
    while True:
        rows = torch.from_numpy(win.take(traffic["batch"]))
        yield rows[:, :-1].to(device), rows[:, 1:].to(device)


def prompts(traffic: dict, vocab: int, seed: int) -> Iterator[np.ndarray]:
    """Endless prompt batches [batch, seq] (host arrays: a server receives
    them from its clients)."""
    win = Windows(corpus_for(traffic, vocab, seed), traffic["seq"], seed)
    while True:
        yield win.take(traffic["batch"])[:, :-1]
