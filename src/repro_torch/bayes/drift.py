"""Streaming drift monitor for NN training (counterpart of
``repro.bayes.drift``): the Page-Hinkley machinery of
``repro_torch.core.streaming`` on the per-token loss signal."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.streaming import DriftState, drift_init, drift_update


class LossDriftMonitor(NamedTuple):
    state: DriftState
    threshold: float

    @staticmethod
    def create(threshold: float = 5.0) -> "LossDriftMonitor":
        """The statistics live on the host: a loss is one float a step."""
        return LossDriftMonitor(state=drift_init(), threshold=threshold)

    def observe(self, loss) -> Tuple["LossDriftMonitor", torch.Tensor]:
        """Feed a batch mean loss; returns (new monitor, drifted?)."""
        # score = negative loss (higher is better, matching ELBO convention)
        loss = torch.as_tensor(loss, dtype=torch.float32)
        st, ph = drift_update(self.state, -loss)
        return LossDriftMonitor(state=st, threshold=self.threshold), \
            ph > self.threshold
