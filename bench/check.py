"""What the traffic kinds' checks (``bench/traffic/<kind>.py``) share: a
gap of norms leaf by leaf, and the verdict of a run's numbers against the
cell's limits."""

from __future__ import annotations

import statistics
from typing import Dict, Optional

SMALL_GRAD = 1e-3


def norm_gap(prog: Dict[str, float], refn: Dict[str, float],
             keys: Optional[list] = None) -> float:
    """The worst leaf's gap between the program's and the reference's
    norm, over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    keys = list(refn) if keys is None else keys
    med = statistics.median(refn.values())
    return max(abs(prog[k] - refn[k]) / max(refn[k], med, 1e-30)
               for k in keys)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] == numbers[k] and numbers[k] <= lim
               for k, lim in limits.items())
