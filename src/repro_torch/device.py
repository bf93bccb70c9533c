"""Device and suff-stats backend selection.

There is no silent fallback: :func:`resolve_device` returns the first CUDA
card by default and raises when there is none, unless the caller asked for
the CPU by name.  The backend follows the device (``"cuda"`` kernels on a
CUDA device, the ``"einsum"`` plain path on the CPU); ``"einsum"`` on a card
is allowed only when the caller names it, as the JAX package allows its XLA
reference backend.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

BACKENDS = ("einsum", "cuda")

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0``; raises if a CUDA device is asked for (or
    defaulted to) and no card is present."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_backend(device: torch.device) -> str:
    """'cuda' on a CUDA device, 'einsum' on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "einsum"


def check_backend(backend: str, device: torch.device) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    if backend == "cuda" and torch.device(device).type != "cuda":
        raise ValueError("backend='cuda' needs tensors on a CUDA device")
    return backend
