"""Batched log-space factor algebra over discrete variables (counterpart of
``repro.infer_exact.factors``).

A :class:`Factor` is a named-scope log-probability table with an optional
leading batch axis (one slice per evidence instance: the whole junction
tree propagates B queries at once).  Scopes and cardinalities are static
Python; tables are torch tensors.

The two hot loops of junction-tree propagation -- sepset absorption (factor
product against a message) and marginalization onto a sepset -- and the
shrink-style evidence reduction run the CUDA kernels of
``repro_torch.kernels.factor_ops`` when ``backend="cuda"``, exactly where
the JAX package calls its Pallas kernels; ``backend="einsum"`` is the plain
PyTorch path (the JAX package's ``use_pallas=False``).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import factor_ops

Tensor = torch.Tensor

NEG_INF = float("-inf")


class Factor(NamedTuple):
    """log p over ``scope``; table shape = batch_shape + cards."""

    scope: Tuple[str, ...]
    cards: Tuple[int, ...]
    logp: Tensor

    @property
    def batch_ndim(self) -> int:
        return self.logp.dim() - len(self.scope)


def _expand(f: Factor, scope: Tuple[str, ...]) -> Tensor:
    """Broadcast ``f.logp`` onto the superset ``scope`` (batch axes lead)."""
    nb = f.batch_ndim
    pos = {v: i for i, v in enumerate(f.scope)}
    order = sorted(range(len(f.scope)), key=lambda i: scope.index(f.scope[i]))
    t = f.logp.permute(tuple(range(nb)) + tuple(nb + i for i in order))
    for axis, v in enumerate(scope):
        if v not in pos:
            t = t.unsqueeze(nb + axis)
    return t


def product(factors: Sequence[Factor]) -> Factor:
    """Log-space factor product: union scope, broadcast add."""
    scope: Tuple[str, ...] = ()
    card_of: Dict[str, int] = {}
    for f in factors:
        for v, c in zip(f.scope, f.cards):
            if v not in card_of:
                scope = scope + (v,)
                card_of[v] = c
            elif card_of[v] != c:
                raise ValueError(f"cardinality clash for {v}")
    cards = tuple(card_of[v] for v in scope)
    t = _expand(factors[0], scope)
    for f in factors[1:]:
        t = t + _expand(f, scope)
    return Factor(scope, cards, t)


def _permute(f: Factor, scope: Tuple[str, ...]) -> Tensor:
    """Reorder ``f``'s table axes to match ``scope`` (same variable set)."""
    nb = f.batch_ndim
    perm = tuple(nb + f.scope.index(v) for v in scope)
    return f.logp.permute(tuple(range(nb)) + perm)


def absorb(f: Factor, msg: Factor, *, backend: str = "einsum") -> Factor:
    """``f * msg`` where ``msg.scope`` is a subset of ``f.scope``.

    The sepset-absorption hot loop: with ``backend="cuda"`` the tables are
    flattened to [B, M, N] (sepset vars minor) and the add runs in the
    ``log_product`` kernel.
    """
    if not set(msg.scope) <= set(f.scope):
        return product([f, msg])
    if backend != "cuda" or f.batch_ndim != 1 or msg.batch_ndim != 1:
        return product([f, msg])
    sep = msg.scope
    keep = tuple(v for v in f.scope if v not in sep)
    perm_scope = keep + sep
    ft = _permute(f, perm_scope).contiguous()
    B = ft.shape[0]
    m = math.prod(f.cards[f.scope.index(v)] for v in keep)
    n = math.prod(msg.cards)
    mt = _permute(msg, sep).contiguous()
    out = factor_ops.log_product(ft.view(B, m, n), mt.view(B, n))
    cards = tuple(f.cards[f.scope.index(v)] for v in perm_scope)
    return Factor(perm_scope, cards, out.view((B,) + cards))


def marginalize(f: Factor, keep: Sequence[str], *,
                backend: str = "einsum") -> Factor:
    """logsumexp out every variable not in ``keep``."""
    keep = tuple(v for v in f.scope if v in set(keep))
    drop = tuple(v for v in f.scope if v not in set(keep))
    if not drop:
        return Factor(keep, tuple(f.cards[f.scope.index(v)] for v in keep),
                      _permute(f, keep))
    cards_keep = tuple(f.cards[f.scope.index(v)] for v in keep)
    t = _permute(f, keep + drop)
    if backend == "cuda" and f.batch_ndim == 1:
        B = t.shape[0]
        m = math.prod(cards_keep)
        n = math.prod(f.cards[f.scope.index(v)] for v in drop)
        out = factor_ops.log_marginalize(t.contiguous().view(B, m, n))
        return Factor(keep, cards_keep, out.view((B,) + cards_keep))
    nb = f.batch_ndim
    axes = tuple(range(nb + len(keep), nb + len(f.scope)))
    return Factor(keep, cards_keep, torch.logsumexp(t, dim=axes))


def reduce_evidence(f: Factor, var: str, idx: Tensor, *,
                    backend: str = "einsum") -> Factor:
    """Clamp ``var`` to per-instance values ``idx`` ([B] int), dropping it.

    Shrink-style evidence reduction: the observed axis disappears, so
    downstream messages are smaller.  ``JunctionTreeEngine`` folds evidence
    as :func:`indicator` factors instead (static clique shapes per evidence
    schema); this op is the algebra layer's alternative for callers that
    want the smaller tables.
    """
    keep = tuple(v for v in f.scope if v != var)
    cards_keep = tuple(f.cards[f.scope.index(v)] for v in keep)
    t = _permute(f, keep + (var,))
    idx = torch.as_tensor(idx, device=t.device)
    nb = f.batch_ndim
    if nb == 0:
        t = t[None]
        idx = idx.reshape(1)
        nb = 1
    B = t.shape[0]
    n = f.cards[f.scope.index(var)]
    flat = t.reshape(B, math.prod(cards_keep), n)
    if backend == "cuda":
        out = factor_ops.evidence_select(flat.contiguous(), idx)
    else:
        sel = idx.long()[:, None, None].expand(B, flat.shape[1], 1)
        out = torch.gather(flat, 2, sel)[..., 0]
    out = out.reshape((B,) + cards_keep)
    if f.batch_ndim == 0:
        out = out[0]
    return Factor(keep, cards_keep, out)


def indicator(var: str, card: int, idx: Tensor) -> Factor:
    """log 1[x_var == idx] as a batched factor ([B] -> [B, card])."""
    idx = torch.as_tensor(idx).reshape(-1).to(torch.int64)
    onehot = idx[:, None] == torch.arange(card, device=idx.device)[None, :]
    zero = torch.zeros((), device=idx.device)
    return Factor((var,), (card,),
                  torch.where(onehot, zero, torch.full_like(zero, NEG_INF)))


def normalize(f: Factor) -> Factor:
    """Normalize over scope axes (per batch instance)."""
    nb = f.batch_ndim
    axes = tuple(range(nb, f.logp.dim()))
    z = torch.logsumexp(f.logp, dim=axes, keepdim=True)
    return Factor(f.scope, f.cards, f.logp - z)
