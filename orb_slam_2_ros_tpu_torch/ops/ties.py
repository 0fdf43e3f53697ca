"""Tie rules of the reference, made explicit.

``jax.lax.top_k`` and ``jnp.argmax`` put the lower index first among equal
values; ``torch.topk`` and ``torch.argmax`` on CUDA promise no order. Loop
closing takes both over integer covisibility counts and scores full of ties
and zeros, so it takes them through these.
"""

from __future__ import annotations

import torch


def top_k_stable(x: torch.Tensor, k: int):
    """The k largest along the last axis, the lower index first among equal
    values (the order ``jax.lax.top_k`` gives). Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def first_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the maximum along ``dim``, the lowest among equal maxima
    (``jnp.argmax``'s rule; an ``argmax`` on CUDA promises none). int64."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    pos = torch.arange(n, dtype=torch.int64, device=x.device).reshape(shape)
    mx = torch.max(x, dim=dim, keepdim=True).values
    return torch.min(torch.where(x == mx, pos, torch.full_like(pos, n)),
                     dim=dim).values
