"""Top-k with ``jax.lax.top_k``'s tie order."""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis; equal values
    keep the lower index first, as ``jax.lax.top_k`` does (``torch.topk``
    does not promise an order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
