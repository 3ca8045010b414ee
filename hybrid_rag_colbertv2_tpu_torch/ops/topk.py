"""Top-k with ``jax.lax.top_k``'s tie order.

``lax.top_k`` returns equal values in ascending index order, and the JAX
cascade relies on it (ties by ascending doc id, ops/fusion.py).
``torch.topk`` promises no order among ties, so the port takes the first
``k`` of a stable descending sort instead. ``jax.lax.approx_max_k`` has
no torch counterpart: the port's candidate selection is always exact.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n) -> (values (..., k), indices (..., k) int64), largest
    first, ties by ascending index."""
    order = torch.argsort(x, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(x, -1, order), order
