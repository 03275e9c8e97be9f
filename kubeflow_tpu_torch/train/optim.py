"""Optimizers with optax's defaults.

The JAX trainer takes an ``optax`` transformation; the port's takes a
factory ``parameters -> torch.optim.Optimizer``. :func:`adamw` gives
``torch.optim.AdamW`` optax's ``adamw`` defaults: torch's own default
``weight_decay`` is 0.01, a hundred times optax's 1e-4. Both apply the
decoupled decay ``p <- p - lr * wd * p`` to every parameter (optax masks
nothing by default), so the algebra is the same.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def adamw(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
) -> Callable[[Iterable[torch.nn.Parameter]], torch.optim.AdamW]:
    """``optax.adamw(learning_rate, b1, b2, eps, weight_decay=...)`` as a
    factory of ``torch.optim.AdamW``."""

    def make(params: Iterable[torch.nn.Parameter]) -> torch.optim.AdamW:
        return torch.optim.AdamW(
            params, lr=learning_rate, betas=(b1, b2), eps=eps,
            weight_decay=weight_decay,
        )

    return make
