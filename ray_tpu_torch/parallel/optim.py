"""Optimizers with optax's hyperparameters.

``torch.optim.AdamW`` and ``optax.adamw`` apply the same update rule: Adam
moments with bias correction, eps added to the square root of the second
moment, and weight decay decoupled from the gradient and taken on the
parameter before the step. Their defaults differ (torch decays by 1e-2,
optax by 1e-4), so ``adamw`` passes every hyperparameter with optax's
default.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> Callable[[Iterable[torch.Tensor]], torch.optim.AdamW]:
    """Counterpart of ``optax.adamw``: a factory that builds a
    ``torch.optim.AdamW`` over the given parameters, with optax's
    defaults. ``make_train_fns`` calls it once in its ``init_fn``."""
    def make(params) -> torch.optim.AdamW:
        return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2),
                                 eps=eps, weight_decay=weight_decay)
    return make
