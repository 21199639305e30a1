"""ReduceLROnPlateau as device state (counterpart of
``rankaae_tpu/optim/plateau.py``).

torch semantics (the reference instantiates one per optimizer:
``sc/clustering/trainer.py:400-408``, mode="min", threshold=0.01 relative,
cooldown=0, min_lr=0, eps=1e-8), as a pure state transition on 0-d device
tensors, so the metric never has to be read on the host:

* best init = +inf
* improvement: metric < best * (1 - threshold)
* on improvement: best = metric, bad-epoch counter reset
* otherwise counter += 1; when counter > patience: lr *= factor (skipped if
  the change is below eps), counter = 0.

Every field may carry a leading trial axis, (T,): the update is elementwise,
so each trial's scheduler steps on its own metric.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PlateauState(NamedTuple):
    lr: torch.Tensor           # current learning rate (f32 scalar)
    best: torch.Tensor         # best metric seen (f32 scalar)
    num_bad: torch.Tensor      # epochs without improvement (int32 scalar)


def plateau_init(lr, device="cpu") -> PlateauState:
    """Fresh state for an initial ``lr``: a number (0-d state) or one per
    trial (a (T,) tensor or sequence)."""
    lr = torch.as_tensor(lr, dtype=torch.float32, device=device)
    return PlateauState(
        lr=lr.clone(),
        best=torch.full_like(lr, float("inf")),
        num_bad=torch.zeros(lr.shape, dtype=torch.int32, device=device),
    )


def plateau_update(state: PlateauState, metric: torch.Tensor, factor: float,
                   patience: int, threshold: float = 0.01, eps: float = 1e-8
                   ) -> PlateauState:
    is_better = metric < state.best * (1.0 - threshold)
    best = torch.where(is_better, metric, state.best)
    num_bad = torch.where(is_better, torch.zeros_like(state.num_bad), state.num_bad + 1)

    reduce = num_bad > patience
    new_lr = state.lr * factor
    # torch skips the update when the reduction is below eps
    new_lr = torch.where(state.lr - new_lr > eps, new_lr, state.lr)
    lr = torch.where(reduce, new_lr, state.lr)
    num_bad = torch.where(reduce, torch.zeros_like(num_bad), num_bad)
    return PlateauState(lr=lr, best=best, num_bad=num_bad)
