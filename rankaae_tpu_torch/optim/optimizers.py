"""Adam and AdamW with *runtime* learning rates (counterpart of
``rankaae_tpu/optim/optimizers.py:35-101``).

The reference uses 7 independent torch optimizers over overlapping parameter
subsets, each with its own lr = ratio * lr_base, driven by per-optimizer
ReduceLROnPlateau schedulers (``sc/clustering/trainer.py:333-408``).  Here an
optimizer is a pair of plain functions over a list of parameters: ``update``
takes the learning rate as an argument (a 0-d device tensor that the plateau
scheduler owns), so no host sync is needed to read it.  The formulas are the
JAX package's, not ``torch.optim``'s code:

* Adam: L2 weight decay folded into the gradient before the moments.
* AdamW: decoupled decay ``p -= lr * wd * p``.

Parameters are updated in place (under ``no_grad``); the moment buffers are
updated in place too.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch


@dataclasses.dataclass
class MomentState:
    count: int                      # step counter (host int: never synced)
    mu: List[torch.Tensor]          # first moments, one per parameter
    nu: List[torch.Tensor]          # second moments


def moment_init(params: List[torch.Tensor]) -> MomentState:
    return MomentState(count=0,
                       mu=[torch.zeros_like(p) for p in params],
                       nu=[torch.zeros_like(p) for p in params])


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``update(grads, state, params, lr)`` steps ``params`` in place."""

    init: Callable[[List[torch.Tensor]], MomentState]
    update: Callable[..., None]


def _adam_moments(grads, state: MomentState, b1: float, b2: float):
    state.count += 1
    for m, v, g in zip(state.mu, state.nu, grads):
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
    # bias corrections in float32, as the JAX package computes them (with
    # b2 = 0.9999 the float32 and float64 values differ by 1.7e-4 relative)
    t = np.float32(state.count)
    one = np.float32(1.0)
    return float(one - np.float32(b1) ** t), float(one - np.float32(b2) ** t)


def make_adam(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    @torch.no_grad()
    def update(grads, state, params, lr):
        if weight_decay:
            grads = [g + weight_decay * p for g, p in zip(grads, params)]
        bc1, bc2 = _adam_moments(grads, state, b1, b2)
        for p, m, v in zip(params, state.mu, state.nu):
            p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))

    return Optimizer(moment_init, update)


def make_adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    @torch.no_grad()
    def update(grads, state, params, lr):
        bc1, bc2 = _adam_moments(grads, state, b1, b2)
        for p, m, v in zip(params, state.mu, state.nu):
            step = lr * weight_decay * p + lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p.sub_(step)

    return Optimizer(moment_init, update)


OPTIMIZERS: Dict[str, Callable[..., Optimizer]] = {
    "Adam": make_adam,
    "AdamW": make_adamw,
}


def make_optimizer(name: str, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                   **kw) -> Optimizer:
    if name in ("RAdam", "AdaBound"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP queue 1, item 5)")
    if name not in OPTIMIZERS:
        raise ValueError(f"Unknown optimizer {name!r}; choose from {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](b1=betas[0], b2=betas[1], eps=eps, weight_decay=weight_decay, **kw)
