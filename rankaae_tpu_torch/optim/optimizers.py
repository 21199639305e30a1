"""Adam, AdamW, RAdam and AdaBound with *runtime* learning rates
(counterpart of ``rankaae_tpu/optim/optimizers.py:35-159``).

The reference uses 7 independent torch optimizers over overlapping parameter
subsets, each with its own lr = ratio * lr_base, driven by per-optimizer
ReduceLROnPlateau schedulers (``sc/clustering/trainer.py:333-408``).  Here an
optimizer is a pair of plain functions over a list of parameters: ``update``
takes the learning rate as an argument (a 0-d device tensor that the plateau
scheduler owns), so no host sync is needed to read it.  The formulas are the
JAX package's, not ``torch.optim``'s code:

* Adam: L2 weight decay folded into the gradient before the moments.
* AdamW: decoupled decay ``p -= lr * wd * p``.
* RAdam (torch_optimizer's): variance rectification; the decay
  ``p -= lr * wd * p`` applies before the rectified step.
* AdaBound (torch_optimizer's): an Adam step whose per-element lr is
  clipped to bounds that converge to ``final_lr``; the decay is added to
  the gradient, and the bounds scale with ``lr / base_lr`` as the plateau
  scheduler shrinks ``lr``.

The scalars that depend only on the step count (bias corrections, RAdam's
rectifier, AdaBound's bound factors) are computed on the host in float32,
as the JAX package computes them on the device.

Parameters are updated in place (under ``no_grad``); the moment buffers are
updated in place too.  The learning rate is a 0-d tensor, or one per trial,
(T,), for parameters stacked on a leading trial axis: it is then broadcast
per leaf as (T, 1, ...).  The step count is one host int, as all trials
step together.

:class:`FlatParameters` is the ``flat_optim`` layout (counterpart of
``rankaae_tpu/optim/optimizers.py:162-190``): the parameters of the
trainer's modules become views into one flat float32 buffer, so each
optimizer's parameter subset is one slice of it and its ~14 elementwise
operations run once per slice instead of once per parameter.  The
arithmetic of every element is unchanged, so the two layouts give the same
numbers bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


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


def _per_leaf(lr, p: torch.Tensor):
    """``lr`` as it broadcasts against ``p``: a per-trial (T,) lr becomes
    (T, 1, ...) of ``p``'s rank."""
    if not isinstance(lr, torch.Tensor) or lr.dim() == 0:
        return lr
    return lr.view((-1,) + (1,) * (p.dim() - 1))


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
            p.sub_(_per_leaf(lr, p) * (m / bc1) / (torch.sqrt(v / bc2) + eps))

    return Optimizer(moment_init, update)


def make_adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    @torch.no_grad()
    def update(grads, state, params, lr):
        bc1, bc2 = _adam_moments(grads, state, b1, b2)
        for p, m, v in zip(params, state.mu, state.nu):
            lr_p = _per_leaf(lr, p)
            step = lr_p * weight_decay * p + lr_p * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p.sub_(step)

    return Optimizer(moment_init, update)


def make_radam(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    f32 = np.float32
    rho_inf = f32(2.0 / (1.0 - b2) - 1.0)
    # a Python-float product in the JAX package, rounded once to float32
    rho_den = f32((float(rho_inf) - 4.0) * (float(rho_inf) - 2.0))

    @torch.no_grad()
    def update(grads, state, params, lr):
        bc1, bc2 = _adam_moments(grads, state, b1, b2)
        t = f32(state.count)
        beta2_t = f32(b2) ** t
        rho_t = rho_inf - f32(2.0) * t * beta2_t / (f32(1.0) - beta2_t)
        ratio = (rho_t - f32(4.0)) * (rho_t - f32(2.0)) * rho_inf / \
            (rho_den * max(rho_t, f32(4.001)))
        rect = float(np.sqrt(max(ratio, f32(0.0))))
        use_rect = rho_t > 5.0
        for p, m, v in zip(params, state.mu, state.nu):
            lr_p = _per_leaf(lr, p)
            if weight_decay:
                p.sub_(lr_p * weight_decay * p)
            mhat = m / bc1
            step = rect * mhat / (torch.sqrt(v / bc2) + eps) if use_rect else mhat
            p.sub_(lr_p * step)

    return Optimizer(moment_init, update)


def make_adabound(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                  final_lr=0.1, gamma=1e-3, base_lr=1e-3) -> Optimizer:
    """torch_optimizer.AdaBound defaults; ``base_lr`` = the configured
    initial lr."""
    f32 = np.float32

    @torch.no_grad()
    def update(grads, state, params, lr):
        if weight_decay:
            grads = [g + weight_decay * p for g, p in zip(grads, params)]
        bc1, bc2 = _adam_moments(grads, state, b1, b2)
        t = f32(state.count)
        lo = float(f32(1.0) - f32(1.0) / (f32(gamma) * t + f32(1.0)))
        hi = float(f32(1.0) + f32(1.0) / (f32(gamma) * t))
        root_bc2 = float(np.sqrt(f32(bc2)))
        for p, m, v in zip(params, state.mu, state.nu):
            lr_p = _per_leaf(lr, p)
            flr = final_lr * lr_p / base_lr
            lower, upper = flr * lo, flr * hi
            step_size = lr_p * root_bc2 / bc1
            eff = torch.minimum(torch.maximum(step_size / (torch.sqrt(v) + eps), lower), upper)
            p.sub_(eff * m)

    return Optimizer(moment_init, update)


class FlatParameters:
    """The parameters of ``modules`` (name -> module) as views into one flat
    float32 buffer, module after module in the given order.

    The layout is parameter-major: each parameter keeps its own contiguous
    (T, ...) block, so the modules, cuDNN and K3 (which takes a trial's
    slice of each parameter, ``ops/fused_block_cuda.py``) see contiguous
    tensors as without the knob.  Each block starts on a multiple of
    :data:`ALIGN` elements (512 bytes, the CUDA caching allocator's
    alignment), so cuBLAS and cuDNN, whose choice of kernel may depend on a
    pointer's alignment, see the alignment of separately allocated
    parameters; the gaps hold zeros, which every optimizer leaves at zero
    (a zero gradient and zero moments give a zero step).  A learning rate
    per trial (T,) is spread over the elements by a per-element trial index
    (:meth:`lr`), since a parameter-major slice has no trial axis to
    broadcast over.  A subset of modules adjacent in the order is one slice
    (:meth:`view`).

    Make it after the modules' last ``.to(device)``: ``to`` replaces the
    parameters' storage.  Everything else writes into the parameters in
    place (``load_state_dict``, ``load_trial_state_dict``,
    ``reset_parameters``, the trainer's ``load_state_tree``) and keeps the
    views."""

    #: elements each parameter's block is aligned to
    ALIGN = 128

    def __init__(self, modules: Dict[str, nn.Module], trials: int):
        self.order = tuple(modules)
        self.spans: Dict[str, Tuple[int, int]] = {}
        #: zeros after each parameter's elements, per module
        self._pads: Dict[str, List[int]] = {}
        params, offsets, off = [], [], 0
        for name, m in modules.items():
            start, pads = off, []
            for p in m.parameters():
                size = -(-p.numel() // self.ALIGN) * self.ALIGN
                params.append(p)
                offsets.append(off)
                pads.append(size - p.numel())
                off += size
            self.spans[name], self._pads[name] = (start, off), pads
        device = params[0].device
        self.buffer = torch.zeros(off, device=device)
        self._zeros = torch.zeros(self.ALIGN, device=device)
        with torch.no_grad():
            for p, o in zip(params, offsets):
                self.buffer[o:o + p.numel()].copy_(p.detach().reshape(-1))
                p.data = self.buffer[o:o + p.numel()].view_as(p)
        #: the trial of each element (every parameter leads with the trial
        #: axis; the gaps count as trial 0); None at T 1, where a (1,) lr
        #: broadcasts as it is
        self.trial = None
        if trials > 1:
            pieces = []
            for p, pad in zip(params, (n for name in self.order for n in self._pads[name])):
                pieces.append(torch.arange(trials, device=device)
                              .repeat_interleave(p[0].numel()))
                pieces.append(torch.zeros(pad, dtype=torch.long, device=device))
            self.trial = torch.cat(pieces)

    def span(self, keys: Sequence[str]) -> Tuple[int, int]:
        """[start, end) of the modules ``keys``, which must be adjacent and
        in the buffer's order."""
        spans = [self.spans[k] for k in keys]
        for (_, end), (start, _) in zip(spans, spans[1:]):
            if end != start:
                raise ValueError(f"modules {keys} are not adjacent in the flat buffer "
                                 f"(order {self.order})")
        return spans[0][0], spans[-1][1]

    def view(self, keys: Sequence[str], of: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The modules ``keys``' slice of the buffer (or of ``of``, a tensor
        laid out as it)."""
        start, end = self.span(keys)
        return (self.buffer if of is None else of)[start:end]

    def flatten(self, keys: Sequence[str], grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-parameter tensors of the modules ``keys``' parameters, in
        their order, as one flat tensor laid out as :meth:`view` (one
        concatenation, zeros in the gaps)."""
        pads = [n for k in keys for n in self._pads[k]]
        pieces = []
        for g, pad in zip(grads, pads):
            pieces.append(g.reshape(-1))
            if pad:
                pieces.append(self._zeros[:pad])
        return torch.cat(pieces)

    def lr(self, lr: torch.Tensor, keys: Sequence[str]) -> torch.Tensor:
        """A per-trial lr (T,) as one value per element of :meth:`view`."""
        if self.trial is None:
            return lr
        start, end = self.span(keys)
        return lr[self.trial[start:end]]


OPTIMIZERS: Dict[str, Callable[..., Optimizer]] = {
    "Adam": make_adam,
    "AdamW": make_adamw,
    "RAdam": make_radam,
    "AdaBound": make_adabound,
}


def make_optimizer(name: str, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                   **kw) -> Optimizer:
    if name not in OPTIMIZERS:
        raise ValueError(f"Unknown optimizer {name!r}; choose from {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](b1=betas[0], b2=betas[1], eps=eps, weight_decay=weight_decay, **kw)
