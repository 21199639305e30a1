"""Gradient reversal as a ``torch.autograd.Function`` (counterpart of
``rankaae_tpu/models/grl.py:17-37``; reference ``sc/clustering/model.py:8-22``).

Identity in the forward pass; the backward multiplies the incoming gradient
by ``-beta``.  That is what lets one backward of the adversarial loss train
the discriminator normally and the encoder adversarially.
"""
from __future__ import annotations

import torch


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, beta):
        ctx.save_for_backward(beta)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (beta,) = ctx.saved_tensors
        # the gradient stays in the primal's dtype (``grl.py:33-34`` in the
        # JAX package)
        return (-g * beta).to(g.dtype), None


def grad_reverse(x: torch.Tensor, beta) -> torch.Tensor:
    """Identity forward; ``dL/dx = -beta * g`` backward.  ``beta`` may be a
    Python number, a 0-d tensor, or a per-trial tensor of shape (T, 1, 1)
    for a (T, B, C) input (``alpha_limit`` and ``alpha_flat_step`` may
    differ between trials).  ``beta`` is taken in ``x``'s dtype, as the JAX
    discriminators pass it (``discriminators.py:42,70``)."""
    beta = torch.as_tensor(beta, device=x.device).to(x.dtype)
    return _GradReverse.apply(x, beta)
