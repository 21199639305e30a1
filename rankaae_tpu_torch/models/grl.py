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
        # the gradient stays in the primal's dtype (beta is an f32 scalar)
        return (-g * beta).to(g.dtype), None


def grad_reverse(x: torch.Tensor, beta) -> torch.Tensor:
    """Identity forward; ``dL/dx = -beta * g`` backward.  ``beta`` may be a
    Python number or a 0-d tensor (the alpha ramp lives on the device)."""
    beta = torch.as_tensor(beta, dtype=torch.float32, device=x.device)
    return _GradReverse.apply(x, beta)
