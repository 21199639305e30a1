"""Latent-space discriminator with gradient reversal and train-mode noise
(counterpart of ``rankaae_tpu/models/discriminators.py:26-49``; reference
``sc/clustering/model.py:631-663``).

It adds N(0, noise) to the input **in training mode only** and passes it
through the GRL before the classifier.  ``beta=None`` skips the reversal.
"""
from __future__ import annotations

from torch import nn

from rankaae_tpu_torch.models.grl import grad_reverse
from rankaae_tpu_torch.models.primitives import Dropout, Linear, PReLU


class DiscriminatorFC(nn.Module):
    """MLP discriminator -> single logit (default in shipped configs)."""

    def __init__(self, nstyle: int = 5, hidden_size: int = 64, dropout_rate: float = 0.2,
                 noise: float = 0.1, layers: int = 3):
        super().__init__()
        self.layers = layers
        self.noise = float(noise)
        width = nstyle
        for i in range(layers - 1):
            self.add_module(f"lin{i}", Linear(width, hidden_size))
            self.add_module(f"prelu{i}", PReLU(hidden_size))
            self.add_module(f"drop{i}", Dropout(dropout_rate))
            width = hidden_size
        self.lin_out = Linear(width, 1)

    def forward(self, x, beta=None, sampler=None):
        if self.training and self.noise > 0:
            if sampler is None:
                raise ValueError("train-mode discriminator noise needs a sampler")
            x = x + self.noise * sampler.normal("dis_noise", x.shape)
        if beta is not None:
            x = grad_reverse(x, beta)
        out = x
        for i in range(self.layers - 1):
            out = getattr(self, f"lin{i}")(out)
            out = getattr(self, f"prelu{i}")(out)
            out = getattr(self, f"drop{i}")(out, sampler)
        return self.lin_out(out)
