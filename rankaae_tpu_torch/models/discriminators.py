"""Latent-space discriminators with gradient reversal and train-mode noise
(counterpart of ``rankaae_tpu/models/discriminators.py:26-88``; reference
``sc/clustering/model.py:573-663``).

Both add N(0, noise) to the input **in training mode only** and pass it
through the GRL before the classifier.  ``beta=None`` skips the reversal.
Each ``Trial*`` class is its single-trial class stacked T times: it takes
(T, B, nstyle) and a per-trial ``beta`` of shape (T, 1, 1); the CNN one runs
its convolutions over (B, T*C, 64) and takes its ``log_softmax`` per trial.
"""
from __future__ import annotations

import torch
from torch import nn

from rankaae_tpu_torch.models.grl import grad_reverse
from rankaae_tpu_torch.models.primitives import TrialModule, from_channels, layers_of, to_channels


def _noise_and_reverse(module, x, beta, sampler):
    if module.training and module.noise > 0:
        if sampler is None:
            raise ValueError("train-mode discriminator noise needs a sampler")
        # drawn in float32, used in x's dtype (JAX draws it in x's dtype)
        x = x + module.noise * sampler.normal("dis_noise", x.shape).to(x.dtype)
    return x if beta is None else grad_reverse(x, beta)


class DiscriminatorFC(nn.Module):
    """MLP discriminator -> single logit (default in shipped configs)."""

    def __init__(self, nstyle: int = 5, hidden_size: int = 64, dropout_rate: float = 0.2,
                 noise: float = 0.1, layers: int = 3):
        super().__init__()
        make = layers_of(self)
        self.layers = layers
        self.noise = float(noise)
        width = nstyle
        for i in range(layers - 1):
            self.add_module(f"lin{i}", make.linear(width, hidden_size))
            self.add_module(f"prelu{i}", make.prelu(hidden_size))
            self.add_module(f"drop{i}", make.dropout(dropout_rate))
            width = hidden_size
        self.lin_out = make.linear(width, 1)

    def forward(self, x, beta=None, sampler=None):
        out = _noise_and_reverse(self, x, beta, sampler)
        for i in range(self.layers - 1):
            out = getattr(self, f"lin{i}")(out)
            out = getattr(self, f"prelu{i}")(out)
            out = getattr(self, f"drop{i}")(out, sampler)
        return self.lin_out(out)


class TrialDiscriminatorFC(TrialModule, DiscriminatorFC):
    """``trials`` independent FC discriminators over (T, B, nstyle)."""


class DiscriminatorCNN(nn.Module):
    """CNN discriminator -> 2-class log-probabilities (reference
    ``model.py:573-628``): the 64-dim embedding is treated as a length-64
    1-channel signal through 5 replicate-padded convs."""

    def __init__(self, nstyle: int = 5, hidden_size: int = 64, channels: int = 2,
                 kernel_size: int = 5, dropout_rate: float = 0.2, noise: float = 0.1):
        super().__init__()
        layers = layers_of(self)
        self.noise = float(noise)
        self.pre_lin = layers.linear(nstyle, hidden_size)
        self.pre_prelu = layers.prelu(hidden_size)
        ch = channels
        self.chans = [(1, ch), (ch, ch), (ch, ch), (ch, ch), (ch, 1)]
        for i, (ci, co) in enumerate(self.chans):
            self.add_module(f"bn{i}", layers.channel_batch_norm(ci))
            self.add_module(f"conv{i}", layers.conv(ci, co, kernel_size,
                                                    padding=(kernel_size - 1) // 2,
                                                    padding_mode="replicate"))
            self.add_module(f"prelu{i}", layers.channel_prelu(co))
        self.post_bn = layers.batch_norm(hidden_size)
        self.post_drop = layers.dropout(dropout_rate)
        self.post_lin = layers.linear(hidden_size, 2)

    def forward(self, x, beta=None, sampler=None):
        x = _noise_and_reverse(self, x, beta, sampler)
        x = to_channels(self, self.pre_prelu(self.pre_lin(x))[..., None, :])
        for i in range(len(self.chans)):
            x = getattr(self, f"prelu{i}")(getattr(self, f"conv{i}")(getattr(self, f"bn{i}")(x)))
        x = self.post_drop(self.post_bn(from_channels(self, x)[..., 0, :]), sampler)
        return torch.log_softmax(self.post_lin(x), dim=-1)


class TrialDiscriminatorCNN(TrialModule, DiscriminatorCNN):
    """``trials`` independent CNN discriminators over (T, B, nstyle)."""
