"""Decoders: latent styles (B, nstyle) -> spectrum (B, dim_out)
(counterpart of ``rankaae_tpu/models/decoders.py:22-54``).

The last-layer activation is ReLU or Softplus(beta=2) per
``decoder_activation``.
"""
from __future__ import annotations

import torch
from torch import nn

from rankaae_tpu_torch.models.primitives import BatchNorm, Dropout, Linear, PReLU, softplus_beta


def _last_act(name: str):
    if name == "ReLu":
        return torch.relu
    if name == "Softplus":
        return lambda x: softplus_beta(x, beta=2.0)
    raise ValueError(f'Unknown activation "{name}", use "ReLu" or "Softplus"')


class FCDecoder(nn.Module):
    """MLP decoder (reference ``model.py:518-570``): mirror of FCEncoder with
    a ReLU/Softplus head."""

    def __init__(self, nstyle: int = 5, dropout_rate: float = 0.2, dim_out: int = 256,
                 last_layer_activation: str = "ReLu", n_layers: int = 3,
                 hidden_size: int = 64):
        super().__init__()
        self.n_layers = n_layers
        self.act = _last_act(last_layer_activation)
        width = nstyle
        for i in range(n_layers - 1):
            self.add_module(f"lin{i}", Linear(width, hidden_size))
            self.add_module(f"prelu{i}", PReLU(hidden_size))
            self.add_module(f"bn{i}", BatchNorm(hidden_size))
            self.add_module(f"drop{i}", Dropout(dropout_rate))
            width = hidden_size
        self.lin_out = Linear(width, dim_out)

    def forward(self, z, sampler=None):
        x = z
        for i in range(self.n_layers - 1):
            x = getattr(self, f"lin{i}")(x)
            x = getattr(self, f"prelu{i}")(x)
            x = getattr(self, f"bn{i}")(x)
            x = getattr(self, f"drop{i}")(x, sampler)
        return self.act(self.lin_out(x))
