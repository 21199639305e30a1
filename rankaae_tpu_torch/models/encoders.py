"""Encoders: spectrum (B, dim_in) -> standardized latent styles (B, nstyle)
(counterpart of ``rankaae_tpu/models/encoders.py:17-42``).

The encoder ends in an affine-free BatchNorm so the latent is standardized —
that is what makes the N(0, I) adversarial prior meaningful.  Submodule names
follow the flax module's (``lin{i}``, ``prelu{i}``, ``bn{i}``, ``lin_out``,
``bn_style``) so the weight bridge maps them one to one.
"""
from __future__ import annotations

from torch import nn

from rankaae_tpu_torch.models.primitives import BatchNorm, Dropout, Linear, PReLU


class FCEncoder(nn.Module):
    """MLP encoder — the form every shipped config uses
    (reference ``model.py:330-378``; ``ae_form: FC``).

    [Linear -> PReLU -> BN -> Dropout] x (n_layers-1) -> Linear -> BN.
    """

    def __init__(self, nstyle: int = 5, dropout_rate: float = 0.2, dim_in: int = 256,
                 n_layers: int = 3, hidden_size: int = 64):
        super().__init__()
        self.n_layers = n_layers
        width = dim_in
        for i in range(n_layers - 1):
            self.add_module(f"lin{i}", Linear(width, hidden_size))
            self.add_module(f"prelu{i}", PReLU(hidden_size))
            self.add_module(f"bn{i}", BatchNorm(hidden_size))
            self.add_module(f"drop{i}", Dropout(dropout_rate))
            width = hidden_size
        self.lin_out = Linear(width, nstyle)
        self.bn_style = BatchNorm(nstyle)

    def forward(self, spec, sampler=None):
        x = spec
        for i in range(self.n_layers - 1):
            x = getattr(self, f"lin{i}")(x)
            x = getattr(self, f"prelu{i}")(x)
            x = getattr(self, f"bn{i}")(x)
            x = getattr(self, f"drop{i}")(x, sampler)
        return self.bn_style(self.lin_out(x))
