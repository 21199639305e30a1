"""Encoders: spectrum (B, dim_in) -> standardized latent styles (B, nstyle)
(counterpart of ``rankaae_tpu/models/encoders.py:17-99``).

The encoder ends in an affine-free BatchNorm so the latent is standardized —
that is what makes the N(0, I) adversarial prior meaningful.  Submodule names
follow the flax module's (``lin{i}``, ``prelu{i}``, ``bn{i}``, ``lin_out``,
``block{i}``, ``lin3``, ``bn_style``) so the weight bridge maps them one to
one.  ``TrialFCEncoder`` is ``FCEncoder`` stacked on a leading trial axis.
"""
from __future__ import annotations

from torch import nn

from rankaae_tpu_torch.models.blocks import EncodingBlock
from rankaae_tpu_torch.models.primitives import BatchNorm, Dropout, Linear, TrialModule, layers_of


class FCEncoder(nn.Module):
    """MLP encoder — the form every shipped config uses
    (reference ``model.py:330-378``; ``ae_form: FC``).

    [Linear -> PReLU -> BN -> Dropout] x (n_layers-1) -> Linear -> BN.
    """

    def __init__(self, nstyle: int = 5, dropout_rate: float = 0.2, dim_in: int = 256,
                 n_layers: int = 3, hidden_size: int = 64):
        super().__init__()
        lin, prelu, bn = layers_of(self)
        self.n_layers = n_layers
        width = dim_in
        for i in range(n_layers - 1):
            self.add_module(f"lin{i}", lin(width, hidden_size))
            self.add_module(f"prelu{i}", prelu(hidden_size))
            self.add_module(f"bn{i}", bn(hidden_size))
            self.add_module(f"drop{i}", Dropout(dropout_rate))
            width = hidden_size
        self.lin_out = lin(width, nstyle)
        self.bn_style = bn(nstyle)

    def forward(self, spec, sampler=None):
        x = spec
        for i in range(self.n_layers - 1):
            x = getattr(self, f"lin{i}")(x)
            x = getattr(self, f"prelu{i}")(x)
            x = getattr(self, f"bn{i}")(x)
            x = getattr(self, f"drop{i}")(x, sampler)
        return self.bn_style(self.lin_out(x))


class TrialFCEncoder(TrialModule, FCEncoder):
    """``trials`` independent FC encoders over (T, B, dim_in)."""


class _ConvEncoder(nn.Module):
    """(B, L) -> stride-2 EncodingBlocks -> flatten to 32 -> Linear -> BN."""

    SPECS: tuple = ()

    def __init__(self, nstyle: int = 5, dropout_rate: float = 0.2, dim_in: int = 256,
                 n_layers: int = 3):
        super().__init__()
        self.n_blocks = len(self.SPECS)
        for i, (c_in, c_out, in_len, out_len, k, e) in enumerate(self.SPECS):
            in_len = dim_in if i == 0 else in_len
            self.add_module(f"block{i}", EncodingBlock(
                c_in, c_out, in_len, out_len, kernel_size=k, stride=2, excitation=e,
                dropout_rate=dropout_rate))
        self.lin3 = Linear(32, nstyle)
        self.bn_style = BatchNorm(nstyle)

    def forward(self, spec, sampler=None):
        x = spec[:, None, :]
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x, sampler)
        return self.bn_style(self.lin3(x.reshape(x.shape[0], 32)))


class Encoder(_ConvEncoder):
    """5-block conv encoder ("normal" form, reference ``model.py:232-261``).
    Block specs: (c_in, c_out, in_len, out_len, kernel, excitation)."""

    SPECS = ((1, 4, 256, 128, 11, 4), (4, 4, 128, 64, 11, 4), (4, 4, 64, 32, 7, 2),
             (4, 4, 32, 16, 7, 2), (4, 4, 16, 8, 5, 1))


class CompactEncoder(_ConvEncoder):
    """3-block conv encoder (reference ``model.py:264-295``)."""

    SPECS = ((1, 4, 256, 64, 11, 4), (4, 4, 64, 16, 7, 2), (4, 4, 16, 8, 5, 1))
