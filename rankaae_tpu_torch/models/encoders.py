"""Encoders: spectrum (B, dim_in) -> standardized latent styles (B, nstyle)
(counterpart of ``rankaae_tpu/models/encoders.py:17-99``).

The encoder ends in an affine-free BatchNorm so the latent is standardized —
that is what makes the N(0, I) adversarial prior meaningful.  Submodule names
follow the flax module's (``lin{i}``, ``prelu{i}``, ``bn{i}``, ``lin_out``,
``block{i}``, ``lin3``, ``bn_style``) so the weight bridge maps them one to
one.  Each ``Trial*`` class is its single-trial class stacked T times: it
takes (T, B, dim_in) and returns (T, B, nstyle); inside, the conv encoders'
blocks run over (B, T*C, L) (``models/primitives.py``).  With ``remat``
the conv encoders run each block through ``blocks.run_block``, which
recomputes its activations in the backward (the JAX modules'
``nn.remat``); the FC and qved encoders have no block to wrap.
"""
from __future__ import annotations

import torch
from torch import nn

from rankaae_tpu_torch.models.blocks import blocks_of, run_block
from rankaae_tpu_torch.models.primitives import (
    TrialModule,
    from_channels,
    layers_of,
    softplus_beta,
    to_channels,
)


class FCEncoder(nn.Module):
    """MLP encoder — the form every shipped config uses
    (reference ``model.py:330-378``; ``ae_form: FC``).

    [Linear -> PReLU -> BN -> Dropout] x (n_layers-1) -> Linear -> BN.
    """

    def __init__(self, nstyle: int = 5, dropout_rate: float = 0.2, dim_in: int = 256,
                 n_layers: int = 3, hidden_size: int = 64):
        super().__init__()
        layers = layers_of(self)
        self.n_layers = n_layers
        width = dim_in
        for i in range(n_layers - 1):
            self.add_module(f"lin{i}", layers.linear(width, hidden_size))
            self.add_module(f"prelu{i}", layers.prelu(hidden_size))
            self.add_module(f"bn{i}", layers.batch_norm(hidden_size))
            self.add_module(f"drop{i}", layers.dropout(dropout_rate))
            width = hidden_size
        self.lin_out = layers.linear(width, nstyle)
        self.bn_style = layers.batch_norm(nstyle)

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
    """(B, L) -> stride-2 EncodingBlocks -> flatten to 32 -> Linear -> BN;
    each block under ``remat`` when it is set."""

    SPECS: tuple = ()

    def __init__(self, nstyle: int = 5, dropout_rate: float = 0.2, dim_in: int = 256,
                 n_layers: int = 3, remat: bool = False):
        super().__init__()
        self.remat = remat
        layers = layers_of(self)
        encoding_block, _ = blocks_of(self)
        self.n_blocks = len(self.SPECS)
        for i, (c_in, c_out, in_len, out_len, k, e) in enumerate(self.SPECS):
            in_len = dim_in if i == 0 else in_len
            self.add_module(f"block{i}", encoding_block(
                c_in, c_out, in_len, out_len, kernel_size=k, stride=2, excitation=e,
                dropout_rate=dropout_rate))
        self.lin3 = layers.linear(32, nstyle)
        self.bn_style = layers.batch_norm(nstyle)

    def forward(self, spec, sampler=None):
        x = to_channels(self, spec[..., None, :])
        for i in range(self.n_blocks):
            x = run_block(getattr(self, f"block{i}"), x, sampler, self.remat)
        x = from_channels(self, x)
        return self.bn_style(self.lin3(x.reshape(*x.shape[:-2], 32)))


class Encoder(_ConvEncoder):
    """5-block conv encoder ("normal" form, reference ``model.py:232-261``).
    Block specs: (c_in, c_out, in_len, out_len, kernel, excitation)."""

    SPECS = ((1, 4, 256, 128, 11, 4), (4, 4, 128, 64, 11, 4), (4, 4, 64, 32, 7, 2),
             (4, 4, 32, 16, 7, 2), (4, 4, 16, 8, 5, 1))


class TrialEncoder(TrialModule, Encoder):
    """``trials`` independent "normal" encoders over (T, B, 256)."""


class CompactEncoder(_ConvEncoder):
    """3-block conv encoder (reference ``model.py:264-295``)."""

    SPECS = ((1, 4, 256, 64, 11, 4), (4, 4, 64, 16, 7, 2), (4, 4, 16, 8, 5, 1))


class TrialCompactEncoder(TrialModule, CompactEncoder):
    """``trials`` independent compact encoders over (T, B, 256)."""


class QvecEncoder(nn.Module):
    """MLP encoder over 12-dim q-vectors, main + shortcut summed (``qved``
    form; ``rankaae_tpu/models/encoders.py:102-132``, reference
    ``model.py:298-327``)."""

    def __init__(self, nstyle: int = 5, dropout_rate: float = 0.2, dim_in: int = 12,
                 n_layers: int = 3):
        super().__init__()
        layers = layers_of(self)
        self.main_lin0 = layers.linear(dim_in, 8)
        self.main_drop = layers.dropout(dropout_rate)
        self.main_lin1 = layers.linear(8, 6)
        self.main_bn1 = layers.batch_norm(6)
        self.main_lin2 = layers.linear(6, 4)
        self.main_bn2 = layers.batch_norm(4)
        self.main_lin3 = layers.linear(4, nstyle)
        self.main_bn3 = layers.batch_norm(nstyle)
        self.short_lin0 = layers.linear(dim_in, 8)
        self.short_drop = layers.dropout(dropout_rate)
        self.short_lin1 = layers.linear(8, nstyle)
        self.short_bn = layers.batch_norm(nstyle)

    def forward(self, q_vec, sampler=None):
        x = self.main_drop(torch.relu(self.main_lin0(q_vec)), sampler)
        x = self.main_bn1(torch.relu(self.main_lin1(x)))
        x = self.main_bn2(softplus_beta(self.main_lin2(x), beta=2.0))
        x = self.main_bn3(self.main_lin3(x))
        s = self.short_drop(torch.relu(self.short_lin0(q_vec)), sampler)
        return x + self.short_bn(self.short_lin1(s))


class TrialQvecEncoder(TrialModule, QvecEncoder):
    """``trials`` independent qved encoders over (T, B, 12)."""
