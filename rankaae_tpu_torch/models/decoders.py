"""Decoders: latent styles (B, nstyle) -> spectrum (B, dim_out)
(counterpart of ``rankaae_tpu/models/decoders.py:22-132``).

The last-layer activation is ReLU or Softplus(beta=2) per
``decoder_activation``.  Submodule names follow the flax modules'
(``dblock{i}``, ``eblock{i}``, ``bn_out``, ``conv_out``).  The conv
decoders end in stride-1 length-256 EncodingBlocks; in eval mode their
c_in == c_out ones run as the K3 kernel on the card (``models/blocks.py``;
stacked, one launch per trial).  Each ``Trial*`` class is its single-trial
class stacked T times: it takes (T, B, nstyle) and returns (T, B, dim_out).
With ``remat`` the conv decoders run each DecodingBlock and EncodingBlock
through ``blocks.run_block`` in train mode (the JAX modules' ``nn.remat``);
eval mode, and with it K3, is unchanged.
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
        layers = layers_of(self)
        self.n_layers = n_layers
        self.act = _last_act(last_layer_activation)
        width = nstyle
        for i in range(n_layers - 1):
            self.add_module(f"lin{i}", layers.linear(width, hidden_size))
            self.add_module(f"prelu{i}", layers.prelu(hidden_size))
            self.add_module(f"bn{i}", layers.batch_norm(hidden_size))
            self.add_module(f"drop{i}", layers.dropout(dropout_rate))
            width = hidden_size
        self.lin_out = layers.linear(width, dim_out)

    def forward(self, z, sampler=None):
        x = z
        for i in range(self.n_layers - 1):
            x = getattr(self, f"lin{i}")(x)
            x = getattr(self, f"prelu{i}")(x)
            x = getattr(self, f"bn{i}")(x)
            x = getattr(self, f"drop{i}")(x, sampler)
        return self.act(self.lin_out(x))


class TrialFCDecoder(TrialModule, FCDecoder):
    """``trials`` independent FC decoders over (T, B, nstyle)."""


class _ConvDecoder(nn.Module):
    """z -> DecodingBlocks (length 1 -> 256) -> stride-1 EncodingBlocks of
    length 256 and kernel 11 -> BN -> 1x1 Conv -> activation; each block
    under ``remat`` when it is set."""

    #: (c_in, c_out, in_len, excitation, out_len) of each DecodingBlock, with
    #: c_in None for nstyle
    DEC: tuple = ()
    #: (c_in, c_out) of each EncodingBlock
    ENC: tuple = ()

    def __init__(self, nstyle: int = 5, dropout_rate: float = 0.2, dim_out: int = 256,
                 last_layer_activation: str = "ReLu", n_layers: int = 3,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        layers = layers_of(self)
        encoding_block, decoding_block = blocks_of(self)
        self.act = _last_act(last_layer_activation)
        for i, (c_in, c_out, in_len, e, out_len) in enumerate(self.DEC):
            self.add_module(f"dblock{i}", decoding_block(
                nstyle if c_in is None else c_in, c_out, in_len, excitation=e,
                dropout_rate=dropout_rate, out_len=out_len))
        for i, (c_in, c_out) in enumerate(self.ENC):
            self.add_module(f"eblock{i}", encoding_block(
                c_in, c_out, in_len=256, out_len=dim_out if i == len(self.ENC) - 1 else 256,
                kernel_size=11, stride=1, excitation=2, dropout_rate=dropout_rate))
        c_last = self.ENC[-1][1]
        self.bn_out = layers.channel_batch_norm(c_last)
        self.conv_out = layers.conv(c_last, 1, 1)

    def forward(self, z, sampler=None):
        x = to_channels(self, z[..., None])
        for i in range(len(self.DEC)):
            x = run_block(getattr(self, f"dblock{i}"), x, sampler, self.remat)
        for i in range(len(self.ENC)):
            x = run_block(getattr(self, f"eblock{i}"), x, sampler, self.remat)
        return self.act(from_channels(self, self.conv_out(self.bn_out(x)))[..., 0, :])


class Decoder(_ConvDecoder):
    """Conv decoder ("normal" form, reference ``model.py:381-427``): 4
    DecodingBlocks, then 5 stride-1 EncodingBlocks (4->4, 4->4, 4->2, 2->2,
    2->2).  The output length is fixed at 256 by the architecture."""

    DEC = ((None, 8, 1, 1, -1), (8, 4, 4, 2, -1), (4, 4, 16, 2, -1), (4, 4, 64, 4, -1))
    ENC = ((4, 4), (4, 4), (4, 2), (2, 2), (2, 2))

    def __init__(self, nstyle: int = 5, dropout_rate: float = 0.2, dim_out: int = 256,
                 last_layer_activation: str = "ReLu", n_layers: int = 3,
                 remat: bool = False):
        # the flax Decoder ignores dim_out: every eblock is 256 -> 256
        super().__init__(nstyle, dropout_rate, 256, last_layer_activation, n_layers, remat)


class TrialDecoder(TrialModule, Decoder):
    """``trials`` independent "normal" decoders over (T, B, nstyle)."""


class CompactDecoder(_ConvDecoder):
    """Compact conv decoder (reference ``model.py:430-474``): 3
    DecodingBlocks (1 -> 8 -> 64 -> 256), then one 4->4 EncodingBlock."""

    DEC = ((None, 8, 1, 1, 8), (8, 4, 8, 2, 64), (4, 4, 64, 4, -1))
    ENC = ((4, 4),)


class TrialCompactDecoder(TrialModule, CompactDecoder):
    """``trials`` independent compact decoders over (T, B, nstyle)."""


class QvecDecoder(nn.Module):
    """MLP decoder to 12-dim q-vectors, main + shortcut summed (``qved``
    form; ``rankaae_tpu/models/decoders.py:135-165``, reference
    ``model.py:477-515``).  The last-layer activation acts inside the main
    branch, after ``main_lin2``; the sum is not activated."""

    def __init__(self, nstyle: int = 5, dropout_rate: float = 0.2, dim_out: int = 12,
                 last_layer_activation: str = "ReLu", n_layers: int = 3):
        super().__init__()
        layers = layers_of(self)
        self.act = _last_act(last_layer_activation)
        self.main_lin0 = layers.linear(nstyle, 4)
        self.main_bn0 = layers.batch_norm(4)
        self.main_lin1 = layers.linear(4, 6)
        self.main_bn1 = layers.batch_norm(6)
        self.main_lin2 = layers.linear(6, 8)
        self.main_drop = layers.dropout(dropout_rate)
        self.main_lin3 = layers.linear(8, dim_out)
        self.short_lin0 = layers.linear(nstyle, 8)
        self.short_drop = layers.dropout(dropout_rate)
        self.short_lin1 = layers.linear(8, dim_out)

    def forward(self, z, sampler=None):
        x = self.main_bn0(torch.relu(self.main_lin0(z)))
        x = self.main_bn1(torch.relu(self.main_lin1(x)))
        x = self.main_drop(self.act(self.main_lin2(x)), sampler)
        x = self.main_lin3(x)
        s = self.short_drop(torch.relu(self.short_lin0(z)), sampler)
        return x + self.short_lin1(s)


class TrialQvecDecoder(TrialModule, QvecDecoder):
    """``trials`` independent qved decoders over (T, B, nstyle)."""
