"""Decoders: latent styles (B, nstyle) -> spectrum (B, dim_out)
(counterpart of ``rankaae_tpu/models/decoders.py:22-132``).

The last-layer activation is ReLU or Softplus(beta=2) per
``decoder_activation``.  Submodule names follow the flax modules'
(``dblock{i}``, ``eblock{i}``, ``bn_out``, ``conv_out``).  The conv
decoders end in stride-1 length-256 EncodingBlocks; in eval mode their
c_in == c_out ones run as the K3 kernel on the card (``models/blocks.py``).
``TrialFCDecoder`` is ``FCDecoder`` stacked on a leading trial axis.
"""
from __future__ import annotations

import torch
from torch import nn

from rankaae_tpu_torch.models.blocks import DecodingBlock, EncodingBlock
from rankaae_tpu_torch.models.primitives import (
    BatchNorm,
    Conv1d,
    Dropout,
    TrialModule,
    layers_of,
    softplus_beta,
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
        lin, prelu, bn = layers_of(self)
        self.n_layers = n_layers
        self.act = _last_act(last_layer_activation)
        width = nstyle
        for i in range(n_layers - 1):
            self.add_module(f"lin{i}", lin(width, hidden_size))
            self.add_module(f"prelu{i}", prelu(hidden_size))
            self.add_module(f"bn{i}", bn(hidden_size))
            self.add_module(f"drop{i}", Dropout(dropout_rate))
            width = hidden_size
        self.lin_out = lin(width, dim_out)

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
    length 256 and kernel 11 -> BN -> 1x1 Conv -> activation."""

    #: (c_in, c_out, in_len, excitation, out_len) of each DecodingBlock, with
    #: c_in None for nstyle
    DEC: tuple = ()
    #: (c_in, c_out) of each EncodingBlock
    ENC: tuple = ()

    def __init__(self, nstyle: int = 5, dropout_rate: float = 0.2, dim_out: int = 256,
                 last_layer_activation: str = "ReLu", n_layers: int = 3):
        super().__init__()
        self.act = _last_act(last_layer_activation)
        for i, (c_in, c_out, in_len, e, out_len) in enumerate(self.DEC):
            self.add_module(f"dblock{i}", DecodingBlock(
                nstyle if c_in is None else c_in, c_out, in_len, excitation=e,
                dropout_rate=dropout_rate, out_len=out_len))
        for i, (c_in, c_out) in enumerate(self.ENC):
            self.add_module(f"eblock{i}", EncodingBlock(
                c_in, c_out, in_len=256, out_len=dim_out if i == len(self.ENC) - 1 else 256,
                kernel_size=11, stride=1, excitation=2, dropout_rate=dropout_rate))
        c_last = self.ENC[-1][1]
        self.bn_out = BatchNorm(c_last)
        self.conv_out = Conv1d(c_last, 1, 1)

    def forward(self, z, sampler=None):
        x = z[:, :, None]
        for i in range(len(self.DEC)):
            x = getattr(self, f"dblock{i}")(x, sampler)
        for i in range(len(self.ENC)):
            x = getattr(self, f"eblock{i}")(x, sampler)
        return self.act(self.conv_out(self.bn_out(x))[:, 0, :])


class Decoder(_ConvDecoder):
    """Conv decoder ("normal" form, reference ``model.py:381-427``): 4
    DecodingBlocks, then 5 stride-1 EncodingBlocks (4->4, 4->4, 4->2, 2->2,
    2->2).  The output length is fixed at 256 by the architecture."""

    DEC = ((None, 8, 1, 1, -1), (8, 4, 4, 2, -1), (4, 4, 16, 2, -1), (4, 4, 64, 4, -1))
    ENC = ((4, 4), (4, 4), (4, 2), (2, 2), (2, 2))

    def __init__(self, nstyle: int = 5, dropout_rate: float = 0.2, dim_out: int = 256,
                 last_layer_activation: str = "ReLu", n_layers: int = 3):
        # the flax Decoder ignores dim_out: every eblock is 256 -> 256
        super().__init__(nstyle, dropout_rate, 256, last_layer_activation, n_layers)


class CompactDecoder(_ConvDecoder):
    """Compact conv decoder (reference ``model.py:430-474``): 3
    DecodingBlocks (1 -> 8 -> 64 -> 256), then one 4->4 EncodingBlock."""

    DEC = ((None, 8, 1, 1, 8), (8, 4, 8, 2, 64), (4, 4, 64, 4, -1))
    ENC = ((4, 4),)
