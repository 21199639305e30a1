"""Residual conv blocks of the "normal"/"compact" forms (counterpart of
``rankaae_tpu/models/blocks.py:24-136``; reference
``sc/clustering/model.py:24-174``).

Each block sums three branches — a 2-conv main path, a strided/grouped
shortcut, and a squeeze-excitation-like MLP over the length axis — with
per-channel PReLU (init 0.01) and affine-free BatchNorm throughout.
Submodule names are the flax module's, so the weight bridge maps them one to
one.  The blocks build their layers through ``primitives.layers_of``:
``TrialEncodingBlock`` and ``TrialDecodingBlock`` are the blocks stacked T
times, over (B, T*C, L) with trial t's channels at [t*C, (t+1)*C).

In eval mode, an :class:`EncodingBlock` of K3's shape (stride 1, c_in ==
c_out in (2, 4), length 256, 11 taps, excitation 2: the decoders' tail) runs
as ``ops/fused_block_cuda.fused_block``, which launches the K3 kernel on a
CUDA tensor; stacked, it launches K3 once per trial
(``fused_block_trials``).  Every other block, and every block in train
mode, runs its modules one by one.  K3 is a float32 kernel: under
bfloat16 activations the fused block takes a float32 copy of its input and
casts K3's output back, so K3 still runs (its bfloat16 instantiation is
kernel work for later, ROADMAP §2); the result differs from the JAX
package's bfloat16 block, which rounds at each primitive, by
bfloat16-sized amounts.

``remat`` (the JAX package's ``nn.remat`` over the conv blocks,
``rankaae_tpu/models/encoders.py:66-67``, ``decoders.py:80-83``): the
encoders and decoders run each block through :func:`run_block`, which in
train mode under autograd wraps it in ``torch.utils.checkpoint`` (not
reentrant), so the backward recomputes the block's activations instead of
keeping them.  flax's remat is functional, and two things of a torch block
are not: its train-mode BatchNorms update their running statistics in
place, and its dropout draws from the caller's generators, which
``checkpoint`` does not restore.  So the first call keeps the keep-masks
it draws, and every recompute (one a backward through the graph: the fused
protocol runs several) replays them and puts the block's running
statistics back as it found them.  The numbers are those of the block run
without ``remat``: outputs, gradients, statistics and generator states.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from rankaae_tpu_torch.models.primitives import TrialModule, layers_of
from rankaae_tpu_torch.ops import fused_block_cuda


class EncodingBlock(nn.Module):
    """Downsampling residual block (reference ``model.py:24-100``).

    Input (B, in_channels, in_len) -> (B, out_channels, out_len).
    Main: [BN] -> Conv(k, stride=in_len//(out_len*stride), replicate pad) -> PReLU
          -> BN -> Conv(k, stride, zero pad) -> PReLU.
    Shortcut (when shape changes): grouped Conv(k=s=in_len//out_len) -> PReLU.
    Excitation: [Dropout] -> Linear(in_len->excitation) -> PReLU
          -> Linear(excitation->out_len) -> PReLU [-> BN -> 1x1 grouped Conv -> PReLU].
    """

    def __init__(self, in_channels: int, out_channels: int, in_len: int, out_len: int,
                 kernel_size: int = 7, stride: int = 2, excitation: int = 4,
                 dropout_rate: float = 0.2):
        super().__init__()
        layers = layers_of(self)
        c_in, c_out, k = in_channels, out_channels, kernel_size
        self.has_bn1 = c_in > 1
        self.has_short = stride > 1 or c_in != c_out
        self.has_dropout = in_len > 10
        self.has_excit_conv = c_in != c_out
        self.fused = (stride == 1 and c_in == c_out and c_in in fused_block_cuda.CHANNELS
                      and in_len == out_len == fused_block_cuda.L
                      and k == fused_block_cuda.K and excitation == fused_block_cuda.E)
        if self.has_bn1:
            self.bn1 = layers.channel_batch_norm(c_in)
        self.conv1 = layers.conv(c_in, c_out, k, stride=in_len // (out_len * stride),
                                 padding=(k - 1) // 2, padding_mode="replicate")
        self.relu1 = layers.channel_prelu(c_out)
        self.bn2 = layers.channel_batch_norm(c_out)
        self.conv2 = layers.conv(c_out, c_out, k, stride=stride, padding=(k - 1) // 2)
        self.relu2 = layers.channel_prelu(c_out)
        if self.has_short:
            self.conv_short = layers.conv(c_in, c_out, in_len // out_len,
                                          stride=in_len // out_len, groups=math.gcd(c_in, c_out))
            self.relu_short = layers.channel_prelu(c_out)
        if self.has_dropout:
            self.dropout_1 = layers.channel_dropout(dropout_rate)
        self.fc1 = layers.length_linear(in_len, excitation)
        self.relu_excit_1 = layers.channel_prelu(c_in)
        self.fc2 = layers.length_linear(excitation, out_len)
        self.relu_excit_2 = layers.channel_prelu(c_in)
        if self.has_excit_conv:
            self.bn_excit = layers.channel_batch_norm(c_in)
            self.conv_excit = layers.conv(c_in, c_out, 1, groups=math.gcd(c_in, c_out))
            self.relu_excit_3 = layers.channel_prelu(c_out)

    def forward(self, x, sampler=None):
        if self.fused and not self.training:
            params = (self.bn1.running_mean, self.bn1.running_var,
                      self.conv1.weight, self.conv1.bias, self.relu1.weight,
                      self.bn2.running_mean, self.bn2.running_var,
                      self.conv2.weight, self.conv2.bias, self.relu2.weight,
                      self.fc1.weight, self.fc1.bias, self.relu_excit_1.weight,
                      self.fc2.weight, self.fc2.bias, self.relu_excit_2.weight)
            if isinstance(self, TrialModule):
                return fused_block_cuda.fused_block_trials(x.float(), *params).to(x.dtype)
            return fused_block_cuda.fused_block(x.float().contiguous(), *params).to(x.dtype)
        out = self.bn1(x) if self.has_bn1 else x
        residual = out
        out = self.relu1(self.conv1(out))
        out = self.relu2(self.conv2(self.bn2(out)))
        res = self.relu_short(self.conv_short(residual)) if self.has_short else residual
        excit = self.dropout_1(residual, sampler) if self.has_dropout else residual
        return out + res + _excitation(self, excit)


class DecodingBlock(nn.Module):
    """Upsampling residual block (reference ``model.py:103-174``).

    Mirror of :class:`EncodingBlock` built on transposed convs, all with
    kernel == stride.  Default ``out_len = 4 * in_len``.
    """

    def __init__(self, in_channels: int, out_channels: int, in_len: int,
                 excitation: int = 4, dropout_rate: float = 0.2, out_len: int = -1):
        super().__init__()
        layers = layers_of(self)
        c_in, c_out = in_channels, out_channels
        out_len = out_len if out_len > 0 else in_len * 4
        self.has_bn1 = in_len > 1
        self.has_dropout = in_len > 10
        self.has_excit_conv = c_in != c_out
        if self.has_bn1:
            self.bn1 = layers.channel_batch_norm(c_in)
        self.conv1 = layers.conv_transpose(c_in, c_out, kernel_size=2, stride=2)
        self.relu1 = layers.channel_prelu(c_out)
        self.bn2 = layers.channel_batch_norm(c_out)
        s2 = out_len // (in_len * 2)
        self.conv2 = layers.conv_transpose(c_out, c_out, kernel_size=s2, stride=s2)
        self.relu2 = layers.channel_prelu(c_out)
        ss = out_len // in_len
        self.conv_short = layers.conv_transpose(c_in, c_out, kernel_size=ss, stride=ss,
                                                groups=math.gcd(c_in, c_out))
        self.relu_short = layers.channel_prelu(c_out)
        if self.has_dropout:
            self.dropout_1 = layers.channel_dropout(dropout_rate)
        self.fc1 = layers.length_linear(in_len, excitation)
        self.relu_excit_1 = layers.channel_prelu(c_in)
        self.fc2 = layers.length_linear(excitation, out_len)
        self.relu_excit_2 = layers.channel_prelu(c_in)
        if self.has_excit_conv:
            self.bn_excit = layers.channel_batch_norm(c_in)
            self.conv_excit = layers.conv(c_in, c_out, 1, groups=math.gcd(c_in, c_out))
            self.relu_excit_3 = layers.channel_prelu(c_out)

    def forward(self, x, sampler=None):
        out = self.bn1(x) if self.has_bn1 else x
        residual = out
        out = self.relu1(self.conv1(out))
        out = self.relu2(self.conv2(self.bn2(out)))
        res = self.relu_short(self.conv_short(residual))
        excit = self.dropout_1(residual, sampler) if self.has_dropout else residual
        return out + res + _excitation(self, excit)


def _excitation(block, excit):
    """The excitation branch after its dropout: Linear -> PReLU -> Linear ->
    PReLU [-> BN -> 1x1 grouped Conv -> PReLU when the channels change]."""
    excit = block.relu_excit_2(block.fc2(block.relu_excit_1(block.fc1(excit))))
    if block.has_excit_conv:
        excit = block.relu_excit_3(block.conv_excit(block.bn_excit(excit)))
    return excit


class TrialEncodingBlock(TrialModule, EncodingBlock):
    """``trials`` independent :class:`EncodingBlock`s over (B, T*C_in, L)."""


class TrialDecodingBlock(TrialModule, DecodingBlock):
    """``trials`` independent :class:`DecodingBlock`s over (B, T*C_in, L)."""


def blocks_of(module: nn.Module):
    """The (EncodingBlock, DecodingBlock) classes ``module`` builds from:
    the stacked ones bound to its ``trials`` for a ``TrialModule``."""
    if not isinstance(module, TrialModule):
        return EncodingBlock, DecodingBlock
    return (functools.partial(TrialEncodingBlock, module.trials),
            functools.partial(TrialDecodingBlock, module.trials))


class _Remat:
    """One checkpointed call of ``block``.  The first call is the forward:
    it asks ``sampler`` for the dropout keep-masks (this object stands in
    for it) and keeps them.  Every later call is a recompute in a backward:
    it replays the masks in order and restores the block's running
    statistics after it."""

    def __init__(self, block: nn.Module, sampler):
        self.block, self.sampler = block, sampler
        self.masks, self.next, self.called = [], 0, False

    def __call__(self, x):
        stand_in = None if self.sampler is None else self
        self.next = 0
        if not self.called:
            self.called = True
            return self.block(x, stand_in)
        saved = [b.clone() for b in self.block.buffers()]
        try:
            return self.block(x, stand_in)
        finally:
            with torch.no_grad():
                for b, s in zip(self.block.buffers(), saved):
                    b.copy_(s)

    def keep_mask(self, shape, keep):
        if self.next == len(self.masks):        # the first call draws
            self.masks.append(self.sampler.keep_mask(shape, keep))
        self.next += 1
        return self.masks[self.next - 1]


def run_block(block: nn.Module, x, sampler, remat: bool):
    """``block(x, sampler)``; with ``remat``, in train mode under autograd,
    through ``torch.utils.checkpoint`` with the masks replayed and the
    running statistics restored in each recompute (module docstring)."""
    if not (remat and block.training and torch.is_grad_enabled()):
        return block(x, sampler)
    return checkpoint(_Remat(block, sampler), x, use_reentrant=False,
                      preserve_rng_state=False)
