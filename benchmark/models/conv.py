"""The reference's "normal" and "compact" conv autoencoders and its FC
discriminator, as a model module of the plain reference (the interface is
in :mod:`benchmark.reference`'s docstring).

The encoders and decoders are built from EncodingBlocks and DecodingBlocks
(``sc/clustering/model.py:24-174,232-295,381-474`` of the reference
package); ``ae_form`` picks the form.  The discriminator is DiscriminatorFC
(``model.py:631-663``) behind the gradient-reversal layer.  Beside each
forward: its weights' layout and its multiply-adds per spectrum.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import Layout, Net, grad_reverse

#: (c_in, c_out, in_len, out_len, kernel, excitation) of the encoders'
#: stride-2 EncodingBlocks (model.py:232-295); the first block's in_len is
#: the spectrum's length
ENCODERS = {
    "normal": ((1, 4, 256, 128, 11, 4), (4, 4, 128, 64, 11, 4), (4, 4, 64, 32, 7, 2),
               (4, 4, 32, 16, 7, 2), (4, 4, 16, 8, 5, 1)),
    "compact": ((1, 4, 256, 64, 11, 4), (4, 4, 64, 16, 7, 2), (4, 4, 16, 8, 5, 1)),
}
#: the decoders (model.py:381-474): (c_in, c_out, in_len, excitation, out_len)
#: of each DecodingBlock (c_in None: nstyle; out_len -1: 4 in_len), then
#: (c_in, c_out) of each stride-1 length-256 EncodingBlock (kernel 11,
#: excitation 2)
DECODERS = {
    "normal": (((None, 8, 1, 1, -1), (8, 4, 4, 2, -1), (4, 4, 16, 2, -1), (4, 4, 64, 4, -1)),
               ((4, 4), (4, 4), (4, 2), (2, 2), (2, 2))),
    "compact": (((None, 8, 1, 1, 8), (8, 4, 8, 2, 64), (4, 4, 64, 4, -1)), ((4, 4),)),
}


def decoder_blocks(cfg):
    """The decoder's (c_in, c_out, in_len, excitation, out_len) DecodingBlocks
    with nstyle and out_len filled in, and its (c_in, c_out) EncodingBlocks."""
    dec, enc = DECODERS[cfg["ae_form"]]
    blocks = []
    for c_in, c_out, in_len, e, out_len in dec:
        blocks.append((cfg["nstyle"] if c_in is None else c_in, c_out, in_len, e,
                       out_len if out_len > 0 else 4 * in_len))
    return blocks, enc


# --------------------------------------------------------------------------- #
# the weights' layout
# --------------------------------------------------------------------------- #

def _encoding_block_layout(lay, p, c_in, c_out, in_len, out_len, k, stride, e):
    g = math.gcd(c_in, c_out)
    if c_in > 1:
        lay.bn(f"{p}.bn1", c_in)
    lay.conv(f"{p}.conv1", c_in, c_out, k)
    lay.prelu(f"{p}.relu1", c_out)
    lay.bn(f"{p}.bn2", c_out)
    lay.conv(f"{p}.conv2", c_out, c_out, k)
    lay.prelu(f"{p}.relu2", c_out)
    if stride > 1 or c_in != c_out:
        lay.conv(f"{p}.conv_short", c_in, c_out, in_len // out_len, groups=g)
        lay.prelu(f"{p}.relu_short", c_out)
    _excitation_layout(lay, p, c_in, c_out, in_len, out_len, e)


def _decoding_block_layout(lay, p, c_in, c_out, in_len, out_len, e):
    g = math.gcd(c_in, c_out)
    if in_len > 1:
        lay.bn(f"{p}.bn1", c_in)
    lay.conv_t(f"{p}.conv1", c_in, c_out, 2)
    lay.prelu(f"{p}.relu1", c_out)
    lay.bn(f"{p}.bn2", c_out)
    lay.conv_t(f"{p}.conv2", c_out, c_out, out_len // (in_len * 2))
    lay.prelu(f"{p}.relu2", c_out)
    lay.conv_t(f"{p}.conv_short", c_in, c_out, out_len // in_len, groups=g)
    lay.prelu(f"{p}.relu_short", c_out)
    _excitation_layout(lay, p, c_in, c_out, in_len, out_len, e)


def _excitation_layout(lay, p, c_in, c_out, in_len, out_len, e):
    lay.linear(f"{p}.fc1", in_len, e)
    lay.prelu(f"{p}.relu_excit_1", c_in)
    lay.linear(f"{p}.fc2", e, out_len)
    lay.prelu(f"{p}.relu_excit_2", c_in)
    if c_in != c_out:
        lay.bn(f"{p}.bn_excit", c_in)
        lay.conv(f"{p}.conv_excit", c_in, c_out, 1, groups=math.gcd(c_in, c_out))
        lay.prelu(f"{p}.relu_excit_3", c_out)


def layout(cfg):
    """``{"enc"|"dec"|"dis": [(name, shape, init), ...]}`` of ``cfg`` (a
    dict of the configuration's keys)."""
    out = {}
    lay = Layout()
    for i, (c_in, c_out, in_len, out_len, k, e) in enumerate(ENCODERS[cfg["ae_form"]]):
        in_len = cfg["dim_in"] if i == 0 else in_len
        _encoding_block_layout(lay, f"block{i}", c_in, c_out, in_len, out_len, k, 2, e)
    lay.linear("lin3", 32, cfg["nstyle"])
    lay.bn("bn_style", cfg["nstyle"])
    out["enc"] = lay.entries

    lay = Layout()
    dblocks, eblocks = decoder_blocks(cfg)
    for i, (c_in, c_out, in_len, e, out_len) in enumerate(dblocks):
        _decoding_block_layout(lay, f"dblock{i}", c_in, c_out, in_len, out_len, e)
    for i, (c_in, c_out) in enumerate(eblocks):
        _encoding_block_layout(lay, f"eblock{i}", c_in, c_out, 256, 256, 11, 1, 2)
    lay.bn("bn_out", eblocks[-1][1])
    lay.conv("conv_out", eblocks[-1][1], 1, 1)
    out["dec"] = lay.entries

    lay = Layout()
    width = cfg["nstyle"]
    for i in range(cfg["FC_discriminator_layers"] - 1):
        lay.linear(f"lin{i}", width, 64)
        lay.prelu(f"prelu{i}", 64)
        width = 64
    lay.linear("lin_out", width, 1)
    out["dis"] = lay.entries
    return out


# --------------------------------------------------------------------------- #
# the forwards
# --------------------------------------------------------------------------- #

def encoding_block(n: Net, p, x, c_in, c_out, in_len, out_len, k, stride):
    """EncodingBlock (model.py:24-100)."""
    out = n.bn(f"{p}.bn1", x) if c_in > 1 else x
    residual = out
    pad = (k - 1) // 2
    out = F.pad(out, (pad, pad), mode="replicate")
    out = n.prelu(f"{p}.relu1", n.conv(f"{p}.conv1", out, stride=in_len // (out_len * stride)))
    out = n.prelu(f"{p}.relu2", n.conv(f"{p}.conv2", n.bn(f"{p}.bn2", out), stride=stride,
                                       padding=pad))
    if stride > 1 or c_in != c_out:
        s = in_len // out_len
        res = n.prelu(f"{p}.relu_short", n.conv(f"{p}.conv_short", residual, stride=s,
                                                groups=math.gcd(c_in, c_out)))
    else:
        res = residual
    excit = n.drop(residual) if in_len > 10 else residual
    return out + res + excitation(n, p, excit, c_in, c_out)


def decoding_block(n: Net, p, x, c_in, c_out, in_len, out_len):
    """DecodingBlock (model.py:103-174): transposed convolutions with kernel
    equal to stride."""
    out = n.bn(f"{p}.bn1", x) if in_len > 1 else x
    residual = out
    out = n.prelu(f"{p}.relu1", n.conv_t(f"{p}.conv1", out, 2))
    out = n.prelu(f"{p}.relu2", n.conv_t(f"{p}.conv2", n.bn(f"{p}.bn2", out),
                                         out_len // (in_len * 2)))
    res = n.prelu(f"{p}.relu_short", n.conv_t(f"{p}.conv_short", residual, out_len // in_len,
                                              groups=math.gcd(c_in, c_out)))
    excit = n.drop(residual) if in_len > 10 else residual
    return out + res + excitation(n, p, excit, c_in, c_out)


def excitation(n: Net, p, x, c_in, c_out):
    x = n.prelu(f"{p}.relu_excit_1", n.linear(f"{p}.fc1", x))
    x = n.prelu(f"{p}.relu_excit_2", n.linear(f"{p}.fc2", x))
    if c_in != c_out:
        x = n.prelu(f"{p}.relu_excit_3", n.conv(f"{p}.conv_excit", n.bn(f"{p}.bn_excit", x),
                                                groups=math.gcd(c_in, c_out)))
    return x


def encoder(cfg, n: Net, spec):
    """(B, dim_in) -> (B, nstyle): the conv blocks, a Linear from the 32
    flattened features, an affine-free BatchNorm."""
    x = spec[:, None, :]
    for i, (c_in, c_out, in_len, out_len, k, _) in enumerate(ENCODERS[cfg["ae_form"]]):
        in_len = cfg["dim_in"] if i == 0 else in_len
        x = encoding_block(n, f"block{i}", x, c_in, c_out, in_len, out_len, k, 2)
    return n.bn("bn_style", n.linear("lin3", x.reshape(x.shape[0], 32)))


def decoder(cfg, n: Net, z):
    """(B, nstyle) -> (B, 256): DecodingBlocks from length 1 to 256,
    stride-1 EncodingBlocks, BatchNorm, a 1x1 convolution, Softplus(beta=2)
    or ReLU."""
    dblocks, eblocks = decoder_blocks(cfg)
    x = z[:, :, None]
    for i, (c_in, c_out, in_len, _, out_len) in enumerate(dblocks):
        x = decoding_block(n, f"dblock{i}", x, c_in, c_out, in_len, out_len)
    for i, (c_in, c_out) in enumerate(eblocks):
        x = encoding_block(n, f"eblock{i}", x, c_in, c_out, 256, 256, 11, 1)
    x = n.conv("conv_out", n.bn("bn_out", x))[:, 0, :]
    if cfg["decoder_activation"] == "Softplus":
        return F.softplus(x, beta=2.0, threshold=20.0)
    return torch.relu(x)


def discriminator(cfg, n: Net, x, beta):
    """DiscriminatorFC (model.py:631-663): train-mode N(0, dis_noise) input
    noise, gradient reversal, [Linear -> PReLU -> Dropout] x (layers - 1),
    Linear -> one logit."""
    if n.train:
        x = x + cfg["dis_noise"] * n.draws.normal("dis_noise", x.shape)
    x = grad_reverse(x, beta)
    for i in range(cfg["FC_discriminator_layers"] - 1):
        x = n.drop(n.prelu(f"prelu{i}", n.linear(f"lin{i}", x)))
    return n.linear("lin_out", x)


def adversarial_logits(cfg, n: Net, z_real, styles, beta):
    """The prior's draws as reals and the styles as fakes in one pass: the
    FC discriminator keeps no batch statistics, so this is the two passes
    of functions.py:109-132, its noise and masks drawn for both at once."""
    logits = discriminator(cfg, n, torch.cat([z_real, styles]), beta)
    n_real = z_real.shape[0]
    return logits[:n_real], logits[n_real:]


# --------------------------------------------------------------------------- #
# multiply-adds per spectrum
# --------------------------------------------------------------------------- #

def conv_macs(c_in, c_out, k, l_out, groups=1):
    return c_out * (c_in // groups) * k * l_out


def conv_t_macs(c_in, c_out, k, l_in, groups=1):
    return c_in * (c_out // groups) * k * l_in


def encoding_block_macs(c_in, c_out, in_len, out_len, k, stride, e):
    """Multiply-adds of one EncodingBlock for one sample: its two
    convolutions, the shortcut, the excitation's two length-Linears and its
    1x1 convolution."""
    s1 = in_len // (out_len * stride)
    l1 = in_len // s1
    macs = conv_macs(c_in, c_out, k, l1) + conv_macs(c_out, c_out, k, l1 // stride)
    if stride > 1 or c_in != c_out:
        macs += conv_macs(c_in, c_out, in_len // out_len, out_len, math.gcd(c_in, c_out))
    macs += c_in * (in_len * e + e * out_len)
    if c_in != c_out:
        macs += conv_macs(c_in, c_out, 1, out_len, math.gcd(c_in, c_out))
    return macs


def decoding_block_macs(c_in, c_out, in_len, out_len, e):
    s2 = out_len // (in_len * 2)
    macs = conv_t_macs(c_in, c_out, 2, in_len) + conv_t_macs(c_out, c_out, s2, 2 * in_len)
    macs += conv_t_macs(c_in, c_out, out_len // in_len, in_len, math.gcd(c_in, c_out))
    macs += c_in * (in_len * e + e * out_len)
    if c_in != c_out:
        macs += conv_macs(c_in, c_out, 1, out_len, math.gcd(c_in, c_out))
    return macs


def encoder_macs(cfg):
    macs = 0
    for i, (c_in, c_out, in_len, out_len, k, e) in enumerate(ENCODERS[cfg["ae_form"]]):
        in_len = cfg["dim_in"] if i == 0 else in_len
        macs += encoding_block_macs(c_in, c_out, in_len, out_len, k, 2, e)
    return macs + 32 * cfg["nstyle"]


def decoder_macs(cfg):
    dblocks, eblocks = decoder_blocks(cfg)
    macs = sum(decoding_block_macs(c_in, c_out, in_len, out_len, e)
               for c_in, c_out, in_len, e, out_len in dblocks)
    macs += sum(encoding_block_macs(c_in, c_out, 256, 256, 11, 1, 2) for c_in, c_out in eblocks)
    return macs + conv_macs(eblocks[-1][1], 1, 1, 256)


def discriminator_macs(cfg):
    layers = cfg["FC_discriminator_layers"]
    return cfg["nstyle"] * 64 + (layers - 2) * 64 * 64 + 64


def macs(cfg):
    """(encoder, decoder, discriminator) multiply-adds per spectrum."""
    return encoder_macs(cfg), decoder_macs(cfg), discriminator_macs(cfg)
