"""Operation and byte counts: a training epoch's operations from the
model's multiply-adds (for ``train_mfu``), and the least time of the port's
hand-written kernels (for their roofline shares).

:func:`bound` and :func:`k3_bound` are frozen copies of
``chip_smoke.py``'s functions of the same names (K1 with PR 3's count);
:func:`bound` also takes K1's call without the row sums (``rows=False``,
the validation's), which writes no P, N.  The model's multiply-adds come
from its model module's ``macs`` (see :mod:`benchmark.reference`), which
counts them from its layer shapes, not from the program.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, published dense peaks at 700 W: HBM bytes/s and float32
# FLOP/s outside the tensor cores (TF32 off)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# K1's operations per unordered pair {a, j} of one (t, k): the two
# differences, the sign of their product and its compare
OPS_PER_PAIR = 4
# and per unordered pair with tgt != 0: the sum and count adds and the
# row-sum add of each of its two rows (a tied pair adds nothing)
OPS_PER_UNTIED_PAIR = 4
# K2's operations per (t, a, k) element: w * P, + N, * scale
OPS_PER_ELEMENT = 3
# K3's block: length, taps, excitation width (the decoders' stride-1 blocks)
K3_L, K3_K, K3_E = 256, 11, 2


def bound(name, t, b, k, untied, rows=True):
    """Least time (ms) for the work of one K1 (``kendall_pair_sums``) or K2
    call, and what bounds it.

    K1: reads d and s (2 T B K words), writes sums, cnts (2 T K each), w
    (T K), loss (T) and, with ``rows``, P and N (2 T B K); does OPS_PER_PAIR
    operations on each of the T K (B^2 - B) / 2 unordered pairs and
    OPS_PER_UNTIED_PAIR more on each of the ``untied`` ones whose
    descriptors differ.  K2: reads P, N (2 T B K), w (T K) and g (T), writes
    grad (T B K), and does OPS_PER_ELEMENT operations per element."""
    f32 = 4
    if name == "kendall_pair_sums":
        moved = (2 * t * b * k + t * k * (2 + 2 + 1) + t + (2 * t * b * k if rows else 0)) * f32
        pairs = t * k * (b * b - b) // 2
        ops = OPS_PER_PAIR * pairs + OPS_PER_UNTIED_PAIR * untied
    else:
        moved = (2 * t * b * k + t * k + t + t * b * k) * f32
        ops = OPS_PER_ELEMENT * t * b * k
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k3_bound(b, c, L=K3_L, K=K3_K, E=K3_E):
    """Least time (ms) of one K3 call, and what bounds it: x read once and
    out written once (plus the block's weights), and per sample two
    C x C x K-tap convs (2 operations a tap) and ~(15 + 4E) elementwise
    operations per (channel, position)."""
    f32 = 4
    weights = 2 * c * c * K + 10 * c + 2 * E * L + L + E
    moved = (2 * b * c * L + weights) * f32
    ops = b * (2 * 2 * c * c * K * L + (15 + 4 * E) * c * L)
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def untied_pairs(d):
    """Unordered pairs {a, j} with d_a != d_j, summed over the columns of
    the descriptors ``d`` (B, K), a numpy array."""
    b, n = d.shape[0], 0
    for col in range(d.shape[1]):
        counts = np.unique(d[:, col], return_counts=True)[1].astype(np.int64)
        n += (b * b - int((counts * counts).sum())) // 2
    return n


# --------------------------------------------------------------------------- #
# the training epoch's operations
# --------------------------------------------------------------------------- #

SMOOTH_MACS = 17 * 256


def epoch_flops(model, cfg, n_train, n_val):
    """Floating-point operations (2 per multiply-add) of one trial's epoch of
    the faithful GRL protocol, with the per-spectrum multiply-adds of the
    model module ``model``: each batch's forwards (6 encodes, 4 decodes,
    the discriminator over the prior's draws and the styles, the
    smoothing) and, for each differentiated pass (4 of the encoder, 3 of the
    decoder, 1 of the discriminator and of the smoothing), a backward of
    twice the forward's; then the validation
    (2 encodes, 2 decodes, the discriminator on the prior's draws and the
    latent, the smoothing).  Nothing is recomputed in this protocol."""
    enc, dec, dis = model.macs(cfg)
    real = cfg["batch_size"]
    macs = 0
    for start in range(0, n_train, cfg["batch_size"]):
        b = min(cfg["batch_size"], n_train - start)
        macs += b * (enc * (6 + 2 * 4) + dec * (4 + 2 * 3) + SMOOTH_MACS * (1 + 2))
        macs += (real + b) * dis * (1 + 2)
    macs += n_val * (2 * enc + 2 * dec + SMOOTH_MACS) + (real + n_val) * dis
    return 2 * macs

