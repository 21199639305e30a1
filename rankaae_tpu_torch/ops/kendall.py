"""Differentiable Kendall-rank-correlation constraint, plain PyTorch
(counterpart of ``rankaae_tpu/ops/kendall.py``; behavioural spec: reference
``sc/utils/functions.py:37-79``).

For a batch of B samples with K descriptors d and K latent styles s
(descriptor k rank-tied to style k):

    target[i, j, k] = sign(d[i, k] - d[j, k])          in {-1, 0, 1}
    pred[i, j, k]   = s[i, k] - s[j, k]                (raw diff: differentiable)
    product         = pred * target
    loss            = -sum(product) / ((B^2 - B) * K)

With ``activate=True`` concordant pairs (product > 0) of descriptor k are
down-weighted by ``n_opp_k / max(n_same_k, n_opp_k)`` (counts clamped to
>= 1).  The weights are counts — piecewise constant — so gradients flow only
through ``pred``.

This is the plain version: the CPU path, and the version the CUDA kernels
(``ops/kendall_cuda.py``) are held against.  Every function takes (B, K)
inputs or a leading trial axis (T, B, K); the loss is then (T,).
"""
from __future__ import annotations

import torch


def _pair_stats(descriptors, styles):
    """Per-descriptor sums over concordant/discordant pairs.

    Returns (sum_pos, sum_neg, sum_tie, cnt_pos, cnt_neg), each (..., K).
    sum_tie is identically 0 in value but carries the gradient of the
    exactly-tied pairs (see :func:`kendall_constraint`).
    """
    target = torch.sign(descriptors[..., :, None, :] - descriptors[..., None, :, :])
    pred = styles[..., :, None, :] - styles[..., None, :, :]
    product = pred * target
    pos = product > 0
    neg = product < 0
    zero = torch.zeros_like(product)
    sum_pos = torch.where(pos, product, zero).sum(dim=(-3, -2))
    sum_neg = torch.where(neg, product, zero).sum(dim=(-3, -2))
    sum_tie = torch.where(product == 0, product, zero).sum(dim=(-3, -2))
    cnt_pos = pos.sum(dim=(-3, -2))
    cnt_neg = neg.sum(dim=(-3, -2))
    return sum_pos, sum_neg, sum_tie, cnt_pos, cnt_neg


def activation_weights(cnt_pos, cnt_neg):
    """Concordant-pair weights n_opp / max(n_same, n_opp), counts clamped to 1
    (reference functions.py:74-76).  Piecewise constant: carries no gradient."""
    n_same = torch.clamp(cnt_pos, min=1).float()
    n_opp = torch.clamp(cnt_neg, min=1).float()
    return (n_opp / torch.maximum(n_same, n_opp)).detach()


def kendall_constraint(descriptors, styles, activate: bool = False):
    """Plain Kendall surrogate loss.

    Parameters
    ----------
    descriptors : (B, K) or (T, B, K) physical descriptor values (constants).
    styles : same shape, latent styles (differentiated).
    activate : per-descriptor concordant-pair reweighting.
    """
    descriptors = descriptors.float().detach()
    styles = styles.float()
    b, k = styles.shape[-2:]
    norm = (b * b - b) * k
    if not activate:
        # sum_ij (s_i - s_j) * sign(d_i - d_j) = 2 * sum_i s_i * c_i with
        # c_i = sum_j sign(d_i - d_j), by antisymmetry of both factors:
        # O(B^2) only in the constant c, O(B*K) in the differentiated part.
        c = torch.sign(descriptors[..., :, None, :] - descriptors[..., None, :, :]).sum(dim=-2)
        total = 2.0 * (styles * c).sum(dim=(-2, -1))
        return -total / norm
    sum_pos, sum_neg, sum_tie, cnt_pos, cnt_neg = _pair_stats(descriptors, styles)
    w = activation_weights(cnt_pos, cnt_neg)
    # exactly-tied pairs (product == 0) add 0 to the loss but DO carry
    # gradient t in the reference (its in-place masked scale touches only
    # product>0 entries, functions.py:69-76); sum_tie keeps that path alive
    total = (w * sum_pos + sum_neg + sum_tie).sum(dim=-1)
    return -total / norm
