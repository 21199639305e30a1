"""Loss library as plain functions of tensors (counterpart of
``rankaae_tpu/ops/losses.py:18-138``; behavioural spec: reference
``sc/utils/functions.py:81-219``).  Every loss reduces in float32.

Every loss takes inputs with a leading trial axis, (T, B, ...), and returns
one value per trial, (T,): the trainer differentiates the sum over trials,
and since trials share no parameter each trial gets exactly its own
gradient (a mean over trials would scale every gradient by 1/T).

The JAX package's key-taking helpers (``adversarial_loss``,
``discriminator_loss``, ``generator_loss``, ``mutual_info_loss``) are not
here: its trainer computes those losses inline, and so does this package's.
"""
from __future__ import annotations

import math

import torch

from rankaae_tpu_torch.models.primitives import gaussian_smooth_1d


def _per_trial_mean(x):
    """Mean over every axis but the leading (trial) one: (T, ...) -> (T,)."""
    return torch.mean(x, dim=tuple(range(1, x.dim())))


def mse(a, b):
    return _per_trial_mean(torch.square(a.float() - b.float()))


def bce_with_logits(logits, targets):
    """Mean binary cross-entropy on logits (torch ``BCEWithLogitsLoss``),
    in the JAX package's log(1+exp(-|x|)) form."""
    logits = logits.float()
    return _per_trial_mean(torch.clamp(logits, min=0.0) - logits * targets
                           + torch.log1p(torch.exp(-torch.abs(logits))))


def nll_loss(log_probs, targets):
    """Mean negative log-likelihood of (T, B, classes) log-probabilities
    over (T, B) integer class targets (torch ``NLLLoss``, as
    ``DiscriminatorCNN`` emits them)."""
    return -_per_trial_mean(log_probs.float().gather(-1, targets[..., None]))


def recon_loss(spec_in, spec_out, scale: bool = False, scale_weight: float = 0.1):
    """Reconstruction loss (reference ``functions.py:81-107``).

    ``scale=True`` is the "flex spectra target" (``use_flex_spec_target``):
    a per-spectrum amplitude ratio is learned toward 1 with a
    ``scale_weight``-weighted penalty, then detached, clamped to [0.7, 1.3],
    and used to rescale the target before the MSE.
    """
    spec_in = spec_in.float()
    spec_out = spec_out.float()
    if not scale:
        return mse(spec_out, spec_in)
    spec_scale = torch.abs(spec_out.mean(dim=-1)) / torch.abs(spec_in.mean(dim=-1))
    loss = _per_trial_mean(torch.square(spec_scale - 1.0)) * scale_weight
    clamped = torch.clamp(spec_scale.detach(), 0.7, 1.3)
    return loss + mse(spec_out, spec_in * clamped[..., None])


def smoothness_loss(spec_out, gs_kernel_size: int = 17, sigma: float = 3.0):
    """MSE between the decoded spectra (T, B, L) and their Gaussian-smoothed
    selves (reference ``functions.py:194-212``)."""
    smooth = gaussian_smooth_1d(spec_out.reshape(-1, spec_out.shape[-1]), gs_kernel_size, sigma)
    return mse(spec_out, smooth.view(spec_out.shape))


def alpha_schedule(epoch_percentage: float, step: float = 800.0, limit: float = 0.7) -> float:
    """GRL strength ramp (reference ``functions.py:214-219``):
    a(p) = (2 / (1 + exp(-1e4/step * p)) - 1) * limit.  A host number: the
    epoch is known on the host."""
    return (2.0 / (1.0 + math.exp(-1.0e4 / step * epoch_percentage)) - 1.0) * limit
