"""Loss library as plain functions of tensors (counterpart of
``rankaae_tpu/ops/losses.py:18-138``; behavioural spec: reference
``sc/utils/functions.py:81-219``).  Every loss reduces in float32.

Every loss takes inputs with a leading trial axis, (T, B, ...), and returns
one value per trial, (T,): the trainer differentiates the sum over trials,
and since trials share no parameter each trial gets exactly its own
gradient (a mean over trials would scale every gradient by 1/T).

The JAX package's key-taking helpers (``adversarial_loss``,
``discriminator_loss``, ``generator_loss``, ``mutual_info_loss``,
``rankaae_tpu/ops/losses.py:62-126``) are here too, with a
``torch.Generator`` where JAX takes a key: the prior is drawn from it, and
it is handed on to the discriminator closure in place of the key's
splits.  Neither package's trainer calls them: both compute those losses
inline.
"""
from __future__ import annotations

import math
from typing import Callable

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


def _prior(generator: torch.Generator, shape, like: torch.Tensor = None) -> torch.Tensor:
    z = torch.randn(tuple(shape), generator=generator, device=generator.device)
    return z if like is None else z.to(like.dtype)


def adversarial_loss(styles, discriminator_apply: Callable, alpha,
                     generator: torch.Generator, batch_size: int):
    """GRL-path adversarial loss (reference ``functions.py:109-132``):
    ``batch_size`` rows of z ~ N(0, I) per trial labelled 1, the (T, B,
    nstyle) ``styles`` labelled 0, the sum of two mean BCE-with-logits terms
    (T,).  ``discriminator_apply(x, alpha, generator)`` runs the
    discriminator in the caller's mode and returns (T, n, 1) logits."""
    z_real = _prior(generator, styles.shape[:-2] + (batch_size, styles.shape[-1]), styles)
    real_pred = discriminator_apply(z_real, alpha, generator).squeeze(-1)
    fake_pred = discriminator_apply(styles, alpha, generator).squeeze(-1)
    return bce_with_logits(real_pred, torch.ones_like(real_pred)) + \
        bce_with_logits(fake_pred, torch.zeros_like(fake_pred))


def discriminator_loss(styles, discriminator_apply: Callable, generator: torch.Generator,
                       batch_size: int):
    """Non-GRL discriminator loss for the 2-class CNN discriminator
    (reference ``functions.py:135-155``): z ~ N(0, I) class 1, the detached
    ``styles`` class 0, NLL on its log-probabilities, (T,)."""
    z_real = _prior(generator, styles.shape[:-2] + (batch_size, styles.shape[-1]), styles)
    real_pred = discriminator_apply(z_real, None, generator)
    fake_pred = discriminator_apply(styles.detach(), None, generator)
    return nll_loss(real_pred, torch.ones(real_pred.shape[:-1], dtype=torch.long,
                                          device=real_pred.device)) + \
        nll_loss(fake_pred, torch.zeros(fake_pred.shape[:-1], dtype=torch.long,
                                        device=fake_pred.device))


def generator_loss(styles, discriminator_apply: Callable, generator: torch.Generator):
    """Non-GRL generator loss (reference ``functions.py:158-171``): NLL of
    the discriminator calling ``styles`` class 1, (T,).  The reference
    labels them 0, which pushes the styles to look fake; like the JAX
    package this labels them 1, the working generator objective."""
    pred = discriminator_apply(styles, None, generator)
    return nll_loss(pred, torch.ones(pred.shape[:-1], dtype=torch.long, device=pred.device))


def mutual_info_loss(encoder_apply: Callable, decoder_apply: Callable,
                     generator: torch.Generator, batch_size: int, nstyle: int,
                     trials: int = 1):
    """Latent-cycle consistency (reference ``functions.py:174-192``): z ~
    N(0, I) of (trials, batch_size, nstyle); MSE(encoder(decoder(z)), z),
    (trials,)."""
    z = _prior(generator, (trials, batch_size, nstyle))
    return mse(encoder_apply(decoder_apply(z)), z)


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
