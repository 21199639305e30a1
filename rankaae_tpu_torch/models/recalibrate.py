"""Deployment calibration of a trained bundle (counterpart of
``rankaae_tpu/models/recalibrate.py``): BatchNorm running statistics from
one pass over the training split (``bn_recalibrate``), and the one-scalar
output gain (``amp_recalibrate``) that ``InferenceModel`` divides the
decoder's outputs by.

The port's ``BatchNorm`` updates its running statistics as
``new = (1 - m) old + m batch`` with momentum 0.1 and the unbiased batch
variance, so after one train-mode pass over the whole split the pass's own
statistics are ``(new - (1 - m) old) / m`` (:func:`_invert_ema`), leaf by
leaf.  In that pass every BatchNorm normalises by its full-split batch
statistics, which is what eval mode reproduces after the swap.  Both
functions take and return single-trial trees in the bundle layout
(``{role: nested numpy dict}``) and run on ``device`` (default ``"cuda"``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from rankaae_tpu_torch.models.inference import InferenceModel
from rankaae_tpu_torch.models.registry import build_autoencoder
from rankaae_tpu_torch.utils.device import resolve_device
from rankaae_tpu_torch.utils.sampler import Sampler
from rankaae_tpu_torch.utils.weights import from_jax, to_jax

#: the port's BatchNorm momentum (``models/primitives.py``)
MOMENTUM = 0.1


def _host(spec) -> np.ndarray:
    """A split of spectra, numpy or a tensor on any device, as host float32."""
    return np.asarray(spec.cpu() if isinstance(spec, torch.Tensor) else spec, np.float32)


def _invert_ema(old_stats: Mapping, new_stats: Mapping) -> Dict:
    """The batch statistics of the one pass that moved ``old_stats`` to
    ``new_stats`` (nested dicts of numpy arrays)."""
    m = np.float32(MOMENTUM)
    return {k: _invert_ema(old_stats[k], v) if isinstance(v, Mapping)
            else (v - (np.float32(1.0) - m) * old_stats[k]) / m
            for k, v in new_stats.items()}


def recalibrate_batch_stats(cfg, params: Dict[str, Any], batch_stats: Dict[str, Any],
                            train_spec, device=None) -> Dict[str, Any]:
    """``batch_stats`` with the encoder's and decoder's BatchNorm leaves
    replaced by the statistics of one train-mode pass over ``train_spec``
    ((N, dim_in), numpy or a tensor).  The pass runs with dropout on, as
    training's activations did, in the config's ``activation_dtype`` (the
    JAX package's pass runs in the training dtype); its keep-masks come
    from a generator seeded 0 on ``device``, so they are not the JAX
    package's ``PRNGKey(0)`` draws.  Other roles pass through."""
    dev = resolve_device(device)
    encoder, decoder = build_autoencoder(cfg)
    models = {"enc": encoder, "dec": decoder}
    sds = from_jax({k: params[k] for k in models}, batch_stats)
    for role, m in models.items():
        m.load_state_dict(sds[role])
        m.to(dev).train()
    sampler = Sampler(0, dev)
    x = torch.as_tensor(_host(train_spec), device=dev)
    with torch.no_grad():
        decoder(encoder(x, sampler=sampler), sampler=sampler)
    _, passed = to_jax(models)
    new_stats = dict(batch_stats)
    for role in models:
        if batch_stats.get(role):
            new_stats[role] = _invert_ema(batch_stats[role], passed[role])
    return new_stats


def amplitude_ratio(cfg, params: Dict[str, Any], batch_stats: Dict[str, Any], train_spec,
                    device=None) -> float:
    """The median over ``train_spec`` of |mean output| / |mean input| of the
    eval-mode reconstruction.  On the card a conv bundle's decode runs
    through K3."""
    model = InferenceModel(params, batch_stats, cfg, device=device)
    x = _host(train_spec)
    out = model.reconstruct(x)
    return float(np.median(np.abs(out.mean(axis=1)) / np.abs(x.mean(axis=1))))


def amplitude_gain(cfg, params: Dict[str, Any], batch_stats: Dict[str, Any], train_spec,
                   device=None) -> float:
    """:func:`amplitude_ratio` clipped to [0.5, 2.0], and 1.0 when it is not
    finite: the gain that the flex reconstruction objective leaves
    unconstrained, which ``InferenceModel`` divides out when a manifest
    carries it as ``amp_gain`` (``rankaae_tpu/models/recalibrate.py:
    102-137``).  Training's own clamp bounds the drift to [0.7, 1.3], so a
    ratio far outside is a diverged model, which a gain would only
    amplify."""
    gain = amplitude_ratio(cfg, params, batch_stats, train_spec, device=device)
    if not np.isfinite(gain):
        return 1.0
    return float(np.clip(gain, 0.5, 2.0))
