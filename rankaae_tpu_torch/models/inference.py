"""Eval-mode inference over a trained model bundle (counterpart of
``rankaae_tpu/models/inference.py``).

Rebuilds the modules from the saved config on ``device`` (default
``"cuda"``), loads the bundle's weights through the weight bridge, and
exposes eval-mode ``encode``/``decode``/``discriminate`` and a fused
``reconstruct`` that take and return numpy arrays, as the JAX package's do.
The ``_encode``/``_decode``/``_reconstruct`` methods take and return device
tensors; the batched serving path (``serve.py``) uses them.  On the card,
the conv decoders' stride-1 4->4 and 2->2 blocks run as the K3 kernel.
The modules compute in float32 whatever the bundle's ``activation_dtype``
(``rankaae_tpu/models/inference.py:28-36`` pins the same).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from rankaae_tpu_torch.models.primitives import set_matmul_precision
from rankaae_tpu_torch.models.registry import build_autoencoder, build_discriminator
from rankaae_tpu_torch.utils.checkpoint import load_model_bundle
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.device import resolve_device
from rankaae_tpu_torch.utils.weights import from_jax


class InferenceModel:
    """Eval-mode forward passes of a trained (encoder, decoder,
    discriminator) triple.  ``params``/``batch_stats`` are the JAX package's
    ``{role: nested numpy dict}`` trees (``dis`` may be absent or empty);
    decoder outputs are divided by ``out_gain``."""

    def __init__(self, params: Dict[str, Any], batch_stats: Dict[str, Any],
                 cfg: TrainConfig, out_gain: float = 1.0, device=None):
        self.device = resolve_device(device)
        set_matmul_precision(cfg.matmul_precision)
        self.cfg = cfg
        self.nstyle = cfg.nstyle
        self.out_gain = float(out_gain)
        cfg32 = cfg.replace(activation_dtype="float32")
        encoder, decoder = build_autoencoder(cfg32)
        self.models = {"enc": encoder, "dec": decoder}
        if params.get("dis"):
            self.models["dis"] = build_discriminator(cfg32)
        sds = from_jax({k: params[k] for k in self.models}, batch_stats)
        for role, m in self.models.items():
            m.load_state_dict(sds[role])
            m.to(self.device).eval()

    @classmethod
    def from_bundle(cls, path: str, device=None) -> "InferenceModel":
        params, batch_stats, cfg, extra = load_model_bundle(path)
        return cls(params, batch_stats, cfg, out_gain=float(extra.get("amp_gain", 1.0)),
                   device=device)

    # device tensors in, device tensors out (the batched serving path)
    @torch.no_grad()
    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.models["enc"](x)

    @torch.no_grad()
    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.models["dec"](z) / self.out_gain

    @torch.no_grad()
    def _reconstruct(self, x: torch.Tensor) -> torch.Tensor:
        return self.models["dec"](self.models["enc"](x)) / self.out_gain

    def _to_device(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    def encode(self, spec) -> np.ndarray:
        return self._encode(self._to_device(spec)).cpu().numpy()

    def decode(self, z) -> np.ndarray:
        return self._decode(self._to_device(z)).cpu().numpy()

    def reconstruct(self, spec) -> np.ndarray:
        return self._reconstruct(self._to_device(spec)).cpu().numpy()

    @torch.no_grad()
    def discriminate(self, z) -> np.ndarray:
        if "dis" not in self.models:
            raise ValueError("this bundle has no discriminator parameters")
        return self.models["dis"](self._to_device(z)).cpu().numpy()
