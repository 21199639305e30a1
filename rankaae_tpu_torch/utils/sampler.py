"""The one source of random draws for a training run.

``rankaae_tpu`` splits and folds ``jax.random`` keys; here every draw comes
from one ``torch.Generator`` through a :class:`Sampler`, in program order.
Draws are named after what they feed, so a test can subclass the sampler and
hand in fixed arrays for the named draws (``jax.random`` and
``torch.Generator`` give different numbers from the same seed).
"""
from __future__ import annotations

from typing import Sequence

import torch


class Sampler:
    """Named draws from one seeded generator on ``device``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def normal(self, name: str, shape: Sequence[int]) -> torch.Tensor:
        """Standard-normal float32 draw; ``name`` identifies the draw site
        (``spec_noise``, ``z_real``, ``z_sample``, ``dis_noise``, ...)."""
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)

    def keep_mask(self, shape: Sequence[int], keep: float) -> torch.Tensor:
        """Boolean dropout keep-mask, True with probability ``keep``."""
        return torch.rand(tuple(shape), generator=self.generator, device=self.device) < keep

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator, device=self.device)
