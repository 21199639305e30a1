"""rankaae_tpu_torch — the PyTorch/CUDA port of ``rankaae_tpu``.

Rank-constrained adversarial autoencoders over XANES spectra, trained on an
NVIDIA H100.  The module layout mirrors ``rankaae_tpu`` name for name, so
each module's counterpart sits at the same path in the JAX package, which
stays the reference this package is tested against.

* models are ``nn.Module``s; the training protocol runs eagerly, its
  per-batch and per-epoch loops are plain Python loops;
* the O(B^2) Kendall rank-correlation loss runs as a pair of CUDA kernels
  written for ``sm_90a`` (``ops/kendall_cuda.py``, ``csrc/kendall.cu``);
* entry points take an explicit ``device`` and default to ``"cuda"``.

This package imports nothing of ``jax`` or ``rankaae_tpu``.
"""

__version__ = "0.1.0"

from rankaae_tpu_torch.utils.config import Parameters, TrainConfig  # noqa: F401
