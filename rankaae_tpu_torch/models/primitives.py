"""Neural-net primitives with PyTorch semantics (counterpart of
``rankaae_tpu/models/primitives.py:104-368``, the FC subset).

* ``Linear`` is ``nn.Linear``; :func:`reset_parameters` re-draws every
  parameter with the torch-default initialisers (kaiming-uniform with
  a=sqrt(5), i.e. U(+-1/sqrt(fan_in)), for weights and biases) from an
  explicit generator, so a run is reproducible from its seed.
* ``PReLU`` is per-channel with init 0.01, as everywhere in the reference.
* ``BatchNorm`` is ``nn.BatchNorm1d(affine=False)``: train mode normalises
  with the biased batch variance and updates the running stats with the
  unbiased one, momentum 0.1, eps 1e-5 — the JAX module's semantics.
* ``Dropout`` draws its keep-mask from the caller's :class:`Sampler`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# matmul/conv precision knob
# ---------------------------------------------------------------------------


def set_matmul_precision(name: str) -> None:
    """'highest' (true f32) or 'default' (TF32 tensor-core passes).

    Sets both the cuBLAS and the cuDNN flag: the smoothing convolution goes
    through cuDNN, whose TF32 is on by default.  Process-level, like the JAX
    package's knob."""
    allow = {"highest": False, "default": True}[name]
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

Linear = nn.Linear


class PReLU(nn.PReLU):
    """Per-channel PReLU initialised to 0.01 (the reference's value)."""

    def __init__(self, num_parameters: int, init_value: float = 0.01):
        super().__init__(num_parameters, init=init_value)
        self.init_value = init_value


class BatchNorm(nn.BatchNorm1d):
    """``BatchNorm1d(affine=False)``, momentum 0.1, eps 1e-5."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1, affine=False)


class Dropout(nn.Module):
    """Inverted dropout (torch semantics), active only in train mode; the
    keep-mask comes from the caller's sampler."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, sampler=None):
        if not self.training or self.rate == 0.0:
            return x
        if sampler is None:
            raise ValueError("train-mode dropout needs a sampler")
        keep = 1.0 - self.rate
        mask = sampler.keep_mask(x.shape, keep)
        return torch.where(mask, x / keep, torch.zeros_like(x))


@torch.no_grad()
def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Torch-default initialisation of every Linear/PReLU/BatchNorm under
    ``module``, drawn from ``generator`` (``primitives.py:104-117`` in the
    JAX package): U(+-1/sqrt(fan_in)) for Linear weights and biases."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, PReLU):
            m.weight.fill_(m.init_value)
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_running_stats()


def softplus_beta(x, beta: float = 2.0, threshold: float = 20.0):
    """torch ``Softplus(beta=2)``: (1/beta) * log(1 + exp(beta*x)), linear
    above threshold (``primitives.py:333-337``)."""
    return F.softplus(x, beta=beta, threshold=threshold)


def gaussian_kernel_1d(kernel_size: int, sigma: float, device=None) -> torch.Tensor:
    """Normalized 1-D Gaussian kernel (reference ``model.py:186-200``)."""
    grid = torch.arange(kernel_size, dtype=torch.float32, device=device)
    mean = (kernel_size - 1) / 2.0
    k = torch.exp(-0.5 * ((grid - mean) / sigma) ** 2) / (sigma * math.sqrt(2 * math.pi))
    return k / torch.sum(k)


def gaussian_smooth_1d(x: torch.Tensor, kernel_size: int = 17, sigma: float = 3.0) -> torch.Tensor:
    """Depthwise Gaussian smoothing of (B, L) signals with replicate padding
    (reference ``GaussianSmoothing`` + ``ReplicationPad1d``,
    ``sc/utils/functions.py:203-209``)."""
    pad = (kernel_size - 1) // 2
    x = x.float()
    kernel = gaussian_kernel_1d(kernel_size, sigma, device=x.device)
    xp = F.pad(x[:, None, :], (pad, pad), mode="replicate")
    return F.conv1d(xp, kernel.view(1, 1, kernel_size))[:, 0, :]
