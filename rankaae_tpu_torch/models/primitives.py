"""Neural-net primitives with PyTorch semantics (counterpart of
``rankaae_tpu/models/primitives.py:104-368``).

* ``Linear`` is ``nn.Linear``; :func:`reset_parameters` re-draws every
  parameter with the torch-default initialisers (kaiming-uniform with
  a=sqrt(5), i.e. U(+-1/sqrt(fan_in)), for weights and biases) from an
  explicit generator, so a run is reproducible from its seed.
* ``PReLU`` is per-channel with init 0.01, as everywhere in the reference.
* ``BatchNorm`` is ``nn.BatchNorm1d(affine=False)``: train mode normalises
  with the biased batch variance and updates the running stats with the
  unbiased one, momentum 0.1, eps 1e-5 — the JAX module's semantics.
* ``Dropout`` draws its keep-mask from the caller's :class:`Sampler`.
* ``Conv1d`` is ``nn.Conv1d`` (zero or replicate padding, stride, groups;
  weight (out, in/groups, k)); ``ConvTranspose1d`` is ``nn.ConvTranspose1d``
  restricted to kernel == stride, the only case the model zoo uses (weight
  (in, out/groups, k)).  Both layouts are also the flax modules'.

The trial-stacked primitives carry T independent trials.  Over features
they take (T, B, C) inputs: ``TrialLinear`` (weight (T, out, in), bias
(T, out), one ``baddbmm``), ``TrialPReLU`` ((T, C)) and ``TrialBatchNorm``
(running statistics (T, C); one ``F.batch_norm`` over the (B, T*C) view, so
every statistic is per trial).  Over channels they take (B, T*C, L) inputs,
trial t's channels at [t*C, (t+1)*C): ``TrialConv1d`` and
``TrialConvTranspose1d`` (weight (T, ...) of the single layout, one grouped
convolution with T times the groups: in float32 on the card the kernels C1–C3
of ``ops/conv1d_cuda.py``, on the CPU ``F.conv1d``), ``TrialChannelPReLU``
(in float32 on the card the kernel P1 of ``ops/prelu_cuda.py``),
``TrialChannelBatchNorm`` (one ``F.batch_norm`` over the T*C channels),
``TrialLengthLinear`` (a ``TrialLinear`` over the length axis, through a
(T, B*C, L) copy) and ``TrialChannelDropout``.  ``Dropout`` asks its sampler
for the keep-mask, and a :class:`~rankaae_tpu_torch.utils.sampler.TrialSampler`
draws it per trial with the trial axis leading, so the channel-layout
dropout draws (T, B, C, L) and moves the trial axis.  Trial t of a stacked
module holds the numbers of one single-trial module: :class:`TrialModule`
exports and imports them in that module's ``state_dict`` layout, and
:func:`reset_parameters` with ``trial=t`` draws them in that module's
order.  A module builds its layers through :func:`layers_of`, which gives
the single-trial classes or the stacked ones.

Activations in bfloat16 (``activation_dtype``, ``primitives.py:60-96``,
``:152-155``, ``:178``, ``:208-223``, ``:253-271`` and ``:307-315`` in the
JAX package): :func:`set_activation_dtype` sets ``act_dtype`` on every
module of a tree (the registry does it from the config; there is no
process-wide setting), and the primitives cast as the flax modules do.
Parameters, running statistics and losses stay float32.

* ``Linear``/``TrialLinear`` and the transposed convolutions: operands
  rounded to bfloat16, products summed in float32 (the operands are held
  as float32 copies of the rounded values, whose products float32 holds
  exactly: JAX's ``preferred_element_type=float32``), the float32 bias
  added, then one rounding of the output to bfloat16, in JAX's order.
* ``Conv1d``/``TrialConv1d``: a bfloat16 convolution (bfloat16 output, as
  JAX's ``preferred_element_type=dt``), then the bias rounded to bfloat16
  and added in bfloat16.
* BatchNorm: statistics and normalisation from a float32 copy, the output
  cast back to the input's dtype; PReLU: the slope cast to the input's
  dtype; dropout: in the input's dtype.

With ``act_dtype`` float32 (the default) nothing is cast.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# matmul/conv precision knob
# ---------------------------------------------------------------------------


def set_matmul_precision(name: str) -> None:
    """'highest' (true f32) or 'default' (TF32 tensor-core passes).

    Sets both the cuBLAS and the cuDNN flag: the single-trial convolutions
    (serving, the report) go through cuDNN, whose TF32 is on by default.
    Process-level, like the JAX package's knob."""
    allow = {"highest": False, "default": True}[name]
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


# ---------------------------------------------------------------------------
# activation dtype
# ---------------------------------------------------------------------------

#: ``activation_dtype`` names -> torch dtypes
ACTIVATION_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def set_activation_dtype(module: nn.Module, name: str) -> nn.Module:
    """Set ``act_dtype`` (``name``: float32 or bfloat16) on ``module`` and
    every module under it; returns ``module``."""
    dtype = ACTIVATION_DTYPES[name]
    for m in module.modules():
        m.act_dtype = dtype
    return module


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held as float32: a matmul operand
    whose products float32 holds exactly.  At float32 ``x`` itself, so a
    module cast to float64 stays float64."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _in_act(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float32 result in ``dtype``: ``y`` itself at float32, as
    :func:`_rounded`."""
    return y if dtype == torch.float32 else y.to(dtype)


def _widened(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32 where it is bfloat16 (BatchNorm's statistics), else
    as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class Linear(nn.Linear):
    """``nn.Linear``, in ``act_dtype`` (see the module docstring)."""

    act_dtype = torch.float32

    def forward(self, x):
        dt = self.act_dtype
        return _in_act(F.linear(_rounded(x, dt), _rounded(self.weight, dt), self.bias), dt)


class PReLU(nn.PReLU):
    """Per-channel PReLU initialised to 0.01 (the reference's value)."""

    def __init__(self, num_parameters: int, init_value: float = 0.01):
        super().__init__(num_parameters, init=init_value)
        self.init_value = init_value

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


class BatchNorm(nn.BatchNorm1d):
    """``BatchNorm1d(affine=False)``, momentum 0.1, eps 1e-5; statistics in
    float32, the output in the input's dtype."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1, affine=False)

    def forward(self, x):
        return super().forward(_widened(x)).to(x.dtype)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d``, in ``act_dtype`` (see the module docstring)."""

    act_dtype = torch.float32

    def forward(self, x):
        dt = self.act_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y + self.bias.to(dt)[:, None]


class ConvTranspose1d(nn.ConvTranspose1d):
    """``ConvTranspose1d`` over (B, C, L) with groups and kernel == stride,
    in ``act_dtype`` (see the module docstring)."""

    act_dtype = torch.float32

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, groups: int = 1):
        if kernel_size != stride:
            raise ValueError(
                "only kernel_size == stride is supported, as in the reference "
                "architectures (sc/clustering/model.py:114-119,140)")
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         groups=groups)

    def forward(self, x):
        dt = self.act_dtype
        return _in_act(F.conv_transpose1d(_rounded(x, dt), _rounded(self.weight, dt),
                                          self.bias, self.stride, 0, 0, self.groups), dt)


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
        return torch.where(self._keep_mask(x, sampler, keep), x / keep, torch.zeros_like(x))

    def _keep_mask(self, x, sampler, keep):
        return sampler.keep_mask(x.shape, keep)


# ---------------------------------------------------------------------------
# trial-stacked modules
# ---------------------------------------------------------------------------


class TrialLinear(nn.Module):
    """T independent ``nn.Linear``s over (T, B, in), in ``act_dtype``."""

    act_dtype = torch.float32

    def __init__(self, trials: int, in_features: int, out_features: int):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(trials, out_features, in_features))
        self.bias = nn.Parameter(torch.empty(trials, out_features))

    def forward(self, x):
        dt = self.act_dtype
        return _in_act(torch.baddbmm(self.bias[:, None, :], _rounded(x, dt),
                                     _rounded(self.weight, dt).transpose(1, 2)), dt)


class TrialPReLU(nn.Module):
    """T independent per-channel PReLUs, initialised to 0.01."""

    def __init__(self, trials: int, num_parameters: int, init_value: float = 0.01):
        super().__init__()
        self.init_value = init_value
        self.weight = nn.Parameter(torch.full((trials, num_parameters), init_value))

    def forward(self, x):
        # torch's prelu: x where x > 0, else w * x (its gradients too)
        return torch.where(x > 0, x, self.weight[:, None, :].to(x.dtype) * x)


class TrialBatchNorm(nn.Module):
    """T independent ``BatchNorm1d(affine=False)`` (momentum 0.1, eps 1e-5):
    running statistics (T, C), normalised as one batch norm over the
    (B, T*C) view, whose running-statistic buffers are flat views of the
    (T, C) storage, so the in-place updates land per trial."""

    def __init__(self, trials: int, num_features: int):
        super().__init__()
        self.register_buffer("running_mean", torch.zeros(trials, num_features))
        self.register_buffer("running_var", torch.ones(trials, num_features))

    def forward(self, x):
        t, b, c = x.shape
        y = F.batch_norm(_widened(x).transpose(0, 1).reshape(b, t * c),
                         self.running_mean.view(-1), self.running_var.view(-1), None, None,
                         self.training, 0.1, 1e-5)
        return y.view(b, t, c).transpose(0, 1).to(x.dtype)


class TrialConv1d(nn.Module):
    """T independent ``nn.Conv1d``s over (B, T*C_in, L): weight (T, C_out,
    C_in/groups, k), bias (T, C_out), run as one convolution with
    T*groups groups (``ops/conv1d_cuda.conv1d``: the kernels C1–C3 in float32
    on the card, which pad inside; on the CPU replicate padding goes through
    ``F.pad`` first, as in ``nn.Conv1d``).  In ``act_dtype``, as
    :class:`Conv1d`."""

    act_dtype = torch.float32

    def __init__(self, trials: int, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, padding_mode: str = "zeros",
                 groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.replicate = padding_mode == "replicate"
        self.weight = nn.Parameter(
            torch.empty(trials, out_channels, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.empty(trials, out_channels))

    def forward(self, x):
        dt, pad = self.act_dtype, self.padding
        groups = self.weight.shape[0] * self.groups
        if dt == torch.float32:
            return conv1d_cuda.conv1d(x, self.weight.flatten(0, 1), self.bias.flatten(),
                                      self.stride, pad, self.replicate, groups)
        x = x.to(dt)
        if self.replicate and pad:
            x, pad = F.pad(x, (pad, pad), mode="replicate"), 0
        y = F.conv1d(x, self.weight.flatten(0, 1).to(dt), None, self.stride, pad, 1, groups)
        return y + self.bias.flatten().to(dt)[:, None]


class TrialConvTranspose1d(nn.Module):
    """T independent :class:`ConvTranspose1d`s (kernel == stride) over
    (B, T*C_in, L): weight (T, C_in, C_out/groups, k), bias (T, C_out), one
    transposed convolution with T*groups groups, in ``act_dtype``, as
    :class:`ConvTranspose1d`."""

    act_dtype = torch.float32

    def __init__(self, trials: int, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, groups: int = 1):
        super().__init__()
        if kernel_size != stride:
            raise ValueError("only kernel_size == stride is supported, as in the reference "
                             "architectures (sc/clustering/model.py:114-119,140)")
        self.stride, self.groups = stride, groups
        self.weight = nn.Parameter(
            torch.empty(trials, in_channels, out_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.empty(trials, out_channels))

    def forward(self, x):
        dt, groups = self.act_dtype, self.weight.shape[0] * self.groups
        if dt == torch.float32:
            return conv1d_cuda.conv_transpose1d(x, self.weight.flatten(0, 1),
                                                self.bias.flatten(), self.stride, groups)
        return _in_act(F.conv_transpose1d(_rounded(x, dt),
                                          _rounded(self.weight.flatten(0, 1), dt),
                                          self.bias.flatten(), self.stride, 0, 0, groups), dt)


class TrialChannelPReLU(TrialPReLU):
    """:class:`TrialPReLU` over the channels of (B, T*C, L) with the T*C
    weights: on a CUDA float32 tensor the kernel P1 with one term
    (``ops/prelu_cuda.py``), else one ``F.prelu``, as ``nn.PReLU`` runs it.
    A block's last PReLUs go into P1 with the sum of its branches
    (``models/blocks.py``)."""

    def forward(self, x):
        if prelu_cuda.takes(x):
            return prelu_cuda.prelu_sum([(x, self.weight.view(-1))])
        return F.prelu(x, self.weight.view(-1).to(x.dtype))


class TrialChannelBatchNorm(TrialBatchNorm):
    """:class:`TrialBatchNorm` over the channels of (B, T*C, L): one batch
    norm over the T*C channels, each normalised over (B, L)."""

    def forward(self, x):
        return F.batch_norm(_widened(x), self.running_mean.view(-1),
                            self.running_var.view(-1), None, None, self.training, 0.1,
                            1e-5).to(x.dtype)


class TrialLengthLinear(TrialLinear):
    """:class:`TrialLinear` over the length axis of (B, T*C, L_in) ->
    (B, T*C, L_out): trial t's (B*C, L_in) rows in one ``baddbmm``."""

    def forward(self, x):
        t = self.weight.shape[0]
        b, tc, length = x.shape
        rows = x.reshape(b, t, tc // t, length).transpose(0, 1).reshape(t, -1, length)
        y = super().forward(rows)
        return y.view(t, b, tc // t, -1).transpose(0, 1).reshape(b, tc, -1)


class TrialChannelDropout(Dropout):
    """:class:`Dropout` over (B, T*C, L): the keep-mask is drawn (T, B, C, L),
    trial t's from its own stream, as the single-trial (B, C, L) one."""

    def __init__(self, trials: int, rate: float):
        super().__init__(rate)
        self.trials = trials

    def _keep_mask(self, x, sampler, keep):
        b, tc, length = x.shape
        mask = sampler.keep_mask((self.trials, b, tc // self.trials, length), keep)
        return mask.transpose(0, 1).reshape(x.shape)


class Layers(NamedTuple):
    """The layer classes a module builds from.  Over features ((B, C), or
    (T, B, C) stacked): ``linear``, ``prelu``, ``batch_norm``, ``dropout``.
    Over channels ((B, C, L), or (B, T*C, L) stacked): ``conv``,
    ``conv_transpose``, ``channel_prelu``, ``channel_batch_norm``,
    ``length_linear`` (a Linear over L) and ``channel_dropout``."""

    linear: Callable
    prelu: Callable
    batch_norm: Callable
    dropout: Callable
    conv: Callable
    conv_transpose: Callable
    channel_prelu: Callable
    channel_batch_norm: Callable
    length_linear: Callable
    channel_dropout: Callable


def layers_of(module: nn.Module) -> Layers:
    """The layer classes ``module`` builds from: the stacked ones bound to
    its ``trials`` for a :class:`TrialModule`, else the single-trial ones.
    Over features a stacked module takes the single ``Dropout``: its sampler
    draws the (T, B, C) keep-mask per trial."""
    if not isinstance(module, TrialModule):
        return Layers(Linear, PReLU, BatchNorm, Dropout, Conv1d, ConvTranspose1d, PReLU,
                      BatchNorm, Linear, Dropout)
    t = functools.partial
    n = module.trials
    return Layers(t(TrialLinear, n), t(TrialPReLU, n), t(TrialBatchNorm, n), Dropout,
                  t(TrialConv1d, n), t(TrialConvTranspose1d, n), t(TrialChannelPReLU, n),
                  t(TrialChannelBatchNorm, n), t(TrialLengthLinear, n),
                  t(TrialChannelDropout, n))


def to_channels(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """(T, B, C, L) -> (B, T*C, L) for a :class:`TrialModule`; a single-trial
    module's (B, C, L) passes as it is."""
    if not isinstance(module, TrialModule):
        return x
    return x.transpose(0, 1).reshape(x.shape[1], -1, x.shape[-1])


def from_channels(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_channels`: (B, T*C, L) -> (T, B, C, L) (a
    view)."""
    if not isinstance(module, TrialModule):
        return x
    b, tc, length = x.shape
    return x.view(b, module.trials, tc // module.trials, length).transpose(0, 1)


class TrialModule(nn.Module):
    """A module stacked on a leading trial axis (``self.trials``), whose
    ``state_dict`` has the keys of its single-trial counterpart, each with
    the trial axis leading.  Mixed in before a single-trial module class
    that builds its layers through :func:`layers_of`:
    ``class TrialX(TrialModule, X)`` is ``X(**kw)`` stacked ``trials``
    times."""

    def __init__(self, trials: int, *args, **kw):
        self.trials = int(trials)
        super().__init__(*args, **kw)

    def trial_state_dict(self, i: int, sd: Optional[Mapping[str, torch.Tensor]] = None
                         ) -> Dict[str, torch.Tensor]:
        """Trial ``i`` of ``sd`` (default: this module's ``state_dict``) in
        the single-trial module's ``state_dict`` layout, as views.  The
        stacked BatchNorms keep no ``num_batches_tracked`` (momentum is
        fixed, so torch never reads it): it is exported as 0."""
        sd = self.state_dict() if sd is None else sd
        out = {k: v[i] for k, v in sd.items()}
        for name, m in self.named_modules():
            if isinstance(m, TrialBatchNorm):
                out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        return out

    @torch.no_grad()
    def load_trial_state_dict(self, i: int, sd: Mapping[str, torch.Tensor]) -> None:
        """Copy a single-trial module's ``state_dict`` into trial ``i``."""
        for k, v in self.state_dict().items():
            v[i].copy_(sd[k])


@torch.no_grad()
def reset_parameters(module: nn.Module, generator: torch.Generator, trial: int = 0) -> None:
    """Torch-default initialisation of every Linear/Conv/PReLU/BatchNorm
    under ``module``, drawn from ``generator`` (``primitives.py:104-136`` in
    the JAX package): U(+-1/sqrt(fan_in)) for weights and biases, with
    fan_in = in_features for Linear, in/groups * k for Conv1d and
    out/groups * k for ConvTranspose1d (torch reads dim 1 of its weight).
    Of a stacked module only trial ``trial`` is initialised, with the draws
    of its single-trial counterpart in the same order."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (TrialLinear, TrialConv1d, TrialConvTranspose1d)):
            bound = 1.0 / math.sqrt(m.weight[trial][0].numel())
            for p in (m.weight, m.bias):
                p[trial].copy_(torch.empty(p.shape[1:], device=p.device).uniform_(
                    -bound, bound, generator=generator))
        elif isinstance(m, (PReLU, TrialPReLU)):
            (m.weight if isinstance(m, PReLU) else m.weight[trial]).fill_(m.init_value)
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_running_stats()
        elif isinstance(m, TrialBatchNorm):
            m.running_mean[trial].zero_()
            m.running_var[trial].fill_(1.0)


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
    ``sc/utils/functions.py:203-209``), in float32: C1 and C2 on the card."""
    pad = (kernel_size - 1) // 2
    x = x.float()
    kernel = gaussian_kernel_1d(kernel_size, sigma, device=x.device)
    return conv1d_cuda.conv1d(x[:, None, :], kernel.view(1, 1, kernel_size), None, 1, pad,
                              True)[:, 0, :]


# last: importing the ops package imports ops/losses.py, which takes
# gaussian_smooth_1d from this module
from rankaae_tpu_torch.ops import conv1d_cuda, prelu_cuda  # noqa: E402
