"""The eval-mode stride-1 ``EncodingBlock`` on the card: K3, one CUDA kernel
(``csrc/fused_block.cu``), and its plain version.

K3 replaces ``scripts/fused_block_probe.py::fused_block_kernel`` (via
``fused_block``): bn1 -> conv1 (11 taps, replicate pad) -> PReLU -> bn2 ->
conv2 (11 taps, zero pad) -> PReLU, plus the residual and the excitation MLP
(Linear 256->2 -> PReLU -> Linear 2->256 -> PReLU), with running statistics,
no dropout and no backward.  ``models/blocks.py`` sends every eval-mode
block of that shape here: the decoders' 4->4 and 2->2 blocks at length 256.

:func:`fused_block` takes the block's tensors in the layouts of the port's
modules (conv weights (C, C, 11), ``fc1_w`` (2, 256), ``fc2_w`` (256, 2)).
On a CUDA tensor it launches K3 on the current stream or raises; on a CPU
tensor it computes :func:`fused_block_plain`, which mirrors the probe's
``reference_block`` op by op.  :func:`fused_block_trials` runs T stacked
blocks (``models/blocks.py::TrialEncodingBlock``): x (B, T*C, L) and every
parameter with the trial axis leading, one :func:`fused_block` per trial on
the trial's contiguous copy of x and its weight slices, so a stacked block
is T launches of K3.  K3 has no backward, so on either device it
raises when autograd would need one (grad enabled and an input that
requires grad).  The counter ``k3.launches`` (``utils/tracing.py``) counts
the kernel launches (plain calls not counted).
"""
from __future__ import annotations

import ctypes
import operator
import struct
from typing import Optional

import torch
import torch.nn.functional as F

from rankaae_tpu_torch.ops import _nvcc
from rankaae_tpu_torch.utils import tracing

SOURCE = _nvcc.CSRC / "fused_block.cu"
L, K, E = 256, 11, 2          # compile-time constants of the kernel
PAD = (K - 1) // 2
CHANNELS = (2, 4)             # the instantiated channel counts
EPS = 1e-5

_lib: Optional[ctypes.CDLL] = None

_ARGS = ("bn1_mean", "bn1_var", "w1", "b1", "a1", "bn2_mean", "bn2_var", "w2", "b2",
         "a2", "fc1_w", "fc1_b", "ae1", "fc2_w", "fc2_b", "ae2")
#: the 16 parameter pointers packed in ``_ARGS`` order, as the kernel's Params
_PARAMS = struct.Struct(f"{len(_ARGS)}P")


def build() -> ctypes.CDLL:
    """Compile ``csrc/fused_block.cu`` (once per source version) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _nvcc.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_block.argtypes = [p, i, i, ctypes.c_char_p, p, p]
    lib.fused_block.restype = i
    lib.fused_block_error_string.argtypes = [i]
    lib.fused_block_error_string.restype = ctypes.c_char_p
    lib.fused_block_wave.argtypes = [i]
    for name in ("fused_block_wave", "fused_block_length", "fused_block_taps",
                 "fused_block_excitation", "fused_block_params_bytes"):
        getattr(lib, name).restype = i
    consts = (lib.fused_block_length(), lib.fused_block_taps(), lib.fused_block_excitation(),
              lib.fused_block_params_bytes())
    if consts != (L, K, E, _PARAMS.size):
        raise RuntimeError(f"{SOURCE.name} was built for (L, K, E, parameter bytes) = {consts}, "
                           f"this wrapper expects {(L, K, E, _PARAMS.size)}")
    _lib = lib
    return lib


def wave(c: int) -> int:
    """Samples one wave of K3's persistent grid holds on the current CUDA
    device (its resident blocks times the samples a block has in flight)."""
    lib = build()
    n = lib.fused_block_wave(c)
    if n <= 0:
        raise RuntimeError(f"fused_block_wave({c}) failed: "
                           f"{lib.fused_block_error_string(-n).decode()}")
    return n


def _shapes(c: int) -> dict:
    vec = (c,)
    return {"bn1_mean": vec, "bn1_var": vec, "w1": (c, c, K), "b1": vec, "a1": vec,
            "bn2_mean": vec, "bn2_var": vec, "w2": (c, c, K), "b2": vec, "a2": vec,
            "fc1_w": (E, L), "fc1_b": (E,), "ae1": vec, "fc2_w": (L, E), "fc2_b": (L,),
            "ae2": vec}


#: the parameters' shapes in argument order, per channel count
_SHAPES = {c: tuple(_shapes(c).values()) for c in CHANNELS}
_shape, _dtype, _device, _requires_grad = (
    operator.attrgetter(a) for a in ("shape", "dtype", "device", "requires_grad"))
_is_contiguous, _data_ptr = torch.Tensor.is_contiguous, torch.Tensor.data_ptr


def _check(x: torch.Tensor, args: tuple) -> None:
    """Raise unless ``x`` is (B >= 1, C in CHANNELS, L) on the CPU or a CUDA
    device and ``x`` and the 16 parameters are contiguous float32 tensors of
    their shapes on x's device.  One pass over the tensors per property;
    only when one fails, :func:`_name_the_fault` finds the tensor to name."""
    if x.dim() != 3 or x.shape[1] not in CHANNELS or x.shape[2] != L or x.shape[0] < 1:
        raise ValueError(f"x must be (B >= 1, C in {CHANNELS}, {L}), got {tuple(x.shape)}")
    if not (x.is_cuda or x.is_cpu):
        raise ValueError(f"unsupported device {x.device}")
    tensors = (x, *args)
    if not (tuple(map(_shape, args)) == _SHAPES[x.shape[1]]
            and set(map(_dtype, tensors)) == {torch.float32}
            and set(map(_device, tensors)) == {x.device}
            and all(map(_is_contiguous, tensors))):
        _name_the_fault(x, args)


def _name_the_fault(x: torch.Tensor, args: tuple) -> None:
    for name, shape, t in zip(_ARGS, _SHAPES[x.shape[1]], args):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    for name, t in zip(("x", *_ARGS), (x, *args)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_block_plain(x, bn1_mean, bn1_var, w1, b1, a1, bn2_mean, bn2_var, w2, b2, a2,
                      fc1_w, fc1_b, ae1, fc2_w, fc2_b, ae2):
    """Plain version of K3 (the probe's ``reference_block``), (B, C, L) -> (B, C, L)."""
    def per_channel(v):
        return v[None, :, None]

    def prelu(v, a):
        return torch.where(v >= 0, v, a * v)

    xb = (x - per_channel(bn1_mean)) * torch.rsqrt(per_channel(bn1_var) + EPS)
    h = F.conv1d(F.pad(xb, (PAD, PAD), mode="replicate"), w1) + per_channel(b1)
    h = prelu(h, per_channel(a1))
    h = (h - per_channel(bn2_mean)) * torch.rsqrt(per_channel(bn2_var) + EPS)
    h2 = F.conv1d(F.pad(h, (PAD, PAD)), w2) + per_channel(b2)
    h2 = prelu(h2, per_channel(a2))
    ex = prelu(F.linear(xb, fc1_w, fc1_b), per_channel(ae1))
    ex = prelu(F.linear(ex, fc2_w, fc2_b), per_channel(ae2))
    return h2 + xb + ex


def fused_block(x, bn1_mean, bn1_var, w1, b1, a1, bn2_mean, bn2_var, w2, b2, a2,
                fc1_w, fc1_b, ae1, fc2_w, fc2_b, ae2):
    """K3 on a CUDA tensor, its plain version on a CPU tensor."""
    args = (bn1_mean, bn1_var, w1, b1, a1, bn2_mean, bn2_var, w2, b2, a2,
            fc1_w, fc1_b, ae1, fc2_w, fc2_b, ae2)
    _check(x, args)
    if torch.is_grad_enabled() and any(map(_requires_grad, (x, *args))):
        raise RuntimeError("fused_block has no backward: call it under torch.no_grad()")
    if x.is_cpu:
        return fused_block_plain(x, *args)
    lib = build()
    x_ptr = x.data_ptr()
    if x_ptr % 16:
        raise ValueError("x must be 16-byte aligned (the kernel reads it as float4)")
    out = torch.empty_like(x)
    b, c, _ = x.shape
    rc = lib.fused_block(x_ptr, b, c, _PARAMS.pack(*map(_data_ptr, args)), out.data_ptr(),
                         torch._C._cuda_getCurrentRawStream(x.get_device()))
    if rc != 0:
        raise RuntimeError(f"fused_block launch failed: {lib.fused_block_error_string(rc).decode()}")
    tracing.count("k3.launches")
    return out


def fused_block_trials(x, *params):
    """T stacked blocks: ``x`` (B, T*C, L) with trial t's channels at
    [t*C, (t+1)*C), each of the 16 parameters with the trial axis leading;
    one :func:`fused_block` (one K3 launch on the card) per trial."""
    t = params[0].shape[0]
    b, tc, length = x.shape
    xs = x.reshape(b, t, tc // t, length)
    out = torch.stack([fused_block(xs[:, i].contiguous(), *(p[i] for p in params))
                       for i in range(t)], dim=1)
    return out.view(b, tc, length)
