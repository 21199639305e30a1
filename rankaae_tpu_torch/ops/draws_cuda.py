"""The trial sampler's draws on the card: one CUDA kernel, D1
(``csrc/trial_draws.cu``), and its plain version.

D1 fills a whole (T, ...) draw in one launch, trial t's slice from its own
counter-based Philox4x32-10 stream: key ``keys[t]`` (the run's seed + t),
element i of the n a trial at counter (``offset`` + i // 4, the constant
:data:`STREAM` above it) and word i % 4 of its output.  A call consumes
:func:`counters` (n) = ceil(n / 4) counters of every trial, so the caller
(``utils/sampler.py::TrialSampler``) advances one offset for all of them,
and trial g's draws depend only on its key and the draw shapes before them
(``csrc/trial_draws.cu`` has the whole scheme, and why the counter's high
words hold :data:`STREAM`).  Four outputs: :data:`BITS` (the words, int32),
:data:`UNIFORM` ((w >> 8) * 2^-24), :data:`NORMAL` (Box-Muller on word
pairs, float32) and :data:`KEEP` (a bool keep-mask, True with probability
``keep``, the decision of ``uniform < keep`` in float32).

:func:`draw` takes the kernel for CUDA keys and :func:`draw_plain` for CPU
keys: the same Philox in int64 torch ops (the 32 x 32-bit products split at
16 bits so none overflows), on any device.  The CPU tests hold it to the
cipher's known answers and to the sampler's contract, and ``chip_smoke.py``
holds the kernel to it on the card: BITS, UNIFORM and KEEP bit-identical,
NORMAL within the ulps of two libraries' ``log``, ``sin`` and ``cos``.  The
counters ``draw.launches`` and ``draw.elements`` (``utils/tracing.py``)
count D1's calls and the elements they write.

The shared library is built with ``nvcc`` by ``ops/_nvcc.py`` on first use
and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import numpy as np
import torch

from rankaae_tpu_torch.ops import _nvcc
from rankaae_tpu_torch.utils import tracing

SOURCE = _nvcc.CSRC / "trial_draws.cu"

BITS, UNIFORM, NORMAL, KEEP = 0, 1, 2, 3
DTYPES = {BITS: torch.int32, UNIFORM: torch.float32, NORMAL: torch.float32, KEEP: torch.bool}
#: the fourth word of every counter (its third is 0); the library's is
#: checked against it when it is loaded
STREAM = 0x44310001
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
#: float32 2 pi, the Box-Muller angle's scale in both versions
TWO_PI = float(np.float32(2 * math.pi))
_MASK = 0xFFFFFFFF

_lib: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile ``csrc/trial_draws.cu`` (once per source version), load it and
    hold its stream constant against :data:`STREAM`."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _nvcc.load(SOURCE)
    lib.trial_draws_stream.restype = ctypes.c_uint
    lib.trial_draws.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_ulonglong,
                                ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.trial_draws.restype = ctypes.c_int
    lib.trial_draws_error_string.argtypes = [ctypes.c_int]
    lib.trial_draws_error_string.restype = ctypes.c_char_p
    if lib.trial_draws_stream() != STREAM:
        raise RuntimeError(f"{SOURCE.name} draws in stream {lib.trial_draws_stream():#x}, "
                           f"this wrapper in {STREAM:#x}")
    _lib = lib
    return lib


def counters(n: int) -> int:
    """The counters of every trial that a draw of ``n`` elements a trial
    consumes: the offset's advance."""
    return -(-int(n) // 4)


def keep_threshold(keep: float) -> int:
    """The integer t with (w >> 8) < t exactly when (w >> 8) * 2^-24 <
    float32(keep): ceil(keep * 2^24), clamped to [0, 2^24]."""
    scaled = float(np.float32(keep)) * 2.0 ** 24       # exact: a power-of-two scale
    return int(min(max(math.ceil(scaled), 0), 2 ** 24))


def keys_tensor(seeds: Sequence[int], device) -> torch.Tensor:
    """The per-trial keys (seeds mod 2^64) as int64 (the uint64 bits)."""
    bits = [(int(s) % 2 ** 64) - (2 ** 64 if int(s) % 2 ** 64 >= 2 ** 63 else 0) for s in seeds]
    return torch.tensor(bits, dtype=torch.int64, device=device)


def _per_trial(shape: Sequence[int], keys: torch.Tensor):
    shape = tuple(int(s) for s in shape)
    if not shape or shape[0] != keys.numel():
        raise ValueError(f"draw of shape {shape} for {keys.numel()} trials")
    return shape, math.prod(shape[1:])


# --------------------------------------------------------------------------- #
# the plain version
# --------------------------------------------------------------------------- #

def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m, a an int64 tensor of words, m a word:
    two products of under 48 bits, so nothing overflows int64."""
    p_lo, p_hi = a * (m & 0xFFFF), a * (m >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _MASK


def philox(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10: the four output words of counter (c0, c1, c2, c3)
    under key (k0, k1), each an int64 tensor (or broadcastable) of 32-bit
    words."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & _MASK, (k1 + PHILOX_W[1]) & _MASK
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words(keys: torch.Tensor, offset: int, q: int) -> torch.Tensor:
    """(T, q, 4) int64: the words of counters offset .. offset + q - 1 (and
    :data:`STREAM` above them) under each trial's key."""
    ctr = (torch.arange(q, dtype=torch.int64, device=keys.device) + int(offset))[None]
    c0, c1 = ctr & _MASK, (ctr >> 32) & _MASK
    words = philox(c0, c1, torch.zeros_like(c0), torch.full_like(c0, STREAM),
                   (keys & _MASK)[:, None], ((keys >> 32) & _MASK)[:, None])
    return torch.stack(torch.broadcast_tensors(*words), -1)


def _unit(w: torch.Tensor) -> torch.Tensor:
    return (w >> 8).float() * 2.0 ** -24


def box_muller(w: torch.Tensor) -> torch.Tensor:
    """(..., 4) float32 standard normals from (..., 4) words: (w0, w1) give
    elements 0 and 1, (w2, w3) elements 2 and 3, each pair r cos theta, r
    sin theta with r = sqrt(-2 log u1), u1 = ((w0 >> 8) + 1) 2^-24 in (0, 1]
    (never log 0), theta = float32(2 pi) (w1 >> 8) 2^-24."""
    u1 = ((w[..., 0::2] >> 8) + 1).float() * 2.0 ** -24
    theta = _unit(w[..., 1::2]) * torch.tensor(TWO_PI, dtype=torch.float32)
    r = torch.sqrt(torch.log(u1) * -2.0)
    return torch.stack((r * torch.cos(theta), r * torch.sin(theta)), -1).flatten(-2)


def draw_plain(mode: int, keys: torch.Tensor, offset: int, shape: Sequence[int],
               keep: float = 1.0) -> torch.Tensor:
    """Plain version of :func:`draw`, on ``keys``'s device."""
    shape, n = _per_trial(shape, keys)
    t, q = keys.numel(), counters(n)
    w = philox_words(keys, offset, q)
    if mode == BITS:
        out = torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)
    elif mode == UNIFORM:
        out = _unit(w)
    elif mode == KEEP:
        out = (w >> 8) < keep_threshold(keep)
    elif mode == NORMAL:
        out = box_muller(w)
    else:
        raise ValueError(f"no draw mode {mode}")
    return out.reshape(t, 4 * q)[:, :n].reshape(shape)


# --------------------------------------------------------------------------- #
# the kernel
# --------------------------------------------------------------------------- #

def draw_kernel(mode: int, keys: torch.Tensor, offset: int, shape: Sequence[int],
                keep: float = 1.0) -> torch.Tensor:
    """D1 on CUDA ``keys`` (int64, one a trial): the (T, ...) draw ``mode``
    of ``shape`` at ``offset``, one launch."""
    shape, n = _per_trial(shape, keys)
    if mode not in DTYPES:
        raise ValueError(f"no draw mode {mode}")
    if keys.dtype != torch.int64 or not keys.is_cuda or not keys.is_contiguous():
        raise ValueError(f"keys must be a contiguous int64 CUDA tensor, got {keys.dtype} on "
                         f"{keys.device}")
    lib = build()
    out = torch.empty(shape, dtype=DTYPES[mode], device=keys.device)
    rc = lib.trial_draws(mode, keys.data_ptr(), int(offset) % 2 ** 64, n, keys.numel(),
                         keep_threshold(keep) if mode == KEEP else 0, out.data_ptr(),
                         torch._C._cuda_getCurrentRawStream(keys.device.index))
    if rc != 0:
        raise RuntimeError(f"trial_draws launch failed for {shape}: "
                           f"{lib.trial_draws_error_string(rc).decode()}")
    tracing.count("draw.launches")
    tracing.count("draw.elements", out.numel())
    return out


def draw(mode: int, keys: torch.Tensor, offset: int, shape: Sequence[int],
         keep: float = 1.0) -> torch.Tensor:
    """The (T, ...) draw ``mode`` of ``shape`` (the trial axis leading, T =
    ``keys.numel()``) at counter ``offset``: D1 for CUDA keys, the plain
    version for CPU keys.  The caller advances its offset by
    :func:`counters` (n), n the elements a trial."""
    return (draw_kernel if keys.is_cuda else draw_plain)(mode, keys, offset, shape, keep)
