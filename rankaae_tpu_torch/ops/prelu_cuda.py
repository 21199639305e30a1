"""The channel PReLUs of the trial-stacked conv layers and the sum of a
block's branches on the card: one CUDA kernel pair, P1
(``csrc/prelu_sum.cu``), its plain version and a
``torch.autograd.Function``.

Over (B, C, L) tensors, C the T*C channels of a stacked module, P1 computes

    out = act_1(y_1) [+ act_2(y_2) [+ act_3(y_3)]]

each ``act_k`` the channel PReLU with slopes ``w_k`` (C) or, where ``w_k``
is None, the identity (the un-activated residual of a stride-1 block), the
terms added in the order given: bit for bit ``F.prelu`` and the adds
``(t1 + t2) + t3`` of the blocks.  Its backward gives each activated term's
gradient (bit for bit PyTorch's) and its slope gradient, summed over (B, L)
in a fixed order inside the kernel (bit-identical run to run; within float
rounding of PyTorch's, which writes a full-size slope gradient and reduces
it in a third pass).  An identity term's gradient is the output's gradient
itself.

* :func:`forward` (one launch) and :func:`backward` (two: the per-tile
  partials and their fixed-order sum) launch the kernels on CUDA tensors;
  :func:`forward_plain` and :func:`backward_plain` are the same functions in
  plain PyTorch, which :class:`PReLUSumFunction` takes for CPU tensors (the
  CPU tests hold them to ``F.prelu``'s autograd, ``chip_smoke.py`` holds
  the kernels to them on the card).
* :func:`prelu_sum` is what the modules call with a list of terms ``(y,
  w or None)``; :func:`takes` says whether a tensor takes P1: a CUDA
  float32 tensor.  The callers ask it only for trial-stacked modules
  (``TrialChannelPReLU``, ``TrialEncodingBlock``, ``TrialDecodingBlock``):
  the CPU, the bfloat16 branch, the single-trial modules and the
  features-axis ``TrialPReLU`` keep ``F.prelu`` and the adds.

The kernels replace no TPU kernel: the JAX package leaves its PReLUs and
adds to XLA.  The counters ``prelu.fwd_launches`` and ``prelu.bwd_launches``
(``utils/tracing.py``) count the forward and backward launches (two a
backward call), and ``prelu.tail_launches`` the forward launches that
summed several terms: one a block forward that runs module by module.

The shared library is built with ``nvcc`` by ``ops/_nvcc.py`` on first use
and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch

from rankaae_tpu_torch.ops import _nvcc
from rankaae_tpu_torch.utils import tracing

SOURCE = _nvcc.CSRC / "prelu_sum.cu"

MAX_TERMS = 3
#: the term patterns with a kernel, as (PReLU or identity) per term; keep in
#: step with PRELU_PATTERNS in csrc/prelu_sum.cu
PATTERNS = ((True,), (True, False, True), (True, True, True))
#: the backward's threads a block and the rows of a batch tile at most; its
#: tiles are at least enough for this many blocks, whatever the card
THREADS, ROWS_PER_TILE, TARGET_BLOCKS = 256, 32, 1024

Term = Tuple[torch.Tensor, Optional[torch.Tensor]]

_lib: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile ``csrc/prelu_sum.cu`` (once per source version) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _nvcc.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.prelu_sum_forward.argtypes = [i, i] + [p] * 7 + [i, i, i, i, p]
    lib.prelu_sum_forward.restype = i
    lib.prelu_sum_backward.argtypes = [i, i] + [p] * 14 + [i, i, i, i, i, p]
    lib.prelu_sum_backward.restype = i
    lib.prelu_sum_error_string.argtypes = [i]
    lib.prelu_sum_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def act_mask(ws: Sequence[Optional[torch.Tensor]]) -> int:
    """Bit k set where term k is a PReLU (has slopes)."""
    return sum(1 << k for k, w in enumerate(ws) if w is not None)


def inner_size(t: torch.Tensor) -> Optional[int]:
    """The elements between one channel and the next in the memory of the
    (B, C, L) tensor ``t`` laid out densely with its dims in any order (a
    contiguous tensor: L; a (C, B, L) one viewed as (B, C, L): B*L); None
    where ``t`` is not dense.  P1 walks the memory as (outer, C, inner)."""
    order = sorted(range(3), key=lambda d: -t.stride(d))
    if not t.permute(order).is_contiguous():
        return None
    return math.prod(t.shape[d] for d in order[order.index(1) + 1:])


def _strides(t: torch.Tensor) -> tuple:
    """The strides of ``t``'s dims longer than 1 (the others never move)."""
    return tuple(st for st, n in zip(t.stride(), t.shape) if n > 1)


def in_layout(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``y``'s values in the memory layout of ``like`` (``y`` itself where it
    has it)."""
    return y if _strides(y) == _strides(like) else torch.empty_like(like).copy_(y)


def same_layout(ys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The terms in one dense layout, the first term's where it is dense
    (as PyTorch's prelu and adds lay out their outputs), else contiguous."""
    first = ys[0] if inner_size(ys[0]) is not None else ys[0].contiguous()
    return [first] + [in_layout(y, first) for y in ys[1:]]


def _check(ys, ws, dout=None) -> int:
    """Raise unless the terms are float32 (B, C, L) tensors on one device in
    one dense layout with (C) slopes, in one of PATTERNS (in the backward
    ``dout`` sets the shape and layout, and an identity term's y may be
    None); return the layout's inner size."""
    pattern = tuple(w is not None for w in ws)
    if len(ys) != len(ws) or pattern not in PATTERNS:
        raise ValueError(f"P1 has kernels for the term patterns {PATTERNS} (PReLU or "
                         f"identity a term), got {pattern} for {len(ys)} terms")
    first = ys[0] if dout is None else dout
    shape, dev = tuple(first.shape), first.device
    inner = inner_size(first) if len(shape) == 3 else None
    if inner is None:
        raise ValueError(f"P1 takes dense (B, C, L) tensors, got {shape} with strides "
                         f"{first.stride()}")
    named = [(f"y_{k}", y, shape) for k, y in enumerate(ys) if y is not None]
    named += [("dout", dout, shape)] if dout is not None else []
    for name, t, want in named:
        if t.dtype != torch.float32 or tuple(t.shape) != want \
                or _strides(t) != _strides(first) or t.device != dev:
            raise ValueError(f"{name} must be a float32 {want} tensor on {dev} with strides "
                             f"{first.stride()}, got {t.dtype} {tuple(t.shape)} with "
                             f"{t.stride()} on {t.device}")
    for k, w in enumerate(ws):
        if w is not None and (w.dtype != torch.float32 or tuple(w.shape) != shape[1:2]
                              or not w.is_contiguous() or w.device != dev):
            raise ValueError(f"w_{k} must be a contiguous float32 {shape[1:2]} tensor on "
                             f"{dev}, got {w.dtype} {tuple(w.shape)} on {w.device}")
    if first.numel() >= 2 ** 31:
        raise ValueError(f"P1 indexes with 32 bits: {shape} has {first.numel()} elements")
    return inner


def _vec(inner: int, *tensors) -> bool:
    """The 16-byte path: inner a multiple of 4 and every pointer 16-byte
    aligned."""
    return inner % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def tiles(outer: int, channels: int, inner: int, vec: bool) -> int:
    """The backward's tiles of the outer rows: at most ROWS_PER_TILE rows a
    tile, and enough tiles that the chunks of whole channels times the tiles
    make about TARGET_BLOCKS blocks.  A function of the shape: the slope
    gradients' order of summation is the same on every card."""
    per = THREADS * (4 if vec else 1)
    chunks = -(-channels // (1 if inner >= per else per // inner))
    return max(1, min(outer, max(-(-outer // ROWS_PER_TILE), -(-TARGET_BLOCKS // chunks))))


def _stream(dev: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _padded(ts: Sequence[Optional[torch.Tensor]]) -> List[Optional[int]]:
    """Data pointers of ``ts`` (None for a missing one), padded to MAX_TERMS."""
    ptrs = [None if t is None else t.data_ptr() for t in ts]
    return ptrs + [None] * (MAX_TERMS - len(ptrs))


def _raise_on(lib, rc: int, what: str, shape, ws) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed at {tuple(shape)} with slopes "
                           f"{[w is not None for w in ws]}: "
                           f"{lib.prelu_sum_error_string(rc).decode()}")


# --------------------------------------------------------------------------- #
# plain versions (CPU tensors; the kernels' reference on the card)
# --------------------------------------------------------------------------- #

def forward_plain(ys: Sequence[torch.Tensor], ws: Sequence[Optional[torch.Tensor]]):
    """Plain version of P1's forward: each activated term y > 0 ? y : w * y
    (PyTorch's prelu), the terms added in order."""
    out = None
    for y, w in zip(ys, ws):
        v = y if w is None else torch.where(y > 0, y, w[:, None] * y)
        out = v if out is None else out + v
    return out


def backward_plain(dout, ys, ws):
    """Plain version of P1's backward: (dy_k, dw_k) for each activated term
    (None for an identity term), as PyTorch's PReLU backward computes them:
    dy = y > 0 ? dout : w * dout, dw the sum over (B, L) of y > 0 ? 0 : y *
    dout."""
    dys, dws = [], []
    for y, w in zip(ys, ws):
        if w is None:
            dys.append(None)
            dws.append(None)
            continue
        pos = y > 0
        dys.append(torch.where(pos, dout, w[:, None] * dout))
        dws.append(torch.where(pos, 0, y * dout).sum((0, 2)))
    return dys, dws


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #

def forward(ys: Sequence[torch.Tensor], ws: Sequence[Optional[torch.Tensor]]):
    """P1's forward on CUDA tensors, one launch: the sum of the terms (B, C,
    L, in one dense layout, which the output takes), term k activated by the
    slopes ``ws[k]`` (C) where given."""
    inner = _check(ys, ws)
    lib = build()
    out = torch.empty_like(ys[0])
    n, c = out.numel(), out.shape[1]
    rc = lib.prelu_sum_forward(len(ys), act_mask(ws), *_padded(ys), *_padded(ws),
                               out.data_ptr(), n // max(1, c * inner), c, inner,
                               int(_vec(inner, out, *ys)), _stream(out.device))
    _raise_on(lib, rc, "prelu_sum_forward", out.shape, ws)
    tracing.count("prelu.fwd_launches")
    if len(ys) > 1:
        tracing.count("prelu.tail_launches")
    return out


def backward(dout: torch.Tensor, ys: Sequence[Optional[torch.Tensor]],
             ws: Sequence[Optional[torch.Tensor]]):
    """P1's backward on CUDA tensors (``dout`` and the activated terms' y in
    one dense layout, which the dy take), two launches: (dy_k, dw_k) of
    each activated term, None for an identity term (whose y may be None),
    as :func:`backward_plain`."""
    inner = _check(ys, ws, dout)
    lib = build()
    act = [k for k, w in enumerate(ws) if w is not None]
    dys = [torch.empty_like(dout) if k in act else None for k in range(len(ws))]
    n, c = dout.numel(), dout.shape[1]
    outer = n // max(1, c * inner)
    vec = _vec(inner, dout, *(ys[k] for k in act), *(dys[k] for k in act))
    n_tiles = tiles(outer, c, inner, vec)
    dw = torch.empty((len(ws), c), dtype=torch.float32, device=dout.device)
    partial = torch.empty(n_tiles * len(ws) * c, dtype=torch.float64, device=dout.device)
    dws = [dw[k] if k in act else None for k in range(len(ws))]
    rc = lib.prelu_sum_backward(len(ws), act_mask(ws), dout.data_ptr(), *_padded(ys),
                                *_padded(ws), *_padded(dys), *_padded(dws), partial.data_ptr(),
                                outer, c, inner, int(vec), n_tiles, _stream(dout.device))
    _raise_on(lib, rc, "prelu_sum_backward", dout.shape, ws)
    tracing.count("prelu.bwd_launches", 2)
    return dys, dws


# --------------------------------------------------------------------------- #
# autograd
# --------------------------------------------------------------------------- #

class PReLUSumFunction(torch.autograd.Function):
    """out = the sum of the terms; arguments y_1, w_1, y_2, w_2, ... (w_k
    None for an identity term).  The kernels on CUDA tensors, the plain
    versions on CPU ones."""

    @staticmethod
    def forward(ctx, *args):
        ys, ws = same_layout(args[0::2]), args[1::2]
        ctx.act = [w is not None for w in ws]
        # an identity term's y is not kept: its gradient is dout
        ctx.save_for_backward(*(t for y, w in zip(ys, ws) if w is not None for t in (y, w)))
        return (forward if ys[0].is_cuda else forward_plain)(ys, ws)

    @staticmethod
    def backward(ctx, dout):
        saved = iter(ctx.saved_tensors)
        ys, ws = [], []
        for a in ctx.act:
            ys.append(next(saved) if a else None)
            ws.append(next(saved) if a else None)
        g = in_layout(dout, next(y for y in ys if y is not None))
        dys, dws = (backward if g.is_cuda else backward_plain)(g, ys, ws)
        grads = []
        for dy, dw in zip(dys, dws):
            grads += [dout if dy is None else dy, dw]    # an identity term: dout as it came
        return tuple(grads)


# --------------------------------------------------------------------------- #
# what the modules call
# --------------------------------------------------------------------------- #

def takes(y: torch.Tensor) -> bool:
    """Whether a trial-stacked module's (B, T*C, L) tensor ``y`` takes P1: a
    CUDA float32 tensor (the CPU and the bfloat16 branch keep ``F.prelu``)."""
    return y.is_cuda and y.dtype == torch.float32


def prelu_sum(terms: Sequence[Term]) -> torch.Tensor:
    """The sum of ``terms`` ((y, w) pairs; w the (T*C) slopes, or None for an
    identity term) through :class:`PReLUSumFunction`."""
    args = []
    for y, w in terms:
        args += [y, None if w is None else w.contiguous()]
    return PReLUSumFunction.apply(*args)
