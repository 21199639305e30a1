"""The trial-stacked 1-D convolutions on the card: three CUDA kernels
(``csrc/conv1d.cu``), their plain versions, and two
``torch.autograd.Function``s.

* C1 :func:`forward` — a grouped convolution with zero or replicate
  padding and a stride, the bias added, one launch.
* C2 :func:`input_grad` — its gradient in the input, the replicate pad's
  gradient folded onto the ends inside the kernel, one launch; with a bias
  it is also the forward of a transposed convolution with kernel == stride.
* C3 :func:`weight_grad` — its weight gradient and a bias gradient, from
  per-tile partial sums and a fixed-order sum over the tiles (two launches
  a call): bit-identical from run to run.

The kernels replace no TPU kernel: the JAX package leaves its convolutions
to XLA.  They replace cuDNN on the conv forms' training path, where its
float32 heuristics picked FFT convolutions and generic weight-gradient
engines that held most of a T 32 epoch's device time (the benchmark's
traced epochs, ``PERF.md`` §5) for work bound by bytes: the kernels read
each input once and write each output once.

:class:`Conv1dFunction` (C1 forward; C2 and C3 backward) serves
``TrialConv1d`` and the smoothing loss's Gaussian filter;
:class:`ConvTranspose1dFunction` serves ``TrialConvTranspose1d`` with the
roles swapped (its forward is C2 with its bias, its input gradient C1, its
weight gradient C3 with x and dy exchanged, its bias gradient the sum of
its output gradient).  The weight layouts need no transposition: a
transposed convolution's (in, out/groups, k) weight is the (out, in/groups,
k) weight of the convolution it is the adjoint of.

:func:`conv1d` and :func:`conv_transpose1d` are what the modules call: a
CPU tensor takes the plain version (``F.pad`` + ``F.conv1d`` or
``F.conv_transpose1d``, differentiated by autograd); a CUDA float32 tensor
takes the kernels, or raises for a per-group shape outside :data:`SHAPES`
(never a fallback).  Inside the Functions each of C1–C3 has a plain
version of the same function (:func:`forward_plain`,
:func:`input_grad_plain`, :func:`weight_grad_plain`), taken for CPU
tensors: the CPU tests hold them, and so the role swap and the pad's fold,
against ``F.conv1d``'s autograd, and ``chip_smoke.py`` holds the kernels
against them on the card.  The counters ``conv.fwd_launches``,
``conv.dgrad_launches`` and ``conv.wgrad_launches`` (``utils/tracing.py``)
count the calls of C1, C2 and C3 (C3's two launches count once).

The shared library is built with ``nvcc`` by ``ops/_nvcc.py`` on first use
and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from rankaae_tpu_torch.ops import _nvcc
from rankaae_tpu_torch.utils import tracing

SOURCE = _nvcc.CSRC / "conv1d.cu"

#: the per-group shapes (C_in, C_out, taps, stride) with a kernel, in
#: convolution terms (a transposed convolution (in, out, k) is (out, in, k,
#: k)): every one the normal and compact forms and the CNN discriminator
#: build at the shipped configuration, and the smoothing filter (1, 1, 17, 1);
#: ``tests/test_torch_conv1d_kernels.py`` walks the models to keep it whole
SHAPES = (
    (1, 1, 2, 2), (1, 1, 4, 4), (1, 1, 17, 1), (1, 2, 4, 4), (1, 2, 5, 1),
    (1, 2, 8, 8), (1, 4, 1, 1), (1, 4, 2, 2), (1, 4, 4, 4), (1, 4, 11, 1),
    (1, 4, 11, 2), (2, 1, 1, 1), (2, 1, 5, 1), (2, 2, 5, 1), (2, 2, 11, 1),
    (3, 4, 1, 1), (4, 1, 1, 1), (4, 2, 11, 1), (4, 3, 4, 4), (4, 3, 8, 8),
    (4, 4, 2, 2), (4, 4, 4, 4), (4, 4, 5, 1), (4, 4, 5, 2), (4, 4, 7, 1),
    (4, 4, 7, 2), (4, 4, 11, 1), (4, 4, 11, 2), (4, 8, 2, 2), (8, 6, 2, 2),
    (8, 8, 2, 2), (8, 8, 4, 4),
)
#: C3's bias gradient: none, the sum of dy (a convolution's bias) or of x
#: (a transposed convolution's, which sits on C1's input side)
BIAS_NONE, BIAS_DY, BIAS_X = 0, 1, 2
#: C3's blocks per SM: the tiles of a call are about this many blocks per SM
#: over its groups
WGRAD_BLOCKS_PER_SM = 4

_lib: Optional[ctypes.CDLL] = None


class Geometry(NamedTuple):
    """One convolution in C1's terms: x (N, groups*c_in, lx) -> y (N,
    groups*c_out, ly) through taps ``k``, ``stride`` and ``pad`` (replicate
    when ``replicate``, else zero)."""

    c_in: int
    c_out: int
    k: int
    stride: int
    pad: int
    replicate: bool
    groups: int

    @property
    def key(self) -> Tuple[int, int, int, int]:
        return (self.c_in, self.c_out, self.k, self.stride)

    def out_length(self, lx: int) -> int:
        return (lx + 2 * self.pad - self.k) // self.stride + 1


def build() -> ctypes.CDLL:
    """Compile ``csrc/conv1d.cu`` (once per source version), load it and hold
    its table of shapes against :data:`SHAPES`."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _nvcc.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv1d_num_shapes.restype = i
    lib.conv1d_shape.argtypes = [i, ctypes.POINTER(ctypes.c_int * 4)]
    lib.conv1d_shape.restype = None
    lib.conv1d_forward.argtypes = [i, i, i, i, p, p, p, p, i, i, i, i, i, i, p]
    lib.conv1d_forward.restype = i
    lib.conv1d_input_grad.argtypes = [i, i, i, i, p, p, p, p, i, i, i, i, i, i, p]
    lib.conv1d_input_grad.restype = i
    lib.conv1d_weight_grad.argtypes = [i, i, i, i, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.conv1d_weight_grad.restype = i
    lib.conv1d_error_string.argtypes = [i]
    lib.conv1d_error_string.restype = ctypes.c_char_p
    table = []
    for j in range(lib.conv1d_num_shapes()):
        out = (ctypes.c_int * 4)()
        lib.conv1d_shape(j, ctypes.byref(out))
        table.append(tuple(out))
    if tuple(table) != SHAPES:
        raise RuntimeError(f"{SOURCE.name} was built for the shapes {table}, this wrapper "
                           f"expects {list(SHAPES)}")
    _lib = lib
    return lib


def _raise_on(lib, rc: int, what: str, geo: Geometry) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed for the per-group shape {geo.key}: "
                           f"{lib.conv1d_error_string(rc).decode()}")


def check_geometry(geo: Geometry) -> None:
    """Raise for a per-group shape with no kernel (``SHAPES``)."""
    if geo.key not in SHAPES:
        raise ValueError(f"no conv1d kernel for the per-group shape (C_in, C_out, taps, "
                         f"stride) = {geo.key}; the instantiated ones are "
                         f"ops/conv1d_cuda.py::SHAPES")


def _check_tensor(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _stream(dev: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(dev.index)


# --------------------------------------------------------------------------- #
# plain versions (CPU tensors; the kernels' reference on the card)
# --------------------------------------------------------------------------- #

def forward_plain(x, w, b, geo: Geometry):
    """Plain version of C1: ``F.pad`` (replicate) + ``F.conv1d``."""
    pad = geo.pad
    if geo.replicate and pad:
        x, pad = F.pad(x, (pad, pad), mode="replicate"), 0
    return F.conv1d(x, w, b, geo.stride, pad, 1, geo.groups)


def input_grad_plain(dy, w, lx: int, geo: Geometry, bias=None):
    """Plain version of C2: the gradient over the padded domain (a
    transposed convolution, zero-extended to lx + 2 pad), then its middle,
    with replicate padding the pad's gradient added to the ends; ``bias``
    (groups * c_in) added last."""
    lxp = lx + 2 * geo.pad
    dxp = F.conv_transpose1d(dy, w, None, geo.stride, 0, 0, geo.groups)
    dxp = F.pad(dxp, (0, lxp - dxp.shape[-1]))
    dx = dxp[..., geo.pad:geo.pad + lx]
    if geo.replicate and geo.pad:
        edges = torch.zeros_like(dx)
        edges[..., 0] = dxp[..., :geo.pad].sum(-1)
        edges[..., -1] = edges[..., -1] + dxp[..., geo.pad + lx:].sum(-1)
        dx = dx + edges
    return dx if bias is None else dx + bias[:, None]


def weight_grad_plain(x, dy, geo: Geometry, bias_of: int = BIAS_DY):
    """Plain version of C3: (dw (groups*c_out, c_in, k), db or None), db
    the sum of dy per channel (``BIAS_DY``) or of x (``BIAS_X``)."""
    n, ly = dy.shape[0], dy.shape[-1]
    g, ci, co, k = geo.groups, geo.c_in, geo.c_out, geo.k
    xp = x
    if geo.pad:
        xp = F.pad(x, (geo.pad, geo.pad), mode="replicate" if geo.replicate else "constant")
    cols = xp.unfold(-1, k, geo.stride)[..., :ly, :].reshape(n, g, ci, ly, k)
    dw = torch.einsum("ngol,ngclk->gock", dy.reshape(n, g, co, ly), cols).reshape(g * co, ci, k)
    if bias_of == BIAS_NONE:
        return dw, None
    return dw, (dy if bias_of == BIAS_DY else x).sum((0, 2))


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #

def forward(x, w, b, geo: Geometry):
    """C1 on CUDA tensors: x (N, groups*c_in, lx), w (groups*c_out, c_in, k),
    b (groups*c_out) or None -> y (N, groups*c_out, ly)."""
    check_geometry(geo)
    n, _, lx = x.shape
    ly = geo.out_length(lx)
    dev = x.device
    _check_tensor("x", x, (n, geo.groups * geo.c_in, lx), dev)
    _check_tensor("w", w, (geo.groups * geo.c_out, geo.c_in, geo.k), dev)
    if b is not None:
        _check_tensor("b", b, (geo.groups * geo.c_out,), dev)
    lib = build()
    y = torch.empty((n, geo.groups * geo.c_out, ly), dtype=torch.float32, device=dev)
    rc = lib.conv1d_forward(*geo.key, x.data_ptr(), w.data_ptr(),
                            None if b is None else b.data_ptr(), y.data_ptr(), n, geo.groups,
                            lx, ly, geo.pad, int(geo.replicate), _stream(dev))
    _raise_on(lib, rc, "conv1d_forward", geo)
    tracing.count("conv.fwd_launches")
    return y


def input_grad(dy, w, lx: int, geo: Geometry, bias=None):
    """C2 on CUDA tensors: dy (N, groups*c_out, ly) -> dx (N, groups*c_in,
    lx), plus ``bias`` (groups*c_in) where given."""
    check_geometry(geo)
    n, _, ly = dy.shape
    if geo.out_length(lx) != ly:
        raise ValueError(f"dy's length {ly} is not the output length of {lx} under {geo}")
    dev = dy.device
    _check_tensor("dy", dy, (n, geo.groups * geo.c_out, ly), dev)
    _check_tensor("w", w, (geo.groups * geo.c_out, geo.c_in, geo.k), dev)
    if bias is not None:
        _check_tensor("bias", bias, (geo.groups * geo.c_in,), dev)
    lib = build()
    dx = torch.empty((n, geo.groups * geo.c_in, lx), dtype=torch.float32, device=dev)
    rc = lib.conv1d_input_grad(*geo.key, dy.data_ptr(), w.data_ptr(),
                               None if bias is None else bias.data_ptr(), dx.data_ptr(), n,
                               geo.groups, lx, ly, geo.pad, int(geo.replicate), _stream(dev))
    _raise_on(lib, rc, "conv1d_input_grad", geo)
    tracing.count("conv.dgrad_launches")
    return dx


def wgrad_tiles(n: int, groups: int, device: torch.device) -> int:
    """C3's tiles of batch rows for a call: about ``WGRAD_BLOCKS_PER_SM``
    blocks per SM over the call's groups, at most one a row."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n, -(-WGRAD_BLOCKS_PER_SM * sms // groups)))


def weight_grad(x, dy, geo: Geometry, bias_of: int = BIAS_DY):
    """C3 on CUDA tensors: (dw (groups*c_out, c_in, k), db or None) from x
    (N, groups*c_in, lx) and dy (N, groups*c_out, ly); db as in
    :func:`weight_grad_plain`.  ``BIAS_X`` needs kernel == stride and no
    padding (a transposed convolution's)."""
    check_geometry(geo)
    n, _, lx = x.shape
    ly = geo.out_length(lx)
    dev = x.device
    _check_tensor("x", x, (n, geo.groups * geo.c_in, lx), dev)
    _check_tensor("dy", dy, (n, geo.groups * geo.c_out, ly), dev)
    if bias_of == BIAS_X and (geo.k != geo.stride or geo.pad or ly * geo.stride != lx):
        raise ValueError(f"C3 sums x for the bias only when kernel == stride, without "
                         f"padding and lx == ly * stride; got {geo} at lx {lx}")
    lib = build()
    nbias = {BIAS_NONE: 0, BIAS_DY: geo.c_out, BIAS_X: geo.c_in}[bias_of]
    taps = geo.c_out * geo.c_in * geo.k
    tiles = wgrad_tiles(n, geo.groups, dev)
    # one allocation: dw, db, then the per-tile slots (scratch, never viewed)
    words = taps + nbias
    buf = torch.empty(geo.groups * words * (1 + tiles), dtype=torch.float32, device=dev)
    dw = buf[:geo.groups * taps].view(geo.groups * geo.c_out, geo.c_in, geo.k)
    db = buf[geo.groups * taps:geo.groups * words] if nbias else None
    rc = lib.conv1d_weight_grad(*geo.key, x.data_ptr(), dy.data_ptr(),
                                buf.data_ptr() + 4 * geo.groups * words, dw.data_ptr(),
                                None if db is None else db.data_ptr(), n, geo.groups, lx, ly,
                                geo.pad, int(geo.replicate), bias_of, tiles, _stream(dev))
    _raise_on(lib, rc, "conv1d_weight_grad", geo)
    tracing.count("conv.wgrad_launches")
    return dw, db


# --------------------------------------------------------------------------- #
# autograd
# --------------------------------------------------------------------------- #

def _fwd(x, w, b, geo):
    return forward(x, w, b, geo) if x.is_cuda else forward_plain(x, w, b, geo)


def _dgrad(dy, w, lx, geo, bias=None):
    return (input_grad if dy.is_cuda else input_grad_plain)(dy, w, lx, geo, bias)


def _wgrad(x, dy, geo, bias_of):
    return (weight_grad if x.is_cuda else weight_grad_plain)(x, dy, geo, bias_of)


class Conv1dFunction(torch.autograd.Function):
    """y = C1(x, w, b); dx = C2(dy, w); dw, db = C3(x, dy).  ``b`` may be
    None.  Each of C1–C3 is the kernel on a CUDA tensor, its plain version
    on a CPU one."""

    @staticmethod
    def forward(ctx, x, w, b, geo: Geometry):
        ctx.geo, ctx.has_bias = geo, b is not None
        ctx.save_for_backward(x, w)
        return _fwd(x, w, b, geo)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        geo, dy = ctx.geo, dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _dgrad(dy, w, x.shape[-1], geo)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = _wgrad(x, dy, geo, BIAS_DY if ctx.has_bias else BIAS_NONE)
        return dx, dw, db, None


class ConvTranspose1dFunction(torch.autograd.Function):
    """The transposed convolution (kernel == stride, no padding) of the
    convolution ``geo`` (in its terms: the transposed one's input is C1's
    output side): y = C2(x, w) + b, dx = C1(dy, w), dw = C3(dy, x), db = the
    sum of dy per channel (C3's ``BIAS_X``)."""

    @staticmethod
    def forward(ctx, x, w, b, geo: Geometry):
        ctx.geo, ctx.has_bias = geo, b is not None
        ctx.save_for_backward(x, w)
        return _dgrad(x, w, x.shape[-1] * geo.stride, geo, b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        geo, dy = ctx.geo, dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _fwd(dy, w, None, geo)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = _wgrad(dy, x, geo, BIAS_X if ctx.has_bias else BIAS_NONE)
        return dx, dw, db, None


# --------------------------------------------------------------------------- #
# what the modules call
# --------------------------------------------------------------------------- #

def _on_card(x: torch.Tensor) -> bool:
    if not x.is_cuda:
        return False
    if x.dtype != torch.float32:
        raise TypeError(f"the conv1d kernels take float32, got {x.dtype}")
    return True


def conv_geometry(w, stride: int, pad: int, replicate: bool, groups: int) -> Geometry:
    """The :class:`Geometry` of a grouped ``conv1d`` with weight (groups*c_out,
    c_in, k)."""
    return Geometry(w.shape[1], w.shape[0] // groups, w.shape[2], stride, pad,
                    bool(replicate and pad), groups)


def transpose_geometry(w, stride: int, groups: int) -> Geometry:
    """The :class:`Geometry`, in convolution terms, of a grouped
    ``conv_transpose1d`` with weight (groups*c_in, c_out, k), k == stride."""
    return Geometry(w.shape[1], w.shape[0] // groups, w.shape[2], stride, 0, False, groups)


def conv1d(x, w, b, stride: int = 1, pad: int = 0, replicate: bool = False,
           groups: int = 1):
    """A grouped ``conv1d`` of (N, groups*c_in, L) with weight (groups*c_out,
    c_in, k), bias (groups*c_out) or None, zero or replicate padding: the
    kernels (C1; C2 and C3 backward) on a CUDA float32 tensor, ``F.pad`` +
    ``F.conv1d`` on a CPU tensor."""
    geo = conv_geometry(w, stride, pad, replicate, groups)
    if not _on_card(x):
        return forward_plain(x, w, b, geo)
    check_geometry(geo)
    return Conv1dFunction.apply(x.contiguous(), w.contiguous(),
                                None if b is None else b.contiguous(), geo)


def conv_transpose1d(x, w, b, stride: int, groups: int = 1):
    """A grouped ``conv_transpose1d`` with kernel == stride of (N,
    groups*c_in, L) with weight (groups*c_in, c_out, k): the kernels (C2;
    C1 and C3 backward) on a CUDA float32 tensor, ``F.conv_transpose1d`` on
    a CPU tensor."""
    if w.shape[2] != stride:
        raise ValueError(f"the transposed convolution needs kernel == stride, got "
                         f"{w.shape[2]} and {stride}")
    if not _on_card(x):
        return F.conv_transpose1d(x, w, b, stride, 0, 0, groups)
    geo = transpose_geometry(w, stride, groups)
    check_geometry(geo)
    return ConvTranspose1dFunction.apply(x.contiguous(), w.contiguous(),
                                         None if b is None else b.contiguous(), geo)
