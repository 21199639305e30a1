"""The Kendall loss on the card: two CUDA kernels, their plain versions, and
one ``torch.autograd.Function`` (counterpart of
``rankaae_tpu/ops/kendall_pallas.py``).

* :func:`pair_sums` — K1 (``csrc/kendall.cu::pair_sums_kernel``, one launch
  a call), replacing ``_fwd_kernel`` via ``_pair_sums_pallas``: the pair sums,
  counts, activation weights and loss, and on request the integer row sums
  P and N that the gradient needs.
* :func:`grad_rows` — K2 (``csrc/kendall.cu::grad_rows_kernel``, one launch
  a call), replacing ``_bwd_kernel`` via ``_grad_rows_pallas``: the styles
  gradient from P, N, w and g, elementwise (it evaluates no pairs).
* :func:`kendall_constraint` — the dispatch that replaces
  ``kendall_constraint_pallas`` (custom VJP) and ``kendall_constraint_auto``:
  a CUDA tensor always goes to the kernel pair, for every batch size (the
  kernels bound their loops by B, so a small or ragged batch costs nothing
  extra); a CPU tensor goes to the plain loss of ``ops/kendall.py``.  There
  is no fallback from the kernels to the plain version: a kernel that does
  not build or launch raises.

Each wrapper checks its tensors and on a CPU tensor computes its kernel's
plain version (for the tests; ``chip_smoke.py`` holds the kernels against the
same functions on the card).  On a CUDA tensor it makes one allocation, from
which it carves every output and scratch buffer.  The counters
``kendall.fwd_launches`` and ``kendall.bwd_launches`` (``utils/tracing.py``)
count the kernel launches (plain-version calls not counted).

The shared library is built with ``nvcc`` on first use, from the source in
this package, by ``ops/_nvcc.py`` and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from rankaae_tpu_torch.ops import _nvcc
from rankaae_tpu_torch.ops import kendall as plain
from rankaae_tpu_torch.utils import tracing

SOURCE = _nvcc.CSRC / "kendall.cu"
MAX_T = 65535          # trials: the grid's z extent, and one ticket word each
MAX_B = 46340          # B * B must fit in int32 (the per-block pair counts)
MAX_K = 32             # kMaxK in kendall.cu
SLOT_WORDS = 4         # kendall.cu's Slot: [pos, neg] sums and counts, 16 bytes

_lib: Optional[ctypes.CDLL] = None
_tile_rows = 0
#: K1's per-trial tickets: one zeroed buffer per (CUDA device, raw stream
#: handle), allocated by the first call on that stream (the kernel leaves
#: every ticket at 0), so calls on two streams never share a ticket
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def build() -> ctypes.CDLL:
    """Compile ``csrc/kendall.cu`` (once per source version), load it and
    read its constants."""
    global _lib, _tile_rows
    if _lib is not None:
        return _lib
    lib = _nvcc.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kendall_pair_sums.argtypes = [p, p, i, i, i, i, f, p, p, p, p, p, p, p, p]
    lib.kendall_pair_sums.restype = i
    lib.kendall_grad_rows.argtypes = [p, p, p, p, i, i, i, f, p, p]
    lib.kendall_grad_rows.restype = i
    lib.kendall_tile_rows.restype = i
    lib.kendall_error_string.argtypes = [i]
    lib.kendall_error_string.restype = ctypes.c_char_p
    _tile_rows = lib.kendall_tile_rows()
    _lib = lib
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() \
            or x.device != device:
        raise ValueError(f"{name} must be a contiguous {dtype} {shape} tensor on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_pair(descriptors: torch.Tensor, styles: torch.Tensor) -> Tuple[int, int, int]:
    for name, x in (("descriptors", descriptors), ("styles", styles)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 3:
            raise ValueError(f"{name} must be (T, B, K), got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if descriptors.shape != styles.shape:
        raise ValueError(f"shape mismatch: descriptors {tuple(descriptors.shape)} "
                         f"vs styles {tuple(styles.shape)}")
    if descriptors.device != styles.device:
        raise ValueError("descriptors and styles must be on one device")
    if styles.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {styles.device}")
    t, b, k = styles.shape
    _check_sizes(t, b, k)
    return t, b, k


def _check_sizes(t: int, b: int, k: int) -> None:
    if not (1 <= t <= MAX_T and 2 <= b <= MAX_B and 1 <= k <= MAX_K):
        raise ValueError(f"need 1 <= T <= {MAX_T}, 2 <= B <= {MAX_B}, 1 <= K <= {MAX_K}; "
                         f"got {(t, b, k)}")


def _norm(b: int, k: int) -> float:
    return float((b * b - b) * k)


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.kendall_error_string(rc).decode()}")


# --------------------------------------------------------------------------- #
# K1: pair sums (and the row sums)
# --------------------------------------------------------------------------- #

def _row_sums_plain(descriptors, styles):
    """Plain version of K1's row sums: P[t,a,k] = sum over j with p_aj > 0
    of tgt_aj and N[t,a,k] = the sum over the other j, int32 (T, B, K)."""
    target = torch.sign(descriptors[:, :, None, :] - descriptors[:, None, :, :])
    p = (styles[:, :, None, :] - styles[:, None, :, :]) * target
    tgt = target.to(torch.int32)
    zero = torch.zeros_like(tgt)
    pos = p > 0
    return (torch.where(pos, tgt, zero).sum(dim=2, dtype=torch.int32),
            torch.where(pos, zero, tgt).sum(dim=2, dtype=torch.int32))


def pair_sums_plain(descriptors, styles, activate: bool, rows: bool = False):
    """Plain version of K1: (sums (T,K,2) [pos, neg], cnts (T,K,2) int32,
    w (T,K), loss (T,)), and with ``rows`` also P and N (see
    :func:`_row_sums_plain`)."""
    _, b, k = styles.shape
    sum_pos, sum_neg, _, cnt_pos, cnt_neg = plain._pair_stats(descriptors, styles)
    if activate:
        w = plain.activation_weights(cnt_pos, cnt_neg)
    else:
        w = torch.ones_like(sum_pos)
    loss = -(w * sum_pos + sum_neg).sum(dim=-1) / _norm(b, k)
    sums = torch.stack([sum_pos, sum_neg], dim=-1)
    cnts = torch.stack([cnt_pos, cnt_neg], dim=-1).to(torch.int32)
    if rows:
        return (sums, cnts, w, loss, *_row_sums_plain(descriptors, styles))
    return sums, cnts, w, loss


def _tickets_on(device: torch.device, stream: int) -> torch.Tensor:
    tickets = _tickets.get((device.index, stream))
    if tickets is None:
        tickets = _tickets[(device.index, stream)] = torch.zeros(MAX_T, dtype=torch.int32,
                                                                device=device)
    return tickets


def pair_sums(descriptors, styles, activate: bool, rows: bool = False):
    """K1 on a CUDA tensor, its plain version on a CPU tensor.  Returns
    (sums, cnts, w, loss), and with ``rows`` also the row sums P and N."""
    t, b, k = _check_pair(descriptors, styles)
    if styles.device.type == "cpu":
        return pair_sums_plain(descriptors, styles, activate, rows)
    lib = build()
    dev = styles.device
    # one buffer of 32-bit words: loss (T,), w (T, K), sums (T, K, 2), then
    # the int32 cnts (T, K, 2) and, with rows, P and N (T, B, K) each, then
    # the slots (T, K, n_tiles) of 16 bytes (scratch, never viewed)
    tk = t * k
    n_rows = t * b * k if rows else 0
    o_cnts = t + 3 * tk
    o_slots = -(-(o_cnts + 2 * tk + 2 * n_rows) // SLOT_WORDS) * SLOT_WORDS
    buf = torch.empty(o_slots + tk * -(-b // _tile_rows) * SLOT_WORDS, dtype=torch.float32,
                      device=dev)
    ints = buf.view(torch.int32)
    loss = buf.as_strided((t,), (1,), 0)
    w = buf.as_strided((t, k), (k, 1), t)
    sums = buf.as_strided((t, k, 2), (2 * k, 2, 1), t + tk)
    cnts = ints.as_strided((t, k, 2), (2 * k, 2, 1), o_cnts)
    base = buf.data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = lib.kendall_pair_sums(
        descriptors.data_ptr(), styles.data_ptr(), t, b, k, int(bool(activate)),
        _norm(b, k), _tickets_on(dev, stream).data_ptr(), base + 4 * o_slots,
        sums.data_ptr(), cnts.data_ptr(), w.data_ptr(), base,
        base + 4 * (o_cnts + 2 * tk) if rows else None, stream)
    _raise_on(lib, rc, "kendall_pair_sums")
    tracing.count("kendall.fwd_launches")
    if rows:
        o_pos = o_cnts + 2 * tk
        return (sums, cnts, w, loss, ints.as_strided((t, b, k), (b * k, k, 1), o_pos),
                ints.as_strided((t, b, k), (b * k, k, 1), o_pos + n_rows))
    return sums, cnts, w, loss


# --------------------------------------------------------------------------- #
# K2: gradient rows
# --------------------------------------------------------------------------- #

def grad_rows_plain(pos_rows, neg_rows, w, g):
    """Plain version of K2: d loss_t / d styles[t] given K1's row sums, its
    weights and the incoming gradient g (T,) of each trial's loss, as
    (T, B, K): -2 g_t / ((B^2 - B) K) * (w_k P + N)."""
    _, b, k = pos_rows.shape
    scale = -2.0 * g / _norm(b, k)
    return scale[:, None, None] * (w[:, None, :] * pos_rows.float() + neg_rows.float())


def grad_rows(pos_rows, neg_rows, w, g):
    """K2 on a CUDA tensor, its plain version on a CPU tensor."""
    if pos_rows.dim() != 3:
        raise ValueError(f"pos_rows must be (T, B, K), got shape {tuple(pos_rows.shape)}")
    t, b, k = pos_rows.shape
    dev = pos_rows.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _check_sizes(t, b, k)
    _check("pos_rows", pos_rows, torch.int32, (t, b, k), dev)
    _check("neg_rows", neg_rows, torch.int32, (t, b, k), dev)
    _check("w", w, torch.float32, (t, k), dev)
    _check("g", g, torch.float32, (t,), dev)
    if dev.type == "cpu":
        return grad_rows_plain(pos_rows, neg_rows, w, g)
    lib = build()
    grad = torch.empty((t, b, k), dtype=torch.float32, device=dev)
    rc = lib.kendall_grad_rows(
        pos_rows.data_ptr(), neg_rows.data_ptr(), w.data_ptr(), g.data_ptr(), t, b, k,
        _norm(b, k), grad.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index))
    _raise_on(lib, rc, "kendall_grad_rows")
    tracing.count("kendall.bwd_launches")
    return grad


# --------------------------------------------------------------------------- #
# autograd + dispatch
# --------------------------------------------------------------------------- #

class KendallFunction(torch.autograd.Function):
    """Loss per trial (T,) from K1; the styles gradient from K2, given the
    row sums K1 wrote in the same pass.  The descriptors get no gradient
    (they are constants).  K1 computes the row sums only when a gradient
    will be asked for: grad mode on and styles requiring grad (``apply``
    decides, since ``forward`` always runs with grad mode off)."""

    @classmethod
    def apply(cls, descriptors, styles, activate):
        rows = torch.is_grad_enabled() and styles.requires_grad
        return super().apply(descriptors, styles, activate, rows)

    @staticmethod
    def forward(ctx, descriptors, styles, activate, rows):
        if not rows:
            return pair_sums(descriptors, styles, activate)[3]
        _, _, w, loss, pos_rows, neg_rows = pair_sums(descriptors, styles, activate, rows=True)
        ctx.save_for_backward(pos_rows, neg_rows, w)
        return loss

    @staticmethod
    def backward(ctx, g):
        pos_rows, neg_rows, w = ctx.saved_tensors
        return None, grad_rows(pos_rows, neg_rows, w, g.float().contiguous()), None, None


def kendall_constraint(descriptors, styles, activate: bool = False):
    """Kendall loss of (B, K) inputs (scalar) or (T, B, K) inputs ((T,)).

    CUDA tensors go through the kernel pair for every B; CPU tensors
    through the plain loss of ``ops/kendall.py``."""
    if styles.device.type == "cpu":
        return plain.kendall_constraint(descriptors, styles, activate=activate)
    single = styles.dim() == 2
    d = descriptors.detach().float().contiguous()
    s = styles.float().contiguous()
    if single:
        d, s = d[None], s[None]
    loss = KendallFunction.apply(d, s, bool(activate))
    return loss[0] if single else loss
