"""The Kendall loss on the card: two CUDA kernels, their plain versions, and
one ``torch.autograd.Function`` (counterpart of
``rankaae_tpu/ops/kendall_pallas.py``).

* :func:`pair_sums` — K1 (``csrc/kendall.cu::pair_sums_kernel`` and its
  finishing pass), replacing ``_fwd_kernel`` via ``_pair_sums_pallas``.
* :func:`grad_rows` — K2 (``csrc/kendall.cu::grad_rows_kernel``), replacing
  ``_bwd_kernel`` via ``_grad_rows_pallas``.
* :func:`kendall_constraint` — the dispatch that replaces
  ``kendall_constraint_pallas`` (custom VJP) and ``kendall_constraint_auto``:
  a CUDA tensor always goes to the kernel pair, for every batch size (the
  kernels bound their loops by B, so a small or ragged batch costs nothing
  extra); a CPU tensor goes to the plain loss of ``ops/kendall.py``.  There
  is no fallback from the kernels to the plain version: a kernel that does
  not build or launch raises.

Each wrapper takes (T, B, K) float32 contiguous tensors (T trials stacked),
checks them, and on a CPU tensor computes its kernel's plain version (for
the tests; ``chip_smoke.py`` holds the kernels against the same functions on
the card).  ``fwd_launches``/``bwd_launches`` count the kernel launches.

The shared library is built with ``nvcc`` on first use, from the source in
this package, into ``rankaae_tpu_torch/_build/`` (keyed by the source's hash),
and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

from rankaae_tpu_torch.ops import kendall as plain

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "kendall.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_B = 46340          # B * B must fit in int32 (the per-block pair counts)

#: kernel launches made through the wrappers (plain-version calls not counted)
fwd_launches = 0
bwd_launches = 0
#: nvcc's output (ptxas register/shared-memory report) of the last build
build_log = ""

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the Kendall kernels "
                       "cannot be built")


def build() -> ctypes.CDLL:
    """Compile ``csrc/kendall.cu`` (once per source version) and load it."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libkendall_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {SOURCE}:\n{build_log}")
        os.replace(tmp, so)       # atomic: concurrent builders never see half a file
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kendall_pair_sums.argtypes = [p, p, i, i, i, i, f, p, p, p, p, p, p, p]
    lib.kendall_pair_sums.restype = i
    lib.kendall_grad_rows.argtypes = [p, p, p, p, i, i, i, f, p, p]
    lib.kendall_grad_rows.restype = i
    lib.kendall_tile_rows.restype = i
    lib.kendall_error_string.argtypes = [i]
    lib.kendall_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


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
    if not (1 <= t <= 65535 and 2 <= b <= MAX_B and 1 <= k <= 32):   # kMaxK in kendall.cu
        raise ValueError(f"need 1 <= T <= 65535, 2 <= B <= {MAX_B}, 1 <= K <= 32; "
                         f"got {(t, b, k)}")
    return t, b, k


def _norm(b: int, k: int) -> float:
    return float((b * b - b) * k)


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.kendall_error_string(rc).decode()}")


# --------------------------------------------------------------------------- #
# K1: pair sums
# --------------------------------------------------------------------------- #

def pair_sums_plain(descriptors, styles, activate: bool):
    """Plain version of K1: (sums (T,K,2) [pos, neg], cnts (T,K,2) int32,
    w (T,K), loss (T,))."""
    _, b, k = styles.shape
    sum_pos, sum_neg, _, cnt_pos, cnt_neg = plain._pair_stats(descriptors, styles)
    if activate:
        w = plain.activation_weights(cnt_pos, cnt_neg)
    else:
        w = torch.ones_like(sum_pos)
    loss = -(w * sum_pos + sum_neg).sum(dim=-1) / _norm(b, k)
    sums = torch.stack([sum_pos, sum_neg], dim=-1)
    cnts = torch.stack([cnt_pos, cnt_neg], dim=-1).to(torch.int32)
    return sums, cnts, w, loss


def pair_sums(descriptors, styles, activate: bool):
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    global fwd_launches
    t, b, k = _check_pair(descriptors, styles)
    if styles.device.type == "cpu":
        return pair_sums_plain(descriptors, styles, activate)
    lib = build()
    dev = styles.device
    n_tiles = -(-b // lib.kendall_tile_rows())
    part_sum = torch.empty((t, k, n_tiles, 2), dtype=torch.float32, device=dev)
    part_cnt = torch.empty((t, k, n_tiles, 2), dtype=torch.int32, device=dev)
    sums = torch.empty((t, k, 2), dtype=torch.float32, device=dev)
    cnts = torch.empty((t, k, 2), dtype=torch.int32, device=dev)
    w = torch.empty((t, k), dtype=torch.float32, device=dev)
    loss = torch.empty((t,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.kendall_pair_sums(
        descriptors.data_ptr(), styles.data_ptr(), t, b, k, int(bool(activate)),
        _norm(b, k), part_sum.data_ptr(), part_cnt.data_ptr(), sums.data_ptr(),
        cnts.data_ptr(), w.data_ptr(), loss.data_ptr(), stream)
    _raise_on(lib, rc, "kendall_pair_sums")
    fwd_launches += 1
    return sums, cnts, w, loss


# --------------------------------------------------------------------------- #
# K2: gradient rows
# --------------------------------------------------------------------------- #

def grad_rows_plain(descriptors, styles, w, g):
    """Plain version of K2: d loss_t / d styles[t] given the incoming
    gradient g (T,) of each trial's loss, as (T, B, K)."""
    _, b, k = styles.shape
    target = torch.sign(descriptors[:, :, None, :] - descriptors[:, None, :, :])
    p = (styles[:, :, None, :] - styles[:, None, :, :]) * target
    w_eff_t = torch.where(p > 0, w[:, None, None, :] * target, target)
    rows = w_eff_t.sum(dim=2)
    scale = -2.0 * g / _norm(b, k)
    return rows * scale[:, None, None]


def grad_rows(descriptors, styles, w, g):
    """K2 on a CUDA tensor, its plain version on a CPU tensor."""
    global bwd_launches
    t, b, k = _check_pair(descriptors, styles)
    for name, x, shape in (("w", w, (t, k)), ("g", g, (t,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous() \
                or x.device != styles.device:
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on "
                             f"{styles.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if styles.device.type == "cpu":
        return grad_rows_plain(descriptors, styles, w, g)
    lib = build()
    grad = torch.empty_like(styles)
    stream = torch.cuda.current_stream(styles.device).cuda_stream
    rc = lib.kendall_grad_rows(
        descriptors.data_ptr(), styles.data_ptr(), w.data_ptr(), g.data_ptr(),
        t, b, k, _norm(b, k), grad.data_ptr(), stream)
    _raise_on(lib, rc, "kendall_grad_rows")
    bwd_launches += 1
    return grad


# --------------------------------------------------------------------------- #
# autograd + dispatch
# --------------------------------------------------------------------------- #

class KendallFunction(torch.autograd.Function):
    """Loss per trial (T,) from K1; the styles gradient from K2.  The
    descriptors get no gradient (they are constants)."""

    @staticmethod
    def forward(ctx, descriptors, styles, activate):
        _, _, w, loss = pair_sums(descriptors, styles, activate)
        ctx.save_for_backward(descriptors, styles, w)
        return loss

    @staticmethod
    def backward(ctx, g):
        descriptors, styles, w = ctx.saved_tensors
        grad = grad_rows(descriptors, styles, w, g.float().contiguous())
        return None, grad.to(styles.dtype), None


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
