"""ctypes binding of the native CSV loader (counterpart of
``rankaae_tpu/data/native.py``), over the port's copy of its C++ source,
``csrc/csv_loader.cpp``.

The first call builds the source with ``g++`` (the JAX package's flags)
into ``rankaae_tpu_torch/_build/`` (the user's cache where the installed
package cannot be written), named by the hash of the source and the flags
as the CUDA libraries are (``ops/_nvcc.py::library_path``), and loads it;
nothing runs at import.  A build that cannot run (no ``g++``) or fails
raises ``RuntimeError``: ``data/dataset.py``'s ``engine="auto"`` then reads
with pandas, ``engine="native"`` lets it raise.  This is a host parser: its
floats are the same as the JAX package's loader gives.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from rankaae_tpu_torch.ops import _nvcc

SOURCE = _nvcc.CSRC / "csv_loader.cpp"
BUILD_DIR = _nvcc.BUILD_DIR
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    return _nvcc.library_path(SOURCE, GXX_FLAGS, BUILD_DIR)


def _build(so: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native CSV loader cannot be built")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True,
                         text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{res.stderr}")
    os.replace(tmp, so)          # atomic: a concurrent build never sees half a file


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.rankaae_csv_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                             ctypes.POINTER(ctypes.c_int64)]
            lib.rankaae_csv_dims.restype = ctypes.c_int
            lib.rankaae_csv_header.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                               ctypes.c_int64]
            lib.rankaae_csv_header.restype = ctypes.c_int64
            lib.rankaae_csv_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
            lib.rankaae_csv_read.restype = ctypes.c_int64
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether :func:`load` builds and loads the library
    (``rankaae_tpu/data/native.py:76``)."""
    try:
        load()
    except (OSError, RuntimeError):
        return False
    return True


def load_csv_native(path: str, n_index_cols: int = 2) -> Tuple[List[str], np.ndarray]:
    """Parse a RankAAE-schema CSV: (data column names, (n_rows, n_data_cols)
    float32 array).  Raises ``RuntimeError`` when the library cannot be
    built or the file cannot be parsed."""
    lib = load()
    bpath = os.fspath(path).encode()
    n_rows, n_cols = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.rankaae_csv_dims(bpath, ctypes.byref(n_rows), ctypes.byref(n_cols))
    if rc != 0:
        raise RuntimeError(f"rankaae_csv_dims failed with {rc} on {path}")
    buf = ctypes.create_string_buffer(1024 * 1024)
    if lib.rankaae_csv_header(bpath, buf, len(buf)) < 0:
        raise RuntimeError(f"rankaae_csv_header failed on {path}")
    data_cols = buf.value.decode().split(",")[n_index_cols:]
    out = np.empty((n_rows.value, n_cols.value - n_index_cols), np.float32)
    got = lib.rankaae_csv_read(bpath, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               n_rows.value, out.shape[1], n_index_cols)
    if got != n_rows.value:
        raise RuntimeError(f"rankaae_csv_read parsed {got}/{n_rows.value} rows of {path}")
    return data_cols, out
