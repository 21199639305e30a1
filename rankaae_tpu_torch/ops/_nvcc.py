"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` is compiled into a shared library with a plain C
interface (``-shared -Xcompiler -fPIC`` for ``sm_90a``) in
``rankaae_tpu_torch/_build/`` (in the user's cache where the installed
package cannot be written; :func:`library_path`), named by the hash of the
source and the flags, so an unchanged source is never rebuilt and an edited
one always is.  nvcc's output (the ptxas register, shared-memory and spill
report) is kept beside each library and read back by :func:`build_log`.  :func:`compile_all`
starts one ``nvcc`` per source at once and waits for all of them;
:func:`load` compiles one source if needed and loads it.  Both add their
seconds to the counter ``setup.kernel_load_s`` and each ``nvcc`` they
start to ``setup.kernel_builds`` (``utils/tracing.py``).  Nothing here runs
when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, Optional

from rankaae_tpu_torch.utils import tracing

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _writable(d: Path) -> bool:
    """Whether ``d`` can be written, or made where it is missing."""
    while not d.exists():
        d = d.parent
    return os.access(d, os.W_OK)


def library_path(source: Path, flags: Iterable[str] = NVCC_FLAGS,
                 build_dir: Optional[Path] = None) -> Path:
    """The library of ``source`` built with ``flags``: in ``build_dir``
    (default the package's ``_build/``) where it is built or can be built
    there, else in ``~/.cache/rankaae_tpu_torch/build`` (the package's
    directory cannot be written: a read-only install).  Makes no directory."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    name = f"lib{source.stem}_{digest.hexdigest()[:16]}.so"
    build_dir = BUILD_DIR if build_dir is None else build_dir
    if (build_dir / name).exists() or _writable(build_dir):
        return build_dir / name
    return Path.home() / ".cache" / "rankaae_tpu_torch" / "build" / name


def build_log(source: Path) -> str:
    """nvcc's output from building ``source``'s library (built or cached)."""
    return library_path(source).with_suffix(".log").read_text()


@tracing.timed("setup.kernel_load_s")
def compile_all(sources: Iterable[Path]) -> None:
    """Compile every source whose library is not built yet, one ``nvcc``
    process per source, all running at once; raise if any fails."""
    _compile(sources)


def _compile(sources: Iterable[Path]) -> None:
    jobs = []
    for source in sources:
        so = library_path(source)
        if so.exists():
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        tracing.count("setup.kernel_builds")
        jobs.append((source, so, tmp, proc))
    failed = []
    for source, so, tmp, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {source}:\n{log}")
            continue
        tmp_log = tmp.with_suffix(".log")
        tmp_log.write_text(log)
        # the log before the library, so a library that exists has one; each
        # replace is atomic, so concurrent builders never see half a file
        os.replace(tmp_log, so.with_suffix(".log"))
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


@tracing.timed("setup.kernel_load_s")
def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, compiled first if needed."""
    _compile([source])
    return ctypes.CDLL(str(library_path(source)))
