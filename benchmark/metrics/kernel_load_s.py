"""Seconds the program spent building (``nvcc``, on a checkout's first run)
and loading its CUDA kernels K1-K3: its counter ``setup.kernel_load_s``
(``rankaae_tpu_torch/ops/_nvcc.py``; ``setup.kernel_builds`` counts the
builds).  Nothing to read where the program has no such counter."""


def read(run):
    try:
        from rankaae_tpu_torch.utils import tracing
    except ImportError:
        return None
    value = tracing.counters().get("setup.kernel_load_s")
    return None if value is None else float(value)
