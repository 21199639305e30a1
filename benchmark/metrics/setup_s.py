"""Set-up: from the start of the process to the first timed epoch (imports,
CUDA start, the kernels' builds, data and weights from the seed, the
trainer's state, the recorded warm-up epoch)."""


def read(run):
    return run.setup_s
