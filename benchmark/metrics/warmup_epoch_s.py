"""The warm-up epoch's wall seconds: every shape's first call (cuDNN's and
cuBLAS's choices, the first launch of each kernel) and the recording the
check takes from it."""


def read(run):
    return run.warmup_epoch_s
