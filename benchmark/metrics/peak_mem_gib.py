"""The window's peak of ``torch.cuda.max_memory_allocated()`` (reset at its
start), in GiB."""


def read(run):
    return run.peak_bytes / 2**30
