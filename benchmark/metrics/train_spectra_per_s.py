"""Training throughput per GPU: T trials x n_train spectra x the epochs that
completed in the window, over the window's seconds (from the sync after
set-up to the sync that ends its last epoch)."""


def read(run):
    return run.rate
