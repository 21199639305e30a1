"""Faults planted in the program under test, for the readings that set the
check's limits and for the test that sees ``correct`` come out false.

Each is a context manager that patches the program's code in this process
and puts it back on exit:

* ``unchanged``: every optimizer step leaves the state as it was;
* ``half``: every mean-reduced loss (MSE, BCE, the reconstruction and
  smoothness losses, in training and validation) is taken over the first
  half of the batch and leaves the rest out;
* ``altered``: the reconstruction and mutual-information MSEs, where the
  trainer computes them, come out 1% high.

The controls are the program's own lower-precision paths, set in its
configuration: ``tf32`` (``matmul_precision: default``, TF32 matmuls and
convolutions) and ``bf16`` (``activation_dtype: bfloat16``).
"""
from __future__ import annotations

import contextlib

CONTROLS = {"tf32": {"matmul_precision": "default"}, "bf16": {"activation_dtype": "bfloat16"}}
FAULTS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def planted(name):
    """The program with fault ``name`` (one of :data:`FAULTS`, or None)."""
    from rankaae_tpu_torch.ops import losses
    from rankaae_tpu_torch.train import trainer

    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "unchanged":
        patch(trainer.RankAAETrainer, "_opt_step", lambda self, opt, loss, state: None)
    elif name == "half":
        mean = losses._per_trial_mean
        patch(losses, "_per_trial_mean",
              lambda x: mean(x[:, : max(1, x.shape[1] // 2)]) if x.dim() > 1 else mean(x))
    elif name == "altered":
        mse = trainer.mse
        patch(trainer, "mse", lambda a, b: mse(a, b) * 1.01)
    elif name is not None:
        raise ValueError(f"no fault {name!r}; have {FAULTS}")
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
