"""``Trainer.get_style_distribution_plot`` of the port's facade against the
JAX package's (``rankaae_tpu/train/facade.py:120-139``): the same figure
size, nstyle shared-axis rows, and on each row the same step-filled
histogram (its outline's vertices, so the bins and the counts), for a latent
batch given as an array and as a tensor."""
from types import SimpleNamespace

import numpy as np
import torch

from rankaae_tpu.train.facade import Trainer as JaxTrainer

from rankaae_tpu_torch.train.facade import Trainer
from tests import torch_parity  # noqa: F401  (one torch thread a process)


def _outlines(fig):
    return [[np.asarray(p.get_xy()) for p in ax.patches] for ax in fig.axes]


def test_style_plot_equals_jax():
    nstyle = 6
    z = np.random.default_rng(0).normal(size=(500, nstyle)).astype(np.float32)
    owner = SimpleNamespace(core=SimpleNamespace(cfg=SimpleNamespace(nstyle=nstyle)))
    ref = JaxTrainer.get_style_distribution_plot(owner, z)
    for latent in (z, torch.from_numpy(z)):
        fig = Trainer.get_style_distribution_plot(owner, latent)
        assert len(fig.axes) == nstyle
        assert tuple(fig.get_size_inches()) == tuple(ref.get_size_inches())
        got, want = _outlines(fig), _outlines(ref)
        assert [len(a) for a in got] == [len(a) for a in want] == [1] * nstyle
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[0], b[0])
        # the outline's heights are the counts over arange(-3, 3.01, 0.2)
        counts = np.histogram(z[:, 0], bins=np.arange(-3.0, 3.01, 0.2))[0]
        assert set(got[0][0][:, 1]) == set(counts.astype(float)) | {0.0}
