"""One faithful batch of the normal conv form with ``remat: true`` against
the JAX package's ``remat=True`` batch (``nn.remat`` over every conv
block), as ``tests/test_torch_conv_train_normal.py`` holds the batch
without it: ``lr_base`` 1e-4, the whole batch within 1e-4 or twice its 1e-7
perturbation spread, and every step alone from the JAX package's inputs
(``tests/torch_parity.py::compare_batch_by_steps``).  A file of its own
for the same reason as that one: the JAX side's initialisation and
compilation of the deep normal form take most of half a minute.
"""
import numpy as np
import pytest

from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.train.trainer import RankAAETrainer
from rankaae_tpu_torch.utils.config import TrainConfig
from tests.test_torch_conv_train_normal import B, CFG, N_VAL
from tests.torch_parity import compare_batch_by_steps, jax_init, make_data


@pytest.fixture(scope="module")
def pair():
    cfg = {**CFG, "remat": True}
    jtr = JaxTrainer(JaxTrainConfig(**cfg), n_train=B, n_val=N_VAL)
    ttr = RankAAETrainer(TrainConfig(**cfg), n_train=B, n_val=N_VAL, device="cpu")
    assert ttr.models["enc"].remat and ttr.models["dec"].remat
    return jtr, jax_init(jtr), ttr, ttr.init_state(0)


def test_normal_remat_batch_matches_jax(pair):
    spec, aux = make_data(5, B)
    moved, _, _ = compare_batch_by_steps(*pair, spec, aux)
    assert np.quantile(moved, 0.9) > 1e-3
