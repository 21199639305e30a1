"""One faithful batch of the normal conv form (FC discriminator, gradient
reversal) with the port against the JAX package, whole and each step from
identical inputs (``tests/torch_parity.py::compare_batch_by_steps``; atol
1e-4 on the losses and on every leaf, or twice the whole batch's 1e-7
perturbation spread where that is larger).  A file of its own: the JAX side's
initialisation and compilation of the deep normal form take most of half
a minute on a CPU, and ``--dist loadfile`` gives each file its own worker.

``lr_base`` is 1e-4 here, not the config's 1e-3.  At 1e-3 the first steps
move every weight of the deep conv stack by up to 1e-2, and the batch that
follows is ill-conditioned: ``python -m rankaae_tpu_torch.tools.batch_spread
--ae-form normal --batch-size 64`` shows a 1e-7 relative weight
perturbation moving the MI loss by 0.25 and the weights by 3.8e-2 on the
port alone.

At 1e-4 the steps before the mutual-info step are well conditioned, but the
batch as a whole is not: ``tests/test_torch_batch_spread.py`` shows a 1e-7
relative perturbation of this test's weights moving the batch's MI loss by
1.6e-4 on the JAX package and 1.7e-4 on the port, and a leaf by 1.9e-4 and
2.0e-4.  The two stacks run in sequence from the same weights differ by
1.6e-4 (MI loss) and 1.9e-4 (leaves): inside that spread, so the difference
is float32 rounding that the steps before the MI step leave and the MI step
amplifies, not a fault.  So the whole batch is held to twice that spread
(with one torch thread it parts by 9.8e-6 on the MI loss and 1.0e-4 on a
leaf), and every step is also compared alone, from the JAX package's
weights, running statistics and moments as they stand before the step;
from identical inputs the MI and smoothness steps agree within 4e-7.
"""
import numpy as np
import pytest

from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.train.trainer import RankAAETrainer
from rankaae_tpu_torch.utils.config import TrainConfig
from tests.test_torch_trainer import CFG as FC_CFG
from tests.torch_parity import compare_batch_by_steps, jax_init, make_data

B, N_VAL = 64, 40
CFG = {**FC_CFG, "ae_form": "normal", "batch_size": B, "lr_base": 1e-4}


@pytest.fixture(scope="module")
def pair():
    jtr = JaxTrainer(JaxTrainConfig(**CFG), n_train=B, n_val=N_VAL)
    ttr = RankAAETrainer(TrainConfig(**CFG), n_train=B, n_val=N_VAL, device="cpu")
    return jtr, jax_init(jtr), ttr, ttr.init_state(0)


def test_normal_fc_grl_batch_matches_jax(pair):
    spec, aux = make_data(5, B)
    moved, _, _ = compare_batch_by_steps(*pair, spec, aux)
    # a tenth of the weights moved by more than ten times the tolerance
    assert np.quantile(moved, 0.9) > 1e-3
