"""The non-GRL GAN branch (``gradient_reversal: false``) of the port's
faithful trainer against the JAX package's, on the FC form with each
discriminator: one batch (the side-effect encode and decode, a D step on
the ``discriminator`` optimizer, a G step with the fakes labelled 1 on the
``generator`` optimizer, then the rest of the protocol) and one
``_validate`` (the prior drawn at ``n_val`` rows, a real ``gen`` loss), as
``tests/torch_parity.py`` sets out (atol 1e-4 on the losses and every leaf
after the batch, 1e-5 on ``_validate``).

The batch is data seed 8 at B 256, compared whole and step by step
(``tests/torch_parity.py::compare_batch_by_steps``: the six losses and
every leaf after the whole batch, within 1e-4 or twice the batch's 1e-7
perturbation spread, then every step, the D and G steps included, and the
stats-only forwards between them, each from the JAX package's inputs to
it).  Some batches of this branch are
ill-conditioned: at data seed 6 the stacks part by up to 1e-3 on a few
weights, and on the port alone (from its own initialisation) a 1e-7
relative weight perturbation moves the weights after such a batch by 2e-3
to 6e-2, so no bound near rounding holds there.  At seed 8, with one
torch thread, the whole batch parts by 2.0e-4 on the MI loss and 1.2e-3
on a leaf with the FC discriminator (spread 1.3e-4 and 1.7e-3 over 16
perturbation seeds) and by 1.4e-3 on a leaf with the CNN one (spread
1.4e-2); every step from identical inputs holds the atol.
"""
import numpy as np
import pytest

from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.train.trainer import RankAAETrainer
from rankaae_tpu_torch.utils.config import TrainConfig
from tests.test_torch_trainer import CFG as FC_CFG
from tests.torch_parity import compare_batch_by_steps, compare_validate, jax_init, make_data

B, N_VAL = 256, 48


@pytest.fixture(scope="module", params=[False, True], ids=["fc_dis", "cnn_dis"])
def pair(request):
    cfg = {**FC_CFG, "gradient_reversal": False, "use_cnn_discriminator": request.param,
           "batch_size": B}
    jtr = JaxTrainer(JaxTrainConfig(**cfg), n_train=B, n_val=N_VAL)
    ttr = RankAAETrainer(TrainConfig(**cfg), n_train=B, n_val=N_VAL, device="cpu")
    return jtr, jax_init(jtr), ttr, ttr.init_state(0)


def test_gan_batch_matches_jax(pair):
    spec, aux = make_data(8, B)
    moved, tlosses, _ = compare_batch_by_steps(*pair, spec, aux)
    assert np.median(moved) > 1e-3
    assert tlosses["gen"].item() > 0.1          # the G step ran
    tstate = pair[3]
    assert tstate.opt["discriminator"].count == tstate.opt["generator"].count == 1
    assert tstate.opt["adversarial"].count == 0


def test_gan_validate_matches_jax(pair):
    spec, aux = make_data(7, N_VAL)
    got = compare_validate(*pair, spec, aux)
    assert np.isfinite(got["gen"].item()) and got["gen"].item() > 0.1
