"""Two ``epoch_step``s of the ``qved`` form against the JAX package's (the
method of ``tests/test_torch_epoch.py``: the JAX epoch's permutation and
draws handed to the port, second moments of 1e-8, ``lr_base`` 1e-5, the
data of ``tests/test_torch_qved.py``).  Every log value, tracker, plateau
state and leaf within atol 1e-4 (the unnormalised q-vectors'
reconstruction losses are ~3, so that is ~3e-5 relative; measured 1.14e-5),
and every parameter leaf within 2% of its own move in the JAX run (the two
biases that feed an affine-free BatchNorm excepted: their gradient is
null), so that a step missing from a leaf that moves little would show.
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.train.trainer import TrialData as JaxTrialData
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
from rankaae_tpu_torch.utils.config import TrainConfig
from tests.test_torch_qved import CFG, qvec_data
from tests.torch_parity import (FixedDraws, _flat, compare_epoch, epoch_draws, jax_init,
                                start_from_jax)

EPOCH_CFG = {**CFG, "epoch_stop_smooth": 1, "sch_patience": 0, "lr_base": 1e-5}
EPOCH_ATOL = 1e-4
MOVE_RTOL = 2e-2
#: biases that feed an affine-free BatchNorm: their gradient is null, so
#: their move is weight decay plus rounding noise (``tests/torch_parity.py``),
#: held by the atol alone
NULL_GRADIENT = ("['enc']['main_lin3']['bias']", "['enc']['short_lin1']['bias']")
N_TRAIN, N_VAL = 150, 40


def test_two_qved_epochs_match_jax():
    jtr = JaxTrainer(JaxTrainConfig(**EPOCH_CFG), n_train=N_TRAIN, n_val=N_VAL)
    ttr = RankAAETrainer(TrainConfig(**EPOCH_CFG), n_train=N_TRAIN, n_val=N_VAL, device="cpu")
    tstate = ttr.init_state(0)
    jstate = start_from_jax(jtr, jax_init(jtr), ttr, tstate)
    q, aux = qvec_data(21, N_TRAIN + N_VAL)
    arrays = (q[:N_TRAIN], aux[:N_TRAIN], q[N_TRAIN:], aux[N_TRAIN:])
    jdata = JaxTrialData(*(jnp.asarray(a) for a in arrays))
    tdata = TrialData(*(torch.tensor(a) for a in arrays))
    start = _flat(jstate.params)
    jstep = jax.jit(jtr.epoch_step)
    worst = 0.0
    for epoch in (0, 1):
        tstate.sampler = draws = FixedDraws(epoch_draws(jtr, jstate.rng, epoch))
        jstate, jlog = jstep(jstate, jnp.int32(epoch), jdata)
        tstate, tlog = ttr.epoch_step(tstate, epoch, tdata)
        assert not draws.draws
        worst = max(worst, compare_epoch(jlog, jstate, ttr, tlog, tstate, atol=EPOCH_ATOL))
    assert tlog["train_smooth"].item() == 0.0 and ttr.n_batch == 3
    # a step missing from a leaf that moves little would hide under the
    # atol: every parameter leaf also lies within MOVE_RTOL of its own move
    got, ref = _flat(ttr.export(0)[0]), _flat(jstate.params)
    ratio = {}
    for name, r in ref.items():
        if name in NULL_GRADIENT:
            continue
        moved = np.abs(np.asarray(r, np.float64) - np.asarray(start[name], np.float64)).max()
        assert moved > 0, name
        ratio[name] = np.abs(np.asarray(got[name], np.float64) - r).max() / moved
    name = max(ratio, key=ratio.get)
    print(f"two qved epochs: largest difference {worst:.3g}; largest difference against a "
          f"leaf's own move {ratio[name]:.3g} ({name})")
    assert ratio[name] <= MOVE_RTOL, (name, ratio[name])

