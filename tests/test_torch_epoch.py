"""The port's ``RankAAETrainer.epoch_step`` against the JAX package's
(``rankaae_tpu/train/trainer.py:936-1056``), two epochs of the FC form.

150 training rows at batch 64 make two full batches and a trailing one of
22 (``z_real`` keeps ``batch_size`` rows, ``z_sample`` the batch's own);
``epoch_stop_smooth`` 1 makes epoch 1 skip the smoothness step;
``sch_patience`` 0 lets the plateau schedulers cut a learning rate after one
epoch without improvement; the second case steps the reconstruction
scheduler on val recon (``sch_recon_metric: val_recon``).  ``lr_base`` is
1e-5: at 1e-4 and 1e-3 these epochs are ill-conditioned (a 1e-7 relative
perturbation of the weights moves epoch 1's losses by more than the
tolerance on the port alone); at 1e-5 the port matches the JAX epochs
within 1e-6 on every compared value (the test prints the largest
difference).  Both stacks start from the JAX state's weights (the weight
bridge) and second moments of 1e-8 (``tests/torch_parity.py``), and the
port's sampler hands out the JAX epoch's permutation and every batch's and
the validation's draws.  Compared after each epoch at atol
:data:`EPOCH_ATOL` (1e-5): every log key (the losses, the metric vector,
``combined``, ``lr_recon``), both trackers, every plateau state, and every
leaf of the weights and of both trackers' snapshots.  At this learning rate
one optimizer step moves a leaf by about lr_base, so the atol alone would
not see a step missing from a leaf that moves little: after the two
epochs every parameter leaf must also lie within :data:`MOVE_RTOL` (2%) of
its own move in the JAX run (measured: at most 0.46%, on the encoder's
``lin_out`` bias; one step of the six missing would be about a sixth).  trackers' snapshots.  The FC hidden width is the module's fixed 64.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.train.trainer import TrialData as JaxTrialData
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
from rankaae_tpu_torch.utils.config import TrainConfig
from tests.test_torch_trainer import CFG as FC_CFG
from tests.torch_parity import (
    FixedDraws,
    _flat,
    compare_epoch,
    epoch_draws,
    jax_init,
    make_data,
    start_from_jax,
)

B, N_TRAIN, N_VAL = 64, 150, 40
CFG = {**FC_CFG, "batch_size": B, "epoch_stop_smooth": 1, "sch_patience": 0, "lr_base": 1e-5}
EPOCH_ATOL = 1e-5   # every compared value, after each epoch
MOVE_RTOL = 2e-2    # each parameter leaf's difference against its own move


def data_pair(seed=21):
    spec, aux = make_data(seed, N_TRAIN + N_VAL)
    arrays = (spec[:N_TRAIN], aux[:N_TRAIN], spec[N_TRAIN:], aux[N_TRAIN:])
    return (JaxTrialData(*(jnp.asarray(a) for a in arrays)),
            TrialData(*(torch.tensor(a) for a in arrays)))


@pytest.mark.parametrize("sch_recon_metric", ["combined", "val_recon"])
def test_two_epochs_match_jax(sch_recon_metric):
    cfg = {**CFG, "sch_recon_metric": sch_recon_metric}
    jtr = JaxTrainer(JaxTrainConfig(**cfg), n_train=N_TRAIN, n_val=N_VAL)
    ttr = RankAAETrainer(TrainConfig(**cfg), n_train=N_TRAIN, n_val=N_VAL, device="cpu")
    tstate = ttr.init_state(0)
    jstate = start_from_jax(jtr, jax_init(jtr), ttr, tstate)
    jdata, tdata = data_pair()
    start = _flat(jstate.params)
    jstep = jax.jit(jtr.epoch_step)
    worst = 0.0
    lrs = []
    for epoch in (0, 1):
        draws = FixedDraws(epoch_draws(jtr, jstate.rng, epoch))
        tstate.sampler = draws
        jstate, jlog = jstep(jstate, jnp.int32(epoch), jdata)
        tstate, tlog = ttr.epoch_step(tstate, epoch, tdata)
        assert not draws.draws               # every draw was consumed
        worst = max(worst, compare_epoch(jlog, jstate, ttr, tlog, tstate, atol=EPOCH_ATOL))
        lrs.append({k: s.lr.item() for k, s in tstate.sched.items()})
    # epoch 1 skipped the smoothness step on both stacks
    assert tlog["train_smooth"].item() == 0.0 and float(jlog["train_smooth"]) == 0.0
    assert tstate.opt["smoothness"].count == ttr.n_batch
    assert tstate.opt["reconstruction"].count == 2 * ttr.n_batch
    # the plateau schedulers cut a learning rate after epoch 1 (no 1% gain)
    # epoch 1's val recon improved by under 1%, its combined metric by more:
    # only the val_recon case cuts the reconstruction learning rate
    cut = lrs[1]["reconstruction"] < lrs[0]["reconstruction"]
    assert cut == (sch_recon_metric == "val_recon"), lrs
    got, ref = _flat(ttr.export(0)[0]), _flat(jstate.params)
    ratio = {}
    for name, r in ref.items():
        moved = np.abs(np.asarray(r, np.float64) - np.asarray(start[name], np.float64)).max()
        diff = np.abs(np.asarray(got[name], np.float64) - np.asarray(r, np.float64)).max()
        assert moved > 0, name
        ratio[name] = diff / moved
    name = max(ratio, key=ratio.get)
    print(f"{sch_recon_metric}: largest difference over two epochs {worst:.3g}; largest "
          f"difference against a leaf's own move {ratio[name]:.3g} ({name})")
    assert ratio[name] <= MOVE_RTOL, (name, ratio[name])
