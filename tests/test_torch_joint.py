"""The joint protocol (``protocol: joint``) of the port against the JAX
package's (``rankaae_tpu/train/trainer.py:758-854``, the optimizer and its
scheduler at ``:173-183`` and ``:245-252``, the scheduler's step at
``:1026-1054``).

* One joint ``_train_batch`` against ``jax.jit(RankAAETrainer._train_batch)``
  from the same weights and draws (keys 0-2 of ``split(rng, 9)``), dropout
  and discriminator noise 0, for the FC form and for the normal form with
  the CNN discriminator: the six losses and every leaf within the larger
  of 1e-4 and twice the batch's 1e-7 perturbation spread
  (``tests/torch_parity.py::compare_batch``), the losses also within
  :data:`LOSS_ATOL` (one forward, nothing stepped before a loss is taken).
* ``state.opt`` and ``state.sched`` hold only ``"joint"``, at
  ``lr_ratio_Reconn * lr_base`` times each trial's ``lr_scales``.
* Two joint FC epochs against the JAX ``epoch_step`` at ``lr_base`` 1e-5
  (``tests/test_torch_epoch.py``'s setting and atol), with the joint
  scheduler stepping on the combined metric and on val recon
  (``sch_recon_metric``); ``lr_recon`` is the joint scheduler's lr.
* A joint run cut after one epoch and resumed equals the uncut run bit for
  bit on the CPU (``run_trials`` with ``checkpoint_dir``).
* A T 3 joint run against three 1-trial runs (``tests/test_torch_trials.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.parallel.trials import run_trials
from rankaae_tpu_torch.train.trainer import RankAAETrainer
from rankaae_tpu_torch.utils.config import TrainConfig
from tests.test_torch_epoch import CFG as EPOCH_CFG
from tests.test_torch_epoch import EPOCH_ATOL, N_TRAIN, N_VAL, data_pair
from tests.test_torch_trainer import CFG as FC_CFG
from tests.test_torch_trials import SELF_CFG, _check_trials_equal_single_trial_runs
from tests.torch_parity import (
    LOSSES,
    FixedDraws,
    compare_batch,
    compare_epoch,
    epoch_draws,
    jax_init,
    make_data,
    start_from_jax,
)

B = 64
#: the six losses of a joint batch, JAX against the port (measured: at most
#: 3.6e-7)
LOSS_ATOL = 1e-5
CASES = {"fc": {},
         "normal_cnn": {"ae_form": "normal", "use_cnn_discriminator": True}}


def joint_cfg(**kw):
    return {**FC_CFG, "protocol": "joint", "batch_size": B, **kw}


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_joint_batch_matches_jax(case):
    cfg = joint_cfg(**CASES[case])
    jtr = JaxTrainer(JaxTrainConfig(**cfg), n_train=B, n_val=N_VAL)
    ttr = RankAAETrainer(TrainConfig(**cfg), n_train=B, n_val=N_VAL, device="cpu")
    tstate = ttr.init_state(0)
    spec, aux = make_data(5, B)
    new_jstate, jlosses, tlosses = compare_batch(jtr, jax_init(jtr), ttr, tstate, spec, aux)
    for k in LOSSES:
        np.testing.assert_allclose(tlosses[k].item(), float(jlosses[k]), atol=LOSS_ATOL,
                                   err_msg=k)
    assert list(tstate.opt) == list(new_jstate.opt) == ["joint"]
    assert tstate.opt["joint"].count == int(new_jstate.opt["joint"].count) == 1


def test_joint_state_and_lr_scales():
    cfg = TrainConfig(**joint_cfg())
    ttr = RankAAETrainer(cfg, n_train=B, n_val=N_VAL, trials=3, device="cpu")
    scales = np.array([1.0, 0.5, 2.0], np.float32)
    state = ttr.init_state(0, lr_scales=scales)
    assert list(state.opt) == list(state.sched) == ["joint"]
    want = torch.tensor(cfg.lr_ratio_Reconn * cfg.lr_base, dtype=torch.float32) \
        * torch.tensor(scales)
    assert torch.equal(state.sched["joint"].lr, want)
    n_params = sum(p.numel() for m in ttr.models.values() for p in m.parameters())
    assert sum(m.numel() for m in state.opt["joint"].mu) == n_params
    assert sorted(ttr.state_tree(state)["opt"]) == ["joint"]


@pytest.mark.parametrize("sch_recon_metric", ["combined", "val_recon"])
def test_two_joint_epochs_match_jax(sch_recon_metric):
    cfg = {**EPOCH_CFG, "protocol": "joint", "sch_recon_metric": sch_recon_metric}
    jtr = JaxTrainer(JaxTrainConfig(**cfg), n_train=N_TRAIN, n_val=N_VAL)
    ttr = RankAAETrainer(TrainConfig(**cfg), n_train=N_TRAIN, n_val=N_VAL, device="cpu")
    tstate = ttr.init_state(0)
    jstate = start_from_jax(jtr, jax_init(jtr), ttr, tstate)
    jdata, tdata = data_pair()
    jstep = jax.jit(jtr.epoch_step)
    worst = 0.0
    for epoch in (0, 1):
        tstate.sampler = FixedDraws(epoch_draws(jtr, jstate.rng, epoch))
        jstate, jlog = jstep(jstate, jnp.int32(epoch), jdata)
        tstate, tlog = ttr.epoch_step(tstate, epoch, tdata)
        worst = max(worst, compare_epoch(jax.tree_util.tree_map(np.asarray, jlog), jstate,
                                         ttr, tlog, tstate, atol=EPOCH_ATOL))
        # the joint scheduler stepped on the configured metric
        metric = tlog["val_recon" if sch_recon_metric == "val_recon" else "combined"]
        assert torch.equal(tstate.sched["joint"].best, metric) or epoch == 1
        assert torch.equal(tlog["lr_recon"], tstate.sched["joint"].lr)
    print(f"two joint epochs vs JAX ({sch_recon_metric}): largest difference {worst:.3g}")


def test_joint_run_resumes_bit_identically(tmp_path):
    cfg = TrainConfig(**{**SELF_CFG, "protocol": "joint", "dropout_rate": 0.1,
                         "dis_noise": 0.1})
    data = data_pair()[1]
    uncut = run_trials(cfg, data, n_trials=2, seed=3, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    run_trials(cfg.replace(max_epoch=1), data, n_trials=2, seed=3, device="cpu",
               checkpoint_dir=ckpt)
    resumed = run_trials(cfg, data, n_trials=2, seed=3, device="cpu", checkpoint_dir=ckpt)
    for k, v in uncut.logs.items():
        np.testing.assert_array_equal(resumed.logs[k], v, err_msg=k)
    for field in ("final_params", "final_batch_stats", "best_params", "best_recon_params"):
        a, b = getattr(uncut, field), getattr(resumed, field)
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(x, y, err_msg=field)


def test_joint_trials_equal_single_trial_runs(monkeypatch, tmp_path):
    _check_trials_equal_single_trial_runs(
        monkeypatch, tmp_path, TrainConfig(**{**SELF_CFG, "protocol": "joint"}))
