"""The fused protocol (``protocol: fused``) of the port against the JAX
package's (``rankaae_tpu/train/trainer.py:518-752``).

* One fused ``_train_batch`` against ``jax.jit(RankAAETrainer._train_batch)``
  from the same weights and the same three draws (keys 0-2 of
  ``split(rng, 9)``, ``tests/torch_parity.py::batch_draws``), dropout and
  discriminator noise 0: the FC form with GRL, the FC form without (the D
  and G losses), the compact form with the CNN discriminator without GRL
  (three discriminator forwards in one running-statistics chain) and the
  qved form.  The six losses and every parameter and running-statistic
  leaf are held to the larger of 1e-4 and twice the batch's 1e-7
  perturbation spread (``compare_whole_batch``), the losses also to
  :data:`LOSS_ATOL` and :data:`LOSS_RTOL`: every fused loss is taken at
  the base parameters from one forward, so no step's rounding reaches
  another loss.  B 64.  Every
  optimizer's step count equals the JAX package's.
* Subset isolation (the port's counterpart of
  ``tests/test_fused_protocol.py:83-110``): with every learning rate 0 but
  the correlation optimizer's (encoder only), one fused batch moves the
  encoder and leaves the decoder and discriminator bit for bit.
* Two fused FC epochs against the JAX ``epoch_step`` at ``lr_base`` 1e-5
  (``tests/test_torch_epoch.py``'s setting and atol: the trailing batch,
  the smoothness cut after epoch 0, the plateau schedulers).
* A T 3 fused run against three 1-trial runs (``tests/test_torch_trials.py``).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.train.trainer import OPT_SPECS, RankAAETrainer
from rankaae_tpu_torch.utils.config import TrainConfig
from tests.test_torch_epoch import CFG as EPOCH_CFG
from tests.test_torch_epoch import EPOCH_ATOL, N_TRAIN, N_VAL, data_pair
from tests.test_torch_qved import CFG as QVED_CFG
from tests.test_torch_qved import qvec_data
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
#: the six losses of a fused batch, JAX against the port (measured: at most
#: 4.5e-7 but on the qved form's flex reconstruction loss, 1.0e-5 of ~72)
LOSS_ATOL, LOSS_RTOL = 1e-5, 1e-6
CASES = {
    "fc_grl": {},
    "fc_gan": {"gradient_reversal": False},
    "compact_cnn_gan": {"ae_form": "compact", "use_cnn_discriminator": True,
                        "gradient_reversal": False},
    "qved": {k: QVED_CFG[k] for k in ("ae_form", "dim_in", "dim_out", "lr_base")},
}


def fused_cfg(**kw):
    return {**FC_CFG, "protocol": "fused", "batch_size": B, **kw}


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_fused_batch_matches_jax(case):
    cfg = fused_cfg(**CASES[case])
    b = cfg["batch_size"]
    jtr = JaxTrainer(JaxTrainConfig(**cfg), n_train=b, n_val=N_VAL)
    ttr = RankAAETrainer(TrainConfig(**cfg), n_train=b, n_val=N_VAL, device="cpu")
    tstate = ttr.init_state(0)
    spec, aux = qvec_data(3, b) if case == "qved" else make_data(3, b)
    new_jstate, jlosses, tlosses = compare_batch(jtr, jax_init(jtr), ttr, tstate, spec, aux)
    for k in LOSSES:
        np.testing.assert_allclose(tlosses[k].item(), float(jlosses[k]), atol=LOSS_ATOL,
                                   rtol=LOSS_RTOL, err_msg=k)
    counts = {name: int(o.count) for name, o in new_jstate.opt.items()}
    assert {name: o.count for name, o in tstate.opt.items()} == counts
    stepped = {"correlation", "reconstruction", "mutual_info", "smoothness"} | (
        {"adversarial"} if cfg["gradient_reversal"] else {"discriminator", "generator"})
    assert {name for name, c in counts.items() if c} == stepped


def test_fused_subset_isolation():
    ratios = {f"lr_ratio_{k}": 0.0 for k in ("Reconn", "Mutual", "Smooth", "dis", "gen")}
    cfg = TrainConfig(**fused_cfg(spec_noise=0.0, lr_ratio_Corr=5.0, **ratios))
    ttr = RankAAETrainer(cfg, n_train=B, n_val=N_VAL, device="cpu")
    state = ttr.init_state(0)
    before = {k: [p.detach().clone() for p in m.parameters()] for k, m in ttr.models.items()}
    spec, aux = make_data(4, B)
    ttr._train_batch(state, torch.tensor(spec)[None], torch.tensor(aux)[None], 0.3, 0)
    assert OPT_SPECS["correlation"][0] == ("enc",)
    moved = [not torch.equal(a, p) for a, p in zip(before["enc"], ttr.models["enc"].parameters())]
    assert any(moved)
    for key in ("dec", "dis"):
        for a, p in zip(before[key], ttr.models[key].parameters()):
            assert torch.equal(a, p), key


def test_two_fused_epochs_match_jax():
    cfg = {**EPOCH_CFG, "protocol": "fused"}
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
        assert not tstate.sampler.draws
        worst = max(worst, compare_epoch(jax.tree_util.tree_map(np.asarray, jlog), jstate,
                                         ttr, tlog, tstate, atol=EPOCH_ATOL))
    # epoch 1 is past epoch_stop_smooth: the smoothness moments froze
    assert tstate.opt["smoothness"].count == int(jstate.opt["smoothness"].count) == 3
    assert float(tlog["train_smooth"][0]) == 0.0
    print(f"two fused epochs vs JAX: largest difference {worst:.3g}")


def test_fused_trials_equal_single_trial_runs(monkeypatch, tmp_path):
    _check_trials_equal_single_trial_runs(
        monkeypatch, tmp_path, TrainConfig(**{**SELF_CFG, "protocol": "fused"}))
