"""Training the conv forms with the port, against the JAX package.

* The compact form with ``DiscriminatorCNN`` and gradient reversal: one
  faithful ``_train_batch`` (the CNN discriminator's two sequential
  train-mode forwards, real then fake, scored with NLL) and one
  ``_validate`` against the JAX trainer's, as ``tests/torch_parity.py``
  sets out (``compare_batch_by_steps``: the whole batch, and each step
  from identical inputs at atol 1e-4; 1e-5 on ``_validate``).  As a whole
  the batch parts by 1.1e-4 on the smoothness loss and 1.2e-3 on a leaf,
  inside what a 1e-7 weight perturbation moves them (1.2e-4 and 2.0e-3,
  16 seeds, one torch thread), so those are held to twice their spread.
* The facade on the CPU: ``Trainer.from_data(...).train()`` of the compact
  form writes ``final.mpk``, ``best_tracked.mpk`` and ``best_recon.mpk``
  with their extras; the JAX package's ``load_model_bundle`` reads
  ``final.mpk``, and its encoder gives the port's ``InferenceModel``
  styles within 1e-5.
"""
import json
import os

import numpy as np
import pytest

import jax

from rankaae_tpu.models.inference import InferenceModel as JaxInferenceModel
from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.utils.checkpoint import load_model_bundle as jax_load_model_bundle
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.data.dataset import read_csv
from rankaae_tpu_torch.models.inference import InferenceModel
from rankaae_tpu_torch.train.facade import Trainer
from rankaae_tpu_torch.train.trainer import RankAAETrainer
from rankaae_tpu_torch.utils.checkpoint import load_model_bundle
from rankaae_tpu_torch.utils.config import Parameters, TrainConfig
from tests.test_torch_trainer import CFG as FC_CFG
from tests.torch_parity import compare_batch_by_steps, compare_validate, jax_init, make_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N_VAL = 64, 40
CFG = {**FC_CFG, "ae_form": "compact", "use_cnn_discriminator": True, "batch_size": B}


@pytest.fixture(scope="module")
def pair():
    jtr = JaxTrainer(JaxTrainConfig(**CFG), n_train=B, n_val=N_VAL)
    ttr = RankAAETrainer(TrainConfig(**CFG), n_train=B, n_val=N_VAL, device="cpu")
    return jtr, jax_init(jtr), ttr, ttr.init_state(0)


def test_compact_cnn_grl_batch_matches_jax(pair):
    spec, aux = make_data(3, B)
    moved, tlosses, n_checked = compare_batch_by_steps(*pair, spec, aux)
    assert n_checked > 100                  # conv trees and the CNN's BN statistics
    assert np.median(moved) > 1e-3
    assert tlosses["gen"].item() == 0.0     # GRL: no generator step


def test_compact_cnn_validate_matches_jax(pair):
    spec, aux = make_data(4, N_VAL)
    compare_validate(*pair, spec, aux)


def test_facade_writes_bundles_the_jax_package_reads(synthetic_csv, tmp_path):
    p = Parameters.from_yaml(os.path.join(REPO, "example", "fix_config.yaml"))
    p.update({"max_epoch": 2, "batch_size": 256, "ae_form": "compact"})
    tr = Trainer.from_data(synthetic_csv, config_parameters=p, device="cpu",
                           work_dir=str(tmp_path), verbose=False)
    metrics = tr.train()
    assert np.all(np.isfinite(metrics))
    state = tr.state
    for name, extra in (("final", {}),
                        ("best_tracked", {"best_epoch": int(state.best_epoch),
                                          "best_combined": float(state.best_combined)}),
                        ("best_recon", {"best_recon_epoch": int(state.best_recon_epoch),
                                        "best_recon_mse": float(state.best_recon)})):
        path = tmp_path / f"{name}.mpk"
        with open(f"{path}.json") as f:
            manifest = json.load(f)
        assert manifest.get("extra", {}) == extra, name
        assert manifest["config"]["ae_form"] == "compact"
    assert 0 <= state.best_epoch.item() <= 1 and 0 <= state.best_recon_epoch.item() <= 1
    # a state-dict snapshot reads as its modules do
    live = {k: m.state_dict() for k, m in tr.core.models.items()}
    for got, ref in zip(tr.core.export(0, live), tr.core.export(0)):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, ref)
    # the trackers' snapshots, not the live modules, went into their bundles
    for name, snapshot in (("best_tracked", state.best_state),
                           ("best_recon", state.best_recon_state)):
        params, stats, _, _ = load_model_bundle(str(tmp_path / f"{name}.mpk"))
        ref_params, ref_stats = tr.core.export(0, snapshot)
        for role in ("enc", "dec", "dis"):
            for got, ref in ((params[role], ref_params[role]), (stats[role], ref_stats[role])):
                np.testing.assert_equal(got, ref)

    final = str(tmp_path / "final.mpk")
    jparams, _, jcfg, _ = jax_load_model_bundle(final)
    assert jcfg.ae_form == "compact" and set(jparams) == {"enc", "dec", "dis"}
    x = read_csv(synthetic_csv)[1][:64, 5:]
    z_port = InferenceModel.from_bundle(final, device="cpu").encode(x)
    z_jax = JaxInferenceModel.from_bundle(final).encode(x)
    np.testing.assert_allclose(z_port, z_jax, atol=1e-5)
    assert np.abs(z_port).max() > 0.1
