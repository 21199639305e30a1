"""The port's deployment calibration against the JAX package's
(``rankaae_tpu_torch/models/recalibrate.py`` vs
``rankaae_tpu/models/recalibrate.py``).

* ``_invert_ema`` recovers a pass's batch statistics from one update of the
  port's ``BatchNorm`` (mean and unbiased variance of the batch), up to
  float32 rounding.
* ``recalibrate_batch_stats`` on the same weights and data gives the JAX
  function's statistics within 1e-5, for the FC and the normal form, at
  dropout 0 (the two packages' dropout draws differ by construction), from
  running statistics far from the data; with dropout on, the port's pass
  is reproducible (its generator is seeded 0).
* ``amplitude_gain`` matches within 1e-5; ``amp_gain`` survives a bundle
  round trip and ``InferenceModel`` divides the decoder's outputs by it.
"""
import numpy as np
import pytest
import torch

import jax

from rankaae_tpu.models.recalibrate import amplitude_gain as jax_amplitude_gain
from rankaae_tpu.models.recalibrate import recalibrate_batch_stats as jax_recalibrate
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.models.inference import InferenceModel
from rankaae_tpu_torch.models.primitives import BatchNorm
from rankaae_tpu_torch.models.recalibrate import (_invert_ema, amplitude_gain,
                                                  recalibrate_batch_stats)
from rankaae_tpu_torch.train.trainer import RankAAETrainer
from rankaae_tpu_torch.utils.checkpoint import load_model_bundle, save_model_bundle
from rankaae_tpu_torch.utils.config import TrainConfig
from tests.test_torch_trainer import CFG
from tests.torch_parity import make_data

N = 96


def _far_stats(stats, seed):
    """Running statistics far from any batch's: means shifted, variances
    scaled, per leaf."""
    rng = np.random.default_rng(seed)

    def far(tree):
        return {k: far(v) if isinstance(v, dict) else
                (v * 3.0 + 0.5 if k == "var" else v + rng.normal(size=v.shape))
                .astype(np.float32) for k, v in tree.items()}

    return {role: far(tree) for role, tree in stats.items()}


def _bundle_trees(cfg_dict, seed=3):
    tr = RankAAETrainer(TrainConfig(**cfg_dict), n_train=N, n_val=N, device="cpu")
    tr.init_state(seed)
    params, stats = tr.export(0)
    return params, _far_stats(stats, seed)


def _assert_trees(got, ref, atol):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            _assert_trees(got[k], ref[k], atol)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=0)


def test_invert_ema_recovers_the_batch_statistics():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(64, 16)).astype(np.float32) * 3 + 1)
    bn = BatchNorm(16)
    old = {"mean": np.full(16, -2.0, np.float32), "var": np.full(16, 9.0, np.float32)}
    bn.running_mean.copy_(torch.tensor(old["mean"]))
    bn.running_var.copy_(torch.tensor(old["var"]))
    bn.train()
    with torch.no_grad():
        bn(x)
    new = {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}
    got = _invert_ema({"bn": old}, {"bn": new})["bn"]
    np.testing.assert_allclose(got["mean"], x.numpy().mean(axis=0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["var"], x.numpy().var(axis=0, ddof=1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ae_form", ["FC", "normal"])
def test_recalibration_matches_jax(ae_form):
    cfg_dict = {**CFG, "ae_form": ae_form}
    params, stats = _bundle_trees(cfg_dict)
    spec, _ = make_data(4, N)
    got = recalibrate_batch_stats(TrainConfig(**cfg_dict), params, stats, spec, device="cpu")
    ref = jax_recalibrate(JaxTrainConfig(**cfg_dict), params, stats, spec)
    _assert_trees(got, jax.tree_util.tree_map(np.asarray, ref), atol=1e-5)
    # the old statistics are gone: another start gives the same result
    again = recalibrate_batch_stats(TrainConfig(**cfg_dict), params, _far_stats(stats, 9), spec,
                                    device="cpu")
    _assert_trees(again, got, atol=1e-4)
    gain = amplitude_gain(TrainConfig(**cfg_dict), params, got, spec, device="cpu")
    ref_gain = jax_amplitude_gain(JaxTrainConfig(**cfg_dict), params, got, spec)
    assert 0.5 <= gain <= 2.0
    np.testing.assert_allclose(gain, ref_gain, atol=1e-5, rtol=0)


def test_recalibration_with_dropout_is_seeded():
    cfg_dict = {**CFG, "dropout_rate": 0.2}
    params, stats = _bundle_trees(cfg_dict)
    spec, _ = make_data(4, N)
    cfg = TrainConfig(**cfg_dict)
    first = recalibrate_batch_stats(cfg, params, stats, spec, device="cpu")
    _assert_trees(recalibrate_batch_stats(cfg, params, stats, spec, device="cpu"), first, 0)
    no_drop = recalibrate_batch_stats(cfg.replace(dropout_rate=0.0), params, stats, spec,
                                      device="cpu")
    assert not np.allclose(first["enc"]["bn_style"]["var"], no_drop["enc"]["bn_style"]["var"])


def test_amp_gain_round_trips_and_divides(tmp_path):
    cfg = TrainConfig(**CFG)
    params, stats = _bundle_trees(CFG)
    spec, _ = make_data(4, N)
    path = str(tmp_path / "final.mpk")
    save_model_bundle(path, params, stats, cfg, extra={"amp_gain": 0.8})
    assert load_model_bundle(path)[3]["amp_gain"] == 0.8
    model = InferenceModel.from_bundle(path, device="cpu")
    assert model.out_gain == 0.8
    plain = InferenceModel(params, stats, cfg, device="cpu")
    z = plain.encode(spec)
    np.testing.assert_allclose(model.decode(z), plain.decode(z) / np.float32(0.8), rtol=1e-6)
    np.testing.assert_allclose(model.reconstruct(spec), plain.reconstruct(spec) / np.float32(0.8),
                               rtol=1e-6)
    # a diverged model's gain is 1, and the gain is clipped to [0.5, 2]
    nan_params = {**params, "dec": jax.tree_util.tree_map(lambda v: v * np.nan, params["dec"])}
    assert amplitude_gain(cfg, nan_params, stats, spec, device="cpu") == 1.0
    loud = {**params, "dec": {**params["dec"], "lin_out": {
        "kernel": np.zeros_like(params["dec"]["lin_out"]["kernel"]),
        "bias": np.full_like(params["dec"]["lin_out"]["bias"], 100.0)}}}
    assert amplitude_gain(cfg, loud, stats, spec, device="cpu") == 2.0
