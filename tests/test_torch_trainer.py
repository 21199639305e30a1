"""The port's faithful trainer against the JAX package's.

* One faithful ``_train_batch`` of the FC form against
  ``jax.jit(RankAAETrainer._train_batch)`` from the same weights and draws,
  and one ``_validate`` (``tests/torch_parity.py`` says how and with what
  tolerances): the whole batch, and each step from identical inputs.  The
  whole batch is ill-conditioned: a 1e-7 weight perturbation moves its
  mutual-info loss by up to 9.6e-4 and a leaf by up to 1.9e-2 on the port
  (16 seeds, one torch thread), and the two stacks part by 2.8e-4 and
  3.4e-3, so each loss and leaf is held to twice its own spread where
  that exceeds 1e-4.  From zero second moments instead of 1e-8 this batch
  put 3631 of the 16384 first-layer weights off by up to 2.2e-2; from
  1e-8, every step from identical inputs is within 1e-4 while the median
  autoencoder weight still moves by more than 1e-3.
* A CPU smoke of the ``Trainer.from_data(...).train()`` facade.
* The package rules: nothing of ``jax``, ``rankaae_tpu``, ``msgpack`` or the
  JAX package's ``scripts`` is imported (the runner, ``train_sc`` and the
  ``tools/`` included), the entry points
  (training, recalibration, serving and the report) do not fall back to
  the CPU; every trainer option builds (the fused and joint protocols,
  ``flat_optim``, bfloat16), and joint without GRL is refused.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

import jax
import torch

from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.models.inference import InferenceModel
from rankaae_tpu_torch.models.recalibrate import amplitude_gain, recalibrate_batch_stats
from rankaae_tpu_torch.models.registry import build_autoencoder
from rankaae_tpu_torch.report.generate_report import main as generate_report_main
from rankaae_tpu_torch.serve import BatchedInference, main as serve_main
from rankaae_tpu_torch.train.facade import Trainer
from rankaae_tpu_torch.train.trainer import OPT_SPECS, RankAAETrainer
from rankaae_tpu_torch.utils.checkpoint import save_model_bundle
from rankaae_tpu_torch.utils.config import Parameters, TrainConfig
from rankaae_tpu_torch.utils.weights import to_jax
from tests.torch_parity import compare_batch_by_steps, compare_validate, make_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N_VAL, NSTYLE = 256, 120, 6

CFG = {
    "max_epoch": 10, "batch_size": B, "gradient_reversal": True,
    "alpha_flat_step": 739, "alpha_limit": 0.7172, "decoder_activation": "Softplus",
    "dis_beta": 1.1, "dis_dropout_rate": 0.0, "dis_noise": 0.0, "gen_beta": 1.1,
    "n_aux": 5, "nstyle": NSTYLE, "ae_form": "FC", "dim_in": 256, "dim_out": 256,
    "n_layers": 3, "FC_discriminator_layers": 3, "use_cnn_discriminator": False,
    "dropout_rate": 0.0, "sch_factor": 0.1, "sch_patience": 100, "lr_base": 0.001,
    "lr_ratio_Corr": 10, "lr_ratio_Mutual": 1, "lr_ratio_Reconn": 10,
    "lr_ratio_Smooth": 1, "lr_ratio_dis": 1, "lr_ratio_gen": 10,
    "optimizer_name": "AdamW", "spec_noise": 0.02, "use_flex_spec_target": True,
    "weight_decay": 0.01, "kendall_activation": True, "epoch_stop_smooth": 5,
}


@pytest.fixture(scope="module")
def pair():
    jtr = JaxTrainer(JaxTrainConfig(**CFG), n_train=B, n_val=N_VAL)
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    ttr = RankAAETrainer(TrainConfig(**CFG), n_train=B, n_val=N_VAL, device="cpu")
    return jtr, jstate, ttr, ttr.init_state(0)


def test_one_faithful_batch_matches_jax(pair):
    spec, aux = make_data(1, B)
    moved, _, n_checked = compare_batch_by_steps(*pair, spec, aux)
    assert n_checked == 34
    # the step moved the autoencoder far beyond the tolerance
    assert np.median(moved) > 1e-3


def test_validate_matches_jax(pair):
    spec, aux = make_data(2, N_VAL)
    compare_validate(*pair, spec, aux)


def test_facade_trains_on_cpu(synthetic_csv, tmp_path):
    p = Parameters.from_yaml(os.path.join(REPO, "example", "fix_config.yaml"))
    p.update({"max_epoch": 2, "batch_size": 256})
    tr = Trainer.from_data(synthetic_csv, config_parameters=p, device="cpu",
                           work_dir=str(tmp_path), verbose=False)
    metrics = tr.train()
    assert len(metrics) == 5 and np.all(np.isfinite(metrics))
    for key, values in tr.logs.items():
        assert np.all(np.isfinite(values)), key
    with open(tmp_path / "losses.csv") as f:
        header, row = f.read().splitlines()[:2]
    assert len(header.split(",")) == 13 and header.startswith("Epoch,")
    assert len([v for v in row.split(",") if v.strip()]) == 13
    assert len(tr.epoch_seconds) == 2


def test_entry_points_default_to_cuda(synthetic_csv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = Parameters.from_yaml(os.path.join(REPO, "example", "fix_config.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer.from_data(synthetic_csv, config_parameters=p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RankAAETrainer(TrainConfig(**CFG), n_train=B, n_val=N_VAL)
    cfg = TrainConfig(**{**CFG, "ae_form": "compact"})
    encoder, decoder = build_autoencoder(cfg)
    params, stats = to_jax({"enc": encoder, "dec": decoder})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceModel(params, stats, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedInference(InferenceModel(params, stats, cfg))     # serves on the model's device
    bundle = save_model_bundle(str(tmp_path / "m.mpk"), params, stats, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main([bundle, synthetic_csv, str(tmp_path / "out")])
    spec = np.ones((4, 256), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recalibrate_batch_stats(cfg, params, stats, spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        amplitude_gain(cfg, params, stats, spec)
    job = tmp_path / "training" / "job_1"
    job.mkdir(parents=True)
    save_model_bundle(str(job / "final.mpk"), params, stats, cfg)
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump({**CFG, "data_file": synthetic_csv}, f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_report_main(["-c", "cfg.yaml", "-w", str(tmp_path), "--no-figures"])


@pytest.mark.parametrize("kw", [{"protocol": "joint"}, {"protocol": "fused"},
                                {"flat_optim": True}, {"activation_dtype": "bfloat16"}],
                         ids=["joint", "fused", "flat_optim", "bfloat16"])
def test_every_option_builds(kw):
    tr = RankAAETrainer(TrainConfig(**{**CFG, **kw}), n_train=B, n_val=N_VAL, device="cpu")
    state = tr.init_state(0)
    assert sorted(state.opt) == (["joint"] if kw.get("protocol") == "joint" else
                                 sorted(OPT_SPECS))


def test_joint_without_grl_is_refused():
    with pytest.raises(ValueError, match="requires gradient_reversal"):
        RankAAETrainer(TrainConfig(**{**CFG, "protocol": "joint", "gradient_reversal": False}),
                       n_train=B, n_val=N_VAL, device="cpu")


def test_package_imports_nothing_of_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import rankaae_tpu_torch.parallel.trials, rankaae_tpu_torch.cli.train_sc\n"
        "import rankaae_tpu_torch.cli.generate_report\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'rankaae_tpu')]\n"
        "import rankaae_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'rankaae_tpu', 'msgpack',\n"
        "                              'matplotlib', 'seaborn', 'sklearn', 'scripts')]\n"
        "import os\n"
        "scripts = os.path.join(os.getcwd(), 'scripts') + os.sep\n"
        "bad += [m for m, mod in list(sys.modules.items()) if getattr(mod, '__file__', None)\n"
        "        and os.path.abspath(mod.__file__).startswith(scripts)]\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = {a.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert not roots & {"jax", "jaxlib", "flax", "rankaae_tpu", "msgpack", "scripts"}, roots
