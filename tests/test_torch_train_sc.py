"""The port's ``train_sc`` against the JAX package's: the same artifact tree.

``python -m rankaae_tpu_torch.cli.train_sc -c cfg.yaml -w dir --device cpu``
and ``rankaae_tpu.cli.train_sc.train_from_config`` each train one tiny
config (FC form, 2 trials, 2 epochs, 3 layers, batch 64, a learning-rate
sweep over the trials) in a work dir of their own.  The relative paths match
file for file (the checkpoint names by pattern: they hold each run's best
loss), the ``losses.csv`` headers and row counts match, the manifests have
the same keys, and the JAX package's ``load_model_bundle`` reads every
bundle the port wrote.  A compact-form config of 2 trials runs as one wave,
and as two waves of one trial when ``run_trials``' ``max_resident`` is 1,
and writes the same tree either way; a normal-form config of 3 trials runs
as one wave and writes every job's files.
"""
import functools
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import yaml

from rankaae_tpu.cli.train_sc import train_from_config as jax_train_from_config
from rankaae_tpu.utils.checkpoint import load_model_bundle as jax_load_model_bundle
from rankaae_tpu.utils.config import Parameters as JaxParameters

from rankaae_tpu_torch.cli import train_sc
from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes_csv
from rankaae_tpu_torch.models.inference import InferenceModel
from rankaae_tpu_torch.parallel import trials as port_trials
from rankaae_tpu_torch.utils.checkpoint import load_model_bundle
from tests import torch_parity  # noqa: F401  (one torch thread a process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = re.compile(r"epoch_\d{6}_loss_[-+0-9.e]+\.mpk(\.json)?$")
OVERRIDES = {"trials": 2, "max_epoch": 2, "n_layers": 3, "batch_size": 64,
             "data_file": "data.csv"}
SWEEP = "0.5,2"


def _work_dir(path, **overrides):
    os.makedirs(path, exist_ok=True)
    make_synthetic_xanes_csv(os.path.join(path, "data.csv"), n_rows=300, dim=256, seed=7)
    with open(os.path.join(REPO, "example", "fix_config.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update({**OVERRIDES, **overrides})
    with open(os.path.join(path, "cfg.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _tree(root):
    """Relative paths of the run's artifacts, checkpoint names by pattern."""
    out = []
    for d, _, files in os.walk(root):
        for name in files:
            rel = os.path.relpath(os.path.join(d, name), root)
            if name in ("cfg.yaml", "data.csv"):
                continue
            out.append(CHECKPOINT.sub(lambda m: "epoch_*_loss_*.mpk" + (m.group(1) or ""), rel))
    return sorted(out)


def _bundles(root):
    return sorted(os.path.join(d, f) for d, _, files in os.walk(root)
                  for f in files if f.endswith(".mpk"))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    work = _work_dir(tmp_path_factory.mktemp("jax"))
    lo, hi = (float(x) for x in SWEEP.split(","))
    jax_train_from_config(work, JaxParameters.from_yaml(os.path.join(work, "cfg.yaml")),
                          lr_scales=np.geomspace(lo, hi, 2).astype(np.float32))
    return work


def test_artifact_tree_matches_jax_cli(jax_run, tmp_path):
    work = _work_dir(tmp_path / "port")
    res = subprocess.run(
        [sys.executable, "-m", "rankaae_tpu_torch.cli.train_sc", "-c", "cfg.yaml", "-w", work,
         "--device", "cpu", "--lr-sweep", SWEEP],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    tree = _tree(work)
    assert tree == _tree(jax_run)
    assert len(tree) == 1 + 2 * 10        # main_process_message.txt; 10 files a job
    for job in ("job_1", "job_2"):
        for name in ("losses.csv", "messages.txt"):
            port_lines = open(os.path.join(work, "training", job, name)).read().splitlines()
            jax_lines = open(os.path.join(jax_run, "training", job, name)).read().splitlines()
            assert len(port_lines) == len(jax_lines), (job, name)
            if name == "losses.csv":
                assert port_lines[0] == jax_lines[0]
                assert [len(r.split(",")) for r in port_lines] == \
                    [len(r.split(",")) for r in jax_lines]
    port_bundles, jax_bundles = _bundles(work), _bundles(jax_run)
    assert len(port_bundles) == len(jax_bundles) == 8
    for path, ref in zip(port_bundles, jax_bundles):
        with open(path + ".json") as f:
            manifest = json.load(f)
        with open(ref + ".json") as f:
            ref_manifest = json.load(f)
        assert sorted(manifest) == sorted(ref_manifest), path
        assert sorted(manifest["config"]) == sorted(ref_manifest["config"]), path
        assert sorted(manifest["extra"]) == sorted(ref_manifest["extra"]), path
        assert "lr_scale" in manifest["extra"]
        params, stats, cfg, extra = jax_load_model_bundle(path)
        assert cfg.trials == 2 and set(params) == {"enc", "dec", "dis"}
        assert extra == manifest["extra"]
    # trial 2's learning rates were swept up: its manifests say so
    _, _, _, extra = load_model_bundle(os.path.join(work, "training", "job_2", "final.mpk"))
    assert extra["lr_scale"] == 2.0 and len(extra["final_metrics"]) == 5
    with open(os.path.join(work, "main_process_message.txt")) as f:
        log = f.read()
    assert "START" in log and "END" in log and "2 trails" in log


def _compact_run(jax_run, path, monkeypatch, max_resident=None):
    """``train_sc`` of the compact form's 2 trials (at most ``max_resident``
    a wave, default ``run_trials``'); checks the tree against the JAX
    CLI's and every bundle, and returns the trials of each wave."""
    waves = []
    real = port_trials._run_wave

    def run_wave(cfg, data, n_trials, *args, **kw):
        waves.append(n_trials)
        return real(cfg, data, n_trials, *args, **kw)

    monkeypatch.setattr(port_trials, "_run_wave", run_wave)
    if max_resident is not None:
        monkeypatch.setattr(train_sc, "run_trials",
                            functools.partial(port_trials.run_trials, max_resident=max_resident))
    work = _work_dir(path, ae_form="compact")
    train_sc.main(["-c", "cfg.yaml", "-w", work, "--device", "cpu"])
    # the tree of the JAX run, less the sweep
    assert _tree(work) == _tree(jax_run)
    for bundle in _bundles(work):
        _, _, cfg, extra = load_model_bundle(bundle)
        assert cfg.ae_form == "compact" and "lr_scale" not in extra
    x = np.random.default_rng(0).normal(1, 0.1, size=(8, 256)).astype(np.float32)
    for job in ("job_1", "job_2"):
        z = InferenceModel.from_bundle(os.path.join(work, "training", job, "final.mpk"),
                                       device="cpu").encode(x)
        assert z.shape == (8, 6) and np.all(np.isfinite(z))
    return waves


def test_conv_form_runs_as_waves_of_one(jax_run, tmp_path, monkeypatch):
    # a stacked form still splits its trials into waves of ``max_resident``
    assert _compact_run(jax_run, tmp_path / "compact", monkeypatch, max_resident=1) == [1, 1]


def test_conv_form_runs_as_one_wave(jax_run, tmp_path, monkeypatch):
    assert _compact_run(jax_run, tmp_path / "compact", monkeypatch) == [2]


def test_normal_form_trials_run_as_one_wave(tmp_path, monkeypatch):
    waves = []
    real = port_trials._run_wave

    def run_wave(cfg, data, n_trials, *args, **kw):
        waves.append(n_trials)
        return real(cfg, data, n_trials, *args, **kw)

    monkeypatch.setattr(port_trials, "_run_wave", run_wave)
    work = _work_dir(tmp_path / "normal", ae_form="normal", trials=3)
    train_sc.main(["-c", "cfg.yaml", "-w", work, "--device", "cpu"])
    assert waves == [3]
    tree = _tree(work)
    assert len(tree) == 1 + 3 * 10 and "main_process_message.txt" in tree
    x = np.random.default_rng(0).normal(1, 0.1, size=(8, 256)).astype(np.float32)
    styles = []
    for job in ("job_1", "job_2", "job_3"):
        with open(os.path.join(work, "training", job, "losses.csv")) as f:
            assert len(f.read().splitlines()) == 2      # the header and epoch 0 (every 10th)
        for name in ("final", "best_tracked", "best_recon"):
            _, _, cfg, _ = load_model_bundle(os.path.join(work, "training", job, f"{name}.mpk"))
            assert cfg.ae_form == "normal" and cfg.trials == 3
        styles.append(InferenceModel.from_bundle(
            os.path.join(work, "training", job, "final.mpk"), device="cpu").encode(x))
    assert all(np.all(np.isfinite(z)) for z in styles)
    assert len({z.tobytes() for z in styles}) == 3           # three different trials
