"""Segmented, resumable runs of the port (``parallel/trials.py``,
``utils/checkpoint.py::save_train_state``, ``cli/train_sc.py
--checkpoint-every/--resume``), exact on the CPU; the cases of
``tests/test_checkpoint_resume.py``.

The config is a tiny FC one with dropout and discriminator noise on, so
every generator is drawn from, and ``alpha_flat_step`` ~ 0, so the GRL ramp
does not depend on ``max_epoch`` and a run "cut" by a smaller ``max_epoch``
trains the first epochs of the longer one.  Equality is exact: every log,
every leaf of the weights and of both trackers' snapshots, every moment and
step count, every plateau state and every generator state (the train-state
trees the runs leave behind).
"""
import json
import os

import numpy as np
import pytest
import torch
import yaml

from rankaae_tpu_torch.cli import train_sc
from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes, make_synthetic_xanes_csv
from rankaae_tpu_torch.parallel.trials import run_trials
from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
from rankaae_tpu_torch.utils.checkpoint import load_train_state, save_train_state
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.logging import append_losses_csv, write_losses_csv
from tests.test_torch_trainer import CFG

RESUME_CFG = {**CFG, "batch_size": 64, "dropout_rate": 0.04, "dis_dropout_rate": 0.056,
              "dis_noise": 0.56, "alpha_flat_step": 1e-9, "epoch_stop_smooth": 1,
              "sch_patience": 0}


def cfg_of(max_epoch, **kw):
    return TrainConfig(**{**RESUME_CFG, "max_epoch": max_epoch, **kw})


@pytest.fixture(scope="module")
def data():
    aux, spec, _ = make_synthetic_xanes(n_rows=190, dim=256, seed=9)
    spec, aux = torch.tensor(spec, dtype=torch.float32), torch.tensor(aux, dtype=torch.float32)
    return TrialData(spec[:150], aux[:150], spec[150:], aux[150:])


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat(sub, f"{prefix}[{i}]").items()}
    return {prefix: np.asarray(tree)}


def assert_equal_trees(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def assert_equal_results(a, b):
    for field in ("final_params", "final_batch_stats", "best_params", "best_batch_stats",
                  "best_recon_params", "best_recon_batch_stats", "best_epoch", "best_combined",
                  "best_recon_epoch", "best_recon", "logs", "final_metrics"):
        assert_equal_trees(getattr(a, field), getattr(b, field))


def final_state(ckdir):
    return load_train_state(os.path.join(ckdir, "trial_state.mpk"))


def test_state_file_round_trip_and_mismatch(data, tmp_path):
    tr = RankAAETrainer(cfg_of(2), 150, 40, trials=2, device="cpu")
    state = tr.init_state(5)
    tr.epoch_step(state, 0, data)
    path = save_train_state(str(tmp_path / "s.mpk"), tr.state_tree(state), extra={"epoch": 1})
    tree, extra = load_train_state(path)
    assert extra == {"epoch": 1}
    fresh = RankAAETrainer(cfg_of(2), 150, 40, trials=2, device="cpu")
    restored = fresh.load_state_tree(fresh.init_state(6), tree)
    assert_equal_trees(fresh.state_tree(restored), tr.state_tree(state))
    other = RankAAETrainer(cfg_of(2, n_layers=4), 150, 40, trials=2, device="cpu")
    with pytest.raises(ValueError, match="another config"):
        other.load_state_tree(other.init_state(0), tree)


def test_segmented_run_equals_plain_run(data, tmp_path):
    cfg = cfg_of(4)
    plain = run_trials(cfg, data, n_trials=2, seed=5, device="cpu")
    seg = run_trials(cfg, data, n_trials=2, seed=5, device="cpu", checkpoint_every=1,
                     checkpoint_dir=str(tmp_path / "ck"))
    assert_equal_results(seg, plain)
    with open(tmp_path / "ck" / "progress.json") as f:
        assert json.load(f) == {"epoch": 4, "n_trials": 2, "seed": 5, "lr_scales": None,
                                "sweep": None}


def test_cut_and_resumed_run_equals_uncut(data, tmp_path):
    full_dir, cut_dir = str(tmp_path / "full"), str(tmp_path / "cut")
    scales = [0.5, 2.0]
    full = run_trials(cfg_of(4), data, n_trials=2, seed=5, device="cpu", lr_scales=scales,
                      checkpoint_dir=full_dir)
    # "crash" after epoch 2: the first two epochs under a shorter max_epoch
    run_trials(cfg_of(2), data, n_trials=2, seed=5, device="cpu", lr_scales=scales,
               checkpoint_every=2, checkpoint_dir=cut_dir)
    resumed = run_trials(cfg_of(4), data, n_trials=2, seed=5, device="cpu", lr_scales=scales,
                         checkpoint_every=2, checkpoint_dir=cut_dir)
    assert resumed.logs["val_recon"].shape == (2, 4)
    np.testing.assert_array_equal(resumed.logs["epoch"][0], np.arange(4))
    assert_equal_results(resumed, full)
    # every leaf, moment, plateau state, tracker and generator state
    (tree, extra), (ref, ref_extra) = final_state(cut_dir), final_state(full_dir)
    assert extra == ref_extra == {"epoch": 4}
    assert_equal_trees(tree, ref)
    # the sweep is part of the checkpoint: another one is refused
    with pytest.raises(ValueError, match="resume sweep mismatch"):
        run_trials(cfg_of(6), data, n_trials=2, seed=5, device="cpu", lr_scales=[1.0, 1.0],
                   checkpoint_dir=cut_dir)


def test_completed_checkpoint_raises(data, tmp_path):
    ckdir = str(tmp_path / "ck")
    run_trials(cfg_of(2), data, n_trials=2, seed=5, device="cpu", checkpoint_every=2,
               checkpoint_dir=ckdir)
    with pytest.raises(ValueError, match="already complete"):
        run_trials(cfg_of(2), data, n_trials=2, seed=5, device="cpu", checkpoint_every=2,
                   checkpoint_dir=ckdir)


def test_mismatched_checkpoint_is_ignored(data, tmp_path):
    ckdir = str(tmp_path / "ck")
    run_trials(cfg_of(2), data, n_trials=2, seed=5, device="cpu", checkpoint_every=1,
               checkpoint_dir=ckdir)
    for kw in ({"n_trials": 2, "seed": 6}, {"n_trials": 3, "seed": 5}):
        res = run_trials(cfg_of(2), data, device="cpu", checkpoint_every=1,
                         checkpoint_dir=ckdir, **kw)
        assert res.logs["val_recon"].shape == (kw["n_trials"], 2)
        assert_equal_results(res, run_trials(cfg_of(2), data, device="cpu", **kw))


def test_wave_resume(data, tmp_path, monkeypatch):
    ckdir = str(tmp_path / "ck")
    kw = dict(n_trials=3, seed=5, device="cpu", max_resident=1)
    full = run_trials(cfg_of(4), data, **kw)
    run_trials(cfg_of(2), data, checkpoint_every=2, checkpoint_dir=ckdir, **kw)
    assert sorted(os.listdir(ckdir)) == ["wave_000", "wave_001", "wave_002"]
    resumed = run_trials(cfg_of(4), data, checkpoint_every=2, checkpoint_dir=ckdir, **kw)
    assert_equal_results(resumed, full)
    # every wave is complete: they reload without training
    calls = []
    real = RankAAETrainer.epoch_step
    monkeypatch.setattr(RankAAETrainer, "epoch_step",
                        lambda self, *a: calls.append(a) or real(self, *a))
    again = run_trials(cfg_of(4), data, checkpoint_every=2, checkpoint_dir=ckdir, **kw)
    assert calls == []
    assert_equal_results(again, full)


def test_crash_between_logs_and_state_duplicates_no_row(data, tmp_path):
    ckdir = tmp_path / "ck"
    run_trials(cfg_of(2), data, n_trials=2, seed=5, device="cpu", checkpoint_every=2,
               checkpoint_dir=str(ckdir))
    # the logs of a segment the state never reached
    with np.load(ckdir / "logs.npz") as z:
        forged = {k: np.concatenate([z[k], np.full_like(z[k][:, :1], 99)], axis=1)
                  for k in z.files}
    np.savez(ckdir / "logs.npz", **forged)
    res = run_trials(cfg_of(4), data, n_trials=2, seed=5, device="cpu", checkpoint_every=2,
                     checkpoint_dir=str(ckdir))
    assert res.logs["val_recon"].shape == (2, 4)
    assert not np.any(res.logs["val_recon"] == 99)
    np.testing.assert_array_equal(res.logs["epoch"][0], np.arange(4))


def test_incremental_losses_csv_equals_one_shot(tmp_path):
    rng = np.random.default_rng(0)
    keys = ("train_dis", "val_dis", "train_gen", "val_gen", "train_aux", "val_aux",
            "train_recon", "val_recon", "train_smooth", "val_smooth", "train_mi", "val_mi")
    logs = {k: rng.normal(size=25) for k in keys}
    logs["epoch"] = np.arange(25)
    logs["metrics"] = rng.normal(size=(25, 5))
    write_losses_csv(str(tmp_path / "one.csv"), logs)
    for e0, e1 in ((0, 7), (7, 8), (8, 20), (20, 25)):
        append_losses_csv(str(tmp_path / "inc.csv"), {k: v[e0:e1] for k, v in logs.items()}, e0)
    assert (tmp_path / "inc.csv").read_text() == (tmp_path / "one.csv").read_text()


def _cli_work_dir(path, max_epoch):
    os.makedirs(path, exist_ok=True)
    make_synthetic_xanes_csv(os.path.join(path, "data.csv"), n_rows=220, dim=256, seed=7)
    with open(os.path.join(path, "cfg.yaml"), "w") as f:
        yaml.safe_dump({**RESUME_CFG, "max_epoch": max_epoch, "trials": 2,
                        "data_file": "data.csv"}, f)
    return str(path)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, files in os.walk(root)
                  for f in files)


def test_train_sc_checkpoint_every_and_resume(tmp_path):
    """``--checkpoint-every`` writes the JAX CLI's file names (the
    ``train_state`` files and a ``checkpoints/`` bundle per improvement),
    and a run cut at epoch 2 and resumed to 3 writes the losses and bundles
    of the uncut run."""
    whole = _cli_work_dir(tmp_path / "whole", 3)
    train_sc.main(["-c", "cfg.yaml", "-w", whole, "--device", "cpu", "--checkpoint-every", "1"])
    files = _files(whole)
    assert {"train_state/progress.json", "train_state/trial_state.mpk",
            "train_state/logs.npz"} <= set(files)
    for job in ("job_1", "job_2"):
        names = {f.split("/", 2)[2] for f in files if f.startswith(f"training/{job}/")}
        assert {"messages.txt", "losses.csv", "final.mpk", "final.mpk.json", "best_tracked.mpk",
                "best_recon.mpk", "best_recon.mpk.json"} <= names
        assert any(n.startswith("checkpoints/epoch_000000_loss_") for n in names)

    cut = _cli_work_dir(tmp_path / "cut", 2)
    train_sc.main(["-c", "cfg.yaml", "-w", cut, "--device", "cpu", "--checkpoint-every", "2"])
    _cli_work_dir(cut, 3)
    train_sc.main(["-c", "cfg.yaml", "-w", cut, "--device", "cpu", "--resume"])
    for job in ("job_1", "job_2"):
        a, b = (os.path.join(w, "training", job) for w in (whole, cut))
        with open(os.path.join(a, "losses.csv")) as fa, open(os.path.join(b, "losses.csv")) as fb:
            assert fa.read() == fb.read()
        for name in ("final.mpk", "best_tracked.mpk", "best_recon.mpk"):
            with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
                assert fa.read() == fb.read(), (job, name)
    with pytest.raises(ValueError, match="already complete"):
        train_sc.main(["-c", "cfg.yaml", "-w", cut, "--device", "cpu", "--resume"])


def test_segment_callback_sees_every_segment(data):
    seen = []
    run_trials(cfg_of(3), data, n_trials=2, seed=5, device="cpu", checkpoint_every=2,
               checkpoint_dir=None,
               on_segment=lambda e0, e1, logs, best, off: seen.append(
                   (e0, e1, logs["epoch"].shape, best.epoch.shape, off,
                    sorted(best.weights(1)[0]))))
    # segments of checkpoint_every epochs, the last one short
    assert seen == [(0, 2, (2, 2), (2,), 0, ["dec", "dis", "enc"]),
                    (2, 3, (2, 1), (2,), 0, ["dec", "dis", "enc"])]
