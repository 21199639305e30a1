"""Trials spread over processes (``rankaae_tpu_torch/parallel/multihost.py``
and ``run_trials`` in a process group), as ``tests/test_multihost.py``
runs the JAX package's recipe: two OS processes on the CPU form a gloo
group (a free port on localhost), each running
``tests/torch_multihost_worker.py``.

* ``initialize`` from explicit arguments and from torchrun's environment:
  rank and world size, a gather of host objects in rank order, and a rank's
  default device ``cuda:<local rank>`` refused where it is absent.
* 4 FC trials over 2 ranks against the 1-process ``run_trials``, epoch by
  epoch from identical inputs at ``lr_base`` 1e-5 as
  ``tests/test_torch_trials.py`` compares waves (epoch 1 resumes from the
  1-process run's checkpoint after epoch 0, cut per rank), atol 1e-4: the
  ranks stack 2 trials where one process stacks 4, and their products may
  sum in another order.  Both ranks return the same results, every trial.
* A resume under another layout is refused, both ways.
* ``train_sc`` under ``python -m torch.distributed.run --nproc-per-node 2``
  writes the 1-process run's tree file for file (checkpoint names by
  pattern), with ``--checkpoint-every`` so that rank 1's segments go
  through its checkpoint subdirectory; the losses agree within 1e-4.
* The trial x dp layout: 2 trials on 2 ranks at dp 2 (one group, the train
  rows sharded) equal the 1-process run exactly, and so do 149 train rows,
  which do not split in two and are replicated.
"""
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from rankaae_tpu_torch.parallel.trials import run_trials
from rankaae_tpu_torch.train.trainer import TrialData
from rankaae_tpu_torch.utils.config import TrainConfig
from tests.test_torch_epoch import N_TRAIN, N_VAL
from tests.test_torch_train_sc import _tree, _work_dir
from tests.test_torch_trials import SELF_ATOL, SELF_CFG, _max_diff, _run_from_nu0, \
    _split_checkpoint
from tests.torch_parity import make_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
TRIALS, SEED = 4, 6


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**kw):
    env = dict(os.environ, OMP_NUM_THREADS="1", **kw)
    env.pop("WORLD_SIZE", None)
    return env


def _ranks(work, scenario, torchrun_env=False):
    """Run ``scenario`` on two ranks; returns each rank's pickled output."""
    port = _free_port()
    procs = []
    for rank in range(2):
        if torchrun_env:
            cmd = [sys.executable, WORKER, scenario, str(work)]
            env = _env(RANK=str(rank), LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
            env["WORLD_SIZE"] = "2"
        else:
            cmd = [sys.executable, WORKER, scenario, str(work), f"localhost:{port}", str(rank)]
            env = _env()
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    outs = []
    for rank in range(2):
        with open(os.path.join(work, f"rank_{rank}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _data(n_train=N_TRAIN):
    spec, aux = make_data(21, n_train + N_VAL)
    return TrialData(*(torch.from_numpy(a) for a in (
        spec[:n_train], aux[:n_train], spec[n_train:], aux[n_train:])))


def _write_inputs(work, data, cfg, runs, n_trials, **kw):
    os.makedirs(work, exist_ok=True)
    np.savez(os.path.join(work, "data.npz"), train_spec=data.train_spec.numpy(),
             train_aux=data.train_aux.numpy(), val_spec=data.val_spec.numpy(),
             val_aux=data.val_aux.numpy())
    with open(os.path.join(work, "run.json"), "w") as f:
        json.dump({"cfg": cfg, "runs": runs, "n_trials": n_trials, "seed": SEED, **kw}, f)


@pytest.mark.parametrize("how", ["arguments", "environment"])
def test_initialize(tmp_path, how):
    outs = _ranks(tmp_path, "init", torchrun_env=how == "environment")
    for rank, out in enumerate(outs):
        assert out["world"] == (rank, 2)
        assert out["gathered"] == [0, 10]
        assert out["device"] == "cpu"
        assert f"cuda:{rank}" in out["no_card"]


def _assert_same(a, b):
    for key in ("logs", "final_params", "final_batch_stats", "best_params",
                "best_recon_params", "best_epoch", "best_recon_epoch"):
        assert _max_diff(getattr(a, key), getattr(b, key)) == 0.0, key


def test_two_ranks_equal_one_process(monkeypatch, tmp_path):
    _run_from_nu0(monkeypatch)
    data = _data()
    one = tmp_path / "one"
    ref0 = run_trials(TrainConfig(**{**SELF_CFG, "max_epoch": 1}), data, n_trials=TRIALS,
                      seed=SEED, device="cpu", checkpoint_dir=str(one))
    shutil.copytree(one, tmp_path / "one_1")
    ref1 = run_trials(TrainConfig(**SELF_CFG), data, n_trials=TRIALS, seed=SEED,
                      device="cpu", checkpoint_dir=str(tmp_path / "one_1"))
    # epoch 1 of the two ranks resumes from the 1-process run's checkpoint
    two = tmp_path / "two"
    for rank, (lo, hi) in enumerate(((0, 2), (2, 4))):
        _split_checkpoint(str(one), str(two / f"rank_{rank:03d}"), lo, hi)
    with open(two / "layout.json", "w") as f:
        json.dump({"world_size": 2, "dp": 1}, f)
    work = tmp_path / "work"
    _write_inputs(work, data, SELF_CFG, [[1, None], [2, str(two)]], TRIALS)
    outs = _ranks(work, "trials")
    got0, got1 = outs[0]["results"]
    assert got0.n_trials == got1.n_trials == TRIALS
    worst = {"epoch 0": _max_diff(ref0.logs, got0.logs),
             "epoch 1": _max_diff({k: v[:, 1] for k, v in ref1.logs.items()},
                                  {k: v[:, 1] for k, v in got1.logs.items()}),
             "weights": max(_max_diff(getattr(ref, k), getattr(got, k))
                            for ref, got in ((ref0, got0), (ref1, got1))
                            for k in ("final_params", "best_params", "best_recon_params"))}
    print(f"4 trials over 2 ranks vs one process, epoch by epoch: {worst}")
    assert max(worst.values()) <= SELF_ATOL, worst
    np.testing.assert_array_equal(ref1.best_epoch, got1.best_epoch)
    for a, b in zip(outs[0]["results"], outs[1]["results"]):
        _assert_same(a, b)                      # every rank returns every trial
    # the trials are distinct runs
    assert len({float(v) for v in got1.logs["val_recon"][:, -1]}) == TRIALS

    # a 2-rank checkpoint refused by one process, and a 1-process one by 2 ranks
    with pytest.raises(ValueError, match="2 rank"):
        run_trials(TrainConfig(**{**SELF_CFG, "max_epoch": 3}), data, n_trials=TRIALS,
                   seed=SEED, device="cpu", checkpoint_dir=str(two))
    work = tmp_path / "refuse"
    _write_inputs(work, data, SELF_CFG, [[3, str(tmp_path / "one_1")]], TRIALS)
    for out in _ranks(work, "trials"):
        assert "written by 1 rank(s)" in out["results"][0]


def test_train_sc_over_two_ranks_writes_the_same_tree(tmp_path):
    overrides = {"trials": 3, "lr_base": 1e-5}
    one = _work_dir(tmp_path / "one", **overrides)
    two = _work_dir(tmp_path / "two", **overrides)
    args = ["-c", "cfg.yaml", "--device", "cpu", "--checkpoint-every", "1"]
    res = subprocess.run([sys.executable, "-m", "rankaae_tpu_torch.cli.train_sc", "-w", one,
                          *args], cwd=REPO, env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                          "--nproc-per-node", "2", "--master-port", str(_free_port()),
                          "-m", "rankaae_tpu_torch.cli.train_sc", "-w", two, *args],
                         cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr

    def user_tree(root):
        return [p for p in _tree(root) if not p.startswith("train_state")]

    assert user_tree(two) == user_tree(one)
    assert len(user_tree(one)) >= 1 + 3 * 10
    assert sorted(os.listdir(os.path.join(two, "train_state"))) == \
        ["layout.json", "rank_000", "rank_001"]
    for job in ("job_1", "job_2", "job_3"):
        rows = [np.loadtxt(os.path.join(w, "training", job, "losses.csv"), delimiter=",",
                           skiprows=1, usecols=range(13), ndmin=2) for w in (one, two)]
        assert rows[0].shape == rows[1].shape == (1, 13), job    # epoch 0 of 2
        np.testing.assert_allclose(rows[1], rows[0], atol=SELF_ATOL)
    with open(os.path.join(two, "main_process_message.txt")) as f:
        assert "split over 2 ranks" in f.read()


@pytest.mark.parametrize("n_train", [N_TRAIN, N_TRAIN - 1], ids=["sharded", "replicated"])
def test_dp_equals_one_process(tmp_path, monkeypatch, n_train):
    _run_from_nu0(monkeypatch)
    data = _data(n_train)
    cfg = {**SELF_CFG, "max_epoch": 1, "dropout_rate": 0.04}
    ref = run_trials(TrainConfig(**cfg), data, n_trials=2, seed=SEED, device="cpu")
    _write_inputs(tmp_path, data, cfg, [[1, None]], 2, dp=2)
    for out in _ranks(tmp_path, "trials"):
        _assert_same(out["results"][0], ref)
        # split in two, every batch comes through the row shards; 149 rows
        # are replicated, and no batch does
        assert out["row_gathers"] == ([n_train // 2] * -(-n_train // 64)
                                      if n_train % 2 == 0 else [])
