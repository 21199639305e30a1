"""The port's public surface against the JAX package's
(``rankaae_tpu/__init__.py`` and its subpackages' ``__init__.py``), on the
CPU at small shapes.

* Every name a JAX ``__init__.py`` exports imports from the port's
  counterpart, except those ``ROADMAP.md`` lists as not ported
  (:data:`NOT_PORTED`); the package root serves ``RankAAETrainer``,
  ``run_trials`` and ``InferenceModel`` lazily and imports no torch.
* ``get_dataloaders`` (``rankaae_tpu/data/dataset.py:157-224``): the
  assertions of ``tests/test_compat_apis.py::test_get_dataloaders_semantics``,
  and every batch's rows equal to the JAX loader's, exactly, for the same
  CSV and seed; batches are CPU float32 tensors.
* ``DualAAE`` (``rankaae_tpu/models/registry.py:55-84``): the FC and normal
  forms with ``DiscriminatorFC`` and the compact form with
  ``DiscriminatorCNN`` equal the JAX ``DualAAE`` through the weight bridge
  at atol and rtol :data:`DUAL_TOL` (float32 sums taken in another order).
* ``RankAAETrainer.run``/``run_epochs`` (``trainer.py:1058-1079``): a run
  cut after epoch 2 by ``run_epochs``, its train state saved and loaded into
  a fresh trainer, and resumed by ``run(start_epoch=2)`` equals the uncut
  ``run`` bit for bit (the counterpart of
  ``tests/test_compat_apis.py::test_resume_exact_equivalence``), and
  ``run``'s logs of two FC epochs equal the JAX ``run``'s at
  ``tests/test_torch_epoch.py``'s ``EPOCH_ATOL`` and ``lr_base`` 1e-5.
* ``native_available``; the package data of ``pyproject.toml`` covers every
  file under ``rankaae_tpu_torch/csrc/`` (an installed port builds its
  native loader), a package dir that cannot be written builds into the
  user's cache, and the port's console scripts name importable entry points.
"""
import ast
import fnmatch
import importlib
import os
import subprocess
import sys
import tomllib

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from rankaae_tpu.data.dataset import epoch_batch_indices as jax_epoch_batch_indices
from rankaae_tpu.data.dataset import get_dataloaders as jax_get_dataloaders
from rankaae_tpu.models import decoders as jax_decoders
from rankaae_tpu.models import encoders as jax_encoders
from rankaae_tpu.models.registry import DualAAE as JaxDualAAE
from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.data import native
from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes
from rankaae_tpu_torch.data.dataset import (
    DataLoader,
    ToTensor,
    epoch_batch_indices,
    get_dataloaders,
    read_csv,
)
from rankaae_tpu_torch.models import decoders, encoders
from rankaae_tpu_torch.models.registry import DualAAE
from rankaae_tpu_torch.ops import _nvcc
from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
from rankaae_tpu_torch.utils.checkpoint import load_train_state, save_train_state
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.weights import to_jax
from tests.test_torch_epoch import CFG as EPOCH_CFG
from tests.test_torch_epoch import EPOCH_ATOL, N_TRAIN, N_VAL, data_pair
from tests.test_torch_resume import assert_equal_trees, cfg_of
from tests.torch_parity import FixedDraws, epoch_draws, jax_init, start_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: JAX exports that ROADMAP.md's "Not ported, and why" excuses
NOT_PORTED = {"trial_mesh"}
SUBPACKAGES = ("", "data", "models", "ops", "optim", "parallel", "train", "report")
DUAL_TOL = 1e-5


def jax_exports(sub):
    """The names ``rankaae_tpu[.sub]/__init__.py`` exports: its imports and
    assignments, and the names its module ``__getattr__`` serves."""
    with open(os.path.join(REPO, "rankaae_tpu", sub, "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            names |= {c.comparators[0].value for c in ast.walk(node)
                      if isinstance(c, ast.Compare) and isinstance(c.comparators[0], ast.Constant)}
    return names


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=[s or "root" for s in SUBPACKAGES])
def test_every_jax_export_imports_from_the_port(sub):
    names = jax_exports(sub) - NOT_PORTED
    assert names
    port = importlib.import_module("rankaae_tpu_torch" + (f".{sub}" if sub else ""))
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, missing


def test_package_root_stays_light():
    code = ("import sys\n"
            "import rankaae_tpu_torch as p\n"
            "assert 'torch' not in sys.modules, 'torch imported by the root'\n"
            "assert p.RankAAETrainer.__name__ == 'RankAAETrainer'\n"
            "assert p.run_trials.__module__ == 'rankaae_tpu_torch.parallel.trials'\n"
            "assert p.InferenceModel.__name__ == 'InferenceModel'\n"
            "try:\n"
            "    p.trial_mesh\n"
            "except AttributeError:\n"
            "    pass\n"
            "else:\n"
            "    raise AssertionError('trial_mesh served')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr


# --------------------------------------------------------------------------- #
# the reference's loader API
# --------------------------------------------------------------------------- #

def test_get_dataloaders_semantics_and_rows_equal_jax(synthetic_csv):
    train, val, test = get_dataloaders(synthetic_csv, batch_size=128, n_aux=5)
    jtrain, jval, jtest = jax_get_dataloaders(synthetic_csv, batch_size=128, n_aux=5)
    assert len(train) == -(-560 // 128)
    batches = list(train)
    assert batches[0][0].shape == (128, 256)
    assert batches[0][1].shape == (128, 5)
    assert batches[-1][0].shape[0] == 560 - 4 * 128  # ragged last batch
    for spec, aux in batches:
        assert isinstance(spec, torch.Tensor) and spec.dtype == torch.float32
        assert spec.device.type == "cpu" and aux.dtype == torch.float32
    # train shuffles between passes, val doesn't
    b1 = next(iter(val))[0]
    b2 = next(iter(val))[0]
    np.testing.assert_array_equal(b1.numpy(), b2.numpy())
    t1 = next(iter(train))[0]
    t2 = next(iter(train))[0]
    assert not np.array_equal(t1.numpy(), t2.numpy())
    assert hasattr(train, "dataset") and len(train.dataset) == 560
    # the same rows as the JAX loader's, batch for batch, for the same seed,
    # over as many passes as each loader has made
    for _ in range(3):
        list(jtrain)
    for port, ref in ((train, jtrain), (train, jtrain), (val, jval), (test, jtest)):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for (spec, aux), (jspec, jaux) in zip(got, want):
            np.testing.assert_array_equal(spec.numpy(), jspec)
            np.testing.assert_array_equal(aux.numpy(), jaux)


def test_loader_without_aux_and_helpers(synthetic_csv, tmp_path):
    df = pd.read_csv(synthetic_csv, index_col=[0, 1], comment="#")
    spectra_only = str(tmp_path / "spectra_only.csv")
    df[[c for c in df.columns if c.startswith("ENE_")]].to_csv(spectra_only)
    train, _, test = get_dataloaders(spectra_only, batch_size=100)
    jtest = jax_get_dataloaders(spectra_only, batch_size=100)[2]
    for (spec, aux), (jspec, jaux) in zip(test, jtest):
        assert torch.equal(aux, torch.zeros(spec.shape[0], 1))
        np.testing.assert_array_equal(spec.numpy(), jspec)
        np.testing.assert_array_equal(aux.numpy(), jaux)
    assert spec.shape == (20, 256)                  # the ragged last of 120 rows
    assert isinstance(train, DataLoader) and train.shuffle and not test.shuffle
    assert [b[0].shape[0] for b in train] == [100] * 5 + [60]
    sample = ToTensor()(np.arange(4, dtype=np.float64))
    assert isinstance(sample, torch.Tensor) and sample.dtype == torch.float32
    np.testing.assert_array_equal(sample.numpy(), np.arange(4))
    got = epoch_batch_indices(np.random.default_rng(3), 150, 64)
    want = jax_epoch_batch_indices(np.random.default_rng(3), 150, 64)
    assert got.shape == (3, 64)
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# DualAAE
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("form,use_cnn", [("FC", False), ("normal", False), ("compact", True)])
def test_dual_aae_matches_jax(form, use_cnn):
    """Seeded torch weights and random running statistics, carried to the
    JAX variables by ``to_jax``, then loaded back by ``DualAAE.load_jax``
    (the JAX ``init`` of the normal form takes ~18 s on an 8-core CPU, its
    ``apply`` 2 s)."""
    names = {"FC": ("FCEncoder", "FCDecoder"), "normal": ("Encoder", "Decoder"),
             "compact": ("CompactEncoder", "CompactDecoder")}[form]
    classes = getattr(encoders, names[0]), getattr(decoders, names[1])
    torch.manual_seed(3)
    seeded = DualAAE(use_cnn, *classes, device="cpu")
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in seeded.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    roles = {"enc": seeded.encoder, "dec": seeded.decoder, "dis": seeded.discriminator}
    params, stats = to_jax(roles)
    variables = {r: {"params": params[r], "batch_stats": stats[r]} for r in roles}
    x = np.random.default_rng(5).normal(size=(8, 256)).astype(np.float32)
    jmodel = JaxDualAAE(use_cnn, getattr(jax_encoders, names[0]), getattr(jax_decoders, names[1]))
    jx2, jgau = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    model = DualAAE(use_cnn, *classes, device="cpu").load_jax(variables)
    assert not model.training and model.discriminator.__class__.__name__ == (
        "DiscriminatorCNN" if use_cnn else "DiscriminatorFC")
    with torch.no_grad():
        x2, gau = model(torch.tensor(x))
    assert x2.shape == (8, 256) and gau.shape == ((8, 2) if use_cnn else (8, 1))
    np.testing.assert_allclose(x2.numpy(), np.asarray(jx2), atol=DUAL_TOL, rtol=DUAL_TOL)
    np.testing.assert_allclose(gau.numpy(), np.asarray(jgau), atol=DUAL_TOL, rtol=DUAL_TOL)


def test_dual_aae_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DualAAE(False, encoders.FCEncoder, decoders.FCDecoder)


# --------------------------------------------------------------------------- #
# run and run_epochs
# --------------------------------------------------------------------------- #

def test_cut_and_resumed_run_equals_uncut(tmp_path):
    """Epochs [0, 2) by ``run_epochs``, the train state saved and loaded into
    a fresh trainer, then ``run(start_epoch=2)``: every log, weight,
    moment, tracker and generator state as the uncut ``run``'s."""
    cfg = cfg_of(4)
    aux, spec, _ = make_synthetic_xanes(n_rows=190, dim=256, seed=9)
    spec, aux = torch.tensor(spec, dtype=torch.float32), torch.tensor(aux, dtype=torch.float32)
    data = TrialData(spec[:150], aux[:150], spec[150:], aux[150:])

    def trainer():
        return RankAAETrainer(cfg, 150, 40, trials=2, device="cpu")

    uncut = trainer()
    s_uncut, logs = uncut.run(uncut.init_state(5), data)
    assert logs["metrics"].shape == (4, 2, 5) and logs["epoch"].shape == (4, 2)
    assert logs["epoch"].dtype == torch.int32 and logs["epoch"][:, 1].tolist() == [0, 1, 2, 3]
    assert torch.equal(RankAAETrainer.final_metrics(logs), logs["metrics"][-1])

    cut = trainer()
    s_cut, first = cut.run_epochs(cut.init_state(5), data, range(2))
    path = save_train_state(str(tmp_path / "state2.mpk"), cut.state_tree(s_cut),
                            extra={"epoch": 2})
    tree, extra = load_train_state(path)
    assert extra == {"epoch": 2}
    resumed = trainer()
    s_res = resumed.load_state_tree(resumed.init_state(5), tree)
    s_res, rest = resumed.run(s_res, data, start_epoch=2)
    for k, v in logs.items():
        assert torch.equal(torch.cat([first[k], rest[k]]), v), k
    assert_equal_trees(resumed.state_tree(s_res), uncut.state_tree(s_uncut))
    with pytest.raises(ValueError, match="at least one epoch"):
        resumed.run(s_res, data, start_epoch=4)


def test_run_logs_match_jax_run():
    """Both ``run``s over two epochs (``max_epoch`` 2) from the same weights
    and draws.  ``alpha_flat_step`` is five times ``test_torch_epoch``'s,
    so the GRL ramp at epoch 1 of 2 is that test's at epoch 1 of 10: the same
    well-conditioned epochs.  At its own ``alpha_flat_step`` epoch 1 of 2
    runs at the ramp's limit, where a 1e-7 relative perturbation of the
    weights moves the port's metrics by up to 1.7e-3 on the port alone
    (measured over three perturbations), as far as the two stacks part."""
    cfg = {**EPOCH_CFG, "max_epoch": 2, "alpha_flat_step": 5 * EPOCH_CFG["alpha_flat_step"]}
    jtr = JaxTrainer(JaxTrainConfig(**cfg), n_train=N_TRAIN, n_val=N_VAL)
    ttr = RankAAETrainer(TrainConfig(**cfg), n_train=N_TRAIN, n_val=N_VAL, device="cpu")
    tstate = ttr.init_state(0)
    jstate = start_from_jax(jtr, jax_init(jtr), ttr, tstate)
    jdata, tdata = data_pair()
    draws = {}
    for epoch in (0, 1):
        for k, v in epoch_draws(jtr, jstate.rng, epoch).items():
            draws.setdefault(k, []).extend(v)
    tstate.sampler = FixedDraws(draws)
    jstate, jlogs = jax.jit(jtr.run)(jstate, jdata)
    tstate, tlogs = ttr.run(tstate, tdata)
    assert not tstate.sampler.draws               # every draw was consumed
    assert sorted(tlogs) == sorted(jlogs)
    worst = 0.0
    for k, v in tlogs.items():
        ref = np.asarray(jlogs[k], np.float64)
        got = v[:, 0].numpy().astype(np.float64)     # (E, T) -> trial 0
        assert got.shape == ref.shape, (k, got.shape, ref.shape)
        worst = max(worst, float(np.abs(got - ref).max()))
        np.testing.assert_allclose(got, ref, atol=EPOCH_ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(RankAAETrainer.final_metrics(tlogs)[0].numpy(),
                               np.asarray(JaxTrainer.final_metrics(jlogs)), atol=EPOCH_ATOL)
    print(f"run vs the JAX run, two epochs: largest log difference {worst:.3g}")


# --------------------------------------------------------------------------- #
# the native loader, the package data and the console scripts
# --------------------------------------------------------------------------- #

def test_native_available(tmp_path, monkeypatch):
    assert native.native_available()                 # g++ is present
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not native.native_available()


def test_package_data_ships_every_csrc_file():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["rankaae_tpu_torch"]
    pkg = os.path.join(REPO, "rankaae_tpu_torch")
    files = [os.path.relpath(os.path.join(d, n), pkg)
             for d, _, names in os.walk(os.path.join(pkg, "csrc")) for n in names]
    assert {"csrc/csv_loader.cpp", "csrc/kendall.cu", "csrc/fused_block.cu"} <= set(files)
    unshipped = [f for f in files if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert not unshipped, unshipped


def test_unwritable_package_builds_into_the_user_cache(synthetic_csv, tmp_path, monkeypatch):
    """A package dir that cannot be written (a read-only install): the
    native loader builds into ``~/.cache/rankaae_tpu_torch/build`` and reads
    the CSV as the pandas engine does."""
    pkg_build = tmp_path / "pkg" / "_build"
    (tmp_path / "pkg").mkdir()
    access = os.access
    monkeypatch.setattr(_nvcc.os, "access", lambda p, mode: False if str(p).startswith(
        str(tmp_path / "pkg")) else access(p, mode))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(native, "BUILD_DIR", pkg_build)
    monkeypatch.setattr(native, "_lib", None)
    so = native.library_path()
    assert so.parent == tmp_path / "home" / ".cache" / "rankaae_tpu_torch" / "build"
    cols, data, index = read_csv(synthetic_csv, engine="native")
    assert so.exists() and not pkg_build.exists()
    pcols, pdata, pindex = read_csv(synthetic_csv, engine="pandas")
    assert cols == pcols and index == pindex
    np.testing.assert_array_equal(data, pdata)


def test_console_scripts_name_the_port_entry_points():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["train_sc"] == "rankaae_tpu.cli.train_sc:main"
    for name, target in (("train_sc_torch", "rankaae_tpu_torch.cli.train_sc:main"),
                         ("sc_generate_report_torch",
                          "rankaae_tpu_torch.report.generate_report:main")):
        assert scripts[name] == target
        module, func = target.split(":")
        assert callable(getattr(importlib.import_module(module), func))
