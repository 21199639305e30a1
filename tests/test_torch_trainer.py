"""The port's faithful trainer against the JAX package's.

* One faithful ``_train_batch`` of ``rankaae_tpu_torch`` against
  ``jax.jit(RankAAETrainer._train_batch)`` from the same weights (carried
  over by the weight bridge) and the same random draws: the JAX keys of the
  batch are recreated with ``jax.random.split(rng, 17)`` and the three draws
  the batch consumes are handed to the port's sampler.  Dropout and the
  discriminator noise are 0, so nothing else is drawn.  Tolerance atol 1e-4
  on the six losses and on every parameter and running stat after the step
  (five sequential AdamW steps at lr up to 1e-2 of float32 arithmetic taken
  in another order).  Both optimizers start the batch from second moments
  of 1e-8 instead of 0: from zero moments Adam's first step is
  lr * g / (|g| + 1e-8), a full-size step in the direction of the rounding
  noise wherever a gradient is near zero (a bias that feeds an affine-free
  BatchNorm, directly or through a one-signed PReLU unit, has an exactly
  null gradient), and that noise differs between two stacks.  Measured on
  this batch from zero moments: 3631 of the 16384 first-layer weights off
  by up to 2.2e-2; from 1e-8, every leaf within 1e-5 while the median
  autoencoder weight still moves by more than 1e-3.
* One ``_validate`` from the same weights and draws (atol 1e-5).
* A CPU smoke of the ``Trainer.from_data(...).train()`` facade.
* The package rules: nothing of ``jax`` or ``rankaae_tpu`` is imported, and
  the entry points do not fall back to the CPU.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.train.trainer import TrialData as JaxTrialData
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.train.facade import Trainer
from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
from rankaae_tpu_torch.utils.config import Parameters, TrainConfig
from rankaae_tpu_torch.utils.sampler import Sampler
from rankaae_tpu_torch.utils.weights import from_jax, to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N_VAL, NSTYLE = 256, 120, 6
NU0 = 1e-8      # second moments both optimizers start the batch from

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


class FixedDraws(Sampler):
    """A sampler that hands out given arrays for the named draws."""

    def __init__(self, draws):
        super().__init__(0, "cpu")
        self.draws = draws

    def normal(self, name, shape):
        x = self.draws.pop(name)
        assert tuple(x.shape) == tuple(shape), (name, x.shape, shape)
        return torch.tensor(np.asarray(x))


def _data(seed, n):
    from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes

    aux, spec, _ = make_synthetic_xanes(n_rows=n, dim=256, seed=seed)
    return spec.astype(np.float32), aux.astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jtr = JaxTrainer(JaxTrainConfig(**CFG), n_train=B, n_val=N_VAL)
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    ttr = RankAAETrainer(TrainConfig(**CFG), n_train=B, n_val=N_VAL, device="cpu")
    tstate = ttr.init_state(0)
    sds = from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                   jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    for key, m in ttr.models.items():
        m.load_state_dict(sds[key])
    return jtr, jstate, ttr, tstate


def test_one_faithful_batch_matches_jax(pair):
    jtr, jstate, ttr, tstate = pair
    spec, aux = _data(1, B)
    alpha, epoch = 0.3, 0
    # both stacks start from the same non-zero second moments (see module
    # docstring): the update is then smooth in the gradient
    jstate = jstate._replace(opt={
        k: o._replace(nu=jax.tree_util.tree_map(lambda x: jnp.full_like(x, NU0), o.nu))
        for k, o in jstate.opt.items()})
    for o in tstate.opt.values():
        for v in o.nu:
            v.fill_(NU0)
    rng = jax.random.PRNGKey(42)
    new_jstate, jlosses = jax.jit(jtr._train_batch)(
        jstate, jnp.asarray(spec), jnp.asarray(aux), jnp.float32(alpha), jnp.int32(epoch), rng)

    keys = jax.random.split(rng, 17)      # trainer.py:315-319,335,462
    sampler = FixedDraws({
        "spec_noise": jax.random.normal(keys[0], spec.shape),
        "z_real": jax.random.normal(keys[1], (B, NSTYLE)),
        "z_sample": jax.random.normal(keys[12], (B, NSTYLE)),
    })
    _, tlosses = ttr._train_batch(tstate, torch.tensor(spec), torch.tensor(aux),
                                  alpha, epoch, sampler)
    assert not sampler.draws             # all three draws were consumed

    for name in ("dis", "gen", "aux", "recon", "smooth", "mi"):
        np.testing.assert_allclose(tlosses[name].item(), float(jlosses[name]),
                                   atol=1e-4, err_msg=name)
    params, stats = to_jax({k: m.state_dict() for k, m in ttr.models.items()})
    ref_params = jax.tree_util.tree_map(np.asarray, new_jstate.params)
    ref_stats = jax.tree_util.tree_map(np.asarray, new_jstate.batch_stats)
    old_params = jax.tree_util.tree_map(np.asarray, jstate.params)
    n_checked, moved = 0, []
    for got, ref in ((params, ref_params), (stats, ref_stats)):
        for mod, layers in ref.items():
            for layer, leaves in layers.items():
                for leaf, value in leaves.items():
                    np.testing.assert_allclose(got[mod][layer][leaf], value, atol=1e-4,
                                               err_msg=f"{mod}/{layer}/{leaf}")
                    n_checked += 1
                    if leaf == "kernel" and mod != "dis":
                        moved.append(np.abs(value - old_params[mod][layer][leaf]).ravel())
    assert n_checked == 34
    # the step moved the autoencoder far beyond the tolerance
    assert np.median(np.concatenate(moved)) > 1e-3


def test_validate_matches_jax(pair):
    jtr, _, ttr, tstate = pair
    # fresh modules loaded from the same JAX init (the batch test moved them)
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    sds = from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                   jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    for key, m in ttr.models.items():
        m.load_state_dict(sds[key])
    spec, aux = _data(2, N_VAL)
    rng = jax.random.PRNGKey(7)
    alpha = 0.25
    jdata = JaxTrialData(jnp.asarray(spec), jnp.asarray(aux), jnp.asarray(spec), jnp.asarray(aux))
    z_ref, ref = jtr._validate(jstate, jdata, jnp.float32(alpha), rng)
    k1, k2 = jax.random.split(rng)
    sampler = FixedDraws({"z_val": jax.random.normal(k1, (N_VAL, NSTYLE)),
                          "z_real_val": jax.random.normal(k2, (B, NSTYLE))})
    tdata = TrialData(*(torch.tensor(a) for a in (spec, aux, spec, aux)))
    z, got = ttr._validate(tstate, tdata, alpha, sampler)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-5)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].item(), float(value), atol=1e-5, err_msg=name)


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


def test_entry_points_default_to_cuda(synthetic_csv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = Parameters.from_yaml(os.path.join(REPO, "example", "fix_config.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer.from_data(synthetic_csv, config_parameters=p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RankAAETrainer(TrainConfig(**CFG), n_train=B, n_val=N_VAL)


def test_unported_paths_raise():
    for kw in ({"protocol": "joint"}, {"protocol": "fused"},
               {"gradient_reversal": False}):
        with pytest.raises(NotImplementedError):
            RankAAETrainer(TrainConfig(**{**CFG, **kw}), n_train=B, n_val=N_VAL, device="cpu")


def test_package_imports_nothing_of_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import rankaae_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'rankaae_tpu')]\n"
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
    assert not roots & {"jax", "jaxlib", "flax", "rankaae_tpu"}, roots
