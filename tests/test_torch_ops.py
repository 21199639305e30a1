"""The port's losses, statistics, optimizers, plateau scheduler, data layer
and config against the JAX package's.

Tolerance: atol 1e-6 (float32 reductions of a few thousand terms taken in
another order), except where a test states otherwise.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rankaae_tpu.data.dataset import load_split_arrays as jax_load_split_arrays
from rankaae_tpu.data.synthetic import make_synthetic_xanes_csv as jax_make_csv
from rankaae_tpu.ops import losses as jl
from rankaae_tpu.ops import stats as js
from rankaae_tpu.optim.optimizers import make_optimizer as jax_make_optimizer
from rankaae_tpu.optim.plateau import plateau_init as jax_plateau_init
from rankaae_tpu.optim.plateau import plateau_update as jax_plateau_update
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.data.dataset import load_split_arrays
from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes_csv
from rankaae_tpu_torch.ops import losses as tl
from rankaae_tpu_torch.ops import stats as ts
from rankaae_tpu_torch.optim.optimizers import make_optimizer
from rankaae_tpu_torch.optim.plateau import plateau_init, plateau_update
from rankaae_tpu_torch.utils.config import TrainConfig

ATOL = 1e-6


def _spectra(seed, b=64, dim=256):
    rng = np.random.default_rng(seed)
    x = (1.0 + 0.3 * rng.normal(size=(b, dim))).astype(np.float32)
    y = (x * rng.uniform(0.6, 1.4, size=(b, 1)) + 0.05 * rng.normal(size=(b, dim)))
    return x, y.astype(np.float32)


def test_mse_and_bce():
    x, y = _spectra(0)
    np.testing.assert_allclose(tl.mse(torch.tensor(x), torch.tensor(y)).item(),
                               float(jl.mse(x, y)), atol=ATOL)
    logits = np.random.default_rng(1).normal(0, 3, size=(200,)).astype(np.float32)
    for target in (0.0, 1.0):
        t = np.full_like(logits, target)
        np.testing.assert_allclose(
            tl.bce_with_logits(torch.tensor(logits), torch.tensor(t)).item(),
            float(jl.bce_with_logits(logits, t)), atol=ATOL)


@pytest.mark.parametrize("scale", [False, True])
def test_recon_loss_and_gradient(scale):
    spec_in, spec_out = _spectra(2)
    out_t = torch.tensor(spec_out, requires_grad=True)
    loss = tl.recon_loss(torch.tensor(spec_in), out_t, scale=scale, scale_weight=0.3)
    loss.backward()
    f = lambda o: jl.recon_loss(spec_in, o, scale=scale, scale_weight=0.3)
    l_ref, g_ref = jax.value_and_grad(f)(jnp.asarray(spec_out))
    np.testing.assert_allclose(loss.item(), float(l_ref), atol=ATOL)
    np.testing.assert_allclose(out_t.grad.numpy(), np.asarray(g_ref), atol=ATOL)


def test_smoothness_loss_and_gradient():
    _, spec = _spectra(3)
    t = torch.tensor(spec, requires_grad=True)
    loss = tl.smoothness_loss(t, 17)
    loss.backward()
    l_ref, g_ref = jax.value_and_grad(lambda s: jl.smoothness_loss(s, 17))(jnp.asarray(spec))
    np.testing.assert_allclose(loss.item(), float(l_ref), atol=ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_ref), atol=ATOL)


@pytest.mark.parametrize("p", [0.0, 0.01, 0.1, 0.5, 1.0])
def test_alpha_schedule(p):
    np.testing.assert_allclose(tl.alpha_schedule(p, 739.0, 0.7172),
                               float(jl.alpha_schedule(jnp.float32(p), 739.0, 0.7172)),
                               atol=ATOL)


def _latent(seed, n=1050, nstyle=6):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, nstyle)).astype(np.float32)
    z[:, 1] = 0.6 * z[:, 0] + 0.8 * z[:, 1]
    z[:, 2] = np.exp(z[:, 2])            # skewed: W well below 1
    return z


def test_spearman_statistics():
    z = _latent(4)
    np.testing.assert_allclose(
        ts.spearman_rho(torch.tensor(z[:, 0]), torch.tensor(z[:, 1])).item(),
        float(js.spearman_rho(z[:, 0], z[:, 1])), atol=ATOL)
    np.testing.assert_allclose(ts.max_interstyle_spearman(torch.tensor(z)).item(),
                               float(js.max_interstyle_spearman(z)), atol=ATOL)


def test_shapiro_statistics():
    z = _latent(5)
    for col in range(z.shape[1]):
        np.testing.assert_allclose(ts.shapiro_w(torch.tensor(z[:, col])).item(),
                                   float(js.shapiro_w(z[:, col])), atol=ATOL)
    np.testing.assert_allclose(ts.min_style_shapiro(torch.tensor(z)).item(),
                               float(js.min_style_shapiro(z)), atol=ATOL)


@pytest.mark.parametrize("name", ["Adam", "AdamW"])
def test_optimizer_steps_match(name):
    """Three steps with the betas the GRL optimizers use (dis_beta 1.1) and
    weight decay; the lr is a runtime value that changes between steps."""
    rng = np.random.default_rng(6)
    shapes = [(8, 4), (4,), (3,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    betas = (0.9 * 1.1, 0.009 * 1.1 + 0.99)
    jopt = jax_make_optimizer(name, betas=betas, weight_decay=0.01)
    topt = make_optimizer(name, betas=betas, weight_decay=0.01)
    jp = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jp)
    tp = [torch.tensor(p) for p in params]
    tstate = topt.init(tp)
    for step, lr in enumerate((1e-2, 1e-2, 2.5e-3)):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        grads[2][:] = 0.0                # a null gradient (BN-fed bias)
        jp, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jp, jnp.float32(lr))
        topt.update([torch.tensor(g) for g in grads], tstate, tp,
                    torch.tensor(lr, dtype=torch.float32))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_plateau_matches():
    # relative threshold: a negative metric that repeats still "improves"
    # (best * 0.99 is above it), as in torch; the positive tail plateaus
    metrics = [-0.5, -0.52, -0.52, 0.9, 0.85, 0.86, 0.86, 0.86, 0.86, 0.9, 0.9, 0.9, 0.9]
    js_, ts_ = jax_plateau_init(1e-3), plateau_init(1e-3)
    for m in metrics:
        js_ = jax_plateau_update(js_, jnp.float32(m), 0.1, 2)
        ts_ = plateau_update(ts_, torch.tensor(m, dtype=torch.float32), 0.1, 2)
        np.testing.assert_allclose(ts_.lr.item(), float(js_.lr), rtol=1e-6)
        assert ts_.best.item() == float(js_.best)
        assert ts_.num_bad.item() == int(js_.num_bad)
    assert ts_.lr.item() < 1e-3          # the schedule did reduce


def test_synthetic_csv_and_splits_match(tmp_path):
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    make_synthetic_xanes_csv(str(ours), n_rows=300, dim=256, seed=3)
    jax_make_csv(str(theirs), n_rows=300, dim=256, seed=3)
    assert ours.read_bytes() == theirs.read_bytes()
    a = load_split_arrays(str(ours), (0.7, 0.15, 0.15), 5)
    b = jax_load_split_arrays(str(ours), (0.7, 0.15, 0.15), 5, engine="pandas")
    for portion in ("train", "val", "test"):
        np.testing.assert_array_equal(a[portion].spec, b[portion].spec)
        np.testing.assert_array_equal(a[portion].aux, b[portion].aux)
        np.testing.assert_array_equal(a[portion].grid, b[portion].grid)
        assert a[portion].atom_index == b[portion].atom_index


def test_config_loads_example_like_jax():
    ours = TrainConfig.from_yaml("example/fix_config.yaml")
    theirs = JaxTrainConfig.from_yaml("example/fix_config.yaml")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    with pytest.raises(KeyError):
        TrainConfig.from_parameters(
            __import__("rankaae_tpu_torch").Parameters({"no_such_key": 1}))
