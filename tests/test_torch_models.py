"""The port's FC modules against their flax counterparts, weights carried
over by ``rankaae_tpu_torch/utils/weights.py``.

Tolerance: atol 1e-5 on module outputs and BatchNorm running stats (float32
matmuls of width <= 256 summed in another order); the weight bridge is
exact.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rankaae_tpu.models.decoders import FCDecoder as JFCDecoder
from rankaae_tpu.models.discriminators import DiscriminatorFC as JDiscriminatorFC
from rankaae_tpu.models.encoders import FCEncoder as JFCEncoder

from rankaae_tpu_torch.models.decoders import FCDecoder
from rankaae_tpu_torch.models.discriminators import DiscriminatorFC
from rankaae_tpu_torch.models.encoders import FCEncoder
from rankaae_tpu_torch.models.grl import grad_reverse
from rankaae_tpu_torch.models.primitives import reset_parameters
from rankaae_tpu_torch.utils.weights import from_jax, to_jax

ATOL = 1e-5
NSTYLE, DIM, LAYERS, B = 6, 256, 4, 64


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """Flax modules with random weights and non-trivial BN running stats,
    and the port's modules loaded with the same numbers."""
    jmods = {
        "enc": JFCEncoder(nstyle=NSTYLE, dropout_rate=0.0, dim_in=DIM, n_layers=LAYERS),
        "dec": JFCDecoder(nstyle=NSTYLE, dropout_rate=0.0, dim_out=DIM,
                          last_layer_activation="Softplus", n_layers=LAYERS),
        "dis": JDiscriminatorFC(nstyle=NSTYLE, dropout_rate=0.0, noise=0.0, layers=3),
    }
    key = jax.random.PRNGKey(3)
    x0 = {"enc": jnp.zeros((2, DIM)), "dec": jnp.zeros((2, NSTYLE))}
    params, stats = {}, {}
    for i, (name, m) in enumerate(jmods.items()):
        k = jax.random.fold_in(key, i)
        if name == "dis":
            v = m.init({"params": k}, jnp.zeros((2, NSTYLE)), jnp.float32(0.3), train=False)
        else:
            v = m.init({"params": k}, x0[name], train=False)
        params[name] = _np_tree(v["params"])
        stats[name] = _np_tree(v.get("batch_stats", {}))
    rng = np.random.default_rng(5)
    for name in ("enc", "dec"):
        for bn in stats[name].values():
            bn["mean"] = rng.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    tmods = {
        "enc": FCEncoder(nstyle=NSTYLE, dropout_rate=0.0, dim_in=DIM, n_layers=LAYERS),
        "dec": FCDecoder(nstyle=NSTYLE, dropout_rate=0.0, dim_out=DIM,
                         last_layer_activation="Softplus", n_layers=LAYERS),
        "dis": DiscriminatorFC(nstyle=NSTYLE, dropout_rate=0.0, noise=0.0, layers=3),
    }
    sds = from_jax(params, stats)
    for name, m in tmods.items():
        m.load_state_dict(sds[name])
    return jmods, params, stats, tmods


def _jvars(params, stats, name):
    v = {"params": params[name]}
    if stats[name]:
        v["batch_stats"] = stats[name]
    return v


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["enc", "dec"])
def test_autoencoder_modules_match_flax(pair, name, train):
    jmods, params, stats, tmods = pair
    width = DIM if name == "enc" else NSTYLE
    x = np.random.default_rng(1).normal(size=(B, width)).astype(np.float32)
    tm = tmods[name]
    tm.train(train)
    sd_before = {k: v.clone() for k, v in tm.state_dict().items()}
    y = tm(torch.tensor(x)).detach().numpy()
    if train:
        y_ref, mut = jmods[name].apply(_jvars(params, stats, name), jnp.asarray(x),
                                       train=True, mutable=["batch_stats"])
        new_stats = _np_tree(mut["batch_stats"])
        _, got_stats = to_jax({"enc": {}, "dec": {}, "dis": {}, name: tm.state_dict()})
        for bn, leaves in new_stats.items():
            for leaf, ref in leaves.items():
                np.testing.assert_allclose(got_stats[name][bn][leaf], ref, atol=ATOL)
        tm.load_state_dict(sd_before)       # keep the fixture's stats intact
    else:
        y_ref = jmods[name].apply(_jvars(params, stats, name), jnp.asarray(x), train=False)
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=ATOL)


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches_flax_with_grl_gradient(pair, train):
    jmods, params, _, tmods = pair
    x = np.random.default_rng(2).normal(size=(B, NSTYLE)).astype(np.float32)
    beta = 0.37
    tm = tmods["dis"]
    tm.train(train)
    xt = torch.tensor(x, requires_grad=True)
    y = tm(xt, beta)
    y.sum().backward()

    def f(x_):
        return jmods["dis"].apply({"params": params["dis"]}, x_, jnp.float32(beta),
                                  train=train).sum()

    y_ref = jmods["dis"].apply({"params": params["dis"]}, jnp.asarray(x),
                               jnp.float32(beta), train=train)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jax.grad(f)(jnp.asarray(x))),
                               atol=ATOL)


def test_grad_reverse_sign_and_scale():
    x = torch.randn(5, 3, requires_grad=True)
    c = torch.randn(5, 3)
    y = grad_reverse(x, torch.tensor(0.6))
    assert torch.equal(y, x)
    (y * c).sum().backward()
    torch.testing.assert_close(x.grad, -0.6 * c)


def test_weight_bridge_round_trip_is_exact(pair):
    _, params, stats, tmods = pair
    back_params, back_stats = to_jax({k: m.state_dict() for k, m in tmods.items()})
    for ref, got in ((params, back_params), (stats, back_stats)):
        ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
        got_leaves, got_def = jax.tree_util.tree_flatten(got)
        assert ref_def == got_def
        for a, b in zip(ref_leaves, got_leaves):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_torch_default_init():
    enc = FCEncoder(nstyle=NSTYLE, dim_in=DIM, n_layers=LAYERS)
    reset_parameters(enc, torch.Generator().manual_seed(0))
    for name, p in enc.named_parameters():
        if name.startswith("prelu"):
            assert torch.all(p == 0.01)
        else:
            fan_in = getattr(enc, name.split(".")[0]).in_features
            assert p.abs().max() <= 1.0 / np.sqrt(fan_in)
            assert p.abs().max() > 0.5 / np.sqrt(fan_in)
    for name, buf in enc.named_buffers():
        if name.endswith("running_mean"):
            assert torch.all(buf == 0)
        elif name.endswith("running_var"):
            assert torch.all(buf == 1)
