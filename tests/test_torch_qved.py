"""The ``qved`` form of the port against the JAX package's.

* ``QvecEncoder`` and ``QvecDecoder`` against the flax modules
  (``rankaae_tpu/models/encoders.py:102-132``, ``decoders.py:135-165``),
  weights carried over by the weight bridge, train and eval mode, running
  statistics included: atol 1e-6 and rtol 1e-5 (float32 products of width
  <= 12 summed in another order; a train-mode BatchNorm of 64 rows turns
  their ulps into ~1e-6 on outputs of magnitude ~3).
* A qved bundle both ways: the JAX package's bundle served by the port's
  ``InferenceModel`` and the port's read by the JAX package, every leaf
  equal, and the port's encode and reconstruction against the JAX
  ``InferenceModel``'s at the same tolerances.
* One faithful qved ``_train_batch`` against the JAX package's, whole and
  each step from identical inputs
  (``tests/torch_parity.py::compare_batch_by_steps``, atol 1e-4: the whole
  batch agrees within 7.2e-7), and ``_validate`` (atol 1e-5).
* Two qved ``epoch_step``s against the JAX ones: ``tests/test_torch_qved_epoch.py``.

The data are the JAX package's qved test's (``tests/test_conv_forms_training.py
:64-84``): 12-dim q-vectors made as the descriptors times a random 5 x 12 map
plus noise, from a numpy seed.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rankaae_tpu.models.inference import InferenceModel as JaxInferenceModel
from rankaae_tpu.models.registry import build_autoencoder as jax_build_autoencoder
from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.utils.checkpoint import load_model_bundle as jax_load_bundle
from rankaae_tpu.utils.checkpoint import save_model_bundle as jax_save_bundle
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.models.inference import InferenceModel
from rankaae_tpu_torch.models.registry import build_autoencoder
from rankaae_tpu_torch.train.trainer import RankAAETrainer
from rankaae_tpu_torch.utils import checkpoint
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.weights import from_jax, to_jax
from tests.test_torch_trainer import CFG as FC_CFG
from tests.torch_parity import compare_batch_by_steps, compare_validate, jax_init

ATOL, RTOL = 1e-6, 1e-5
DIM, NSTYLE = 12, 6
CFG = {**FC_CFG, "ae_form": "qved", "dim_in": DIM, "dim_out": DIM, "batch_size": 64,
       "lr_base": 1e-4}
N_VAL = 40


def qvec_data(seed, n):
    """(q-vectors (n, 12), descriptors (n, 5)), as the JAX qved test makes them."""
    rng = np.random.default_rng(seed)
    aux = rng.normal(size=(n, 5)).astype(np.float32)
    qvec = (aux @ rng.normal(size=(5, DIM)).astype(np.float32)
            + rng.normal(size=(n, DIM)).astype(np.float32) * 0.1)
    return qvec.astype(np.float32), aux


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    """The flax qved modules' initial weights, with non-trivial running
    statistics."""
    jcfg = JaxTrainConfig(**CFG)
    jenc, jdec = jax_build_autoencoder(jcfg)
    params, stats = {}, {}
    for i, (role, m, width) in enumerate((("enc", jenc, DIM), ("dec", jdec, NSTYLE))):
        v = m.init({"params": jax.random.PRNGKey(i)}, jnp.zeros((2, width)), train=False)
        params[role], stats[role] = _np(v["params"]), _np(v["batch_stats"])
    rng = np.random.default_rng(5)
    for role in stats:
        for bn in stats[role].values():
            bn["mean"] = rng.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return (jenc, jdec), params, stats


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("role", ["enc", "dec"])
def test_qved_modules_match_flax(trees, role, train):
    (jenc, jdec), params, stats = trees
    jmod = jenc if role == "enc" else jdec
    encoder, decoder = build_autoencoder(TrainConfig(**CFG))
    tmod = encoder if role == "enc" else decoder
    tmod.load_state_dict(from_jax(params, stats)[role])
    tmod.train(train)
    x = np.random.default_rng(1).normal(size=(64, DIM if role == "enc" else NSTYLE))
    x = x.astype(np.float32)
    y = tmod(torch.tensor(x)).detach().numpy()
    jvars = {"params": params[role], "batch_stats": stats[role]}
    if train:
        y_ref, mut = jmod.apply(jvars, jnp.asarray(x), train=True, mutable=["batch_stats"])
        _, got = to_jax({role: tmod})
        for bn, leaves in _np(mut["batch_stats"]).items():
            for leaf, ref in leaves.items():
                np.testing.assert_allclose(got[role][bn][leaf], ref, atol=ATOL, rtol=RTOL,
                                           err_msg=bn)
    else:
        y_ref = jmod.apply(jvars, jnp.asarray(x), train=False)
    assert y.shape == (64, NSTYLE if role == "enc" else DIM)
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=ATOL, rtol=RTOL)


def test_qved_bundle_round_trip(trees, tmp_path):
    _, params, stats = trees
    cfg = TrainConfig(**CFG)
    jax_path = jax_save_bundle(str(tmp_path / "jax.mpk"), params, stats, JaxTrainConfig(**CFG))
    port_path = checkpoint.save_model_bundle(str(tmp_path / "port.mpk"), params, stats, cfg)
    for load, path in ((checkpoint.load_model_bundle, jax_path), (jax_load_bundle, port_path)):
        p, s, c, _ = load(path)
        assert c.ae_form == "qved"
        for got, ref in ((p, params), (s, stats)):
            got_leaves, got_def = jax.tree_util.tree_flatten(got)
            ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
            assert got_def == ref_def
            for a, b in zip(got_leaves, ref_leaves):
                np.testing.assert_array_equal(a, b)
    port = InferenceModel.from_bundle(jax_path, device="cpu")
    ref = JaxInferenceModel.from_bundle(port_path)
    q, _ = qvec_data(3, 32)
    z = port.encode(q)
    assert z.shape == (32, NSTYLE)
    np.testing.assert_allclose(z, ref.encode(q), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(port.reconstruct(q), ref.decode(ref.encode(q)), atol=ATOL,
                               rtol=RTOL)


@pytest.fixture(scope="module")
def pair():
    b = CFG["batch_size"]
    jtr = JaxTrainer(JaxTrainConfig(**CFG), n_train=b, n_val=N_VAL)
    ttr = RankAAETrainer(TrainConfig(**CFG), n_train=b, n_val=N_VAL, device="cpu")
    return jtr, jax_init(jtr), ttr, ttr.init_state(0)


def test_qved_batch_matches_jax(pair):
    q, aux = qvec_data(1, CFG["batch_size"])
    moved, _, _ = compare_batch_by_steps(*pair, q, aux)
    # the batch moved the autoencoder far beyond the tolerance
    assert np.median(moved) > 1e-4


def test_qved_validate_matches_jax(pair):
    q, aux = qvec_data(2, N_VAL)
    got = compare_validate(*pair, q, aux)
    assert np.isfinite(got["gain"].item()) and np.isfinite(got["smooth"].item())
