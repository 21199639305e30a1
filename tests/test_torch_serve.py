"""The port's serving path of the conv forms against the JAX package's.

For ``ae_form`` normal (with ``DiscriminatorCNN``) and compact (with the FC
discriminator), at ``nstyle`` 6 and ``dim`` 256, from weights drawn by the
port's initialiser with running statistics and PReLU slopes moved off their
init values:

* the weight bridge is exact both ways, and the port's nested parameter and
  statistics trees have the flax modules' structure and shapes
  (``jax.eval_shape`` of their ``init``);
* a bundle written by the JAX package loads in the port and a bundle
  written by the port loads in the JAX package, leaf for leaf, with the
  same config and extras; the port's msgpack codec reads what the
  ``msgpack`` package writes and writes what it reads;
* ``InferenceModel.encode``/``decode`` (with ``amp_gain`` 1.7)/
  ``reconstruct``/``discriminate`` match the JAX ``InferenceModel`` within
  atol 1e-4 (float32 convs and matmuls summed in another order, through up
  to 11 blocks);
* ``BatchedInference`` over a row count that is not a multiple of the batch
  equals the whole-batch result (atol 1e-5), and the serve CLI's files
  match the JAX CLI's (atol 1e-4).
"""
import json

import msgpack
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import rankaae_tpu.utils.profiling as jprofiling
from rankaae_tpu.models.inference import InferenceModel as JaxInferenceModel
from rankaae_tpu.models.registry import build_autoencoder as jax_build_autoencoder
from rankaae_tpu.models.registry import build_discriminator as jax_build_discriminator
from rankaae_tpu.serve import main as jax_serve_main
from rankaae_tpu.utils.checkpoint import load_model_bundle as jax_load_bundle
from rankaae_tpu.utils.checkpoint import save_model_bundle as jax_save_bundle
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes, make_synthetic_xanes_csv
from rankaae_tpu_torch.models.inference import InferenceModel
from rankaae_tpu_torch.models.primitives import reset_parameters
from rankaae_tpu_torch.models.registry import build_autoencoder, build_discriminator
from rankaae_tpu_torch.serve import BatchedInference, device_benchmark, main as serve_main
from rankaae_tpu_torch.utils import checkpoint
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.weights import from_jax, to_jax
from tests import torch_parity  # noqa: F401  (one torch thread a process)

ATOL = 1e-4
FORMS = {"normal": True, "compact": False}     # ae_form -> use_cnn_discriminator
GAIN = 1.7


def _cfg(form):
    return TrainConfig(ae_form=form, nstyle=6, use_cnn_discriminator=FORMS[form],
                       decoder_activation="Softplus", dropout_rate=0.0, dis_dropout_rate=0.0)


def _trees(form):
    cfg = _cfg(form)
    encoder, decoder = build_autoencoder(cfg)
    models = {"enc": encoder, "dec": decoder, "dis": build_discriminator(cfg)}
    gen = torch.Generator().manual_seed(len(form))
    rng = np.random.default_rng(len(form))
    with torch.no_grad():
        for m in models.values():
            reset_parameters(m, gen)
            for sub in m.modules():
                if isinstance(sub, torch.nn.BatchNorm1d):
                    sub.running_mean.copy_(torch.tensor(rng.normal(0, 0.2, sub.num_features)))
                    sub.running_var.copy_(torch.tensor(rng.uniform(0.5, 1.5, sub.num_features)))
                elif isinstance(sub, torch.nn.PReLU):
                    sub.weight.copy_(torch.tensor(rng.uniform(0.0, 0.3, sub.weight.shape)))
    params, stats = to_jax(models)
    return cfg, params, stats


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Per form: (cfg, params, stats, path of a JAX-written bundle, path of a
    port-written bundle), both with ``amp_gain`` in their extras."""
    out = {}
    for form in FORMS:
        cfg, params, stats = _trees(form)
        d = tmp_path_factory.mktemp(form)
        jax_path = jax_save_bundle(str(d / "jax.mpk"), params, stats,
                                   JaxTrainConfig(**cfg.to_dict()), extra={"amp_gain": GAIN})
        port_path = checkpoint.save_model_bundle(str(d / "port.mpk"), params, stats, cfg,
                                                 extra={"amp_gain": GAIN})
        out[form] = (cfg, params, stats, jax_path, port_path)
    return out


def _assert_trees_equal(got, ref):
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    assert got_def == ref_def
    for a, b in zip(got_leaves, ref_leaves):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("form", FORMS)
def test_weight_bridge_round_trip_is_exact_on_conv_trees(bundles, form):
    cfg, params, stats, _, _ = bundles[form]
    # the nested trees have the flax modules' structure and shapes
    jcfg = JaxTrainConfig(**cfg.to_dict())
    jenc, jdec = jax_build_autoencoder(jcfg)
    key = jax.random.PRNGKey(0)
    shapes = {
        "enc": jax.eval_shape(lambda: jenc.init(key, jnp.zeros((2, 256)), train=False)),
        "dec": jax.eval_shape(lambda: jdec.init(key, jnp.zeros((2, 6)), train=False)),
        "dis": jax.eval_shape(lambda: jax_build_discriminator(jcfg).init(
            key, jnp.zeros((2, 6)), None, train=False)),
    }
    for role, v in shapes.items():
        for tree, name in ((params, "params"), (stats, "batch_stats")):
            ref = jax.tree_util.tree_map(lambda s: s.shape, v.get(name, {}))
            got = jax.tree_util.tree_map(np.shape, tree[role])
            assert ref == got, (role, name)
    # from_jax -> load into fresh modules -> to_jax gives the same leaves
    encoder, decoder = build_autoencoder(cfg)
    models = {"enc": encoder, "dec": decoder, "dis": build_discriminator(cfg)}
    for role, sd in from_jax(params, stats).items():
        models[role].load_state_dict(sd)
    back_params, back_stats = to_jax(models)
    _assert_trees_equal(back_params, params)
    _assert_trees_equal(back_stats, stats)


@pytest.mark.parametrize("form", FORMS)
def test_bundles_load_across_packages(bundles, form):
    cfg, params, stats, jax_path, port_path = bundles[form]
    p, s, c, extra = checkpoint.load_model_bundle(jax_path)
    _assert_trees_equal(p, params)
    _assert_trees_equal(s, stats)
    assert c == cfg and extra == {"amp_gain": GAIN}
    p, s, c, extra = jax_load_bundle(port_path)
    _assert_trees_equal(p, params)
    _assert_trees_equal(s, stats)
    assert c.to_dict() == cfg.to_dict() and extra == {"amp_gain": GAIN}
    with open(jax_path + ".json") as f, open(port_path + ".json") as g:
        assert json.load(f) == json.load(g)


def test_msgpack_codec_matches_the_msgpack_package():
    obj = {"s": "x" * 40, "long": "y" * 300, "b": b"\x00" * 300, "ints": [
        0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63, -1, -32, -33, -128, -129,
        -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 63], "f": [0.5, -1e300], "t": True, "n": None,
        "nest": {str(i): i for i in range(20)}, "list": list(range(20))}
    packed = checkpoint.packb(obj)
    assert packed == msgpack.packb(obj, use_bin_type=True)
    assert checkpoint.unpackb(packed) == obj
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = checkpoint.unpackb(checkpoint.packb({"a": arr, "z": np.float32(2.5),
                                               "e": np.zeros((0, 3), np.int64)}))
    np.testing.assert_array_equal(got["a"], arr)
    assert got["z"] == np.float32(2.5) and got["z"].dtype == np.float32
    assert got["e"].shape == (0, 3) and got["e"].dtype == np.int64
    # a float32 as msgpack's own 0xca
    assert checkpoint.unpackb(msgpack.packb(0.25, use_single_float=True)) == 0.25


@pytest.fixture(scope="module")
def models(bundles):
    """Per form: the port's CPU InferenceModel from the JAX-written bundle and
    the JAX InferenceModel from the port-written bundle."""
    return {form: (InferenceModel.from_bundle(b[3], device="cpu"),
                   JaxInferenceModel.from_bundle(b[4])) for form, b in bundles.items()}


@pytest.mark.parametrize("form", FORMS)
def test_inference_matches_jax(models, form):
    port, ref = models[form]
    assert port.out_gain == ref.out_gain == GAIN
    _, spec, _ = make_synthetic_xanes(n_rows=16, dim=256, seed=3)
    spec = spec.astype(np.float32)
    z, z_ref = port.encode(spec), ref.encode(spec)
    assert z.shape == (16, 6)
    np.testing.assert_allclose(z, z_ref, atol=ATOL)
    y, y_ref = port.decode(z_ref), ref.decode(z_ref)
    assert y.shape == (16, 256) and np.abs(y_ref).max() > 1e-3
    np.testing.assert_allclose(y, y_ref, atol=ATOL)
    np.testing.assert_allclose(port.reconstruct(spec), ref.decode(ref.encode(spec)),
                               atol=ATOL)
    np.testing.assert_allclose(port.discriminate(z_ref), ref.discriminate(z_ref), atol=ATOL)


@pytest.mark.parametrize("form", FORMS)
def test_batched_inference_equals_whole_batch(models, form):
    port, _ = models[form]
    spec = np.random.default_rng(4).normal(size=(37, 256)).astype(np.float32)
    serve = BatchedInference(port, batch_size=16)
    assert serve.device == torch.device("cpu")        # the model's
    np.testing.assert_allclose(serve.encode(spec), port.encode(spec), atol=1e-5)
    recon = serve.reconstruct(spec)
    assert recon.shape == (37, 256)
    np.testing.assert_allclose(recon, port.reconstruct(spec), atol=1e-5)
    np.testing.assert_allclose(recon, serve.decode(serve.encode(spec)), atol=1e-5)


@pytest.mark.parametrize("form", FORMS)
def test_serve_cli_matches_jax(bundles, tmp_path, monkeypatch, form):
    # the JAX CLI would point its compile cache into the home directory
    monkeypatch.setattr(jprofiling, "enable_compilation_cache", lambda: None)
    csv = make_synthetic_xanes_csv(str(tmp_path / "data.csv"), n_rows=40, dim=256, seed=5)
    bundle = bundles[form][4]
    serve_main([bundle, csv, str(tmp_path / "port"), "--batch-size", "16", "--device", "cpu"])
    jax_serve_main([bundle, csv, str(tmp_path / "jax"), "--batch-size", "16"])
    for kind, shape in (("styles", (40, 6)), ("recon", (40, 256))):
        got = np.loadtxt(tmp_path / f"port_{kind}.txt")
        ref = np.loadtxt(tmp_path / f"jax_{kind}.txt")
        assert got.shape == shape
        np.testing.assert_allclose(got, ref, atol=ATOL)


def test_benchmarks_refuse_the_cpu(models):
    with pytest.raises(RuntimeError, match="measures the card"):
        device_benchmark(models["compact"][0], batch_size=4, iters=1)
