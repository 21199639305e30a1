"""The port's conv primitives, residual blocks and K3's plain version against
the JAX package.

* ``Conv1d``/``ConvTranspose1d`` against the flax primitives, over zero and
  replicate padding, stride and groups (atol 1e-5: float32 sums of at most
  44 terms taken in another order).
* ``EncodingBlock``/``DecodingBlock`` against flax in train mode (dropout 0;
  outputs and updated running statistics) and in eval mode, over every block
  configuration of the four conv models (atol 1e-5).  Weights are drawn by
  the port's initialiser and carried to flax by the weight bridge; the
  running statistics are perturbed away from (0, 1).
* ``fused_block_plain`` against the probe's ``reference_block`` and its
  Pallas kernel ``fused_block(..., interpret=True)`` at B = 128 and C 4 and
  2 (relative 1e-5 of the output's largest magnitude).  The probe is loaded
  from ``scripts/`` with importlib, a copy per case, whose module constant
  ``C`` the case sets.
* An eval-mode block of K3's shape on the CPU computes ``fused_block_plain``
  exactly, which agrees with the block's own op-by-op path (atol 1e-5), and
  launches nothing; with grad enabled it raises, as K3 has no backward.
"""
import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rankaae_tpu.models import blocks as jblocks
from rankaae_tpu.models import primitives as jprim

from rankaae_tpu_torch.models.blocks import DecodingBlock, EncodingBlock
from rankaae_tpu_torch.models.primitives import Conv1d, ConvTranspose1d, reset_parameters
from rankaae_tpu_torch.ops import fused_block_cuda as fb
from rankaae_tpu_torch.utils import tracing
from rankaae_tpu_torch.utils.weights import to_jax
from tests import torch_parity  # noqa: F401  (one torch thread a process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
B = 16


def _init(module, seed):
    reset_parameters(module, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.tensor(rng.normal(0, 0.3, m.num_features)))
                m.running_var.copy_(torch.tensor(rng.uniform(0.5, 2.0, m.num_features)))
            elif isinstance(m, torch.nn.PReLU):      # off the 0.01 init: exercise the slopes
                m.weight.copy_(torch.tensor(rng.uniform(0.0, 0.3, m.weight.shape)))
    return module


@pytest.mark.parametrize("c_in,c_out,k,stride,padding,mode,groups", [
    (1, 4, 11, 1, 5, "replicate", 1),
    (4, 4, 11, 2, 5, "zeros", 1),
    (4, 4, 7, 2, 3, "replicate", 1),
    (4, 2, 2, 2, 0, "zeros", 2),
    (4, 2, 1, 1, 0, "zeros", 2),
    (2, 1, 5, 1, 2, "replicate", 1),
])
def test_conv1d_matches_flax(c_in, c_out, k, stride, padding, mode, groups):
    tm = _init(Conv1d(c_in, c_out, k, stride=stride, padding=padding, padding_mode=mode,
                      groups=groups), 1)
    jm = jprim.Conv1d(c_in, c_out, k, stride=stride, padding=padding, padding_mode=mode,
                      groups=groups)
    x = np.random.default_rng(2).normal(size=(B, c_in, 64)).astype(np.float32)
    params, _ = to_jax({"m": tm})
    y_ref = jm.apply({"params": params["m"]}, jnp.asarray(x))
    y = tm(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=ATOL)


@pytest.mark.parametrize("c_in,c_out,k,groups", [
    (6, 8, 2, 1), (8, 4, 4, 4), (4, 4, 2, 1), (8, 4, 8, 4), (4, 4, 4, 4)])
def test_conv_transpose1d_matches_flax(c_in, c_out, k, groups):
    tm = _init(ConvTranspose1d(c_in, c_out, k, k, groups=groups), 3)
    jm = jprim.ConvTranspose1d(c_in, c_out, k, k, groups=groups)
    x = np.random.default_rng(4).normal(size=(B, c_in, 16)).astype(np.float32)
    params, _ = to_jax({"m": tm})
    y_ref = jm.apply({"params": params["m"]}, jnp.asarray(x))
    y = tm(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=ATOL)


def test_conv_transpose1d_needs_kernel_equal_stride():
    with pytest.raises(ValueError, match="kernel_size == stride"):
        ConvTranspose1d(4, 4, 4, 2)


# (c_in, c_out, in_len, out_len, kernel, stride, excitation) of every
# EncodingBlock of Encoder, CompactEncoder, Decoder and CompactDecoder
ENC_BLOCKS = [
    (1, 4, 256, 128, 11, 2, 4), (4, 4, 128, 64, 11, 2, 4), (4, 4, 64, 32, 7, 2, 2),
    (4, 4, 32, 16, 7, 2, 2), (4, 4, 16, 8, 5, 2, 1),                 # Encoder
    (1, 4, 256, 64, 11, 2, 4), (4, 4, 64, 16, 7, 2, 2),              # CompactEncoder
    (4, 4, 256, 256, 11, 1, 2), (4, 2, 256, 256, 11, 1, 2),
    (2, 2, 256, 256, 11, 1, 2),                                      # (Compact)Decoder
]
# (c_in, c_out, in_len, excitation, out_len) of every DecodingBlock
DEC_BLOCKS = [
    (6, 8, 1, 1, -1), (8, 4, 4, 2, -1), (4, 4, 16, 2, -1), (4, 4, 64, 4, -1),  # Decoder
    (6, 8, 1, 1, 8), (8, 4, 8, 2, 64),                                         # Compact
]


def _block_pair(kind, spec):
    if kind == "enc":
        c_in, c_out, in_len, out_len, k, stride, e = spec
        kw = dict(kernel_size=k, stride=stride, excitation=e, dropout_rate=0.0)
        tm = EncodingBlock(c_in, c_out, in_len, out_len, **kw)
        jm = jblocks.EncodingBlock(c_in, c_out, in_len, out_len, **kw)
    else:
        c_in, c_out, in_len, e, out_len = spec
        kw = dict(excitation=e, dropout_rate=0.0, out_len=out_len)
        tm = DecodingBlock(c_in, c_out, in_len, **kw)
        jm = jblocks.DecodingBlock(c_in, c_out, in_len, **kw)
    return _init(tm, sum(spec) + 7), jm, (c_in, in_len)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind,spec", [("enc", s) for s in ENC_BLOCKS]
                         + [("dec", s) for s in DEC_BLOCKS])
def test_block_matches_flax(kind, spec, train):
    tm, jm, (c_in, in_len) = _block_pair(kind, spec)
    x = np.random.default_rng(5).normal(size=(B, c_in, in_len)).astype(np.float32)
    params, stats = to_jax({"m": tm})
    variables = {"params": params["m"], "batch_stats": stats["m"]}
    tm.train(train)
    with torch.no_grad():           # an eval block of K3's shape has no backward
        y = tm(torch.tensor(x)).numpy()
    if train:
        y_ref, mut = jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
        _, got = to_jax({"m": tm})
        ref_leaves, ref_def = jax.tree_util.tree_flatten(mut["batch_stats"])
        got_leaves, got_def = jax.tree_util.tree_flatten(got["m"])
        assert ref_def == got_def
        for a, b in zip(got_leaves, ref_leaves):
            np.testing.assert_allclose(a, np.asarray(b), atol=ATOL)
    else:
        y_ref = jm.apply(variables, jnp.asarray(x), False)
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=ATOL)


def _probe():
    spec = importlib.util.spec_from_file_location(
        "fused_block_probe", os.path.join(REPO, "scripts", "fused_block_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_args(p):
    """The probe's parameter dict in the wrapper's argument order and the
    port's layouts (fc1 (E, L), fc2 (L, E))."""
    t = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    return (t["bn1m"], t["bn1v"], t["w1"], t["b1"], t["a1"], t["bn2m"], t["bn2v"],
            t["w2"], t["b2"], t["a2"], t["fc1w"].T.contiguous(), t["fc1b"], t["ae1"],
            t["fc2w"].T.contiguous(), t["fc2b"], t["ae2"])


@pytest.mark.parametrize("c", (4, 2))
def test_fused_block_plain_matches_probe_kernel(c):
    probe = _probe()
    probe.C = c                     # this case's own copy of the probe module
    x, p = probe.make_inputs(128, seed=3)
    y_kernel = np.asarray(probe.fused_block(x, p, interpret=True))
    y_ref = np.asarray(jax.jit(probe.reference_block)(x, p))
    y = fb.fused_block(torch.tensor(np.asarray(x)), *_port_args(p)).numpy()
    scale = np.abs(y_ref).max()
    np.testing.assert_allclose(y, y_kernel, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("c", fb.CHANNELS)
def test_eval_block_on_cpu_is_fused_block_plain(c):
    block = _init(EncodingBlock(c, c, 256, 256, kernel_size=11, stride=1, excitation=2,
                                dropout_rate=0.0), 11 + c).eval()
    assert block.fused
    x = torch.tensor(np.random.default_rng(6).normal(size=(33, c, 256)).astype(np.float32))
    before = tracing.counter("k3.launches")
    with torch.no_grad():
        y = block(x)
        y_plain = fb.fused_block_plain(
            x, block.bn1.running_mean, block.bn1.running_var, block.conv1.weight,
            block.conv1.bias, block.relu1.weight, block.bn2.running_mean,
            block.bn2.running_var, block.conv2.weight, block.conv2.bias, block.relu2.weight,
            block.fc1.weight, block.fc1.bias, block.relu_excit_1.weight,
            block.fc2.weight, block.fc2.bias, block.relu_excit_2.weight)
        block.fused = False
        y_ops = block(x)
    assert tracing.counter("k3.launches") == before
    assert torch.equal(y, y_plain)
    np.testing.assert_allclose(y.numpy(), y_ops.numpy(), atol=ATOL)


@pytest.mark.parametrize("needs_grad", ["params", "input"])
def test_fused_block_refuses_autograd(needs_grad):
    block = _init(EncodingBlock(4, 4, 256, 256, kernel_size=11, stride=1, excitation=2,
                                dropout_rate=0.0), 5).eval()
    x = torch.zeros((2, 4, 256))
    if needs_grad == "input":
        block.requires_grad_(False)
        x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        block(x)
    with torch.no_grad():
        assert block(x).shape == x.shape


def test_fused_block_checks_its_inputs():
    x, p = _probe().make_inputs(2, seed=0)
    args = _port_args(p)
    x = torch.tensor(np.asarray(x))
    with pytest.raises(TypeError, match="float32"):
        fb.fused_block(x.double(), *args)
    with pytest.raises(ValueError, match="shape"):
        fb.fused_block(x, *args[:2], args[2][:, :, :5].contiguous(), *args[3:])
    with pytest.raises(ValueError, match="C in"):
        fb.fused_block(x[:, :3].contiguous(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        fb.fused_block(x, *args[:10], args[10].T.contiguous().T, *args[11:])
    with pytest.raises(ValueError, match="is on meta"):
        fb.fused_block(x, *args[:3], args[3].to("meta"), *args[4:])
    with pytest.raises(ValueError, match="unsupported device"):
        fb.fused_block(x.to("meta"), *(a.to("meta") for a in args))
