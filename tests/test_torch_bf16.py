"""``activation_dtype: bfloat16`` in the port against the JAX package
(``rankaae_tpu/models/primitives.py:60-96`` and the casts of its modules).

The JAX side's dtype is set only inside ``activation_dtype_scope`` (its
trainer's constructor sets the process global, so the JAX trainers are
built and traced inside the scope too), so nothing leaks into later tests
of the same worker.  The port carries the dtype on its modules.

Tolerances: a bfloat16 value carries 8 significant bits, so two stacks
that sum the same float32 products in another order and round the sum to
bfloat16 may part by one unit in the last place, 2^-8 to 2^-7 of the value
(:data:`RTOL`, with :data:`ATOL` of the largest magnitude for values that
cancel to near 0).  A gradient passes through several such roundings
(:data:`GRAD_RTOL`, :data:`GRAD_ATOL`).

* Each primitive (``Linear``, ``TrialLinear``, ``Conv1d``/``TrialConv1d``,
  ``ConvTranspose1d``/``TrialConvTranspose1d``, BatchNorm over features
  and channels, PReLU over features and channels) against its flax
  counterpart in bfloat16: the output (its dtype bfloat16) and the
  input's gradient for a fixed cotangent, every parameter's gradient
  (float32) against the float32 sum of the same products (see
  :func:`_jax_forward`), a stacked module per trial; BatchNorm in train
  mode, its running statistics float32.
* One faithful FC and one compact (CNN discriminator) batch against the
  JAX bfloat16 batch at ``lr_base`` 1e-4, dropout and noise 0: each of the
  six losses within :data:`BATCH_LOSS_RTOL` of its value or twice the
  spread a perturbation of the weights by 2^-9 relative (half a bfloat16
  unit) makes on either stack, and every leaf within twice that spread or
  :data:`BATCH_LEAF_ATOL`.  A bfloat16 rounding that falls the other way
  is amplified by the steps after it as float32 rounding is in the
  float32 batches (``tests/torch_parity.py``), only 2^16 times larger;
  measured: losses within 1.4e-3 (FC) and 3.3e-3 (compact), leaves within
  1.6e-3 and 1.7e-2, inside the spreads.
* The fused block (K3's shape) in eval mode under bfloat16: exactly the
  float32 plain version of K3 on a float32 copy of the input, cast back
  (K3 is a float32 kernel), and within :data:`BLOCK_RTOL` of the flax
  bfloat16 block, which rounds at every primitive.
* A bfloat16 trainer followed by an ``InferenceModel``: the inference
  modules compute in float32 (outputs equal to those of a float32
  config's model bit for bit) while the trainer's stay bfloat16.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rankaae_tpu.models import blocks as jblocks
from rankaae_tpu.models import primitives as jprim
from rankaae_tpu.models.primitives import activation_dtype_scope
from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.models.blocks import EncodingBlock, TrialEncodingBlock
from rankaae_tpu_torch.models.inference import InferenceModel
from rankaae_tpu_torch.models.primitives import (
    BatchNorm,
    Conv1d,
    ConvTranspose1d,
    Linear,
    PReLU,
    TrialBatchNorm,
    TrialChannelBatchNorm,
    TrialChannelPReLU,
    TrialConv1d,
    TrialConvTranspose1d,
    TrialLinear,
    TrialPReLU,
    reset_parameters,
    set_activation_dtype,
)
from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.weights import to_jax
from tests.test_torch_conv import _init
from tests.test_torch_trainer import CFG as FC_CFG
from tests.torch_parity import (
    LOSSES,
    _flat,
    _port_batch,
    _with_nu0,
    jax_init,
    make_data,
)

BF16 = torch.bfloat16
RTOL, ATOL = 2.0 ** -7, 2.0 ** -8         # of the value, of the largest magnitude
GRAD_RTOL, GRAD_ATOL = 2.0 ** -5, 2.0 ** -7
BATCH_LOSS_RTOL = 2e-2
BATCH_LEAF_ATOL = 1e-4
BLOCK_RTOL = 2.0 ** -4                    # of the block output's largest magnitude
PERTURB = 2.0 ** -9
T, B = 2, 16


def _bf16(x):
    """A float32 array rounded to bfloat16, as a float32 numpy array."""
    return np.asarray(torch.tensor(x).to(BF16).float())


def _close(got, ref, rtol, atol, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max()) or 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * scale, err_msg=what)


# (single module, stacked module, flax module, input shape of one trial,
#  channel layout (B, T*C, L) or features (T, B, C))
PRIMITIVES = {
    "linear": (lambda: Linear(20, 7), lambda: TrialLinear(T, 20, 7),
               lambda: jprim.Linear(7), (B, 20), False),
    "conv": (lambda: Conv1d(4, 4, 11, stride=2, padding=5, padding_mode="replicate"),
             lambda: TrialConv1d(T, 4, 4, 11, stride=2, padding=5, padding_mode="replicate"),
             lambda: jprim.Conv1d(4, 4, 11, stride=2, padding=5, padding_mode="replicate"),
             (B, 4, 64), True),
    "conv_transpose": (lambda: ConvTranspose1d(8, 4, 4, 4, groups=4),
                       lambda: TrialConvTranspose1d(T, 8, 4, 4, 4, groups=4),
                       lambda: jprim.ConvTranspose1d(8, 4, 4, 4, groups=4), (B, 8, 16), True),
    "batch_norm": (lambda: BatchNorm(7), lambda: TrialBatchNorm(T, 7),
                   lambda: jprim.BatchNorm(7), (B, 7), False),
    "channel_batch_norm": (lambda: BatchNorm(4), lambda: TrialChannelBatchNorm(T, 4),
                           lambda: jprim.BatchNorm(4, channel_axis=1), (B, 4, 32), True),
    "prelu": (lambda: PReLU(7), lambda: TrialPReLU(T, 7), lambda: jprim.PReLU(7), (B, 7), False),
    "channel_prelu": (lambda: PReLU(4), lambda: TrialChannelPReLU(T, 4),
                      lambda: jprim.PReLU(4, channel_axis=1), (B, 4, 32), True),
}


def _jax_forward(jm, params, stats, x, g):
    """The flax module on the bfloat16 ``x``: its bfloat16 output and the
    input's gradient for the cotangent ``g``, and the parameters' gradients
    of the module in float32 on the same (bfloat16-valued) ``x`` and ``g``
    (train mode where it has running statistics).

    A primitive's parameter gradient is a sum over the batch of products
    of ``x`` and ``g`` (bfloat16 values, so float32 holds each product
    exactly).  The JAX package's bfloat16 modules take some of these sums
    in bfloat16 (the PReLU slope's and the convolution bias's): on 512
    terms the slope's gradient lands up to 5% off its float64 value, where
    the port's, summed in float32 and rounded once, is within one bfloat16
    unit.  So the parameters' gradients are held to the float32 sums."""
    def f(p, xx):
        if stats:
            return jm.apply({"params": p, "batch_stats": stats}, xx, True,
                            mutable=["batch_stats"])[0]
        return jm.apply({"params": p}, xx)

    with activation_dtype_scope("bfloat16"):
        y, vjp = jax.vjp(f, params, x)
        _, gx = vjp(jnp.asarray(g, y.dtype))
    _, vjp32 = jax.vjp(f, params, jnp.asarray(x, jnp.float32))
    gp, _ = vjp32(jnp.asarray(g, jnp.float32))
    return y, gx, gp


def _single_of(make_single, sd, i, stacked):
    """A single-trial module holding trial ``i`` of the state dict ``sd``."""
    m = make_single()
    m.load_state_dict({k: v[i] if stacked else v for k, v in sd.items()}, strict=False)
    return m


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_matches_flax_in_bf16(name, stacked):
    make_single, make_stacked, make_flax, shape, channels = PRIMITIVES[name]
    gen = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(4)
    tm = make_stacked() if stacked else make_single()
    for i in range(T if stacked else 1):
        reset_parameters(tm, gen, trial=i)
    with torch.no_grad():               # slopes and statistics off their initial values
        for key, v in tm.state_dict().items():
            if key.endswith("running_mean"):
                v.copy_(torch.tensor(rng.normal(0, 0.3, v.shape)))
            elif key.endswith("running_var"):
                v.copy_(torch.tensor(rng.uniform(0.5, 2.0, v.shape)))
            elif "prelu" in name:
                v.copy_(torch.tensor(rng.uniform(0.0, 0.3, v.shape)))
    set_activation_dtype(tm, "bfloat16")
    train = "batch_norm" in name
    tm.train(train)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    # each trial's (B, ...) input, in bfloat16 as the activations between modules
    xs = [_bf16(rng.normal(size=shape).astype(np.float32)) for _ in range(T if stacked else 1)]
    x = xs[0] if not stacked else np.concatenate(xs, axis=1) if channels else np.stack(xs)
    x = torch.tensor(x).to(BF16).requires_grad_(True)
    params = list(tm.parameters())
    y = tm(x)
    assert y.dtype == BF16
    g = torch.tensor(_bf16(rng.normal(size=tuple(y.shape)).astype(np.float32))).to(BF16)
    gx, *gparams = torch.autograd.grad(y, [x] + params, g)
    assert gx.dtype == BF16 and all(p.dtype == torch.float32 for p in gparams)
    worst = {"y": 0.0, "dx": 0.0}
    for i, xi in enumerate(xs):
        if channels:                    # trial i's input and output channels
            c_in, c_out = shape[1], y.shape[1] // len(xs)
            sl = (slice(None), slice(i * c_in, (i + 1) * c_in))
            sl_out = (slice(None), slice(i * c_out, (i + 1) * c_out))
        else:
            sl = sl_out = (i,) if stacked else (slice(None),)
        jparams, jstats = to_jax({"m": _single_of(make_single, before, i, stacked)})
        y_ref, gx_ref, gp_ref = _jax_forward(make_flax(), jparams["m"], jstats["m"] if train
                                             else {}, jnp.asarray(xi, jnp.bfloat16),
                                             np.asarray(g[sl_out].float()))
        assert y_ref.dtype == jnp.bfloat16
        for key, got, ref, rtol, atol in (
                ("y", y.detach()[sl_out], y_ref, RTOL, ATOL),
                ("dx", gx[sl], gx_ref, GRAD_RTOL, GRAD_ATOL)):
            got, ref = got.float().numpy(), np.asarray(ref, np.float32)
            _close(got, ref, rtol, atol, f"{name} {key}[{i}]")
            worst[key] = max(worst[key], float(np.abs(got - ref).max()))
        if params:
            got = _flat(to_jax({"m": _single_of(
                make_single, dict(zip([k for k, _ in tm.named_parameters()], gparams)), i,
                stacked)})[0]["m"])
            for key, ref in _flat(gp_ref).items():
                ref = np.asarray(ref, np.float32)
                _close(got[key], ref, GRAD_RTOL, GRAD_ATOL, f"{name} d{key}[{i}]")
                worst[f"d{key}"] = max(worst.get(f"d{key}", 0.0),
                                       float(np.abs(got[key] - ref).max()))
        if train:                       # running statistics stay float32
            ref_stats = jax.tree_util.tree_map(np.asarray, _jax_stats(
                make_flax(), jparams["m"], jstats["m"], jnp.asarray(xi, jnp.bfloat16)))
            now = _single_of(make_single, tm.state_dict(), i, stacked)
            _, got_stats = to_jax({"m": now})
            for key, ref in _flat(ref_stats).items():
                got_v = _flat(got_stats["m"])[key]
                assert got_v.dtype == np.float32
                np.testing.assert_allclose(got_v, ref, rtol=1e-5, atol=1e-6, err_msg=key)
    print(json.dumps({f"{name} {'stacked' if stacked else 'single'}": worst}))


def _jax_stats(jm, params, stats, x):
    with activation_dtype_scope("bfloat16"):
        return jm.apply({"params": params, "batch_stats": stats}, x, True,
                        mutable=["batch_stats"])[1]["batch_stats"]


BATCH_CASES = {"fc": {}, "compact": {"ae_form": "compact", "use_cnn_discriminator": True}}
SPREAD_SEEDS = range(1, 5)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) * (1 + PERTURB * rng.standard_normal(np.shape(x))))
        .astype(np.float32), params)


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_bf16_batch_matches_jax(case):
    cfg = {**FC_CFG, "batch_size": 64, "activation_dtype": "bfloat16", "lr_base": 1e-4,
           **BATCH_CASES[case]}
    b = cfg["batch_size"]
    spec, aux = make_data(9, b)
    rng = jax.random.PRNGKey(42)
    ttr = RankAAETrainer(TrainConfig(**cfg), n_train=b, n_val=16, device="cpu")
    assert all(m.act_dtype == BF16 for m in ttr.models["enc"].modules())
    with activation_dtype_scope("bfloat16"):
        jtr = JaxTrainer(JaxTrainConfig(**cfg), n_train=b, n_val=16)
        jstate = _with_nu0(jax_init(jtr), ttr.init_state(0))
        step = jax.jit(jtr._train_batch)
        args = (jnp.asarray(spec), jnp.asarray(aux), jnp.float32(0.3), jnp.int32(0), rng)

        def run_jax(state):
            new, losses = step(state, *args)
            return ({k: float(v) for k, v in losses.items()},
                    _flat({"params": new.params, "stats": new.batch_stats}))

        ref = run_jax(jstate)
        jax_runs = [run_jax(jstate._replace(params=_perturbed(jstate.params, s)))
                    for s in SPREAD_SEEDS]

    def run_port(state):
        losses, leaves, _ = _port_batch(jtr, state, ttr, ttr.init_state(0), spec, aux, 0.3, 0,
                                        rng)
        return losses, leaves

    got = run_port(jstate)
    port_runs = [run_port(jstate._replace(params=_perturbed(jstate.params, s)))
                 for s in SPREAD_SEEDS]
    spread = ({k: 0.0 for k in LOSSES}, {k: 0.0 for k in ref[1]})
    for base, runs in ((ref, jax_runs), (got, port_runs)):
        for run in runs:
            for k in LOSSES:
                spread[0][k] = max(spread[0][k], abs(run[0][k] - base[0][k]))
            for k in ref[1]:
                spread[1][k] = max(spread[1][k], float(np.abs(run[1][k] - base[1][k]).max()))
    diff = ({k: abs(got[0][k] - ref[0][k]) for k in LOSSES},
            {k: float(np.abs(got[1][k] - v).max()) for k, v in ref[1].items()})
    print(json.dumps({"bf16 batch": case, "loss_diff": diff[0], "loss_spread": spread[0],
                      "leaf_diff_max": max(diff[1].values()),
                      "leaf_spread_max": max(spread[1].values())}))
    assert sorted(got[1]) == sorted(ref[1])
    for k in LOSSES:
        assert diff[0][k] <= max(BATCH_LOSS_RTOL * abs(ref[0][k]), 2 * spread[0][k]), k
    for k in ref[1]:
        assert diff[1][k] <= max(BATCH_LEAF_ATOL, 2 * spread[1][k]), (k, diff[1][k])


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
def test_bf16_fused_block_runs_k3_in_float32(stacked):
    make = (lambda: TrialEncodingBlock(T, 4, 4, 256, 256, kernel_size=11, stride=1,
                                       excitation=2, dropout_rate=0.0)) if stacked else \
        (lambda: EncodingBlock(4, 4, 256, 256, kernel_size=11, stride=1, excitation=2,
                               dropout_rate=0.0))
    block = _init(make(), 13)
    if stacked:
        reset_parameters(block, torch.Generator().manual_seed(14), trial=1)
    set_activation_dtype(block.eval(), "bfloat16")
    assert block.fused
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.normal(size=(33, 4 * (T if stacked else 1), 256)).astype(np.float32))
    x16 = x.to(BF16)
    with torch.no_grad():
        y = block(x16)
        assert y.dtype == BF16
        set_activation_dtype(block, "float32")
        y32 = block(x16.float())              # K3's plain version, float32
    assert torch.equal(y, y32.to(BF16))
    # against the flax block in bfloat16, which rounds at every primitive
    for i in range(T if stacked else 1):
        single = _single_of(lambda: EncodingBlock(4, 4, 256, 256, kernel_size=11, stride=1,
                                                  excitation=2, dropout_rate=0.0),
                            block.state_dict(), i, stacked)
        params, stats = to_jax({"m": single})
        jm = jblocks.EncodingBlock(4, 4, 256, 256, kernel_size=11, stride=1, excitation=2,
                                   dropout_rate=0.0)
        with activation_dtype_scope("bfloat16"):
            y_ref = jm.apply({"params": params["m"], "batch_stats": stats["m"]},
                             jnp.asarray(x16[:, 4 * i:4 * (i + 1)].float().numpy(),
                                         jnp.bfloat16), False)
        got = y[:, 4 * i:4 * (i + 1)].float().numpy()
        ref = np.asarray(y_ref, np.float32)
        print(f"bf16 fused block vs flax: {np.abs(got - ref).max():.3g} of max "
              f"{np.abs(ref).max():.3g}")
        np.testing.assert_allclose(got, ref, rtol=0, atol=BLOCK_RTOL * np.abs(ref).max())


def test_inference_after_bf16_trainer_is_float32():
    cfg = TrainConfig(**{**FC_CFG, "batch_size": 32, "activation_dtype": "bfloat16",
                         "ae_form": "compact"})
    spec, aux = make_data(10, 48)
    data = TrialData(*(torch.tensor(a) for a in (spec[:32], aux[:32], spec[32:], aux[32:])))
    ttr = RankAAETrainer(cfg, n_train=32, n_val=16, device="cpu")
    state = ttr.init_state(0)
    state, log = ttr.epoch_step(state, 0, data)
    params, stats = ttr.export(0)
    model = InferenceModel(params, stats, cfg, device="cpu")
    model32 = InferenceModel(params, stats, cfg.replace(activation_dtype="float32"),
                             device="cpu")
    for m in model.models.values():
        assert all(sub.act_dtype == torch.float32 for sub in m.modules())
    z, rec = model.encode(spec[32:]), model.reconstruct(spec[32:])
    assert z.dtype == rec.dtype == np.float32
    np.testing.assert_array_equal(z, model32.encode(spec[32:]))
    np.testing.assert_array_equal(rec, model32.reconstruct(spec[32:]))
    # the trainer's modules still compute in bfloat16
    assert all(sub.act_dtype == BF16 for m in ttr.models.values() for sub in m.modules())
    assert all(np.isfinite(v.numpy()).all() for k, v in log.items() if k != "epoch")
