"""Every form stacked on the trial axis: the port's stacked conv primitives,
blocks, conv and qved encoders and decoders and the CNN discriminator
against T single-trial modules, and a stacked conv run against 1-trial runs.

* Each stacked module at T = 3 against three single-trial modules loaded
  from ``trial_state_dict(i)``, train and eval mode: outputs, input
  gradients, running statistics after the forward and parameter gradients.
  In float64, at atol and rtol 1e-9: a grouped convolution sums in another
  order than a single one, and in float32 a train-mode BatchNorm of 32 rows
  turns that into relative differences of up to 1e-4 in the parameter
  gradients (the CNN discriminator's ``pre_lin``), so float32 would hide a
  wrong layout behind a loose tolerance where float64 isolates it.  The
  decoders' K3-shaped blocks take float32 and have no backward
  (``ops/fused_block_cuda.py``): their eval case is forward only, in
  float32, at the tolerances of ``tests/test_torch_trials.py`` (atol 1e-6,
  rtol 1e-5).
* ``reset_parameters(stacked, generator of seed i, trial=i)`` gives trial i
  the single module's initialisation from seed i, bit for bit.
* A T-trial validation of the normal form calls the fused block (one K3
  launch on the card) 8 T times: two eval-mode decodes, four K3-shaped
  blocks each, one call a trial.
* Three stacked trials of the compact form with the CNN discriminator
  against three 1-trial runs of seeds s + g, two epochs, at ``lr_base``
  1e-5 (the method and tolerance of
  ``tests/test_torch_trials.py::test_trials_equal_single_trial_runs_with_draws``:
  the config's dropout and discriminator noise, so every keep-mask and
  noise draw of trial g must come from generator g; atol 1e-4).
"""
import functools

import numpy as np
import pytest
import torch

from rankaae_tpu_torch.models import blocks, decoders, discriminators, encoders
from rankaae_tpu_torch.models import primitives as P
from rankaae_tpu_torch.ops import fused_block_cuda
from rankaae_tpu_torch.parallel.trials import run_trials
from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.sampler import Sampler, TrialSampler
from tests.test_torch_trials import (
    ATOL,
    ATOL64,
    RTOL,
    RTOL64,
    SELF_ATOL,
    SELF_CFG,
    _max_diff,
    _perturb,
    _run_from_nu0,
)
from tests.torch_parity import make_data

T, B, NSTYLE = 3, 32, 6


class _Stacked(P.TrialModule):
    """A stacked layer as a TrialModule, for the per-trial export."""

    def __init__(self, make):
        super().__init__(T)
        self.m = make(T)

    def forward(self, x, sampler=None):
        return self.m(x, sampler) if isinstance(self.m, P.Dropout) else self.m(x)


class _Single(torch.nn.Module):
    """A single-trial layer under the same name."""

    def __init__(self, make):
        super().__init__()
        self.m = make()

    def forward(self, x, sampler=None):
        return self.m(x, sampler) if isinstance(self.m, P.Dropout) else self.m(x)


def _layer(stacked, single, width, length):
    return (lambda t: _Stacked(stacked), lambda: _Single(single), (width, length))


def _module(stacked, single, shape):
    return (lambda t: stacked(t), single, shape)


_dec_kw = dict(nstyle=NSTYLE, dropout_rate=0.3, last_layer_activation="Softplus")
#: name -> (make stacked(T), make single(), input shape of one trial:
#: (C, L) for a layer over channels, (width,) for a module over (B, width))
MODULES = {
    "conv_replicate": _layer(lambda t: P.TrialConv1d(t, 2, 4, 5, stride=2, padding=2,
                                                     padding_mode="replicate"),
                             lambda: P.Conv1d(2, 4, 5, stride=2, padding=2,
                                              padding_mode="replicate"), 2, 32),
    "conv_grouped": _layer(lambda t: P.TrialConv1d(t, 4, 4, 4, stride=4, groups=4),
                           lambda: P.Conv1d(4, 4, 4, stride=4, groups=4), 4, 32),
    "conv_transpose": _layer(lambda t: P.TrialConvTranspose1d(t, 4, 2, 4, 4, groups=2),
                             lambda: P.ConvTranspose1d(4, 2, 4, 4, groups=2), 4, 16),
    "channel_prelu": _layer(lambda t: P.TrialChannelPReLU(t, 4), lambda: P.PReLU(4), 4, 16),
    "channel_batch_norm": _layer(lambda t: P.TrialChannelBatchNorm(t, 4),
                                 lambda: P.BatchNorm(4), 4, 16),
    "length_linear": _layer(lambda t: P.TrialLengthLinear(t, 16, 3),
                            lambda: P.Linear(16, 3), 4, 16),
    "channel_dropout": _layer(lambda t: P.TrialChannelDropout(t, 0.3),
                              lambda: P.Dropout(0.3), 4, 16),
    "encoding_block": _module(
        functools.partial(blocks.TrialEncodingBlock, in_channels=1, out_channels=4,
                          in_len=64, out_len=16, kernel_size=11, dropout_rate=0.3),
        functools.partial(blocks.EncodingBlock, in_channels=1, out_channels=4,
                          in_len=64, out_len=16, kernel_size=11, dropout_rate=0.3), (1, 64)),
    "encoding_block_k3": _module(
        functools.partial(blocks.TrialEncodingBlock, in_channels=2, out_channels=2,
                          in_len=256, out_len=256, kernel_size=11, stride=1, excitation=2),
        functools.partial(blocks.EncodingBlock, in_channels=2, out_channels=2,
                          in_len=256, out_len=256, kernel_size=11, stride=1, excitation=2),
        (2, 256)),
    "decoding_block": _module(
        functools.partial(blocks.TrialDecodingBlock, in_channels=8, out_channels=4,
                          in_len=16, excitation=2, dropout_rate=0.3),
        functools.partial(blocks.DecodingBlock, in_channels=8, out_channels=4,
                          in_len=16, excitation=2, dropout_rate=0.3), (8, 16)),
    "encoder": _module(functools.partial(encoders.TrialEncoder, nstyle=NSTYLE, dropout_rate=0.3),
                       functools.partial(encoders.Encoder, nstyle=NSTYLE, dropout_rate=0.3),
                       (256,)),
    "compact_encoder": _module(
        functools.partial(encoders.TrialCompactEncoder, nstyle=NSTYLE, dropout_rate=0.3),
        functools.partial(encoders.CompactEncoder, nstyle=NSTYLE, dropout_rate=0.3), (256,)),
    "decoder": _module(functools.partial(decoders.TrialDecoder, **_dec_kw),
                       functools.partial(decoders.Decoder, **_dec_kw), (NSTYLE,)),
    "compact_decoder": _module(functools.partial(decoders.TrialCompactDecoder, **_dec_kw),
                               functools.partial(decoders.CompactDecoder, **_dec_kw),
                               (NSTYLE,)),
    "qved_encoder": _module(
        functools.partial(encoders.TrialQvecEncoder, nstyle=NSTYLE, dropout_rate=0.3),
        functools.partial(encoders.QvecEncoder, nstyle=NSTYLE, dropout_rate=0.3), (12,)),
    "qved_decoder": _module(functools.partial(decoders.TrialQvecDecoder, **_dec_kw),
                            functools.partial(decoders.QvecDecoder, **_dec_kw), (NSTYLE,)),
    "cnn_discriminator": _module(
        functools.partial(discriminators.TrialDiscriminatorCNN, nstyle=NSTYLE,
                          dropout_rate=0.3, noise=0.5),
        functools.partial(discriminators.DiscriminatorCNN, nstyle=NSTYLE, dropout_rate=0.3,
                          noise=0.5), (NSTYLE,)),
}
#: the modules with a K3-shaped block: no backward in eval mode
FUSED = ("encoding_block_k3", "decoder", "compact_decoder")


def _stacked_input(shape, gen):
    """The stacked module's input and each trial's single-trial input."""
    x = torch.randn(T, B, *shape, generator=gen)
    if len(shape) == 2:          # over channels: (B, T*C, L)
        return x.transpose(0, 1).reshape(B, T * shape[0], shape[1]), list(x)
    return x, list(x)


def _trial(y, i, shape):
    """Trial i of a stacked output or input gradient."""
    return y.view(B, T, -1, y.shape[-1])[:, i] if len(shape) == 2 else y[i]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_stacked_module_matches_single_modules(name, train):
    make_stacked, make_single, shape = MODULES[name]
    stacked = make_stacked(T)
    for i in range(T):
        P.reset_parameters(stacked, torch.Generator().manual_seed(i), trial=i)
    _perturb(stacked, 9)
    singles = [make_single() for _ in range(T)]
    for i, m in enumerate(singles):
        m.load_state_dict(stacked.trial_state_dict(i))
    for m in (stacked, *singles):
        m.train(train)
    backward = train or name not in FUSED
    dtype, atol, rtol = (torch.float64, ATOL64, RTOL64) if backward else \
        (torch.float32, ATOL, RTOL)
    for m in (stacked, *singles):
        m.to(dtype)
    x, xs = _stacked_input(shape, torch.Generator().manual_seed(1))
    x = x.to(dtype).requires_grad_(backward)
    with torch.set_grad_enabled(backward):
        if name == "cnn_discriminator":
            beta = torch.tensor([0.2, 0.5, 0.9], dtype=dtype).view(T, 1, 1)
            y = stacked(x, beta, sampler=TrialSampler(4, T, "cpu"))
        else:
            y = stacked(x, sampler=TrialSampler(4, T, "cpu"))
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(2)).to(dtype)
        if backward:
            (y * g).sum().backward()
        for i, m in enumerate(singles):
            xi = xs[i].to(dtype).requires_grad_(backward)
            if name == "cnn_discriminator":
                yi = m(xi, beta[i].reshape(()), sampler=Sampler(4 + i, "cpu"))
            else:
                yi = m(xi, sampler=Sampler(4 + i, "cpu"))
            np.testing.assert_allclose(_trial(y, i, shape).detach().numpy(),
                                       yi.detach().numpy(), atol=atol, rtol=rtol)
            if backward:
                (yi * _trial(g, i, shape)).sum().backward()
                np.testing.assert_allclose(_trial(x.grad, i, shape).numpy(),
                                           xi.grad.numpy(), atol=atol, rtol=rtol)
            got = stacked.trial_state_dict(i)
            for key, ref in m.state_dict().items():      # running statistics after the forward
                if ref.is_floating_point():
                    np.testing.assert_allclose(got[key].numpy(), ref.numpy(), atol=atol,
                                               rtol=rtol, err_msg=key)
            if backward:
                for (pname, p), (_, q) in zip(stacked.named_parameters(), m.named_parameters()):
                    np.testing.assert_allclose(p.grad[i].numpy(), q.grad.numpy(), atol=atol,
                                               rtol=rtol, err_msg=pname)
    stacked.load_trial_state_dict(1, singles[0].state_dict())
    for key, ref in singles[0].state_dict().items():
        assert not ref.is_floating_point() or torch.equal(stacked.trial_state_dict(1)[key],
                                                          ref), key


@pytest.mark.parametrize("name", sorted(MODULES))
def test_reset_parameters_per_trial_is_the_single_init(name):
    make_stacked, make_single, _ = MODULES[name]
    stacked = make_stacked(T)
    for i in (2, 0, 1):          # the order of the trials does not matter
        P.reset_parameters(stacked, torch.Generator().manual_seed(10 + i), trial=i)
    for i in range(T):
        single = make_single()
        P.reset_parameters(single, torch.Generator().manual_seed(10 + i))
        got = stacked.trial_state_dict(i)
        assert sorted(got) == sorted(single.state_dict())
        for key, ref in single.state_dict().items():
            assert torch.equal(got[key], ref), (name, i, key)


def test_stacked_validation_calls_k3_once_per_trial_and_block(monkeypatch):
    calls = []
    real = fused_block_cuda.fused_block

    def fused_block(x, *params):
        calls.append(tuple(x.shape))
        return real(x, *params)

    monkeypatch.setattr(fused_block_cuda, "fused_block", fused_block)
    cfg = TrainConfig(**{**SELF_CFG, "ae_form": "normal", "use_cnn_discriminator": True})
    spec, aux = make_data(3, 24)
    data = TrialData(*(torch.tensor(a) for a in (spec, aux, spec, aux)))
    trainer = RankAAETrainer(cfg, n_train=24, n_val=24, trials=T, device="cpu")
    state = trainer.init_state(0)
    trainer._validate(state, data, trainer._alpha(state, 0))
    # two eval-mode decodes (the validation split and the N(0, I) draws),
    # the decoder's four 4->4 and 2->2 blocks each, one call a trial
    assert len(calls) == 2 * 4 * T
    assert sorted(set(calls)) == [(24, 2, 256), (24, 4, 256)]


def test_conv_trials_equal_single_trial_runs(monkeypatch):
    """Compact form, CNN discriminator, the config's dropout and noise:
    trial g of T = 3 against the 1-trial run of seed 4 + g."""
    _run_from_nu0(monkeypatch)
    cfg = TrainConfig(**{**SELF_CFG, "ae_form": "compact", "use_cnn_discriminator": True,
                         "dropout_rate": 0.04, "dis_dropout_rate": 0.056, "dis_noise": 0.56,
                         "lr_base": 1e-5, "batch_size": 32})
    spec, aux = make_data(21, 80)
    data = TrialData(*(torch.tensor(a) for a in (spec[:56], aux[:56], spec[56:], aux[56:])))
    stacked = run_trials(cfg, data, n_trials=T, seed=4, device="cpu")
    worst = {"logs": 0.0, "weights": 0.0}
    for i in range(T):
        single = run_trials(cfg, data, n_trials=1, seed=4 + i, device="cpu").trial(0)
        got = stacked.trial(i)
        worst["logs"] = max(worst["logs"], _max_diff(got["logs"], single["logs"]))
        for key in ("final_params", "final_batch_stats", "best_params", "best_recon_params"):
            worst["weights"] = max(worst["weights"], _max_diff(got[key], single[key]))
        assert got["best_epoch"] == single["best_epoch"]
    print(f"compact + CNN, T = 3 vs three 1-trial runs: largest differences {worst}")
    assert max(worst.values()) <= SELF_ATOL, worst
    assert len({float(v) for v in stacked.logs["val_recon"][:, -1]}) == T
