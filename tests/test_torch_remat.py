"""``remat`` in the port (``torch.utils.checkpoint`` over the conv blocks,
``rankaae_tpu_torch/models/blocks.py::run_block``) against the same runs
without it, and against the JAX package's ``remat=True``.

* The conv encoder and decoder of the normal and the compact form, single
  and stacked (T 3), float32 and bfloat16, with dropout 0.3: one train
  forward and three backwards through the same graph (as the fused
  protocol takes them), with and without ``remat``.  The outputs, every
  gradient of every backward, every running statistic afterwards and every
  generator's state (read by a draw after the run) are bit-identical.  A
  recompute that updated the running statistics a second time, or drew its
  dropout masks again, fails this test (it changes the statistics, the
  gradients and the generators' next draws).
* One batch of the faithful, the fused and the joint protocol (normal form,
  T 2, the config's dropout and discriminator noise) with ``remat`` is bit
  for bit the batch without it: the losses, every parameter and running
  statistic, every optimizer moment and every generator's state.
* One faithful batch of the compact form with the CNN discriminator and
  ``remat: true`` against the JAX package's ``remat=True`` batch, as
  ``tests/test_torch_conv_train.py`` holds it without (``compare_batch_by_
  steps``: atol 1e-4, or twice the batch's 1e-7 perturbation spread).  The
  normal form's is ``tests/test_torch_remat_normal.py``.
* FC ignores the knob, as in the JAX package.
"""
import numpy as np
import pytest
import torch

from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.models.decoders import (
    CompactDecoder,
    Decoder,
    TrialCompactDecoder,
    TrialDecoder,
)
from rankaae_tpu_torch.models.encoders import (
    CompactEncoder,
    Encoder,
    TrialCompactEncoder,
    TrialEncoder,
)
from rankaae_tpu_torch.models.primitives import reset_parameters, set_activation_dtype
from rankaae_tpu_torch.models.registry import build_autoencoder
from rankaae_tpu_torch.train.trainer import RankAAETrainer
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.sampler import Sampler, TrialSampler
from tests.test_torch_trainer import CFG as FC_CFG
from tests.torch_parity import compare_batch_by_steps, jax_init, make_data

FORMS = {"normal": ((Encoder, TrialEncoder), (Decoder, TrialDecoder)),
         "compact": ((CompactEncoder, TrialCompactEncoder),
                     (CompactDecoder, TrialCompactDecoder))}
BACKWARDS = 3


def _run_blocks(form, trials, dtype, remat):
    """The form's encoder and decoder in train mode: outputs, the gradients
    of ``BACKWARDS`` backwards, the running statistics and a draw after."""
    (enc_cls, trial_enc), (dec_cls, trial_dec) = FORMS[form]
    kw = {"nstyle": 6, "dropout_rate": 0.3, "remat": remat}
    if trials is None:
        enc, dec = enc_cls(**kw), dec_cls(**kw)
        sampler = Sampler(5, "cpu")
        shape = (16, 256)
    else:
        enc, dec = trial_enc(trials, **kw), trial_dec(trials, **kw)
        sampler = TrialSampler(5, trials, "cpu")
        shape = (trials, 16, 256)
    gen = torch.Generator().manual_seed(0)
    for t in range(trials or 1):
        for m in (enc, dec):
            reset_parameters(m, gen, trial=t)
            set_activation_dtype(m, dtype)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    z = enc(x, sampler)
    y = dec(z, sampler)
    loss = (y.float() ** 2).mean() + (z.float() ** 2).mean()
    params = list(enc.parameters()) + list(dec.parameters())
    grads = [torch.autograd.grad(loss, params, retain_graph=i < BACKWARDS - 1)
             for i in range(BACKWARDS)]
    stats = [b.clone() for b in list(enc.buffers()) + list(dec.buffers())]
    after = sampler.normal("after", shape[:-1] + (4,))
    return [z.detach(), y.detach(), *(g for gs in grads for g in gs), *stats, after]


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("trials,dtype", [(None, "float32"), (3, "float32"), (3, "bfloat16")])
def test_remat_blocks_are_bit_identical(form, trials, dtype):
    plain = _run_blocks(form, trials, dtype, remat=False)
    remat = _run_blocks(form, trials, dtype, remat=True)
    assert len(plain) == len(remat)
    for i, (a, b) in enumerate(zip(plain, remat)):
        assert torch.equal(a, b), (form, trials, dtype, i)


B, N_VAL, T = 32, 40, 2
PROTOCOL_CFG = {**FC_CFG, "ae_form": "normal", "batch_size": B, "dropout_rate": 0.2,
                "dis_dropout_rate": 0.2, "dis_noise": 0.3}


def _protocol_batch(protocol, remat):
    cfg = TrainConfig(**{**PROTOCOL_CFG, "protocol": protocol, "remat": remat})
    tr = RankAAETrainer(cfg, n_train=B, n_val=N_VAL, trials=T, device="cpu")
    state = tr.init_state(3)
    spec, aux = make_data(6, T * B)
    state, losses = tr._train_batch(state, torch.from_numpy(spec).view(T, B, -1),
                                    torch.from_numpy(aux).view(T, B, -1), 0.3, 0)
    weights = [v for m in tr.models.values() for v in m.state_dict().values()]
    moments = [v for o in state.opt.values() for v in (*o.mu, *o.nu)]
    return ([losses[k] for k in sorted(losses)], weights, moments,
            [torch.from_numpy(s) for s in state.sampler.get_state()])


@pytest.mark.parametrize("protocol", ["faithful", "fused", "joint"])
def test_remat_protocol_batch_is_bit_identical(protocol):
    plain = _protocol_batch(protocol, remat=False)
    remat = _protocol_batch(protocol, remat=True)
    for what, a, b in zip(("losses", "weights", "moments", "generators"), plain, remat):
        assert len(a) == len(b) > 0, what
        for i, (x, y) in enumerate(zip(a, b)):
            assert torch.equal(x, y), (protocol, what, i)


def test_compact_cnn_remat_batch_matches_jax():
    cfg = {**FC_CFG, "ae_form": "compact", "use_cnn_discriminator": True, "batch_size": 64,
           "remat": True}
    jtr = JaxTrainer(JaxTrainConfig(**cfg), n_train=64, n_val=N_VAL)
    ttr = RankAAETrainer(TrainConfig(**cfg), n_train=64, n_val=N_VAL, device="cpu")
    assert ttr.models["enc"].remat and ttr.models["dec"].remat
    spec, aux = make_data(3, 64)
    moved, tlosses, n_checked = compare_batch_by_steps(jtr, jax_init(jtr), ttr,
                                                       ttr.init_state(0), spec, aux)
    assert n_checked > 100
    assert np.median(moved) > 1e-3


def test_fc_form_ignores_remat():
    enc, dec = build_autoencoder(TrainConfig(**{**FC_CFG, "remat": True}), trials=2)
    assert not hasattr(enc, "remat") and not hasattr(dec, "remat")
