"""``flat_optim``: the parameters as views into one flat buffer, one slice
an optimizer (``rankaae_tpu_torch/optim/optimizers.py::FlatParameters``;
``rankaae_tpu/optim/optimizers.py:162-190`` in the JAX package).

* Bit-identical to the per-leaf form: two epochs of 3 stacked trials (8
  optimizer steps, so RAdam's rectified branch runs) with the knob and
  without, from the same seed, for Adam, AdamW, RAdam and AdaBound, the FC
  and the normal form, under the faithful, fused and joint protocols:
  every log value, every parameter, running statistic and moment (the
  per-leaf moments concatenated in the flat layout) equal bit for bit.
  Every step is elementwise, so each element sees the same operations.
  The normal form runs with the CNN discriminator (its BatchNorms and
  convolutions) and dropout and discriminator noise on, so each trial's
  draws take the same order under both layouts.
* The parameters stay views of the buffer after ``load_state_tree``,
  ``load_trial_state_dicts`` and ``reset_parameters(trial=i)``: writes into
  the buffer show in the modules and the other way round.
* A port flat batch against the JAX package's ``flat_optim`` batch (FC,
  each protocol): the whole batch within the larger of 1e-4 and twice its
  1e-7 perturbation spread (``tests/torch_parity.py::compare_batch``).
* A train state written without the knob is refused by a trainer with it,
  and the other way round (another moment layout).
"""
import itertools

import numpy as np
import pytest
import torch

from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.models.primitives import reset_parameters
from rankaae_tpu_torch.train.trainer import JOINT_KEYS, RankAAETrainer, TrialData
from rankaae_tpu_torch.utils.config import TrainConfig
from tests.test_torch_trainer import CFG as FC_CFG
from tests.torch_parity import compare_batch, jax_init, make_data

T, B, N_TRAIN, N_VAL = 3, 16, 64, 16
OPTIMIZERS = ("Adam", "AdamW", "RAdam", "AdaBound")
FORMS = {"FC": {},
         "normal": {"ae_form": "normal", "use_cnn_discriminator": True}}
PROTOCOLS = ("faithful", "fused", "joint")
DRAWS = {"dropout_rate": 0.1, "dis_dropout_rate": 0.1, "dis_noise": 0.1}


def _data(seed=5):
    spec, aux = make_data(seed, N_TRAIN + N_VAL)
    return TrialData(*(torch.tensor(a) for a in (spec[:N_TRAIN], aux[:N_TRAIN],
                                                  spec[N_TRAIN:], aux[N_TRAIN:])))


def _cfg(flat, **kw):
    return TrainConfig(**{**FC_CFG, "batch_size": B, "epoch_stop_smooth": 1, **DRAWS,
                          "flat_optim": flat, **kw})


def _train(cfg, data, epochs=2):
    tr = RankAAETrainer(cfg, n_train=N_TRAIN, n_val=N_VAL, trials=T, device="cpu")
    state = tr.init_state(7)
    logs = [tr.epoch_step(state, e, data)[1] for e in range(epochs)]
    return tr, state, logs


def _flat_moments(flat_tr, name, o):
    """Per-leaf moments ``o`` of optimizer ``name`` laid out as the flat
    trainer's (its flatten of the gradients), zeros in the gaps."""
    keys = flat_tr._keys(name)
    return [flat_tr.flat.flatten(keys, ms) for ms in (o.mu, o.nu)]


@pytest.mark.parametrize("optimizer,form,protocol",
                         list(itertools.product(OPTIMIZERS, FORMS, PROTOCOLS)))
def test_flat_is_bit_identical_to_per_leaf(optimizer, form, protocol):
    data = _data()
    runs = [_train(_cfg(flat, optimizer_name=optimizer, protocol=protocol, **FORMS[form]), data)
            for flat in (False, True)]
    (leaf_tr, leaf_state, leaf_logs), (flat_tr, flat_state, flat_logs) = runs
    assert flat_tr.flat is not None and leaf_tr.flat is None
    for a, b in zip(leaf_logs, flat_logs):
        for k in a:
            if k != "epoch":
                assert torch.equal(a[k], b[k]), k
    for key in leaf_tr.models:
        sa, sb = leaf_tr.models[key].state_dict(), flat_tr.models[key].state_dict()
        for name in sa:
            assert torch.equal(sa[name], sb[name]), (key, name)
    assert sorted(leaf_state.opt) == sorted(flat_state.opt)
    for name, o in leaf_state.opt.items():
        f = flat_state.opt[name]
        assert o.count == f.count and len(f.mu) == len(f.nu) == 1
        for a, b in zip(_flat_moments(flat_tr, name, o), (f.mu[0], f.nu[0])):
            assert torch.equal(a, b), name
    _views(flat_tr)


def _views(tr):
    """Every parameter's storage is the flat buffer's, each parameter a
    contiguous block at an aligned offset after the last, the gaps zero."""
    buf = tr.flat.buffer
    covered = torch.zeros(buf.numel(), dtype=torch.bool)
    off = 0
    for p in tr._leaves(JOINT_KEYS):
        assert p.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
        assert p.is_contiguous() and p.storage_offset() % tr.flat.ALIGN == 0
        assert p.storage_offset() >= off
        off = p.storage_offset() + p.numel()
        covered[p.storage_offset():off] = True
    assert off <= buf.numel() and not buf[~covered].any()


@pytest.mark.parametrize("form", sorted(FORMS))
def test_parameters_stay_views(form):
    data = _data()
    tr, state, _ = _train(_cfg(True, **FORMS[form]), data, epochs=1)
    _views(tr)
    other, other_state, _ = _train(_cfg(True, **FORMS[form]), _data(6), epochs=1)
    tr.load_state_tree(state, other.state_tree(other_state))
    _views(tr)
    assert torch.equal(tr.flat.buffer, other.flat.buffer)
    tr.load_trial_state_dicts(1, other.trial_state_dicts(2))
    _views(tr)
    for gen_seed in (3, 4):
        reset_parameters(tr.models["enc"], torch.Generator().manual_seed(gen_seed), trial=0)
    _views(tr)
    # a write through the buffer shows in the modules, and one through a
    # module shows in the buffer
    enc = next(tr.models["enc"].parameters())
    enc_before = enc.detach().clone()
    with torch.no_grad():
        tr.flat.buffer.add_(1.0)
    assert torch.equal(enc.detach(), enc_before + 1.0)
    with torch.no_grad():
        p = next(tr.models["dec"].parameters())
        before = tr.flat.buffer.clone()
        p.mul_(2.0)
    start = p.storage_offset()
    assert start == tr.flat.spans["dec"][0]
    assert torch.equal(tr.flat.buffer[start:start + p.numel()], p.detach().reshape(-1))
    assert torch.equal(tr.flat.buffer[:start], before[:start])


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_flat_batch_matches_jax_flat_optim(protocol):
    cfg = {**FC_CFG, "batch_size": 64, "flat_optim": True, "protocol": protocol}
    jtr = JaxTrainer(JaxTrainConfig(**cfg), n_train=64, n_val=N_VAL)
    ttr = RankAAETrainer(TrainConfig(**cfg), n_train=64, n_val=N_VAL, device="cpu")
    tstate = ttr.init_state(0)
    jstate = jax_init(jtr)
    assert all(np.ndim(o.mu) == 1 for o in jstate.opt.values())     # the JAX flat layout
    spec, aux = make_data(8, 64)
    compare_batch(jtr, jstate, ttr, tstate, spec, aux)
    assert all(len(o.mu) == 1 for o in tstate.opt.values())


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_resume_across_the_knob_raises(protocol):
    trainers = {flat: RankAAETrainer(_cfg(flat, protocol=protocol), n_train=N_TRAIN,
                                     n_val=N_VAL, trials=T, device="cpu")
                for flat in (False, True)}
    states = {flat: tr.init_state(0) for flat, tr in trainers.items()}
    for flat in (False, True):
        tree = trainers[flat].state_tree(states[flat])
        with pytest.raises(ValueError, match="another config"):
            trainers[not flat].load_state_tree(states[not flat], tree)
        trainers[flat].load_state_tree(states[flat], tree)       # its own layout loads
