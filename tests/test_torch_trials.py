"""Several trials at once: the port's trial-stacked modules, sampler,
trainer and runner (``rankaae_tpu_torch/parallel/trials.py``).

* Stacked primitives and FC modules at T = 3 against three single-trial
  modules loaded from ``trial_state_dict(i)``, train and eval mode, running
  statistics included; the per-trial losses and statistics against the
  same functions at T = 1.  atol 1e-6 and rtol 1e-5 (the same float32
  operations; a batched product may sum in another order than a single
  one), and atol 1e-5 on the parameters' gradients: a bias that feeds an
  affine-free BatchNorm has an exactly null gradient, and what is computed
  for it is rounding noise, ~2e-6 here.
* The JAX package against the port, per trial: one ``epoch_step`` of 3
  stacked trials with distinct ``lr_scale`` and ``spec_noise`` against
  ``jax.vmap`` of the JAX ``epoch_step`` over ``jax.vmap(init_state)``,
  weights carried across per trial and each trial's draws taken from its
  own JAX key (``tests/torch_parity.py``), atol 1e-4 as in
  ``tests/test_torch_epoch.py`` (the test prints the largest difference;
  it holds it under 1e-5).
* The port against itself: trial g of a T = 3 run equals the 1-trial run
  with seed s + g, and two waves (``max_resident=2``) equal one, over two
  epochs.  The initial weights and every draw are bit-identical; the
  trained values are not, since the batched products of T = 3 and T = 1 may
  sum in another order (the discriminator's 6-wide products do, by an ulp
  or so).  These epochs are well conditioned only from
  second moments of 1e-8 and at ``lr_base`` 1e-4 (from zero moments Adam's
  first step turns those 1e-8 differences into full-size steps on the
  null-gradient biases; ``tests/torch_parity.py``), so both runs start
  there, and they agree within atol 1e-4 (the tests print the largest
  differences).
* The guards of the JAX runner: AdaBound with ``lr_scales`` and a bad
  ``sweep`` key or shape raise.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.models.decoders import FCDecoder, TrialFCDecoder
from rankaae_tpu_torch.models.discriminators import DiscriminatorFC, TrialDiscriminatorFC
from rankaae_tpu_torch.models.encoders import FCEncoder, TrialFCEncoder
from rankaae_tpu_torch.models.primitives import (
    BatchNorm,
    Linear,
    PReLU,
    TrialBatchNorm,
    TrialLinear,
    TrialModule,
    TrialPReLU,
    reset_parameters,
)
from rankaae_tpu_torch.ops import losses as tl
from rankaae_tpu_torch.ops import stats as ts
from rankaae_tpu_torch.parallel import trials as port_trials
from rankaae_tpu_torch.parallel.trials import run_trials
from rankaae_tpu_torch.train.trainer import RankAAETrainer
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.sampler import Sampler, TrialSampler
from tests.test_torch_epoch import CFG as EPOCH_CFG
from tests.test_torch_epoch import N_TRAIN, N_VAL, data_pair
from tests.torch_parity import FixedDraws, NU0, compare_epoch, epoch_draws, start_from_jax

T = 3
ATOL, RTOL, GRAD_ATOL = 1e-6, 1e-5, 1e-5
SELF_ATOL = 1e-4
DIM, NSTYLE, B = 256, 6, 48


class _Stacked(TrialModule):
    """A stacked primitive as a TrialModule, for the per-trial export."""

    def __init__(self, inner):
        super().__init__(T)
        self.m = inner

    def forward(self, x):
        return self.m(x)


class _Single(torch.nn.Module):
    """A single-trial primitive under the same name."""

    def __init__(self, inner):
        super().__init__()
        self.m = inner

    def forward(self, x):
        return self.m(x)


PRIMITIVES = {
    "linear": (lambda: TrialLinear(T, 20, 7), lambda: Linear(20, 7), 20),
    "prelu": (lambda: TrialPReLU(T, 7), lambda: PReLU(7), 7),
    "batchnorm": (lambda: TrialBatchNorm(T, 7), lambda: BatchNorm(7), 7),
}
MODULES = {
    "encoder": (lambda t: TrialFCEncoder(t, nstyle=NSTYLE, dim_in=DIM, n_layers=4,
                                         dropout_rate=0.3),
                lambda: FCEncoder(nstyle=NSTYLE, dim_in=DIM, n_layers=4, dropout_rate=0.3),
                DIM),
    "decoder": (lambda t: TrialFCDecoder(t, nstyle=NSTYLE, dim_out=DIM, n_layers=4,
                                         dropout_rate=0.3, last_layer_activation="Softplus"),
                lambda: FCDecoder(nstyle=NSTYLE, dim_out=DIM, n_layers=4, dropout_rate=0.3,
                                  last_layer_activation="Softplus"),
                NSTYLE),
    "discriminator": (lambda t: TrialDiscriminatorFC(t, nstyle=NSTYLE, dropout_rate=0.3,
                                                     noise=0.5),
                      lambda: DiscriminatorFC(nstyle=NSTYLE, dropout_rate=0.3, noise=0.5),
                      NSTYLE),
}


def _perturb(module, seed):
    """Non-default weights and running statistics."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for key, v in module.state_dict().items():
            v.add_(0.1 * torch.randn(v.shape, generator=gen))
            if key.endswith("running_var"):
                v.abs_()


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(PRIMITIVES) + sorted(MODULES))
def test_stacked_module_matches_single_modules(name, train):
    if name in PRIMITIVES:
        make_stacked, make_primitive, width = PRIMITIVES[name]
        stacked = _Stacked(make_stacked())
        make_single = lambda: _Single(make_primitive())    # noqa: E731
    else:
        make_stacked, make_single, width = MODULES[name]
        stacked = make_stacked(T)
    for i in range(T):
        reset_parameters(stacked, torch.Generator().manual_seed(i), trial=i)
    _perturb(stacked, 9)
    singles = [make_single() for _ in range(T)]
    for i, m in enumerate(singles):
        m.load_state_dict(stacked.trial_state_dict(i))
    for m in (stacked, *singles):
        m.train(train)
    x = torch.randn(T, B, width, generator=torch.Generator().manual_seed(1), requires_grad=True)
    kw = {}
    if name == "discriminator":
        beta = torch.tensor([0.2, 0.5, 0.9]).view(T, 1, 1)
        kw = {"sampler": TrialSampler(4, T, "cpu")}
        y = stacked(x, beta, **kw)
    elif name in MODULES:
        y = stacked(x, sampler=TrialSampler(4, T, "cpu"))
    else:
        y = stacked(x)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    (y * g).sum().backward()
    for i, m in enumerate(singles):
        xi = x[i].detach().clone().requires_grad_(True)
        if name == "discriminator":
            yi = m(xi, beta[i].reshape(()), sampler=Sampler(4 + i, "cpu"))
        elif name in MODULES:
            yi = m(xi, sampler=Sampler(4 + i, "cpu"))
        else:
            yi = m(xi)
        (yi * g[i]).sum().backward()
        np.testing.assert_allclose(y[i].detach().numpy(), yi.detach().numpy(), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(x.grad[i].numpy(), xi.grad.numpy(), atol=ATOL, rtol=RTOL)
        got = stacked.trial_state_dict(i)
        for key, ref in m.state_dict().items():       # running statistics after the forward
            if ref.is_floating_point():               # not num_batches_tracked
                np.testing.assert_allclose(got[key].numpy(), ref.numpy(), atol=ATOL, rtol=RTOL,
                                           err_msg=key)
        for (pname, p), (_, q) in zip(stacked.named_parameters(), m.named_parameters()):
            np.testing.assert_allclose(p.grad[i].numpy(), q.grad.numpy(), atol=GRAD_ATOL,
                                       err_msg=pname)
    # and back: a single module's state dict loads into its trial
    stacked.load_trial_state_dict(1, singles[0].state_dict())
    for key, ref in singles[0].state_dict().items():
        assert not ref.is_floating_point() or torch.equal(stacked.trial_state_dict(1)[key],
                                                          ref), key


def test_trial_sampler_draws_as_single_samplers():
    sampler = TrialSampler(10, T, "cpu")
    z = sampler.normal("z", (T, 5, 2))
    mask = sampler.keep_mask((T, 4, 3), 0.7)
    perm = sampler.permutation(9)
    for i in range(T):
        single = Sampler(10 + i, "cpu")
        assert torch.equal(z[i], single.normal("z", (5, 2)))
        assert torch.equal(mask[i], single.keep_mask((4, 3), 0.7))
        assert torch.equal(perm[i], single.permutation(9))
    # trial(i) is a plain sampler over generator i: it continues that stream
    single = Sampler(12, "cpu")
    single.normal("z", (5, 2)), single.keep_mask((4, 3), 0.7), single.permutation(9)
    assert torch.equal(sampler.trial(2).normal("z", (3,)), single.normal("z", (3,)))


def test_losses_and_statistics_per_trial():
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.normal(1, 0.3, size=(T, 40, DIM)).astype(np.float32))
    b = torch.tensor(rng.normal(1, 0.3, size=(T, 40, DIM)).astype(np.float32))
    logits = torch.tensor(rng.normal(0, 3, size=(T, 40)).astype(np.float32))
    logp = torch.log_softmax(torch.tensor(rng.normal(size=(T, 40, 2)).astype(np.float32)), -1)
    z = torch.tensor(rng.normal(size=(T, 300, NSTYLE)).astype(np.float32))
    cases = {
        "mse": lambda s: tl.mse(a[s], b[s]),
        "bce": lambda s: tl.bce_with_logits(logits[s], torch.ones_like(logits[s])),
        "nll": lambda s: tl.nll_loss(logp[s], torch.ones(logp[s].shape[:-1], dtype=torch.long)),
        "recon": lambda s: tl.recon_loss(a[s], b[s], scale=True, scale_weight=0.3),
        "smooth": lambda s: tl.smoothness_loss(b[s], 17),
        "spearman": lambda s: ts.max_interstyle_spearman(z[s]),
        "shapiro": lambda s: ts.min_style_shapiro(z[s]),
    }
    for name, fn in cases.items():
        stacked = fn(slice(None))
        assert stacked.shape == (T,), name
        for i in range(T):
            np.testing.assert_allclose(stacked[i].item(), fn(slice(i, i + 1)).item(),
                                       atol=ATOL, err_msg=name)


def test_initial_weights_are_the_single_runs():
    cfg = TrainConfig(**EPOCH_CFG)
    stacked = RankAAETrainer(cfg, N_TRAIN, N_VAL, trials=T, device="cpu")
    stacked.init_state(5)
    for i in range(T):
        single = RankAAETrainer(cfg, N_TRAIN, N_VAL, device="cpu")
        single.init_state(5 + i)
        ref = single.trial_state_dicts(0)
        got = stacked.trial_state_dicts(i)
        for role in ref:
            for key in ref[role]:
                assert torch.equal(got[role][key], ref[role][key]), (i, role, key)
        # and the single-trial modules initialised from one generator of that
        # seed, in the order enc, dec, dis
        gen = torch.Generator().manual_seed(5 + i)
        for role, m in single.single_models.items():
            reset_parameters(m, gen)
            for key, v in m.state_dict().items():
                assert torch.equal(ref[role][key], v), (role, key)


def _stack_draws(per_trial):
    """Per-trial FixedDraws dicts (trial axis 1) -> one dict, trial axis T."""
    return {k: [np.concatenate([d[k][j] for d in per_trial]) for j in range(len(v))]
            for k, v in per_trial[0].items()}


def test_stacked_epoch_matches_jax_vmap():
    scales = np.asarray([1.0, 0.5, 2.0], np.float32)
    noise = np.asarray([0.0, 0.02, 0.05], np.float32)
    jtr = JaxTrainer(JaxTrainConfig(**EPOCH_CFG), n_train=N_TRAIN, n_val=N_VAL)
    keys = jax.random.split(jax.random.PRNGKey(0), T)
    jstates = jax.jit(jax.vmap(jtr.init_state))(keys, jnp.asarray(scales),
                                                {"spec_noise": jnp.asarray(noise)})
    ttr = RankAAETrainer(TrainConfig(**EPOCH_CFG), N_TRAIN, N_VAL, trials=T, device="cpu")
    tstate = ttr.init_state(0, lr_scales=scales, hparams={"spec_noise": noise})
    one = lambda tree, i: jax.tree_util.tree_map(lambda x: x[i], tree)    # noqa: E731
    per = [start_from_jax(jtr, one(jstates, i), ttr, tstate, trial=i) for i in range(T)]
    jstates = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per)
    jdata, tdata = data_pair()
    tstate.sampler = FixedDraws(_stack_draws([epoch_draws(jtr, jstates.rng[i], 0)
                                              for i in range(T)]), trials=T)
    jstates, jlogs = jax.jit(jax.vmap(jtr.epoch_step, in_axes=(0, None, None)))(
        jstates, jnp.int32(0), jdata)
    tstate, tlog = ttr.epoch_step(tstate, 0, tdata)
    assert not tstate.sampler.draws
    worst = max(compare_epoch(one(jlogs, i), one(jstates, i), ttr, tlog, tstate, trial=i)
                for i in range(T))
    # the trials differ: their learning rates and input noise do
    np.testing.assert_allclose(tstate.sched["reconstruction"].lr.numpy(),
                               EPOCH_CFG["lr_ratio_Reconn"] * EPOCH_CFG["lr_base"] * scales,
                               rtol=1e-6)
    assert len(set(tlog["train_recon"].tolist())) == T
    print(f"3 stacked trials vs jax.vmap: largest difference {worst:.3g}")
    assert worst < 1e-5, worst


def _run_from_nu0(monkeypatch):
    """Every init_state starts from second moments of NU0 (see the module
    docstring)."""
    init = RankAAETrainer.init_state

    def init_state(self, *args, **kw):
        state = init(self, *args, **kw)
        for o in state.opt.values():
            for v in o.nu:
                v.fill_(NU0)
        return state

    monkeypatch.setattr(RankAAETrainer, "init_state", init_state)


SELF_CFG = {**EPOCH_CFG, "lr_base": 1e-4, "max_epoch": 2}


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
               for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


def test_trials_equal_single_trial_runs(monkeypatch):
    _check_trials_equal_single_trial_runs(monkeypatch, TrainConfig(**SELF_CFG))


def test_trials_equal_single_trial_runs_with_draws(monkeypatch):
    """As above with dropout in every module and the discriminator's input
    noise (``example/fix_config.yaml``'s rates), so that each trial's
    keep-masks and noise come from its own generator.  At ``lr_base`` 1e-4
    these two epochs are chaotic: a 1e-7 relative perturbation of a 1-trial
    run's weights moves its logs by 2.2e-2, as far as T = 3 lies from the
    1-trial runs.  At 1e-5 that spread is 1.1e-6, and a trial that took
    another's keep-masks or noise would differ in its training losses at
    once, by far more than the atol."""
    _check_trials_equal_single_trial_runs(monkeypatch, TrainConfig(
        **{**SELF_CFG, "dropout_rate": 0.04, "dis_dropout_rate": 0.056, "dis_noise": 0.56,
           "lr_base": 1e-5}))


def _check_trials_equal_single_trial_runs(monkeypatch, cfg):
    _run_from_nu0(monkeypatch)
    data = data_pair()[1]
    stacked = run_trials(cfg, data, n_trials=T, seed=4, device="cpu")
    assert stacked.logs["val_recon"].shape == (T, 2) and stacked.final_metrics.shape == (T, 5)
    worst = {"logs": 0.0, "weights": 0.0}
    for i in range(T):
        single = run_trials(cfg, data, n_trials=1, seed=4 + i, device="cpu").trial(0)
        got = stacked.trial(i)
        worst["logs"] = max(worst["logs"], _max_diff(got["logs"], single["logs"]))
        for key in ("final_params", "final_batch_stats", "best_params", "best_recon_params"):
            worst["weights"] = max(worst["weights"], _max_diff(got[key], single[key]))
        assert got["best_epoch"] == single["best_epoch"]
    print(f"T = 3 vs three 1-trial runs: largest differences {worst}")
    assert max(worst.values()) <= SELF_ATOL, worst
    # the trials are different runs
    assert len({float(v) for v in stacked.logs["val_recon"][:, -1]}) == T


def test_waves_equal_one_wave(monkeypatch):
    _run_from_nu0(monkeypatch)
    cfg = TrainConfig(**SELF_CFG)
    data = data_pair()[1]
    waves = []
    real = port_trials._run_wave

    def run_wave(cfg, data, n_trials, *args, **kw):
        waves.append(n_trials)
        return real(cfg, data, n_trials, *args, **kw)

    monkeypatch.setattr(port_trials, "_run_wave", run_wave)
    one = run_trials(cfg, data, n_trials=T, seed=2, device="cpu")
    two = run_trials(cfg, data, n_trials=T, seed=2, device="cpu", max_resident=2)
    assert waves == [3, 2, 1]
    assert two.n_trials == T and two.best_epoch.shape == (T,)
    for i in range(T):
        a, b = one.trial(i), two.trial(i)
        assert _max_diff(a["logs"], b["logs"]) <= SELF_ATOL
        assert _max_diff(a["final_params"], b["final_params"]) <= SELF_ATOL


def test_runner_guards():
    data = data_pair()[1]
    cfg = TrainConfig(**SELF_CFG)
    with pytest.raises(NotImplementedError, match="AdaBound"):
        run_trials(cfg.replace(optimizer_name="AdaBound"), data, n_trials=2,
                   lr_scales=np.ones(2), device="cpu")
    with pytest.raises(NotImplementedError, match="AdaBound"):
        RankAAETrainer(cfg.replace(optimizer_name="AdaBound"), N_TRAIN, N_VAL, trials=2,
                       device="cpu").init_state(0, lr_scales=[1.0, 0.5])
    with pytest.raises(ValueError, match="lr_scales"):
        run_trials(cfg, data, n_trials=2, lr_scales=np.ones(3), device="cpu")
    with pytest.raises(KeyError, match="sweepable"):
        run_trials(cfg, data, n_trials=2, sweep={"lr_base": np.ones(2)}, device="cpu")
    with pytest.raises(ValueError, match="spec_noise"):
        run_trials(cfg, data, n_trials=2, sweep={"spec_noise": np.ones(3)}, device="cpu")
    with pytest.raises(KeyError, match="sweepable"):
        RankAAETrainer(cfg, N_TRAIN, N_VAL, trials=2, device="cpu").init_state(
            0, hparams={"dropout_rate": [0.1, 0.2]})
    # the forms not stacked yet train one trial at a time
    with pytest.raises(ValueError, match="not stacked"):
        RankAAETrainer(cfg.replace(ae_form="compact"), N_TRAIN, N_VAL, trials=2, device="cpu")
    with pytest.raises(ValueError, match="not stacked"):
        RankAAETrainer(cfg.replace(use_cnn_discriminator=True), N_TRAIN, N_VAL, trials=2,
                       device="cpu")
