"""The training core (counterpart of ``rankaae_tpu/train/trainer.py``;
reference ``sc/clustering/trainer.py:65-315``).

The faithful per-batch protocol re-encodes from scratch before every loss
and steps a dedicated optimizer per loss, in the reference order: adversarial (GRL) ->
kendall -> reconstruction -> mutual-info -> smoothness
(``trainer.py:103-204``), with the parameter subsets of :data:`OPT_SPECS`.
The train-mode forwards that exist in the reference only as side effects
(the dead decode at ``trainer.py:114``, the unused re-encode at ``:176``)
run as stats-only forwards, so BatchNorm running statistics follow the
same trajectory as in the JAX package.

Where the JAX package scans, this package loops: an epoch is a Python loop
over the full batches of a per-epoch permutation, then the trailing partial
batch at its own size (``drop_last=False`` semantics); a run is a loop over
epochs (:meth:`RankAAETrainer.run_epochs`, :meth:`RankAAETrainer.run`).
Everything an epoch computes stays on the device — losses, the quality
metrics, the plateau schedulers, the best trackers — so the loop needs no
host sync.  The Kendall loss goes through the CUDA kernel pair on
the card (``ops/kendall_cuda.py``).

Where the JAX package ``vmap``s a trial axis, this trainer carries one:
T trials live stacked in every module (``models/registry.py``), every
tensor of a batch is (T, B, ...), every loss is (T,) and each optimizer
differentiates the sum over trials (trials share no parameter, so each gets
its own gradient), every learning rate, scheduler and tracker is per trial,
and each trial draws from its own stream (``utils/sampler.py``; on the
card every trial's slice of a draw in one launch): trial g of a T-trial
run with seed s is the 1-trial run with seed s + g.  One launch of each
kernel serves all T trials, for every form (K3, the conv decoders' fused
eval-mode block, is one launch per trial).

Every form (FC, ``normal``, ``compact``, ``qved``) trains, with both
discriminators, gradient reversal on or off (the non-GRL branch steps a D
and a G optimizer) and the four optimizers, under each of the JAX
package's options:

* ``protocol: fused`` (``trainer.py:518-752``): one shared forward graph a
  batch; each loss's gradient over its optimizer's subset from it, every
  update computed from the base parameters and applied once as their sum;
* ``protocol: joint`` (``trainer.py:758-854``): one weighted total loss,
  one backward, one optimizer over all parameters and one plateau
  scheduler (GRL only, as the config validates);
* ``flat_optim`` (``optim/optimizers.py::FlatParameters``): the
  parameters as views into one flat buffer, one slice an optimizer;
* ``activation_dtype: bfloat16``: the modules compute in bfloat16 as the
  registry sets them (``models/primitives.py``); parameters, moments,
  statistics, losses and the validation metrics stay float32.

Spans (``utils/tracing.py``) mark the work where it happens: ``epoch``,
each ``batch``, each loss's ``step.<optimizer>``, its ``backward`` (the one
``autograd.grad`` site) and its optimizer ``update``, and ``validate``; the
counter ``setup.trainer_s`` adds the seconds of ``__init__`` and
:meth:`RankAAETrainer.init_state`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from rankaae_tpu_torch.models.primitives import reset_parameters, set_matmul_precision
from rankaae_tpu_torch.models.registry import build_autoencoder, build_discriminator
from rankaae_tpu_torch.ops.kendall_cuda import kendall_constraint
from rankaae_tpu_torch.ops.losses import (
    alpha_schedule,
    bce_with_logits,
    mse,
    nll_loss,
    recon_loss,
    smoothness_loss,
)
from rankaae_tpu_torch.ops.stats import max_interstyle_spearman, min_style_shapiro
from rankaae_tpu_torch.optim.optimizers import (
    FlatParameters,
    MomentState,
    Optimizer,
    make_optimizer,
)
from rankaae_tpu_torch.optim.plateau import PlateauState, plateau_init, plateau_update
from rankaae_tpu_torch.utils import tracing
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.device import resolve_device
from rankaae_tpu_torch.utils.sampler import TrialSampler
from rankaae_tpu_torch.utils.weights import to_jax

# reference trainer.py:35-36
METRIC_WEIGHTS = (1.0, -1.0, -0.01, -1.0, -1.0)
GAU_KERNEL_SIZE = 17

# optimizer name -> (param subset keys, lr ratio attr, uses custom betas,
# explicit wd) (reference trainer.py:333-397).  The four optimizers the
# reference constructs WITHOUT weight_decay= inherit the torch class default
# — 0.01 for AdamW, 0 for Adam — so "no explicit wd" is NOT "no wd" under
# the shipped AdamW configs.
OPT_SPECS = {
    "reconstruction": (("enc", "dec"), "lr_ratio_Reconn", None, True),
    "mutual_info": (("enc", "dec"), "lr_ratio_Mutual", None, False),
    "smoothness": (("dec",), "lr_ratio_Smooth", None, True),
    "correlation": (("enc",), "lr_ratio_Corr", None, True),
    "discriminator": (("dis",), "lr_ratio_dis", "dis_beta", False),
    "generator": (("enc",), "lr_ratio_gen", "gen_beta", False),
    "adversarial": (("dis", "enc"), "lr_ratio_dis", "dis_beta", False),
}

#: the joint protocol's optimizer steps every module; this order makes each
#: optimizer's subset adjacent in the ``flat_optim`` buffer
JOINT_KEYS = ("dis", "enc", "dec")

# torch default weight_decay per optimizer class (applied when the reference
# omits the kwarg)
DEFAULT_WD = {"Adam": 0.0, "AdamW": 1e-2, "RAdam": 0.0, "AdaBound": 0.0}

#: config knobs that may differ between the trials of one run
#: (``rankaae_tpu/train/trainer.py:133``)
SWEEPABLE_HPARAMS = ("spec_noise", "alpha_limit", "alpha_flat_step")


def per_trial(name: str, values, trials: int) -> np.ndarray:
    """``values`` as host float32 of shape (trials,), or a ValueError that
    names them."""
    values = np.asarray(values, np.float32)
    if values.shape != (trials,):
        raise ValueError(f"{name} must have shape ({trials},), got {values.shape}")
    return values


@dataclasses.dataclass
class TrialData:
    """Device-resident dataset for one training run."""

    train_spec: torch.Tensor   # (N_train, dim_in)
    train_aux: torch.Tensor    # (N_train, n_aux)
    val_spec: torch.Tensor     # (N_val, dim_in)
    val_aux: torch.Tensor      # (N_val, n_aux)


@dataclasses.dataclass
class TrainState:
    """Everything a run carries besides the trainer's module weights (which
    live in ``RankAAETrainer.models``); every tensor has the trial axis
    leading."""

    opt: Dict[str, MomentState]          # one moment state per optimizer
    sched: Dict[str, PlateauState]       # one plateau state per optimizer, (T,) each
    sampler: TrialSampler                # the run's random draws, one stream a trial
    #: the SWEEPABLE_HPARAMS per trial, host float32 (T,)
    hparams: Dict[str, np.ndarray]
    spec_noise: torch.Tensor             # hparams["spec_noise"] on the device, (T, 1, 1)
    # true-best tracking (min combined metric)
    best_combined: torch.Tensor
    best_epoch: torch.Tensor
    best_state: Dict[str, Dict[str, torch.Tensor]]
    # faithful-quirk gate (reference trainer.py:76,297-301; never fires)
    faithful_best: torch.Tensor
    # best-reconstruction tracking (min val recon MSE)
    best_recon: torch.Tensor
    best_recon_epoch: torch.Tensor
    best_recon_state: Dict[str, Dict[str, torch.Tensor]]


#: the trackers' per-trial tensors of a TrainState
_TRACKERS = ("best_combined", "best_epoch", "faithful_best", "best_recon", "best_recon_epoch")


def _lead(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-trial (T,) tensor shaped to broadcast against ``like``, whose
    leading axis is the trial axis (or, at T = 1, any axis)."""
    if like.dim() == 0:
        return v.reshape(())
    return v.view((v.shape[0],) + (1,) * (like.dim() - 1))


class RankAAETrainer:
    """Trainer for one config and ``trials`` stacked trials, on ``device``
    (default ``"cuda"``; raises if no CUDA device is present)."""

    @tracing.timed("setup.trainer_s")
    def __init__(self, cfg: TrainConfig, n_train: int, n_val: int, trials: int = 1,
                 device=None):
        cfg.validate()
        if trials < 1:
            raise ValueError(f"trials must be >= 1, got {trials}")
        self.device = resolve_device(device)
        set_matmul_precision(cfg.matmul_precision)
        self.cfg = cfg
        self.n_train = n_train
        self.n_val = n_val
        self.n_batch = -(-n_train // cfg.batch_size)
        self.trials = trials
        encoder, decoder = build_autoencoder(cfg, trials)
        self.models: Dict[str, nn.Module] = {
            "enc": encoder.to(self.device),
            "dec": decoder.to(self.device),
            "dis": build_discriminator(cfg, trials).to(self.device),
        }
        self._single_models: Optional[Dict[str, nn.Module]] = None
        #: where an epoch's batches come from: None reads them from the
        #: dataset's train rows; the trial x dp layout sets a
        #: ``parallel.trials.RowShards`` that gathers them from its group
        self.rows = None
        self.opts: Dict[str, Optimizer] = {}
        for name, (_, ratio_attr, beta_attr, explicit_wd) in OPT_SPECS.items():
            betas = (0.9, 0.999)
            if beta_attr is not None:
                b = getattr(cfg, beta_attr)
                betas = (0.9 * b, 0.009 * b + 0.99)  # reference trainer.py:369,377,386
            wd = cfg.weight_decay if explicit_wd else DEFAULT_WD[cfg.optimizer_name]
            kw = {}
            if cfg.optimizer_name == "AdaBound":
                kw["base_lr"] = getattr(cfg, ratio_attr) * cfg.lr_base
            self.opts[name] = make_optimizer(cfg.optimizer_name, betas=betas,
                                             weight_decay=wd, **kw)
        if cfg.protocol == "joint":
            # one optimizer over every parameter, its lr the reconstruction
            # ratio's (trainer.py:173-183)
            kw = {}
            if cfg.optimizer_name == "AdaBound":
                kw["base_lr"] = cfg.lr_ratio_Reconn * cfg.lr_base
            self.opts["joint"] = make_optimizer(cfg.optimizer_name, betas=(0.9, 0.999),
                                                weight_decay=cfg.weight_decay, **kw)
        self.flat = FlatParameters({k: self.models[k] for k in JOINT_KEYS}, trials) \
            if cfg.flat_optim else None

    # ------------------------------------------------------------------ #
    # state
    # ------------------------------------------------------------------ #

    @staticmethod
    def _keys(name: str):
        """The modules optimizer ``name`` steps."""
        return JOINT_KEYS if name == "joint" else OPT_SPECS[name][0]

    def _leaves(self, keys, of=None) -> List[torch.Tensor]:
        return [p for key in keys
                for p in (self.models[key].parameters() if of is None else of[key])]

    def _params(self, name: str, of=None) -> List[torch.Tensor]:
        """Optimizer ``name``'s parameters: one tensor a parameter, or under
        ``flat_optim`` one slice of the flat buffer.  With ``of`` from
        :meth:`_zeros_like_params`, the same part of ``of`` (views)."""
        if self.flat is not None:
            return [self.flat.view(self._keys(name), of)]
        return self._leaves(self._keys(name), of)

    def _zeros_like_params(self):
        """Zeros laid out as the parameters, read through ``_params(name,
        of=...)``: a flat buffer's under ``flat_optim``, else a list of
        tensors per module."""
        if self.flat is not None:
            return torch.zeros_like(self.flat.buffer)
        return {key: [torch.zeros_like(p) for p in self.models[key].parameters()]
                for key in JOINT_KEYS}

    @tracing.spanned("backward")
    def _grads(self, name: str, loss: torch.Tensor, retain_graph: bool = False
               ) -> List[torch.Tensor]:
        """The gradient of the trials' summed ``loss`` (T,) over optimizer
        ``name``'s parameters, laid out as ``_params(name)``.  Trials share
        no parameter, so each gets exactly its own gradient."""
        leaves = self._leaves(self._keys(name))
        grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True,
                                    retain_graph=retain_graph)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return grads if self.flat is None else [self.flat.flatten(self._keys(name), grads)]

    def _lr(self, name: str, state: "TrainState") -> torch.Tensor:
        """Optimizer ``name``'s learning rate per trial (T,), or under
        ``flat_optim`` per element of its slice."""
        lr = state.sched[name].lr
        return lr if self.flat is None else self.flat.lr(lr, self._keys(name))

    def _snapshot(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {k: {n: t.detach().clone() for n, t in m.state_dict().items()}
                for k, m in self.models.items()}

    @tracing.timed("setup.trainer_s")
    def init_state(self, seed: int = 0, lr_scales=None, hparams=None) -> TrainState:
        """Fresh weights (torch-default init, trial t drawn from the run's
        generator t, seeded ``seed + t``) and fresh optimizer, scheduler and
        tracker state.

        ``lr_scales`` ((T,)) multiplies each trial's initial learning rates;
        ``hparams`` maps keys of :data:`SWEEPABLE_HPARAMS` to per-trial
        values ((T,)) that replace the config's
        (``rankaae_tpu/train/trainer.py:204-286``)."""
        cfg, t = self.cfg, self.trials
        if lr_scales is not None and cfg.optimizer_name == "AdaBound":
            # AdaBound's bound target uses the base_lr fixed when the
            # optimizer is made; scaling only the runtime lr would train no
            # real AdaBound configuration (trainer.py:214-228, trials.py:171-179)
            raise NotImplementedError(
                "lr_scales is not supported with AdaBound (its lr-bound schedule depends "
                "on a static base_lr); use Adam/AdamW/RAdam, or run separate AdaBound configs")
        scales = np.ones(t, np.float32) if lr_scales is None else \
            per_trial("lr_scales", lr_scales, t)
        hp = {k: np.full(t, getattr(cfg, k), np.float32) for k in SWEEPABLE_HPARAMS}
        for k, v in (hparams or {}).items():
            if k not in SWEEPABLE_HPARAMS:
                raise KeyError(f"{k!r} is not sweepable; choose from {SWEEPABLE_HPARAMS}")
            hp[k] = per_trial(f"hparams[{k!r}]", v, t)

        sampler = TrialSampler(seed, t, self.device)
        for i, gen in enumerate(sampler.generators):
            for key in ("enc", "dec", "dis"):
                reset_parameters(self.models[key], gen, trial=i)
        # joint: one optimizer and one scheduler, at the reconstruction
        # ratio's lr (trainer.py:245-252); else one a loss
        lr0 = {"joint": cfg.lr_ratio_Reconn * cfg.lr_base} if cfg.protocol == "joint" else \
            {name: getattr(cfg, ratio) * cfg.lr_base
             for name, (_, ratio, _, _) in OPT_SPECS.items()}
        opt = {name: self.opts[name].init(self._params(name)) for name in lr0}
        scales_t = torch.tensor(scales, device=self.device)
        sched = {name: plateau_init(torch.tensor(lr, dtype=torch.float32, device=self.device)
                                    * scales_t, self.device)
                 for name, lr in lr0.items()}

        def full(v, dtype=torch.float32):
            return torch.full((t,), v, dtype=dtype, device=self.device)

        return TrainState(
            opt=opt, sched=sched, sampler=sampler, hparams=hp,
            spec_noise=torch.tensor(hp["spec_noise"], device=self.device).view(t, 1, 1),
            best_combined=full(float("inf")),
            best_epoch=full(-1, torch.int32),
            best_state=self._snapshot(),
            faithful_best=full(10.0),
            best_recon=full(float("inf")),
            best_recon_epoch=full(-1, torch.int32),
            best_recon_state=self._snapshot(),
        )

    # ------------------------------------------------------------------ #
    # the whole run as a host tree (resume)
    # ------------------------------------------------------------------ #

    def state_tree(self, state: TrainState) -> Dict:
        """Everything a run carries, as nested dicts of host numpy arrays
        (what ``utils/checkpoint.py::save_train_state`` writes): every
        module's weights and running statistics, every optimizer's moments
        and step count, the plateau states, both trackers and their
        snapshots, the sweepable hyperparameters and every generator's
        state."""
        def np_(t):
            return t.detach().cpu().numpy().copy()

        def host(sd):
            return {k: np_(v) for k, v in sd.items()}

        return {
            "models": {k: host(m.state_dict()) for k, m in self.models.items()},
            "opt": {name: {"count": np.int64(o.count), "mu": [np_(t) for t in o.mu],
                           "nu": [np_(t) for t in o.nu]}
                    for name, o in state.opt.items()},
            "sched": {name: host(sch._asdict()) for name, sch in state.sched.items()},
            "hparams": {k: np.asarray(v, np.float32) for k, v in state.hparams.items()},
            "trackers": host({k: getattr(state, k) for k in _TRACKERS}),
            "best_state": {k: host(sd) for k, sd in state.best_state.items()},
            "best_recon_state": {k: host(sd) for k, sd in state.best_recon_state.items()},
            "sampler": state.sampler.get_state(),
        }

    def load_state_tree(self, state: TrainState, tree: Mapping) -> TrainState:
        """Restore :meth:`state_tree`'s ``tree`` into the modules and into
        ``state`` (a fresh :meth:`init_state` of the same config and trial
        count, which gives the layout); raises ``ValueError`` where a key or
        a shape differs."""
        def check(got, want, what):
            if sorted(got) != sorted(want):
                raise ValueError(f"train state {what}: keys {sorted(got)} != {sorted(want)} "
                                 "(another config?)")

        def put(dst: torch.Tensor, src, what):
            src = np.asarray(src)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"train state {what}: shape {src.shape} != {tuple(dst.shape)} "
                                 "(another config?)")
            with torch.no_grad():
                dst.copy_(torch.from_numpy(src.copy()))

        def put_dict(dst: Mapping[str, torch.Tensor], src: Mapping, what):
            check(src, dst, what)
            for k, t in dst.items():
                put(t, src[k], f"{what}.{k}")

        check(tree, ("models", "opt", "sched", "hparams", "trackers", "best_state",
                     "best_recon_state", "sampler"), "")
        for k, m in self.models.items():
            put_dict(m.state_dict(), tree["models"][k], f"models.{k}")
        check(tree["opt"], state.opt, "opt")
        for name, o in state.opt.items():
            saved = tree["opt"][name]
            o.count = int(saved["count"])
            for field in ("mu", "nu"):
                if len(saved[field]) != len(getattr(o, field)):
                    raise ValueError(f"train state opt.{name}.{field}: another config?")
                for i, t in enumerate(getattr(o, field)):
                    put(t, saved[field][i], f"opt.{name}.{field}[{i}]")
        check(tree["sched"], state.sched, "sched")
        state.sched = {name: PlateauState(**{
            f: torch.tensor(np.asarray(tree["sched"][name][f]), device=self.device)
            for f in PlateauState._fields}) for name in state.sched}
        check(tree["hparams"], state.hparams, "hparams")
        state.hparams = {k: np.asarray(v, np.float32) for k, v in tree["hparams"].items()}
        state.spec_noise = torch.tensor(state.hparams["spec_noise"],
                                        device=self.device).view(self.trials, 1, 1)
        trackers = tree["trackers"]
        check(trackers, _TRACKERS, "trackers")
        for k in _TRACKERS:
            put(getattr(state, k), trackers[k], k)
        for snap in ("best_state", "best_recon_state"):
            check(tree[snap], getattr(state, snap), snap)
            for k, sd in getattr(state, snap).items():
                put_dict(sd, tree[snap][k], f"{snap}.{k}")
        state.sampler.set_state(tree["sampler"])
        return state

    # ------------------------------------------------------------------ #
    # one trial's weights in the single-trial modules' layout
    # ------------------------------------------------------------------ #

    @property
    def single_models(self) -> Dict[str, nn.Module]:
        """Single-trial modules of the config (on the CPU), the layout that
        :func:`~rankaae_tpu_torch.utils.weights.to_jax`, the bundles and
        serving use."""
        if self._single_models is None:
            encoder, decoder = build_autoencoder(self.cfg)
            self._single_models = {"enc": encoder, "dec": decoder,
                                   "dis": build_discriminator(self.cfg)}
        return self._single_models

    def trial_state_dicts(self, i: int,
                          snapshot: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Trial ``i`` of the modules (or of a snapshot the trackers keep)
        as ``{role: single-trial state_dict}``."""
        return {k: m.trial_state_dict(i, None if snapshot is None else snapshot[k])
                for k, m in self.models.items()}

    def load_trial_state_dicts(self, i: int,
                               sds: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
        """Load ``{role: single-trial state_dict}`` into trial ``i``."""
        for k, m in self.models.items():
            m.load_trial_state_dict(i, sds[k])

    def export(self, i: int, snapshot=None):
        """Trial ``i`` as the JAX package's ``(params, batch_stats)`` trees
        (what a model bundle holds)."""
        return to_jax(self.single_models, self.trial_state_dicts(i, snapshot))

    def _opt_step(self, name: str, loss: torch.Tensor, state: TrainState) -> None:
        """Gradient of the trials' summed ``loss`` (T,) over the optimizer's
        parameter subset, then its update (in place)."""
        grads = self._grads(name, loss)
        with tracing.span("update"):
            self.opts[name].update(grads, state.opt[name], self._params(name),
                                   self._lr(name, state))

    def _label_loss(self, pred, label: int):
        """The discriminator's loss (T,) on ``pred`` against one label for
        every row: NLL on the CNN discriminator's 2-class log-probabilities,
        BCE on the FC one's logit.  The discriminator's loss labels real 1
        and fake 0; the generator's labels its fakes 1 (the documented
        deviation from the reference, which labels them 0; PARITY.md
        #4/#10)."""
        if self.cfg.use_cnn_discriminator:
            return nll_loss(pred, torch.full(pred.shape[:-1], label, device=pred.device))
        logit = pred.squeeze(-1)
        return bce_with_logits(logit, torch.full_like(logit, float(label)))

    def _beta(self, alpha) -> torch.Tensor:
        """The GRL strength per trial as (T, 1, 1) (``alpha`` a number or (T,))."""
        return torch.as_tensor(alpha, dtype=torch.float32, device=self.device).reshape(-1, 1, 1)

    def _alpha(self, state: TrainState, epoch: int) -> torch.Tensor:
        """The GRL ramp of each trial at ``epoch``, (T,) (0 without GRL)."""
        if not self.cfg.gradient_reversal:
            return torch.zeros(self.trials, device=self.device)
        hp = state.hparams
        return torch.tensor(
            [alpha_schedule(epoch / self.cfg.max_epoch, float(step), float(limit))
             for step, limit in zip(hp["alpha_flat_step"], hp["alpha_limit"])],
            dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ #
    # per-batch training protocol (reference trainer.py:103-204)
    # ------------------------------------------------------------------ #

    @tracing.spanned("batch")
    def _train_batch(self, state: TrainState, spec, aux, alpha, epoch: int,
                     sampler: Optional[TrialSampler] = None):
        """One batch of every trial: ``spec`` (T, B, dim_in), ``aux``
        (T, B, n_aux), ``alpha`` the GRL strength (T,) or a number.  Returns
        the state and the six losses, (T,) each."""
        cfg = self.cfg
        sampler = state.sampler if sampler is None else sampler
        for m in self.models.values():
            m.train()
        if cfg.protocol == "fused":
            return self._train_batch_fused(state, spec, aux, alpha, epoch, sampler)
        if cfg.protocol == "joint":
            return self._train_batch_joint(state, spec, aux, alpha, epoch, sampler)
        t, b = spec.shape[:2]

        # input noise (trainer.py:112)
        spec_in = spec + sampler.normal("spec_noise", spec.shape) * state.spec_noise

        z_real = sampler.normal("z_real", (t, cfg.batch_size, cfg.nstyle))
        if cfg.gradient_reversal:
            dis_loss = self._adversarial_step(state, spec_in, z_real, self._beta(alpha),
                                              sampler)
            gen_loss = torch.zeros(t, device=self.device)
        else:
            dis_loss, gen_loss = self._gan_steps(state, spec_in, z_real, sampler)

        aux_loss = self._correlation_step(state, spec_in, aux, sampler)
        rec_loss = self._reconstruction_step(state, spec_in, sampler)
        with torch.no_grad():
            # the dead re-encode at trainer.py:176: stats only
            self.models["enc"](spec_in, sampler=sampler)
        mi_loss = self._mutual_info_step(state, b, sampler)
        if epoch < cfg.epoch_stop_smooth:
            sm_loss = self._smoothness_step(state, spec_in, sampler)
        else:
            sm_loss = torch.zeros(t, device=self.device)

        return state, {
            "dis": dis_loss.detach(),
            "gen": gen_loss.detach(),
            "aux": aux_loss.detach(),
            "recon": rec_loss.detach(),
            "smooth": sm_loss.detach(),
            "mi": mi_loss.detach(),
        }

    @tracing.spanned("step.correlation")
    def _correlation_step(self, state: TrainState, spec_in, aux, sampler):
        """The Kendall step (trainer.py:152-161); returns its loss (T,)."""
        styles = self.models["enc"](spec_in, sampler=sampler)
        loss = kendall_constraint(aux, styles[..., : self.cfg.n_aux],
                                  activate=self.cfg.kendall_activation)
        self._opt_step("correlation", loss, state)
        return loss

    @tracing.spanned("step.reconstruction")
    def _reconstruction_step(self, state: TrainState, spec_in, sampler):
        """The reconstruction step (trainer.py:163-172); returns its loss."""
        enc, dec, cfg = self.models["enc"], self.models["dec"], self.cfg
        spec_out = dec(enc(spec_in, sampler=sampler), sampler=sampler)
        loss = recon_loss(spec_in, spec_out, scale=cfg.use_flex_spec_target,
                          scale_weight=cfg.flex_scale_weight)
        self._opt_step("reconstruction", loss, state)
        return loss

    @tracing.spanned("step.mutual_info")
    def _mutual_info_step(self, state: TrainState, b: int, sampler):
        """The mutual-info step (trainer.py:174-186) after the dead
        re-encode: decode and re-encode z ~ N(0, I) at the actual batch
        size ``b`` (functions.py:185); returns its loss."""
        enc, dec = self.models["enc"], self.models["dec"]
        z_sample = sampler.normal("z_sample", (self.trials, b, self.cfg.nstyle))
        loss = mse(enc(dec(z_sample, sampler=sampler), sampler=sampler), z_sample)
        self._opt_step("mutual_info", loss, state)
        return loss

    @tracing.spanned("step.smoothness")
    def _smoothness_step(self, state: TrainState, spec_in, sampler):
        """The smoothness step (trainer.py:188-200): the decoder alone, on
        styles of a stats-updating encode; returns its loss."""
        with torch.no_grad():
            styles = self.models["enc"](spec_in, sampler=sampler)
        loss = smoothness_loss(self.models["dec"](styles, sampler=sampler), GAU_KERNEL_SIZE)
        self._opt_step("smoothness", loss, state)
        return loss

    @tracing.spanned("step.adversarial")
    def _adversarial_step(self, state: TrainState, spec_in, z_real, beta, sampler):
        """The GRL step (``trainer.py:334-373`` in the JAX package): one
        backward trains the discriminator and, reversed, the encoder."""
        enc, dec = self.models["enc"], self.models["dec"]
        styles = enc(spec_in, sampler=sampler)
        with torch.no_grad():
            # the reference's dead decode (trainer.py:113-114): stats only
            dec(styles, sampler=sampler)
        dis_loss = self._adversarial_loss(styles, z_real, beta, sampler)
        self._opt_step("adversarial", dis_loss, state)
        return dis_loss

    def _adversarial_loss(self, styles, z_real, beta, sampler):
        """The GRL discriminator's loss (T,) on the prior's draws ``z_real``
        (real) and ``styles`` (fake)."""
        dis = self.models["dis"]
        if self.cfg.use_cnn_discriminator:
            # BatchNorms inside: two sequential forwards, so each batch is
            # normalised by its own statistics and the running statistics
            # take the real batch, then the fake one (one concatenated
            # forward would mix them)
            real_pred = dis(z_real, beta, sampler=sampler)
            fake_pred = dis(styles, beta, sampler=sampler)
        else:
            # the FC discriminator is BN-free: one (T, B_real + B, nstyle)
            # forward, the loss taken as two separately averaged halves (the
            # prior's draws in the styles' dtype, as trainer.py:360)
            n_real = z_real.shape[1]
            pred = dis(torch.cat([z_real.to(styles.dtype), styles], dim=1), beta,
                       sampler=sampler)
            real_pred, fake_pred = pred[:, :n_real], pred[:, n_real:]
        return self._label_loss(real_pred, 1) + self._label_loss(fake_pred, 0)

    def _gan_steps(self, state: TrainState, spec_in, z_real, sampler):
        """The non-GRL branch (``trainer.py:374-423`` in the JAX package):
        the side-effect encode and decode, a D step on the discriminator
        optimizer, then a G step on the generator optimizer."""
        enc, dec = self.models["enc"], self.models["dec"]
        with torch.no_grad():
            dec(enc(spec_in, sampler=sampler), sampler=sampler)   # trainer.py:113-114: stats only
        return (self._discriminator_step(state, spec_in, z_real, sampler),
                self._generator_step(state, spec_in, sampler))

    @tracing.spanned("step.discriminator")
    def _discriminator_step(self, state: TrainState, spec_in, z_real, sampler):
        """The D step: the prior's draws labelled real, the styles of a
        stats-updating encode (detached) fake; returns its loss (T,)."""
        enc, dis = self.models["enc"], self.models["dis"]
        with torch.no_grad():
            styles = enc(spec_in, sampler=sampler)
        real_pred = dis(z_real, None, sampler=sampler)
        fake_pred = dis(styles, None, sampler=sampler)
        dis_loss = self._label_loss(real_pred, 1) + self._label_loss(fake_pred, 0)
        self._opt_step("discriminator", dis_loss, state)
        return dis_loss

    @tracing.spanned("step.generator")
    def _generator_step(self, state: TrainState, spec_in, sampler):
        """The G step: the encoder's styles labelled real by the
        discriminator; returns its loss (T,)."""
        enc, dis = self.models["enc"], self.models["dis"]
        gen_loss = self._label_loss(dis(enc(spec_in, sampler=sampler), None, sampler=sampler), 1)
        self._opt_step("generator", gen_loss, state)
        return gen_loss

    # ------------------------------------------------------------------ #
    # the opt-in protocols (trainer.py:518-854 in the JAX package)
    # ------------------------------------------------------------------ #

    def _batch_draws(self, state: TrainState, spec, sampler):
        """The noisy input and the prior's draws of a fused or joint batch
        (keys 0-2 of ``trainer.py:552``): ``spec_in``, ``z_real`` at the
        configured batch size and ``z_sample`` at the batch's own."""
        t, b = spec.shape[:2]
        spec_in = spec + sampler.normal("spec_noise", spec.shape) * state.spec_noise
        z_real = sampler.normal("z_real", (t, self.cfg.batch_size, self.cfg.nstyle))
        z_sample = sampler.normal("z_sample", (t, b, self.cfg.nstyle))
        return spec_in, z_real, z_sample

    def _train_batch_fused(self, state: TrainState, spec, aux, alpha, epoch: int, sampler):
        """One batch of the fused protocol (``trainer.py:518-752``): one
        shared forward graph, each loss's gradient over its optimizer's
        subset from it, and every update computed from the base parameters
        (a Jacobi sweep, not the faithful protocol's sequential one), then
        applied once as the sum of the updates' deltas in plan order.

        The graph makes exactly the JAX chain's train-mode forwards, in its
        order for each module's running statistics (``:709-737``): the
        encoder on ``spec_in`` then on the decoded prior draws, the decoder
        on the styles then on ``z_sample``, the discriminator on
        ``z_real`` and the styles in one pass (GRL, FC discriminator), in
        two (GRL, CNN), or on ``z_real``, the detached styles and the styles
        (the D and G losses without GRL)."""
        cfg = self.cfg
        enc, dec, dis = self.models["enc"], self.models["dec"], self.models["dis"]
        t = spec.shape[0]
        spec_in, z_real, z_sample = self._batch_draws(state, spec, sampler)
        styles = enc(spec_in, sampler=sampler)
        spec_out = dec(styles, sampler=sampler)
        z_recon = enc(dec(z_sample, sampler=sampler), sampler=sampler)
        losses = {}
        if cfg.gradient_reversal:
            losses["adversarial"] = self._adversarial_loss(styles, z_real, self._beta(alpha),
                                                           sampler)
        else:
            real_pred = dis(z_real, None, sampler=sampler)
            fake_pred = dis(styles.detach(), None, sampler=sampler)
            losses["discriminator"] = self._label_loss(real_pred, 1) + \
                self._label_loss(fake_pred, 0)
            losses["generator"] = self._label_loss(dis(styles, None, sampler=sampler), 1)
        losses["correlation"] = kendall_constraint(aux, styles[..., : cfg.n_aux],
                                                   activate=cfg.kendall_activation)
        losses["reconstruction"] = recon_loss(spec_in, spec_out, scale=cfg.use_flex_spec_target,
                                              scale_weight=cfg.flex_scale_weight)
        losses["mutual_info"] = mse(z_recon, z_sample)
        if epoch < cfg.epoch_stop_smooth:
            # the decoder alone; after the cut its moments freeze (:693-707)
            losses["smoothness"] = smoothness_loss(spec_out, GAU_KERNEL_SIZE)

        names = list(losses)
        delta = self._zeros_like_params()
        for name in names:
            grads = self._grads(name, losses[name], retain_graph=name != names[-1])
            with torch.no_grad():
                base = self._params(name)
                new = [p.detach().clone() for p in base]
                with tracing.span("update"):
                    self.opts[name].update(grads, state.opt[name], new, self._lr(name, state))
                for d, n, p in zip(self._params(name, of=delta), new, base):
                    d.add_(n.sub_(p))           # delta += (new - base), :673-689
        with torch.no_grad():
            for p, d in zip(self._params("joint"), self._params("joint", of=delta)):
                p.add_(d)                       # :739

        zero = torch.zeros(t, device=self.device)
        return state, {
            "dis": losses.get("adversarial", losses.get("discriminator")).detach(),
            "gen": losses.get("generator", zero).detach(),
            "aux": losses["correlation"].detach(),
            "recon": losses["reconstruction"].detach(),
            "smooth": losses.get("smoothness", zero).detach(),
            "mi": losses["mutual_info"].detach(),
        }

    def _train_batch_joint(self, state: TrainState, spec, aux, alpha, epoch: int, sampler):
        """One batch of the joint protocol (``trainer.py:758-854``): the
        reference's learning-rate ratios over the reconstruction ratio as
        loss weights, one backward of the weighted total and one update of
        the one optimizer over every parameter.  GRL only (the config
        refuses joint without it).  The forwards are the fused protocol's
        chain with the discriminator's GRL pass."""
        cfg = self.cfg
        enc, dec = self.models["enc"], self.models["dec"]
        t = spec.shape[0]
        spec_in, z_real, z_sample = self._batch_draws(state, spec, sampler)
        r = cfg.lr_ratio_Reconn
        sm_on = float(epoch < cfg.epoch_stop_smooth)
        styles = enc(spec_in, sampler=sampler)
        spec_out = dec(styles, sampler=sampler)
        adv = self._adversarial_loss(styles, z_real, self._beta(alpha), sampler)
        corr = kendall_constraint(aux, styles[..., : cfg.n_aux], activate=cfg.kendall_activation)
        rec = recon_loss(spec_in, spec_out, scale=cfg.use_flex_spec_target,
                         scale_weight=cfg.flex_scale_weight)
        sm = smoothness_loss(spec_out, GAU_KERNEL_SIZE)
        mi = mse(enc(dec(z_sample, sampler=sampler), sampler=sampler), z_sample)
        total = (cfg.lr_ratio_dis / r * adv + cfg.lr_ratio_Corr / r * corr + rec
                 + cfg.lr_ratio_Mutual / r * mi + sm_on * (cfg.lr_ratio_Smooth / r) * sm)
        self._opt_step("joint", total, state)
        return state, {"dis": adv.detach(), "gen": torch.zeros(t, device=self.device),
                       "aux": corr.detach(), "recon": rec.detach(),
                       "smooth": (sm_on * sm).detach(), "mi": mi.detach()}

    # ------------------------------------------------------------------ #
    # validation (reference trainer.py:206-304)
    # ------------------------------------------------------------------ #

    @tracing.spanned("validate")
    @torch.no_grad()
    def _validate(self, state: TrainState, data: TrialData, alpha,
                  sampler: Optional[TrialSampler] = None):
        """Every trial on the validation split (shared by the trials);
        returns the latent (T, n_val, nstyle) and the losses, (T,) each."""
        cfg, t = self.cfg, self.trials
        sampler = state.sampler if sampler is None else sampler
        enc, dec, dis = self.models["enc"], self.models["dec"], self.models["dis"]
        for m in self.models.values():
            m.eval()
        val_spec = data.val_spec.expand(t, -1, -1)
        z = enc(val_spec)
        spec_out = dec(z)

        recon_v = mse(spec_out, val_spec)   # plain MSE (trainer.py:223)
        aux_v = kendall_constraint(data.val_aux.expand(t, -1, -1), z[..., : cfg.n_aux],
                                   activate=cfg.kendall_activation)
        smooth_v = smoothness_loss(spec_out, GAU_KERNEL_SIZE)

        # amplitude drift: median output/target amplitude ratio, and the
        # fraction outside the flex clamp window.  No epsilon in the
        # denominator, as in the JAX package (trainer.py:881-882).  The
        # median of an even count averages the two middle values, as
        # jnp.median does (torch.median would return the lower one).
        ratio = torch.abs(spec_out.float().mean(dim=-1)) / torch.abs(data.val_spec.mean(dim=-1))
        gain_v = torch.quantile(ratio, 0.5, dim=1)
        clamp_frac_v = ((ratio < 0.7) | (ratio > 1.3)).float().mean(dim=1)

        z_sample = sampler.normal("z_val", (t, self.n_val, cfg.nstyle))
        mi_v = mse(enc(dec(z_sample)), z_sample)

        # the prior draw: batch_size rows with GRL, n_val rows without
        # (trainer.py:900-913 in the JAX package)
        beta = self._beta(alpha) if cfg.gradient_reversal else None
        n_real = cfg.batch_size if cfg.gradient_reversal else self.n_val
        z_real = sampler.normal("z_real_val", (t, n_real, cfg.nstyle))
        fp = dis(z, beta)
        dis_v = self._label_loss(dis(z_real, beta), 1) + self._label_loss(fp, 0)
        gen_v = torch.zeros(t, device=self.device) if cfg.gradient_reversal \
            else self._label_loss(fp, 1)
        return z, {"recon": recon_v, "aux": aux_v, "smooth": smooth_v,
                   "mi": mi_v, "dis": dis_v, "gen": gen_v,
                   "gain": gain_v, "clamp_frac": clamp_frac_v}

    # ------------------------------------------------------------------ #
    # epochs
    # ------------------------------------------------------------------ #

    def _track(self, best: Dict[str, Dict[str, torch.Tensor]], take: torch.Tensor) -> None:
        """Copy the trials where ``take`` (T,) is true into the snapshot."""
        with torch.no_grad():
            for key, m in self.models.items():
                for name, x in m.state_dict().items():
                    best[key][name].copy_(torch.where(_lead(take, x), x, best[key][name]))

    @tracing.spanned("epoch")
    def epoch_step(self, state: TrainState, epoch: int, data: TrialData):
        """One epoch of every trial (``rankaae_tpu/train/trainer.py:936-1056``);
        the log's values have the trial axis leading."""
        cfg, t = self.cfg, self.trials
        alpha = self._alpha(state, epoch)

        # DataLoader shuffle + drop_last=False (dataloader.py:66-70): a
        # permutation per trial, sliced into full batches plus one smaller
        # trailing batch
        perm = state.sampler.permutation(self.n_train)
        mi_sum = torch.zeros(t, device=self.device)
        last = None
        for start in range(0, self.n_train, cfg.batch_size):
            idx = perm[:, start:start + cfg.batch_size]
            flat = idx.reshape(-1)
            b = idx.shape[1]
            if self.rows is None:
                spec, aux = (data.train_spec.index_select(0, flat),
                             data.train_aux.index_select(0, flat))
            else:
                spec, aux = self.rows.gather(flat)
            state, last = self._train_batch(state, spec.view(t, b, -1), aux.view(t, b, -1),
                                            alpha, epoch)
            mi_sum = mi_sum + last["mi"]
        avg_mi = mi_sum / self.n_batch

        z_val, val_losses = self._validate(state, data, alpha)

        # quality metrics (trainer.py:286-297), (T, 5)
        metrics = torch.stack([
            min_style_shapiro(z_val),
            val_losses["recon"],
            avg_mi,
            max_interstyle_spearman(z_val),
            val_losses["aux"],
        ], dim=1)
        weights = torch.tensor(METRIC_WEIGHTS, dtype=torch.float32, device=self.device)
        combined = -torch.sum(weights * metrics, dim=1)
        epoch_t = torch.tensor(epoch, dtype=torch.int32, device=self.device)

        # true-best tracking (min combined)
        is_best = combined < state.best_combined
        self._track(state.best_state, is_best)
        state.best_combined = torch.where(is_best, combined, state.best_combined)
        state.best_epoch = torch.where(is_best, epoch_t, state.best_epoch)
        # faithful (dead) gate: combined > faithful_best, init 10.0
        state.faithful_best = torch.where(combined > state.faithful_best, combined,
                                          state.faithful_best)
        # best-reconstruction tracking (min val recon MSE)
        is_best_recon = val_losses["recon"] < state.best_recon
        self._track(state.best_recon_state, is_best_recon)
        state.best_recon = torch.where(is_best_recon, val_losses["recon"], state.best_recon)
        state.best_recon_epoch = torch.where(is_best_recon, epoch_t, state.best_recon_epoch)

        # plateau schedulers step on the combined metric (trainer.py:303-304);
        # sch_recon_metric="val_recon" steps the reconstruction one (the
        # joint one under protocol joint) on val recon
        state.sched = {
            name: plateau_update(
                sched,
                val_losses["recon"] if (name in ("reconstruction", "joint")
                                        and cfg.sch_recon_metric == "val_recon")
                else combined,
                cfg.sch_factor, cfg.sch_patience)
            for name, sched in state.sched.items()
        }

        log = {
            "epoch": epoch,
            "train_dis": last["dis"], "train_gen": last["gen"],
            "train_aux": last["aux"], "train_recon": last["recon"],
            "train_smooth": last["smooth"], "train_mi": last["mi"],
            "val_dis": val_losses["dis"], "val_gen": val_losses["gen"],
            "val_aux": val_losses["aux"], "val_recon": val_losses["recon"],
            "val_smooth": val_losses["smooth"], "val_mi": val_losses["mi"],
            "val_gain": val_losses["gain"],
            "val_clamp_frac": val_losses["clamp_frac"],
            "metrics": metrics,
            "combined": combined,
            "lr_recon": state.sched.get("reconstruction", state.sched.get("joint")).lr,
        }
        return state, log

    def run_epochs(self, state: TrainState, data: TrialData, epochs):
        """Every trial over the epoch indices ``epochs``, in order
        (``rankaae_tpu/train/trainer.py:1058-1066``): the building block of
        a whole run, a resume and a run in segments.  Returns the state and
        the logs, each stacked epoch-first on the device: (E, T, ...), the
        epoch index (E, T) int32."""
        logs = []
        for epoch in epochs:
            state, log = self.epoch_step(state, int(epoch), data)
            logs.append(log)
        if not logs:
            raise ValueError("run_epochs needs at least one epoch")
        epoch = torch.tensor([log["epoch"] for log in logs], dtype=torch.int32,
                             device=self.device)[:, None].repeat(1, self.trials)
        return state, {k: epoch if k == "epoch" else torch.stack([log[k] for log in logs])
                       for k in logs[0]}

    def run(self, state: TrainState, data: TrialData, start_epoch: int = 0):
        """The whole run from ``start_epoch`` (``rankaae_tpu/train/
        trainer.py:1068-1079``): :meth:`run_epochs` over ``range(start_epoch,
        cfg.max_epoch)``.  A state checkpointed after epoch k
        (:meth:`state_tree`) and restored (:meth:`load_state_tree`) resumes
        with ``start_epoch=k`` exactly where the uncut run goes on."""
        return self.run_epochs(state, data, range(start_epoch, self.cfg.max_epoch))

    @staticmethod
    def final_metrics(logs):
        """metrics list of the last epoch (reference ``Trainer.train`` return)
        of logs stacked over epochs (E, ...), as :meth:`run` returns them."""
        return logs["metrics"][-1]
