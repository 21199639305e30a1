"""The training core, faithful protocol (counterpart of
``rankaae_tpu/train/trainer.py``; reference ``sc/clustering/trainer.py:65-315``).

The per-batch protocol re-encodes from scratch before every loss and steps a
dedicated optimizer per loss, in the reference order: adversarial (GRL) ->
kendall -> reconstruction -> mutual-info -> smoothness
(``trainer.py:103-204``), with the parameter subsets of :data:`OPT_SPECS`.
The train-mode forwards that exist in the reference only as side effects
(the dead decode at ``trainer.py:114``, the unused re-encode at ``:176``)
run as stats-only forwards, so BatchNorm running statistics follow the
same trajectory as in the JAX package.

Where the JAX package scans, this package loops: an epoch is a Python loop
over the full batches of a per-epoch permutation, then the trailing partial
batch at its own size (``drop_last=False`` semantics); a run is a loop over
epochs.  Everything an epoch computes stays on the device — losses, the
quality metrics, the plateau schedulers, the best trackers — so the loop
needs no host sync.  The Kendall loss goes through the CUDA kernel pair on
the card (``ops/kendall_cuda.py``).

Only the faithful protocol with gradient reversal and the FC discriminator
is ported; the ``fused``/``joint`` protocols and the non-GRL GAN branch
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from rankaae_tpu_torch.models.primitives import reset_parameters, set_matmul_precision
from rankaae_tpu_torch.models.registry import build_autoencoder, build_discriminator
from rankaae_tpu_torch.ops.kendall_cuda import kendall_constraint
from rankaae_tpu_torch.ops.losses import (
    alpha_schedule,
    bce_with_logits,
    mse,
    recon_loss,
    smoothness_loss,
)
from rankaae_tpu_torch.ops.stats import max_interstyle_spearman, min_style_shapiro
from rankaae_tpu_torch.optim.optimizers import MomentState, Optimizer, make_optimizer
from rankaae_tpu_torch.optim.plateau import PlateauState, plateau_init, plateau_update
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.device import resolve_device
from rankaae_tpu_torch.utils.sampler import Sampler

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

# torch default weight_decay per optimizer class (applied when the reference
# omits the kwarg)
DEFAULT_WD = {"Adam": 0.0, "AdamW": 1e-2, "RAdam": 0.0, "AdaBound": 0.0}


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
    live in ``RankAAETrainer.models``)."""

    opt: Dict[str, MomentState]          # one moment state per optimizer
    sched: Dict[str, PlateauState]       # one plateau state per optimizer
    sampler: Sampler                     # the run's random draws
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


class RankAAETrainer:
    """Trainer for one config and one trial, on ``device`` (default
    ``"cuda"``; raises if no CUDA device is present)."""

    def __init__(self, cfg: TrainConfig, n_train: int, n_val: int, device=None):
        cfg.validate()
        if cfg.protocol != "faithful":
            raise NotImplementedError(
                f"protocol {cfg.protocol!r} is not ported yet (ROADMAP queue 1, item 13)")
        if not cfg.gradient_reversal:
            raise NotImplementedError(
                "the non-GRL GAN branch is not ported yet (ROADMAP queue 1, item 14)")
        if cfg.activation_dtype != "float32":
            raise NotImplementedError("activation_dtype bfloat16 is not ported yet")
        if cfg.flat_optim:
            raise NotImplementedError(
                "flat_optim is not ported yet (ROADMAP queue 1, item 13)")
        self.device = resolve_device(device)
        set_matmul_precision(cfg.matmul_precision)
        self.cfg = cfg
        self.n_train = n_train
        self.n_val = n_val
        self.n_batch = -(-n_train // cfg.batch_size)
        encoder, decoder = build_autoencoder(cfg)
        self.models: Dict[str, nn.Module] = {
            "enc": encoder.to(self.device),
            "dec": decoder.to(self.device),
            "dis": build_discriminator(cfg).to(self.device),
        }
        self.opts: Dict[str, Optimizer] = {}
        for name, (_, _, beta_attr, explicit_wd) in OPT_SPECS.items():
            betas = (0.9, 0.999)
            if beta_attr is not None:
                b = getattr(cfg, beta_attr)
                betas = (0.9 * b, 0.009 * b + 0.99)  # reference trainer.py:369,377,386
            wd = cfg.weight_decay if explicit_wd else DEFAULT_WD[cfg.optimizer_name]
            self.opts[name] = make_optimizer(cfg.optimizer_name, betas=betas, weight_decay=wd)

    # ------------------------------------------------------------------ #
    # state
    # ------------------------------------------------------------------ #

    def _params(self, name: str) -> List[torch.Tensor]:
        return [p for key in OPT_SPECS[name][0] for p in self.models[key].parameters()]

    def _snapshot(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {k: {n: t.detach().clone() for n, t in m.state_dict().items()}
                for k, m in self.models.items()}

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh weights (torch-default init drawn from the run's generator)
        and fresh optimizer, scheduler and tracker state."""
        cfg = self.cfg
        sampler = Sampler(seed, self.device)
        for key in ("enc", "dec", "dis"):
            reset_parameters(self.models[key], sampler.generator)
        opt = {name: self.opts[name].init(self._params(name)) for name in OPT_SPECS}
        sched = {name: plateau_init(getattr(cfg, ratio) * cfg.lr_base, self.device)
                 for name, (_, ratio, _, _) in OPT_SPECS.items()}

        def scalar(v, dtype=torch.float32):
            return torch.tensor(v, dtype=dtype, device=self.device)

        return TrainState(
            opt=opt, sched=sched, sampler=sampler,
            best_combined=scalar(float("inf")),
            best_epoch=scalar(-1, torch.int32),
            best_state=self._snapshot(),
            faithful_best=scalar(10.0),
            best_recon=scalar(float("inf")),
            best_recon_epoch=scalar(-1, torch.int32),
            best_recon_state=self._snapshot(),
        )

    def _opt_step(self, name: str, loss: torch.Tensor, state: TrainState) -> None:
        """Gradient of ``loss`` over the optimizer's parameter subset, then
        its update (in place)."""
        params = self._params(name)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        self.opts[name].update(grads, state.opt[name], params, state.sched[name].lr)

    # ------------------------------------------------------------------ #
    # per-batch training protocol (reference trainer.py:103-204)
    # ------------------------------------------------------------------ #

    def _train_batch(self, state: TrainState, spec, aux, alpha, epoch: int,
                     sampler: Optional[Sampler] = None):
        cfg = self.cfg
        sampler = state.sampler if sampler is None else sampler
        enc, dec, dis = self.models["enc"], self.models["dec"], self.models["dis"]
        for m in self.models.values():
            m.train()

        # input noise (trainer.py:112)
        spec_in = spec + sampler.normal("spec_noise", spec.shape) * cfg.spec_noise

        # ---- adversarial step (GRL) ------------------------------------ #
        z_real = sampler.normal("z_real", (cfg.batch_size, cfg.nstyle))
        styles = enc(spec_in, sampler)
        with torch.no_grad():
            # the reference's dead decode (trainer.py:113-114): stats only
            dec(styles, sampler)
        # FC discriminator is BN-free: one (B_real + B, nstyle) forward,
        # the loss taken as two separately averaged halves
        pred = dis(torch.cat([z_real, styles], dim=0), alpha, sampler)
        real_p = pred[: cfg.batch_size].squeeze(-1)
        fake_p = pred[cfg.batch_size:].squeeze(-1)
        dis_loss = bce_with_logits(real_p, torch.ones_like(real_p)) + \
            bce_with_logits(fake_p, torch.zeros_like(fake_p))
        self._opt_step("adversarial", dis_loss, state)

        # ---- kendall / correlation step (trainer.py:152-161) ----------- #
        styles = enc(spec_in, sampler)
        aux_loss = kendall_constraint(aux, styles[:, : cfg.n_aux],
                                      activate=cfg.kendall_activation)
        self._opt_step("correlation", aux_loss, state)

        # ---- reconstruction step (trainer.py:163-172) ------------------ #
        spec_out = dec(enc(spec_in, sampler), sampler)
        rec_loss = recon_loss(spec_in, spec_out, scale=cfg.use_flex_spec_target,
                              scale_weight=cfg.flex_scale_weight)
        self._opt_step("reconstruction", rec_loss, state)

        # ---- mutual-info step (trainer.py:174-186) --------------------- #
        with torch.no_grad():
            enc(spec_in, sampler)      # dead re-encode at trainer.py:176: stats only
        # z ~ N(0,I) at the ACTUAL batch size (functions.py:185)
        z_sample = sampler.normal("z_sample", (spec.shape[0], cfg.nstyle))
        z_recon = enc(dec(z_sample, sampler), sampler)
        mi_loss = mse(z_recon, z_sample)
        self._opt_step("mutual_info", mi_loss, state)

        # ---- smoothness step, until epoch_stop_smooth (trainer.py:188-200) #
        if epoch < cfg.epoch_stop_smooth:
            with torch.no_grad():
                styles = enc(spec_in, sampler)
            sm_loss = smoothness_loss(dec(styles, sampler), GAU_KERNEL_SIZE)
            self._opt_step("smoothness", sm_loss, state)
        else:
            sm_loss = torch.zeros((), device=self.device)

        return state, {
            "dis": dis_loss.detach(),
            "gen": torch.zeros((), device=self.device),
            "aux": aux_loss.detach(),
            "recon": rec_loss.detach(),
            "smooth": sm_loss.detach(),
            "mi": mi_loss.detach(),
        }

    # ------------------------------------------------------------------ #
    # validation (reference trainer.py:206-304)
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _validate(self, state: TrainState, data: TrialData, alpha,
                  sampler: Optional[Sampler] = None):
        cfg = self.cfg
        sampler = state.sampler if sampler is None else sampler
        enc, dec, dis = self.models["enc"], self.models["dec"], self.models["dis"]
        for m in self.models.values():
            m.eval()
        z = enc(data.val_spec)
        spec_out = dec(z)

        recon_v = mse(spec_out, data.val_spec)   # plain MSE (trainer.py:223)
        aux_v = kendall_constraint(data.val_aux, z[:, : cfg.n_aux],
                                   activate=cfg.kendall_activation)
        smooth_v = smoothness_loss(spec_out, GAU_KERNEL_SIZE)

        # amplitude drift: median output/target amplitude ratio, and the
        # fraction outside the flex clamp window.  No epsilon in the
        # denominator, as in the JAX package (trainer.py:881-882).  The
        # median of an even count averages the two middle values, as
        # jnp.median does (torch.median would return the lower one).
        ratio = torch.abs(spec_out.float().mean(dim=1)) / torch.abs(data.val_spec.mean(dim=1))
        gain_v = torch.quantile(ratio, 0.5)
        clamp_frac_v = ((ratio < 0.7) | (ratio > 1.3)).float().mean()

        z_sample = sampler.normal("z_val", (self.n_val, cfg.nstyle))
        mi_v = mse(enc(dec(z_sample)), z_sample)

        z_real = sampler.normal("z_real_val", (cfg.batch_size, cfg.nstyle))
        rp = dis(z_real, alpha).squeeze(-1)
        fp = dis(z, alpha).squeeze(-1)
        dis_v = bce_with_logits(rp, torch.ones_like(rp)) + \
            bce_with_logits(fp, torch.zeros_like(fp))
        return z, {"recon": recon_v, "aux": aux_v, "smooth": smooth_v,
                   "mi": mi_v, "dis": dis_v, "gen": torch.zeros((), device=self.device),
                   "gain": gain_v, "clamp_frac": clamp_frac_v}

    # ------------------------------------------------------------------ #
    # epochs
    # ------------------------------------------------------------------ #

    def _track(self, best: Dict[str, Dict[str, torch.Tensor]], take: torch.Tensor) -> None:
        with torch.no_grad():
            for key, m in self.models.items():
                for name, t in m.state_dict().items():
                    best[key][name].copy_(torch.where(take, t, best[key][name]))

    def epoch_step(self, state: TrainState, epoch: int, data: TrialData):
        cfg = self.cfg
        alpha = alpha_schedule(epoch / cfg.max_epoch, cfg.alpha_flat_step, cfg.alpha_limit)

        # DataLoader shuffle + drop_last=False (dataloader.py:66-70): a
        # permutation sliced into full batches plus one smaller trailing batch
        perm = state.sampler.permutation(self.n_train)
        starts = range(0, self.n_train, cfg.batch_size)
        mi_sum = torch.zeros((), device=self.device)
        last = None
        for start in starts:
            idx = perm[start:start + cfg.batch_size]
            state, last = self._train_batch(
                state, data.train_spec.index_select(0, idx),
                data.train_aux.index_select(0, idx), alpha, epoch)
            mi_sum = mi_sum + last["mi"]
        avg_mi = mi_sum / self.n_batch

        z_val, val_losses = self._validate(state, data, alpha)

        # quality metrics (trainer.py:286-297)
        metrics = torch.stack([
            min_style_shapiro(z_val),
            val_losses["recon"],
            avg_mi,
            max_interstyle_spearman(z_val),
            val_losses["aux"],
        ])
        weights = torch.tensor(METRIC_WEIGHTS, dtype=torch.float32, device=self.device)
        combined = -torch.sum(weights * metrics)
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
        # sch_recon_metric="val_recon" steps the reconstruction one on val recon
        state.sched = {
            name: plateau_update(
                sched,
                val_losses["recon"] if (name == "reconstruction"
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
            "lr_recon": state.sched["reconstruction"].lr,
        }
        return state, log

    @staticmethod
    def final_metrics(logs):
        """metrics list of the last epoch (reference ``Trainer.train`` return)."""
        return logs["metrics"][-1]
