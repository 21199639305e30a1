"""Several trials of one configuration trained at once (counterpart of
``rankaae_tpu/parallel/trials.py:41-288``).

The reference runs N hyperparameter-identical trials as N processes, one
device each (``sc/cmd/train_sc.py:25-45``).  The JAX package ``vmap``s one
compiled run over a trial axis.  Here the trials are stacked on a leading
trial axis inside every module (``RankAAETrainer(trials=T)``), so one
launch of each kernel — the Kendall pair K1, K2 among them — carries all T
trials, and training, which is bound by the host's launches, costs about
the same host time for T trials as for one.

Trial g of a run with base seed s draws from a generator seeded s + g, so it
is the 1-trial run with seed s + g, and waves change no trial.  When there
are more trials than ``max_resident``, they run in sequential waves
(``trials.py:195-221``); the forms not stacked yet (the conv forms, the CNN
discriminator) run one trial a wave.  One GPU: the ``trial_mesh`` and
``trial_dp_mesh`` layouts wait for several (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from rankaae_tpu_torch.models.registry import stacks_trials
from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrainState, TrialData, per_trial
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.device import resolve_device


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


@dataclasses.dataclass
class TrialResults:
    """Results with the trial axis leading (host numpy).  The weights are
    the JAX package's ``{role: ...}`` params and batch_stats trees (the
    layout a model bundle holds), leaves (T, ...)."""

    n_trials: int
    final_params: Dict[str, Any]        # leaves (T, ...)
    final_batch_stats: Dict[str, Any]
    best_params: Dict[str, Any]
    best_batch_stats: Dict[str, Any]
    best_epoch: np.ndarray              # (T,)
    best_combined: np.ndarray           # (T,)
    logs: Dict[str, np.ndarray]         # (T, E, ...)
    final_metrics: np.ndarray           # (T, 5) reference-format metric list
    # min-val-recon tracked model (the `use_best_checkpoint` target)
    best_recon_params: Dict[str, Any]
    best_recon_batch_stats: Dict[str, Any]
    best_recon_epoch: np.ndarray        # (T,)
    best_recon: np.ndarray              # (T,)

    def trial(self, i: int) -> Dict[str, Any]:
        """Per-trial view: the weights as one model's trees, which
        ``save_model_bundle`` takes as they are."""
        take = lambda tree: _tree_map(lambda x: x[i], tree)     # noqa: E731
        return {
            "final_params": take(self.final_params),
            "final_batch_stats": take(self.final_batch_stats),
            "best_params": take(self.best_params),
            "best_batch_stats": take(self.best_batch_stats),
            "best_epoch": int(self.best_epoch[i]),
            "best_combined": float(self.best_combined[i]),
            "best_recon_params": take(self.best_recon_params),
            "best_recon_batch_stats": take(self.best_recon_batch_stats),
            "best_recon_epoch": int(self.best_recon_epoch[i]),
            "best_recon": float(self.best_recon[i]),
            "logs": {k: v[i] for k, v in self.logs.items()},
            "final_metrics": self.final_metrics[i],
        }


def run_trials(
    cfg: TrainConfig,
    data: TrialData,
    n_trials: Optional[int] = None,
    seed: int = 0,
    max_resident: int = 64,
    lr_scales=None,
    sweep=None,
    device=None,
) -> TrialResults:
    """Train ``n_trials`` (default ``cfg.trials``) independent trials of
    ``cfg`` on ``device`` (default ``"cuda"``), at most ``max_resident``
    at once (1 for the forms not stacked yet).

    ``lr_scales`` ((n_trials,)) multiplies each trial's learning rates;
    ``sweep`` maps keys of ``SWEEPABLE_HPARAMS`` (spec_noise, alpha_limit,
    alpha_flat_step) to per-trial values ((n_trials,)).  Both are validated
    as the JAX runner validates them (``trials.py:122-191``)."""
    n_trials = cfg.trials if n_trials is None else n_trials
    # the whole run's shapes; each wave's init_state refuses a key that is
    # not sweepable and lr_scales with AdaBound
    if lr_scales is not None:
        lr_scales = per_trial("lr_scales", lr_scales, n_trials)
    if sweep is not None:
        sweep = {k: per_trial(f"sweep[{k!r}]", v, n_trials) for k, v in sweep.items()}

    dev = resolve_device(device)
    data = TrialData(*(x.to(dev) for x in dataclasses.astuple(data)))
    max_wave = max(1, int(max_resident)) if stacks_trials(cfg) else 1
    waves = []
    done = 0
    while done < n_trials:
        take = min(max_wave, n_trials - done)
        waves.append(_run_wave(
            cfg, data, take, seed + done, dev,
            None if lr_scales is None else lr_scales[done:done + take],
            None if sweep is None else {k: v[done:done + take] for k, v in sweep.items()}))
        done += take
    return waves[0] if len(waves) == 1 else _concat_results(waves)


def _concat_results(waves: List[TrialResults]) -> TrialResults:
    cat = lambda trees: _tree_map(lambda *xs: np.concatenate(xs, axis=0), *trees)  # noqa: E731
    fields = {f.name: cat([getattr(w, f.name) for w in waves])
              for f in dataclasses.fields(TrialResults) if f.name != "n_trials"}
    return TrialResults(n_trials=sum(w.n_trials for w in waves), **fields)


def _run_wave(cfg, data: TrialData, n_trials: int, seed: int, device,
              lr_scales, sweep) -> TrialResults:
    """One wave of ``n_trials`` resident trials, base seed ``seed``."""
    trainer = RankAAETrainer(cfg, n_train=data.train_spec.shape[0],
                             n_val=data.val_spec.shape[0], trials=n_trials, device=device)
    state = trainer.init_state(seed, lr_scales=lr_scales, hparams=sweep)
    logs = []
    for epoch in range(cfg.max_epoch):
        state, log = trainer.epoch_step(state, epoch, data)
        logs.append(log)
    return _collect_results(trainer, state, logs)


def _collect_results(trainer: RankAAETrainer, state: TrainState, logs: List[dict]
                     ) -> TrialResults:
    """The trainer's trials, their trackers and their per-epoch logs (one
    dict per epoch, as ``epoch_step`` returns them) as host results."""
    t = trainer.trials

    def weights(snapshot):
        snapshot = {k: m.state_dict() for k, m in trainer.models.items()} \
            if snapshot is None else snapshot
        host = {k: {n: v.detach().cpu() for n, v in sd.items()} for k, sd in snapshot.items()}
        per_trial = [trainer.export(i, host) for i in range(t)]
        return tuple(_tree_map(lambda *xs: np.stack(xs), *(p[j] for p in per_trial))
                     for j in (0, 1))

    final_params, final_stats = weights(None)
    best_params, best_stats = weights(state.best_state)
    recon_params, recon_stats = weights(state.best_recon_state)
    host = {k: np.broadcast_to(np.asarray([log[k] for log in logs], np.int32), (t, len(logs)))
            .copy() if k == "epoch"
            else torch.stack([log[k] for log in logs], dim=1).cpu().numpy()
            for k in logs[0]}
    return TrialResults(
        n_trials=t,
        final_params=final_params, final_batch_stats=final_stats,
        best_params=best_params, best_batch_stats=best_stats,
        best_epoch=state.best_epoch.cpu().numpy(),
        best_combined=state.best_combined.cpu().numpy(),
        logs=host,
        final_metrics=host["metrics"][:, -1, :],
        best_recon_params=recon_params, best_recon_batch_stats=recon_stats,
        best_recon_epoch=state.best_recon_epoch.cpu().numpy(),
        best_recon=state.best_recon.cpu().numpy(),
    )
