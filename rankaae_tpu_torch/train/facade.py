"""Reference-compatible ``Trainer`` facade (counterpart of
``rankaae_tpu/train/facade.py:50-118``).

The reference's public training API is
``Trainer.from_data(csv_fn, ..., config_parameters).train(callback)``
(``sc/clustering/trainer.py:65,411-474``).  ``from_data`` loads the splits
onto the device and builds the trainer; ``train`` runs every epoch, writes
``losses.csv`` and three model bundles into ``work_dir`` — ``final.mpk``
(the last epoch's weights), ``best_tracked.mpk`` (min combined metric,
extras ``best_epoch``/``best_combined``) and ``best_recon.mpk`` (min val
recon MSE, extras ``best_recon_epoch``/``best_recon_mse``), each with its
``.json`` manifest, in the JAX package's format — and returns the final
metrics list ``[min shapiro-W, val recon MSE, avg train MI, max inter-style
|rho|, val kendall]`` (``trainer.py:294-295``).

``get_style_distribution_plot`` draws a latent batch's per-style
histograms (``facade.py:120-139``).  ``device`` defaults to
``cuda:<igpu>``; with no CUDA device present,
``from_data`` raises unless the caller passes ``device="cpu"``.  The facade
trains one trial (the trainer at T = 1); ``train_sc``
(``cli/train_sc.py``) trains the config's ``trials``.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from rankaae_tpu_torch.data.dataset import load_split_arrays
from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrainState, TrialData
from rankaae_tpu_torch.utils.checkpoint import save_model_bundle
from rankaae_tpu_torch.utils.config import Parameters, TrainConfig
from rankaae_tpu_torch.utils.device import resolve_device
from rankaae_tpu_torch.utils.logging import write_losses_csv


class Trainer:
    """Single-trial facade with the reference's construction/run interface."""

    def __init__(self, core: RankAAETrainer, data: TrialData, work_dir: str = ".",
                 seed: int = 0, verbose: bool = True,
                 logger: Optional[logging.Logger] = None):
        self.core = core
        self.data = data
        self.work_dir = work_dir
        self.seed = seed
        self.verbose = verbose
        self.logger = logger or logging.getLogger("training")
        self.state: Optional[TrainState] = None
        self.logs = None
        #: wall seconds of each epoch, each ending in a device sync
        self.epoch_seconds: List[float] = []

    @classmethod
    def from_data(
        cls,
        csv_fn: str,
        igpu: int = 0,
        verbose: bool = True,
        work_dir: str = ".",
        train_ratio: float = 0.7,
        validation_ratio: float = 0.15,
        test_ratio: float = 0.15,
        config_parameters: Parameters = None,
        logger: Optional[logging.Logger] = None,
        loss_logger=None,                   # losses.csv is written by train()
        seed: int = 0,
        device=None,
    ) -> "Trainer":
        dev = resolve_device(f"cuda:{igpu}" if device is None else device)
        cfg = TrainConfig.from_parameters(config_parameters).replace(
            train_ratio=train_ratio,
            validation_ratio=validation_ratio,
            test_ratio=test_ratio,
        )
        splits = load_split_arrays(
            csv_fn, (train_ratio, validation_ratio, test_ratio), cfg.n_aux
        )
        data = TrialData(*(torch.from_numpy(a).to(dev) for a in (
            splits["train"].spec, splits["train"].aux,
            splits["val"].spec, splits["val"].aux)))
        core = RankAAETrainer(cfg, n_train=len(splits["train"]),
                              n_val=len(splits["val"]), device=dev)
        return cls(core, data, work_dir=work_dir, seed=seed, verbose=verbose,
                   logger=logger)

    def train(self, callback: Optional[Callable] = None) -> List[float]:
        core = self.core
        state = core.init_state(self.seed)
        logs = []
        self.epoch_seconds = []
        for epoch in range(core.cfg.max_epoch):
            t0 = time.perf_counter()
            state, log = core.epoch_step(state, epoch, self.data)
            if core.device.type == "cuda":
                torch.cuda.synchronize(core.device)
            self.epoch_seconds.append(time.perf_counter() - t0)
            logs.append(log)
        self.state = state
        # the one trial's logs, stacked over epochs: (E, ...)
        self.logs = {k: np.asarray([log[k] for log in logs]) if k == "epoch"
                     else torch.stack([log[k][0] for log in logs]).cpu().numpy()
                     for k in logs[0]}

        os.makedirs(self.work_dir, exist_ok=True)
        write_losses_csv(os.path.join(self.work_dir, "losses.csv"), self.logs)
        cfg = core.cfg
        save_model_bundle(os.path.join(self.work_dir, "final.mpk"), *core.export(0), cfg)
        save_model_bundle(
            os.path.join(self.work_dir, "best_tracked.mpk"),
            *core.export(0, state.best_state), cfg,
            extra={"best_epoch": int(state.best_epoch[0]),
                   "best_combined": float(state.best_combined[0])})
        save_model_bundle(
            os.path.join(self.work_dir, "best_recon.mpk"),
            *core.export(0, state.best_recon_state), cfg,
            extra={"best_recon_epoch": int(state.best_recon_epoch[0]),
                   "best_recon_mse": float(state.best_recon[0])})

        metrics_all = self.logs["metrics"]
        if callback is not None:
            for epoch in range(metrics_all.shape[0]):
                callback(epoch, [float(m) for m in metrics_all[epoch]])

        metrics = [float(m) for m in metrics_all[-1]]
        if self.verbose:
            self.logger.info(metrics)
        return metrics

    def get_style_distribution_plot(self, z):
        """Stacked per-style histograms of a latent batch ``z`` (B, nstyle), a
        tensor or an array (``rankaae_tpu/train/facade.py:120-139``; the
        reference's ``sc/clustering/trainer.py:323-330``): nstyle
        shared-axis rows of step-filled histograms over bins
        ``arange(-3, 3.01, 0.2)``, on a ``matplotlib.figure.Figure`` made
        without pyplot (the user's backend is left alone)."""
        from matplotlib.figure import Figure

        z = z.detach().cpu().numpy() if isinstance(z, torch.Tensor) else np.asarray(z)
        nstyle = self.core.cfg.nstyle
        fig = Figure(figsize=(9, 12))
        ax_list = fig.subplots(nstyle, 1, sharex=True, sharey=True)
        bins = np.arange(-3.0, 3.01, 0.2)
        for istyle, ax in zip(range(nstyle), np.atleast_1d(ax_list)):
            ax.hist(z[:, istyle], bins=bins, color="blue", histtype="stepfilled",
                    edgecolor="blue")
        return fig
