"""Reference-compatible ``Trainer`` facade (counterpart of
``rankaae_tpu/train/facade.py:50-118``).

The reference's public training API is
``Trainer.from_data(csv_fn, ..., config_parameters).train(callback)``
(``sc/clustering/trainer.py:65,411-474``).  ``from_data`` loads the splits
onto the device and builds the trainer; ``train`` runs every epoch, writes
``losses.csv`` into ``work_dir`` and returns the final metrics list
``[min shapiro-W, val recon MSE, avg train MI, max inter-style |rho|, val
kendall]`` (``trainer.py:294-295``).  The model bundles (``final.mpk`` ...)
are not written yet.

``device`` defaults to ``cuda:<igpu>``; with no CUDA device present,
``from_data`` raises unless the caller passes ``device="cpu"``.
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
        self.logs = {k: np.asarray([log[k] for log in logs]) if k == "epoch"
                     else torch.stack([log[k] for log in logs]).cpu().numpy()
                     for k in logs[0]}

        os.makedirs(self.work_dir, exist_ok=True)
        write_losses_csv(os.path.join(self.work_dir, "losses.csv"), self.logs)

        metrics_all = self.logs["metrics"]
        if callback is not None:
            for epoch in range(metrics_all.shape[0]):
                callback(epoch, [float(m) for m in metrics_all[epoch]])

        metrics = [float(m) for m in metrics_all[-1]]
        if self.verbose:
            self.logger.info(metrics)
        return metrics
