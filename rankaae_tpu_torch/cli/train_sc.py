"""``train_sc``: train the config's trials and write their artifacts
(counterpart of ``rankaae_tpu/cli/train_sc.py:38-281``).

    python -m rankaae_tpu_torch.cli.train_sc -c cfg.yaml -w work_dir [--seed N]
        [--lr-sweep LO,HI] [--checkpoint-every N] [--resume] [--device cuda|cpu]
        [--debug-nans] [--profile-dir DIR]

Reads ``cfg.yaml`` (relative to the work dir) and its ``data_file``, trains
``trials`` trials of it at once on one device (``parallel/trials.py``), or
split over several processes (below), and writes the JAX CLI's artifact
tree:

    work_dir/main_process_message.txt
    work_dir/training/job_<i>/messages.txt, losses.csv,
        final.mpk, best_tracked.mpk, best_recon.mpk (each with its .json),
        checkpoints/epoch_<best epoch:06d>_loss_<best combined:07.6g>.mpk

with the same manifest extras (``final_metrics``, ``lr_scale`` under a
sweep, ``best_epoch``/``best_combined``, ``best_recon_epoch``/
``best_recon_mse``).  The config's ``timeout`` (hours) is one SIGALRM
around the whole run: the trials train together, so a per-trial deadline
and a total one coincide.  ``--lr-sweep LO,HI`` gives trial i the learning
rates scaled by ``geomspace(LO, HI, trials)[i]``.  ``--debug-nans`` turns
on autograd's anomaly detection; ``--profile-dir`` writes a
``torch.profiler`` trace of the run there, and beside it ``spans.json``:
the program's spans of the run (``utils/tracing.py``: name, parent, host
start and end ns on the trace's clock, device-stream ms), its counters,
and the totals per span name (count, host, self and device ms).

``--checkpoint-every N`` saves the whole train state into
``work_dir/train_state`` every N epochs (``parallel/trials.py``), appends
each segment's rows to every ``losses.csv`` as it ends, and writes a
``checkpoints/`` bundle whenever a trial's best combined metric improved in
the segment; ``--resume`` continues from ``work_dir/train_state``.
``bn_recalibrate: true`` replaces the BatchNorm statistics of the final,
best and best-recon models by one train-mode pass over the training split
before any bundle is written, and ``amp_recalibrate: true`` writes each
model's output gain into its manifest as ``amp_gain``
(``models/recalibrate.py``).  ``--device`` defaults to ``cuda``, and the
command raises without a CUDA device unless it is ``cpu``.

Several processes, one GPU each::

    python -m torch.distributed.run --nproc-per-node N \
        -m rankaae_tpu_torch.cli.train_sc -c cfg.yaml -w work_dir

Each rank joins the process group from torchrun's environment
(``parallel/multihost.py``), trains a contiguous block of the trials on
``cuda:LOCAL_RANK`` (or on the ``--device`` it is given: two ranks may
share one card), and every rank gets every trial's results; rank 0 writes
the whole tree above, file for file as one process would.  The other ranks
write nothing outside their checkpoint subdirectory
(``train_state/rank_<r:03d>``): with ``--checkpoint-every`` their
segments' ``losses.csv`` rows and ``checkpoints/`` bundles go there, and
rank 0 writes them into the tree when the run ends.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import signal
import time

import numpy as np
import torch
import torch.distributed as dist

from rankaae_tpu_torch.data.dataset import load_split_arrays
from rankaae_tpu_torch.models.recalibrate import amplitude_gain, recalibrate_batch_stats
from rankaae_tpu_torch.parallel import multihost
from rankaae_tpu_torch.parallel.trials import SegmentBest, TrialResults, run_trials
from rankaae_tpu_torch.train.trainer import TrialData
from rankaae_tpu_torch.utils import tracing
from rankaae_tpu_torch.utils.checkpoint import save_model_bundle
from rankaae_tpu_torch.utils.config import Parameters, TrainConfig
from rankaae_tpu_torch.utils.logging import append_losses_csv, create_logger, write_losses_csv


def _timeout_handler(signum, frame):
    raise TimeoutError("Training Overtime!")


def _checkpoint_bundle(job_dir: str, cfg: TrainConfig, params, stats, extra) -> None:
    """The reference's checkpoint-directory layout (trainer.py:77,300):
    ``checkpoints/epoch_<best epoch>_loss_<best combined>.mpk``."""
    save_model_bundle(
        os.path.join(job_dir, "checkpoints",
                     f"epoch_{extra['best_epoch']:06d}_loss_{extra['best_combined']:07.6g}.mpk"),
        params, stats, cfg, extra=extra)


def _segment_writer(work_dir: str, cfg: TrainConfig):
    """``run_trials``' ``on_segment`` for a checkpointed run
    (``rankaae_tpu/cli/train_sc.py:70-117``): each segment's rows are
    appended to every ``losses.csv`` (they survive a crash, and a resumed
    run appends where the last segment stopped), and each trial whose best
    combined metric improved in the segment gets a new ``checkpoints/``
    bundle beside the earlier ones."""
    last_best = {}

    def on_segment(e0, e1, seg_logs, best: SegmentBest, trial_offset=0):
        for i in range(seg_logs["epoch"].shape[0]):
            g = trial_offset + i
            job_dir = os.path.join(work_dir, "training", f"job_{g + 1}")
            os.makedirs(job_dir, exist_ok=True)
            append_losses_csv(os.path.join(job_dir, "losses.csv"),
                              {k: v[i] for k, v in seg_logs.items() if k != "metrics"}, e0)
            combined = float(best.combined[i])
            if np.isfinite(combined) and combined < last_best.get(g, np.inf):
                last_best[g] = combined
                _checkpoint_bundle(job_dir, cfg, *best.weights(i),
                                   {"best_epoch": int(best.epoch[i]), "best_combined": combined})

    return on_segment


def _staged_files(root: str) -> dict:
    """Every file under ``root/training`` as {path relative to root: bytes}."""
    out = {}
    for dirpath, _, names in os.walk(os.path.join(root, "training")):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def train_from_config(work_dir: str, params: Parameters, seed: int = 0,
                      checkpoint_every=None, resume: bool = False, lr_scales=None,
                      device=None) -> TrialResults:
    """Train every trial of ``params`` and write the artifact tree into
    ``work_dir`` (rank 0's job in a process group).  Returns the
    results."""
    cfg = TrainConfig.from_parameters(params)
    dev = multihost.rank_device(device)
    rank, world = multihost.world()
    if rank:
        # every file this rank writes lies in its checkpoint subdirectory
        logger = logging.getLogger(f"rankaae_tpu_torch.train_sc.rank_{rank}")
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
    else:
        logger = create_logger(
            "Main training:", os.path.join(work_dir, "main_process_message.txt"), append=True)
    logger.info("START")

    data_file = os.path.join(work_dir, params.get("data_file"))
    splits = load_split_arrays(
        data_file, (cfg.train_ratio, cfg.validation_ratio, cfg.test_ratio), cfg.n_aux)
    data = TrialData(*(torch.from_numpy(a).to(dev) for a in (
        splits["train"].spec, splits["train"].aux, splits["val"].spec, splits["val"].aux)))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    logger.info(f"Running {cfg.trials} trial(s) on {dev} ({name})"
                + (f", split over {world} ranks" if world > 1 else ""))

    timeout_s = int(cfg.timeout * 3600)
    alarm = timeout_s > 0 and hasattr(signal, "SIGALRM")
    if alarm:
        signal.signal(signal.SIGALRM, _timeout_handler)
        signal.alarm(timeout_s)
    start = time.time()
    checkpoint_dir = os.path.join(work_dir, "train_state") \
        if (checkpoint_every or resume) else None
    # rank r > 0 stages its segments' files in its checkpoint subdirectory
    segment_root = work_dir if checkpoint_dir is None or rank == 0 else \
        os.path.join(checkpoint_dir, f"rank_{rank:03d}")
    try:
        results = run_trials(
            cfg, data, seed=seed, lr_scales=lr_scales, device=dev,
            checkpoint_every=checkpoint_every, checkpoint_dir=checkpoint_dir,
            on_segment=None if checkpoint_dir is None else _segment_writer(segment_root, cfg))
    finally:
        if alarm:
            signal.alarm(0)
    total = time.time() - start
    if world > 1 and checkpoint_dir is not None:
        staged = multihost.all_gather_objects(_staged_files(segment_root) if rank else {})
        if rank == 0:
            for files in staged:
                for rel, blob in files.items():
                    os.makedirs(os.path.dirname(os.path.join(work_dir, rel)), exist_ok=True)
                    with open(os.path.join(work_dir, rel), "wb") as f:
                        f.write(blob)
    if rank:
        return results

    snapshots = (("final_params", "final_batch_stats"), ("best_params", "best_batch_stats"),
                 ("best_recon_params", "best_recon_batch_stats"))
    for i in range(results.n_trials):
        job_dir = os.path.join(work_dir, "training", f"job_{i + 1}")
        os.makedirs(job_dir, exist_ok=True)
        tr = results.trial(i)
        if cfg.bn_recalibrate:
            # full-train-split BatchNorm statistics for every saved model
            for pk, sk in snapshots:
                tr[sk] = recalibrate_batch_stats(cfg, tr[pk], tr[sk], data.train_spec,
                                                 device=dev)
        job_logger = create_logger(f"subtraining_{i + 1}", os.path.join(job_dir, "messages.txt"))
        job_logger.info(f"Training started for trial {i + 1}.")
        extras = [{"final_metrics": [float(x) for x in tr["final_metrics"]]},
                  # the true best (min combined metric) and the best
                  # reconstruction (min val recon MSE), as in the JAX CLI
                  {"best_epoch": tr["best_epoch"], "best_combined": tr["best_combined"]},
                  {"best_recon_epoch": tr["best_recon_epoch"],
                   "best_recon_mse": tr["best_recon"]}]
        if lr_scales is not None:
            for extra in extras:
                extra["lr_scale"] = float(lr_scales[i])
            job_logger.info(f"lr_scale: {float(lr_scales[i]):.6g} (sweep over the trial axis)")
        if cfg.amp_recalibrate:
            # the one-scalar deployment gain InferenceModel divides out
            for extra, (pk, sk) in zip(extras, snapshots):
                extra["amp_gain"] = amplitude_gain(cfg, tr[pk], tr[sk], data.train_spec,
                                                   device=dev)
        if checkpoint_dir is None:
            # (a checkpointed run wrote its rows segment by segment)
            write_losses_csv(os.path.join(job_dir, "losses.csv"), tr["logs"])
        for name, extra, (pk, sk) in zip(("final", "best_tracked", "best_recon"), extras,
                                         snapshots):
            save_model_bundle(os.path.join(job_dir, f"{name}.mpk"), tr[pk], tr[sk], cfg,
                              extra=extra)
        _checkpoint_bundle(job_dir, cfg, tr["best_params"], tr["best_batch_stats"], extras[1])
        job_logger.info(list(np.round(tr["final_metrics"], 6)))
        job_logger.info(
            f"Training finished. Time used: {total:.2f}s (concurrent with all trials).\n\n")

    per_trial = total / max(results.n_trials, 1)
    logger.info(f"Time used for each trial: {per_trial:.2f} +/- 0.00s (lockstep).\n"
                + " ".join([f"{per_trial:.2f}s"] * results.n_trials))
    logger.info(f"Total time used: {total:.2f}s for {results.n_trials} trails "
                f"({per_trial:.2f} each on average).")
    logger.info("END\n\n")
    return results


@contextlib.contextmanager
def _profile(profile_dir):
    """A ``torch.profiler`` trace of the block and its spans into
    ``profile_dir``, or nothing when it is None."""
    if profile_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    tracing.reset()
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "train_sc.trace.json"))
    with open(os.path.join(profile_dir, "spans.json"), "w") as f:
        json.dump(tracing.report(tracing.trace_start_ns(prof)), f)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="Config for training parameter in YAML format")
    parser.add_argument("-w", "--work_dir", type=str, default=".",
                        help="Working directory to write the output files")
    parser.add_argument("--seed", type=int, default=0, help="Base seed: trial i gets seed + i")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu; there is no silent fallback")
    parser.add_argument("--debug-nans", action="store_true",
                        help="Turn on autograd anomaly detection")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="Write a torch.profiler trace of the training run")
    parser.add_argument("--checkpoint-every", type=int, default=None,
                        help="Save resumable training state every N epochs")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from <work_dir>/train_state if present")
    parser.add_argument("--lr-sweep", type=str, default=None, metavar="LO,HI",
                        help="Sweep the learning rates geometrically across the trials: "
                             "trial i's are scaled by geomspace(LO, HI, trials)[i]")
    args = parser.parse_args(argv)

    work_dir = os.path.abspath(os.path.expanduser(args.work_dir))
    if not os.path.isdir(work_dir):
        raise FileNotFoundError(f"work dir {work_dir} does not exist")
    params = Parameters.from_yaml(os.path.join(work_dir, args.config))
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    lr_scales = None
    if args.lr_sweep:
        lo, hi = (float(x) for x in args.lr_sweep.split(","))
        lr_scales = np.geomspace(lo, hi, int(params.get("trials", 1))).astype(np.float32)
    joined = multihost.launched() and not dist.is_initialized()
    if joined:
        multihost.initialize()
    try:
        with _profile(args.profile_dir):
            train_from_config(work_dir, params, seed=args.seed,
                              checkpoint_every=args.checkpoint_every, resume=args.resume,
                              lr_scales=lr_scales, device=args.device)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
