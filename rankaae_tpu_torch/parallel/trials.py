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
(``trials.py:195-221``), every form alike.

Several processes (``parallel/multihost.py``; the JAX package's
``trial_mesh`` and ``trial_dp_mesh``, ``trials.py:78-119``): in a process
group of W ranks, ``run_trials`` splits the ranks into W / ``dp`` groups
of ``dp`` consecutive ranks, and gives group k a contiguous block of the
trials (the first n_trials % groups blocks one trial more; no padding
lanes).  Each rank trains its group's block in waves of ``max_resident``,
trial g still from seed s + g, and the results are gathered in trial order
onto every rank over a gloo group, so every rank returns the same
:class:`TrialResults`.  With ``dp`` > 1 the ranks of a group train the
same trials, and the train rows are sharded over them when ``dp`` divides
their count (else every rank keeps them all, as ``_data_sharding``
replicates a dataset it cannot split evenly): each minibatch's rows are
then gathered from the shards (:class:`RowShards`), so the result is the
1-process run's.  The validation rows are replicated: every validation
reads them all.

With ``checkpoint_dir``, a wave trains in segments of ``checkpoint_every``
epochs and after each writes ``logs.npz`` (the logs so far),
``trial_state.mpk`` (the whole train state and its epoch) and
``progress.json``, in that order, into the checkpoint dir (into
``wave_<w:03d>`` of it when there are several waves); a rerun resumes from
them (``rankaae_tpu/parallel/trials.py:291-464``).  The state file names
its own epoch and the logs are cut to it, so a crash between two of the
writes never duplicates a row.  Under several ranks each rank checkpoints
into ``rank_<r:03d>`` of the checkpoint dir, and ``layout.json`` names the
world size and ``dp``: a resume under another layout is refused.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from rankaae_tpu_torch.parallel import multihost
from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrainState, TrialData, per_trial
from rankaae_tpu_torch.utils.checkpoint import load_train_state, save_train_state
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
    checkpoint_every: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    on_segment: Optional[Callable] = None,
    dp: int = 1,
) -> TrialResults:
    """Train ``n_trials`` (default ``cfg.trials``) independent trials of
    ``cfg`` on ``device`` (default ``"cuda"``), at most ``max_resident``
    at once on each rank.

    ``lr_scales`` ((n_trials,)) multiplies each trial's learning rates;
    ``sweep`` maps keys of ``SWEEPABLE_HPARAMS`` (spec_noise, alpha_limit,
    alpha_flat_step) to per-trial values ((n_trials,)).  Both are validated
    as the JAX runner validates them (``trials.py:122-191``).

    In a process group the ranks split the trials, in groups of ``dp``
    ranks that share their trials and shard the train rows (see the module
    docstring); every rank returns every trial's results.

    ``checkpoint_dir`` makes the run resumable (see the module docstring),
    with a checkpoint every ``checkpoint_every`` epochs (default: at the
    end).  ``on_segment(e0, e1, logs, best, trial_offset)`` is called after
    each segment of epochs [e0, e1) with its host logs (T, e1 - e0, ...),
    the wave's :class:`SegmentBest` and the wave's first trial (in the whole
    run); under several ranks, on the rank that trained the wave."""
    n_trials = cfg.trials if n_trials is None else n_trials
    # the whole run's shapes; each wave's init_state refuses a key that is
    # not sweepable and lr_scales with AdaBound
    if lr_scales is not None:
        lr_scales = per_trial("lr_scales", lr_scales, n_trials)
    if sweep is not None:
        sweep = {k: per_trial(f"sweep[{k!r}]", v, n_trials) for k, v in sweep.items()}

    rank, world = multihost.world()
    if dp < 1 or world % dp:
        raise ValueError(f"dp={dp} must divide the world size {world}")
    groups = world // dp
    if n_trials < groups:
        raise ValueError(f"{n_trials} trials for {groups} trial groups of {dp} rank(s): "
                         f"each group needs a trial")
    # this rank's group trains trials [lo, lo + take): contiguous, the
    # first n_trials % groups blocks one trial longer
    group = rank // dp
    per, extra = divmod(n_trials, groups)
    lo, take = group * per + min(group, extra), per + (group < extra)
    if checkpoint_dir is not None:
        checkpoint_dir = _rank_checkpoint_dir(checkpoint_dir, rank, world, dp)

    dev = resolve_device(device)
    data = TrialData(*(x.to(dev) for x in dataclasses.astuple(data)))
    rows = None
    if dp > 1 and data.train_spec.shape[0] % dp == 0:
        rows = RowShards(data, rank % dp, _dp_group(world, dp, group, dev))
        data = rows.data
    max_wave = max(1, int(max_resident))
    n_waves = -(-take // max_wave)
    waves = []
    for w in range(n_waves):
        done = lo + w * max_wave
        size = min(max_wave, lo + take - done)
        # several waves checkpoint into a dir each, and a wave that completed
        # before a resume reloads without training (trials.py:193-233)
        wave_dir = checkpoint_dir if checkpoint_dir is None or n_waves == 1 else \
            os.path.join(checkpoint_dir, f"wave_{w:03d}")
        waves.append(_run_wave(
            cfg, data, size, seed + done, dev,
            None if lr_scales is None else lr_scales[done:done + size],
            None if sweep is None else {k: v[done:done + size] for k, v in sweep.items()},
            checkpoint_every=checkpoint_every, checkpoint_dir=wave_dir,
            on_segment=on_segment, trial_offset=done, allow_completed=n_waves > 1,
            rows=rows))
    results = waves[0] if len(waves) == 1 else _concat_results(waves)
    if world == 1:
        return results
    # every group's first rank's results, in trial order, on every rank
    return _concat_results(multihost.all_gather_objects(results)[::dp])


def _rank_checkpoint_dir(checkpoint_dir: str, rank: int, world: int, dp: int) -> str:
    """This rank's checkpoint dir (``rank_<r:03d>`` under several ranks),
    after refusing a checkpoint of another layout; rank 0 writes the
    layout of a run of several ranks."""
    layout_fn = os.path.join(checkpoint_dir, "layout.json")
    saved = {"world_size": 1, "dp": 1}
    if os.path.exists(layout_fn):
        with open(layout_fn) as f:
            saved = json.load(f)
    elif not os.path.exists(os.path.join(checkpoint_dir, "progress.json")) and \
            not os.path.isdir(os.path.join(checkpoint_dir, "wave_000")):
        saved = None                 # nothing to resume
    want = {"world_size": world, "dp": dp}
    if saved is not None and saved != want:
        raise ValueError(f"checkpoint in {checkpoint_dir} was written by {saved['world_size']} "
                         f"rank(s) at dp {saved['dp']}; resume with that layout, not "
                         f"{world} rank(s) at dp {dp}")
    if world == 1:
        return checkpoint_dir
    dist.barrier(group=multihost.host_group())      # every rank read the layout
    if rank == 0:
        os.makedirs(checkpoint_dir, exist_ok=True)
        with open(layout_fn, "w") as f:
            json.dump(want, f)
    return os.path.join(checkpoint_dir, f"rank_{rank:03d}")


def _dp_group(world: int, dp: int, group: int, device):
    """The process group of dp group ``group`` (ranks group * dp .. group *
    dp + dp - 1): NCCL for the row gathers on CUDA, gloo on the CPU.  Every
    rank makes every group, in the same order."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    made = [dist.new_group(list(range(g * dp, (g + 1) * dp)), backend=backend)
            for g in range(world // dp)]
    return made[group]


class RowShards:
    """The train rows of one dp group, sharded: member ``index`` of the
    group's ``size`` ranks keeps rows [index * n / size, (index + 1) * n /
    size) of the train spectra and descriptors (``size`` divides their
    count n; ``rankaae_tpu/parallel/trials.py:105-119``).  :meth:`gather`
    builds a minibatch from the shards: each member reads the rows it holds
    and zeros elsewhere, the group all-gathers that, and every row is taken
    from the member that holds it, so the rows are exactly the dataset's.
    ``data`` is the dataset this rank keeps."""

    def __init__(self, data: TrialData, index: int, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.n_rows = data.train_spec.shape[0]
        self.per = self.n_rows // self.size
        self.lo = index * self.per
        self.dim = data.train_spec.shape[1]
        rows = torch.cat([data.train_spec, data.train_aux], dim=1)
        self.rows = rows[self.lo:self.lo + self.per].clone()
        self.data = TrialData(self.rows[:, :self.dim], self.rows[:, self.dim:], data.val_spec,
                              data.val_aux)

    def gather(self, flat: torch.Tensor):
        """The train rows ``flat`` (indices into the whole split) as
        (spectra, descriptors)."""
        local = (flat - self.lo).clamp(0, self.per - 1)
        mine = ((flat >= self.lo) & (flat < self.lo + self.per))[:, None]
        part = torch.where(mine, self.rows.index_select(0, local),
                           torch.zeros((), device=flat.device))
        parts = [torch.empty_like(part) for _ in range(self.size)]
        dist.all_gather(parts, part, group=self.group)
        owner = torch.div(flat, self.per, rounding_mode="floor")
        rows = torch.stack(parts)[owner, torch.arange(flat.numel(), device=flat.device)]
        return rows[:, :self.dim], rows[:, self.dim:]


def _concat_results(waves: List[TrialResults]) -> TrialResults:
    cat = lambda trees: _tree_map(lambda *xs: np.concatenate(xs, axis=0), *trees)  # noqa: E731
    fields = {f.name: cat([getattr(w, f.name) for w in waves])
              for f in dataclasses.fields(TrialResults) if f.name != "n_trials"}
    return TrialResults(n_trials=sum(w.n_trials for w in waves), **fields)


@dataclasses.dataclass
class SegmentBest:
    """A wave's best-combined trackers after a segment: the epoch and metric
    per trial (T,), and ``weights(i)``, trial i's best model as
    ``(params, batch_stats)`` (the bundle layout)."""

    epoch: np.ndarray
    combined: np.ndarray
    weights: Callable[[int], tuple]


def _sweep_record(lr_scales, sweep):
    return (None if lr_scales is None else [float(x) for x in lr_scales],
            None if sweep is None else {k: [float(x) for x in v] for k, v in sweep.items()})


def _resume(trainer: RankAAETrainer, state: TrainState, checkpoint_dir: str, n_trials: int,
            seed: int, lr_scales, sweep):
    """The epoch to start from and the logs so far, from the wave's
    checkpoint when there is one of this seed and trial count (else 0 and
    none); a checkpoint of another sweep raises."""
    progress_fn = os.path.join(checkpoint_dir, "progress.json")
    state_fn = os.path.join(checkpoint_dir, "trial_state.mpk")
    logs_fn = os.path.join(checkpoint_dir, "logs.npz")
    if not (os.path.exists(progress_fn) and os.path.exists(state_fn)):
        return 0, []
    with open(progress_fn) as f:
        progress = json.load(f)
    if progress.get("n_trials") != n_trials or progress.get("seed") != seed:
        return 0, []
    want = _sweep_record(lr_scales, sweep)
    saved = (progress.get("lr_scales"), progress.get("sweep"))
    if saved != want:
        # the saved learning rates and hyperparameters are the original
        # sweep's: resuming under another would mislabel the trials
        raise ValueError(f"resume sweep mismatch: checkpoint was trained with "
                         f"lr_scales={saved[0]}, sweep={saved[1]}; resume requested "
                         f"lr_scales={want[0]}, sweep={want[1]}")
    tree, extra = load_train_state(state_fn)
    trainer.load_state_tree(state, tree)
    # the state file's own epoch wins; the logs, written before it, are cut
    # to it, so a crash between the two writes never duplicates a row
    start = int(extra.get("epoch", progress["epoch"]))
    if not os.path.exists(logs_fn):
        return start, []
    with np.load(logs_fn) as z:
        return start, [{k: z[k][:, :start] for k in z.files}]


def _checkpoint(trainer: RankAAETrainer, state: TrainState, checkpoint_dir: str, epoch: int,
                logs: Dict[str, np.ndarray], n_trials: int, seed: int, lr_scales, sweep) -> None:
    """Logs, then the state (naming its epoch), then the progress file."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    tmp = os.path.join(checkpoint_dir, "logs.tmp.npz")
    np.savez(tmp, **logs)
    os.replace(tmp, os.path.join(checkpoint_dir, "logs.npz"))
    save_train_state(os.path.join(checkpoint_dir, "trial_state.mpk"),
                     trainer.state_tree(state), extra={"epoch": epoch})
    scales, hp = _sweep_record(lr_scales, sweep)
    with open(os.path.join(checkpoint_dir, "progress.json"), "w") as f:
        json.dump({"epoch": epoch, "n_trials": n_trials, "seed": seed, "lr_scales": scales,
                   "sweep": hp}, f)


def _run_wave(cfg, data: TrialData, n_trials: int, seed: int, device, lr_scales, sweep,
              checkpoint_every: Optional[int] = None, checkpoint_dir: Optional[str] = None,
              on_segment: Optional[Callable] = None, trial_offset: int = 0,
              allow_completed: bool = False, rows: Optional[RowShards] = None
              ) -> TrialResults:
    """One wave of ``n_trials`` resident trials, base seed ``seed``, in
    segments of ``checkpoint_every`` epochs (one segment without); its
    batches from ``rows`` where the train rows are sharded."""
    n_train = data.train_spec.shape[0] if rows is None else rows.n_rows
    trainer = RankAAETrainer(cfg, n_train=n_train, n_val=data.val_spec.shape[0],
                             trials=n_trials, device=device)
    trainer.rows = rows
    state = trainer.init_state(seed, lr_scales=lr_scales, hparams=sweep)
    start, log_parts = 0, []
    if checkpoint_dir:
        start, log_parts = _resume(trainer, state, checkpoint_dir, n_trials, seed,
                                   lr_scales, sweep)
    if start >= cfg.max_epoch and not (allow_completed and log_parts):
        raise ValueError(f"checkpoint in {checkpoint_dir} is already complete "
                         f"(epoch {start} >= max_epoch {cfg.max_epoch})")
    seg = checkpoint_every or (cfg.max_epoch - start)
    for e0 in range(start, cfg.max_epoch, seg):
        e1 = min(e0 + seg, cfg.max_epoch)
        state, logs = trainer.run_epochs(state, data, range(e0, e1))
        log_parts.append(_host_logs(logs))
        if on_segment is not None:
            on_segment(e0, e1, log_parts[-1], SegmentBest(
                state.best_epoch.cpu().numpy(), state.best_combined.cpu().numpy(),
                lambda i: trainer.export(i, state.best_state)), trial_offset)
        if checkpoint_dir:
            _checkpoint(trainer, state, checkpoint_dir, e1, _concat_logs(log_parts), n_trials,
                        seed, lr_scales, sweep)
    return _collect_results(trainer, state, _concat_logs(log_parts))


def _host_logs(logs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``run_epochs``' logs (E, T, ...) as host arrays (T, E, ...)."""
    return {k: np.ascontiguousarray(v.transpose(0, 1).cpu().numpy()) for k, v in logs.items()}


def _concat_logs(parts: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.concatenate([p[k] for p in parts], axis=1) for k in parts[0]}


def _collect_results(trainer: RankAAETrainer, state: TrainState, logs: Dict[str, np.ndarray]
                     ) -> TrialResults:
    """The trainer's trials, their trackers and their host logs
    (T, E, ...) as host results."""
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
    return TrialResults(
        n_trials=t,
        final_params=final_params, final_batch_stats=final_stats,
        best_params=best_params, best_batch_stats=best_stats,
        best_epoch=state.best_epoch.cpu().numpy(),
        best_combined=state.best_combined.cpu().numpy(),
        logs=logs,
        final_metrics=logs["metrics"][:, -1, :],
        best_recon_params=recon_params, best_recon_batch_stats=recon_stats,
        best_recon_epoch=state.best_recon_epoch.cpu().numpy(),
        best_recon=state.best_recon.cpu().numpy(),
    )
