"""The port's training-quality harness (counterpart of
``scripts/parity_experiment.py`` ``--mode ours`` and ``--mode aggregate``).

    python -m rankaae_tpu_torch.tools.parity_experiment --mode ours \\
        [--epochs 300] [--rows 2000] [--seeds 8] [--ae-form FC] [--act-dtype bfloat16]
        [--set KEY=VALUE ...] [--segment-epochs N] [--json-dir DIR] [--device cuda]
    python -m rankaae_tpu_torch.tools.parity_experiment --mode aggregate \\
        --json-dir DIR [--ref-json-dir DIR] [--ae-form FC] [--out FILE]

``--mode ours`` trains ``--seeds`` seeds of the JAX script's experiment
config (``example/fix_config.yaml``'s hyperparameters at B 512, AdamW, GRL,
the flex target and the activated Kendall loss; :func:`_experiment_config`)
on the schema-exact synthetic dataset (``--rows`` rows, seed 42: 2,000 rows
give n_train 1,400 and n_val 300) through the port's entry points: one wave
of ``run_trials`` (trial g from seed g), then each seed's final, recalibrated
final (``bn_recalibrate``), min-combined (``best``) and min-val-recon
(``best_recon``) weights scored on the validation split by
:func:`_final_stats` through ``InferenceModel``.  It writes
``<json-dir>/ours.json`` with the JAX script's schema key for key (its
per-epoch traces under the JAX trace keys), plus ``stack``, ``device`` (the
card's name and power limit, from ``nvidia-smi``), ``seed_scheme`` and
``command``.  The JAX script split ``PRNGKey(0)`` into its seeds, so seed g
of the two stacks is not the same run: only the distributions over seeds
compare.  ``wall`` is the seconds of ``run_trials`` (set-up included).

``--segment-epochs N`` checkpoints every N epochs into
``<json-dir>/train_state`` (``run_trials(checkpoint_every=N,
checkpoint_dir=...)``): the same command run again after a cut resumes from
the last checkpoint, bit for bit on the FC form.  A finished checkpoint is
refused: remove ``train_state`` to train again.

``--mode aggregate`` renders the reference-against-port tables (final and
min-combined-selected models, the amplitude decomposition, the
reconstruction floor) from the reference's ``ref_seed_*.json`` in
``--ref-json-dir`` (default ``--json-dir``) and the port's ``ours.json`` in
``--json-dir``, to ``--out`` or the standard output.

The JAX script's ``--precision`` and ``--sch-recon-metric`` are ``--set
matmul_precision=...`` and ``--set sch_recon_metric=...`` here (the same
config keys).  Not ported: ``--mode ref`` and ``--mode full`` train the
torch reference from its checkout, which this repository does not hold;
``--rng`` sets the XLA program's ``rng_impl``, which the eager port has no
counterpart of.  Both are refused with a message.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import glob
import itertools
import json
import os
import shlex
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np

STACK = "rankaae_tpu_torch"
SEED_SCHEME = ("trial g of run_trials(seed=0) draws from streams seeded g (Philox keyed g "
               "on the card, a generator seeded g on the CPU); the JAX package split "
               "PRNGKey(0) into its seeds, so seeds are not paired across the stacks: only "
               "distributions over seeds compare")
#: the JAX script's per-epoch trace keys (``scripts/parity_experiment.py:423-426``)
TRACE_KEYS = ("metrics", "val_gen", "val_dis", "val_smooth", "val_mi", "val_aux",
              "train_recon", "train_gen", "train_dis", "train_aux", "train_smooth",
              "train_mi", "val_gain", "val_clamp_frac")
DESCRIPTORS = ["CT", "CN", "OCN", "RSTD", "MOOD"]


def _experiment_config(epochs, ae_form="FC", precision=None, rng_impl=None,
                       act_dtype=None, sch_recon_metric=None):
    """The JAX script's experiment config (``scripts/parity_experiment.py:
    75-136``), number for number."""
    extra = {}
    if sch_recon_metric is not None:
        extra["sch_recon_metric"] = sch_recon_metric
    if ae_form != "FC":
        extra["ae_form"] = ae_form
    if ae_form == "qved":
        # the q-vector family is 12-dimensional
        extra["dim_in"] = 12
        extra["dim_out"] = 12
    if precision is not None:
        extra["matmul_precision"] = precision
    if rng_impl is not None:
        extra["rng_impl"] = rng_impl
    if act_dtype is not None:
        extra["activation_dtype"] = act_dtype
    base = {
        "data_file": "parity_data.csv",
        "trials": 1,
        "timeout": 10,
        "verbose": False,
        "max_epoch": epochs,
        "batch_size": 512,
        "gradient_reversal": True,
        "alpha_flat_step": 739,
        "alpha_limit": 0.7172,
        "decoder_activation": "Softplus",
        "dis_beta": 1.1,
        "dis_dropout_rate": 0.056,
        "dis_noise": 0.56,
        "gen_beta": 1.1,
        "n_aux": 5,
        "nstyle": 6,
        "ae_form": "FC",
        "dim_in": 256,
        "dim_out": 256,
        "n_layers": 5,
        "FC_discriminator_layers": 3,
        "use_cnn_discriminator": False,
        "dropout_rate": 0.04,
        "sch_factor": 0.1,
        "sch_patience": 100,
        "lr_base": 0.001,
        "lr_ratio_Corr": 10,
        "lr_ratio_Mutual": 1,
        "lr_ratio_Reconn": 10,
        "lr_ratio_Smooth": 1,
        "lr_ratio_dis": 1,
        "lr_ratio_gen": 10,
        "optimizer_name": "AdamW",
        "spec_noise": 0.02,
        "use_flex_spec_target": True,
        "weight_decay": 0.01,
        "kendall_activation": True,
        "epoch_stop_smooth": epochs,
    }
    base.update(extra)  # overrides must win over the FC defaults above
    return base


def _apply_overrides(cfg_dict: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """``--set KEY=VALUE`` as the JAX script applies it
    (``scripts/parity_experiment.py:778-789``): a key of the experiment
    config or a field of the port's ``TrainConfig``, the value a Python
    literal or else a bare string."""
    from rankaae_tpu_torch.utils.config import TrainConfig

    out = dict(cfg_dict)
    fields = set(TrainConfig.field_names())
    for kv in overrides:
        key, _, raw = kv.partition("=")
        if key not in out and key not in fields:
            raise SystemExit(f"--set {key}: unknown config key")
        try:
            out[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            out[key] = raw
    return out


def _final_stats(encode, decode, val_spec, val_aux, train_spec=None):
    """The JAX script's model scores (``scripts/parity_experiment.py:
    139-195``): val recon MSE (plain, under the flex objective's clamped
    rescale, and with the median val gain divided out), the amplitude
    ratio's error, bias and spread, each style's Spearman against its
    descriptor, the least per-style Shapiro-W and the largest inter-style
    |Spearman|; with ``train_spec``, the train-split gain and the val MSE
    with it divided out (the ``amp_recalibrate`` deployment)."""
    from scipy.stats import shapiro, spearmanr

    z = encode(val_spec)
    out = decode(z)
    recon_mse = float(np.mean((out - val_spec) ** 2))
    style_desc_rho = [
        float(spearmanr(z[:, k], val_aux[:, k]).correlation) for k in range(5)
    ]
    shapiro_min = float(min(shapiro(z[:, k]).statistic for k in range(z.shape[1])))
    coupling = float(max(
        abs(spearmanr(z[:, i], z[:, j]).correlation)
        for i, j in itertools.combinations(range(z.shape[1]), 2)
    ))
    ratio = np.abs(out.mean(axis=1)) / np.abs(val_spec.mean(axis=1))
    scale_err = float(np.median(np.abs(ratio - 1.0)))
    scale_bias = float(np.median(ratio) - 1.0)
    scale_spread = float(np.percentile(ratio, 84) - np.percentile(ratio, 16))
    clamped = np.clip(ratio, 0.7, 1.3)
    recon_mse_flex = float(np.mean((out - val_spec * clamped[:, None]) ** 2))
    recon_mse_cal = float(np.mean(
        (out / (1.0 + scale_bias) - val_spec) ** 2))
    res_extra = {}
    if train_spec is not None:
        tout = decode(encode(train_spec))
        tratio = np.abs(tout.mean(axis=1)) / np.abs(train_spec.mean(axis=1))
        gain = float(np.clip(np.median(tratio), 0.5, 2.0))
        res_extra["amp_gain_train"] = gain
        res_extra["recon_mse_amp"] = float(np.mean((out / gain - val_spec) ** 2))
    return {
        "recon_mse": recon_mse,
        "recon_mse_flex": recon_mse_flex,
        "recon_mse_cal": recon_mse_cal,
        **res_extra,
        "scale_err": scale_err,
        "scale_bias": scale_bias,
        "scale_spread": scale_spread,
        "style_desc_rho": style_desc_rho,
        "shapiro_min": shapiro_min,
        "coupling": coupling,
    }


def _train_eval_recon(encode, decode, train_spec):
    """Eval-mode (running-stats) recon MSE on the train split
    (``scripts/parity_experiment.py:795-802``): high here while the
    train-mode train_recon trace is low means a BatchNorm running-stats
    mismatch, not overfitting."""
    out = decode(encode(train_spec))
    return float(np.mean((out - train_spec) ** 2))


def device_line(device) -> str:
    """The device a run used: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them, or ``cpu``."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return str(dev)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[dev.index or 0]


@dataclasses.dataclass
class OursRun:
    """A ``--mode ours`` run: the trials' results, the seconds of
    ``run_trials``, the config and the host splits (train spec, val spec,
    val aux), and the record written as ``ours.json``."""

    results: Any
    wall: float
    cfg: Any
    train_spec: np.ndarray
    val_spec: np.ndarray
    val_aux: np.ndarray
    record: Optional[Dict[str, Any]] = None


def run_ours(cfg_dict: Dict[str, Any], csv_path: str, n_seeds: int, device,
             segment_epochs: Optional[int] = None,
             checkpoint_dir: Optional[str] = None) -> OursRun:
    """Train ``n_seeds`` trials of ``cfg_dict`` on ``csv_path`` as one wave
    of ``run_trials`` on ``device`` (the JAX script's ``run_ours``,
    ``:358-453``); with ``segment_epochs``, checkpointed into
    ``checkpoint_dir`` every ``segment_epochs`` epochs."""
    import torch

    from rankaae_tpu_torch.data.dataset import load_split_arrays
    from rankaae_tpu_torch.parallel.trials import run_trials
    from rankaae_tpu_torch.train.trainer import TrialData
    from rankaae_tpu_torch.utils.config import Parameters, TrainConfig

    cfg = TrainConfig.from_parameters(Parameters(dict(cfg_dict)))
    splits = load_split_arrays(csv_path, n_aux=cfg.n_aux)
    data = TrialData(*(torch.tensor(a) for a in (
        splits["train"].spec, splits["train"].aux, splits["val"].spec, splits["val"].aux)))
    t0 = time.perf_counter()
    results = run_trials(cfg, data, n_trials=n_seeds, seed=0, max_resident=n_seeds,
                         device=device,
                         checkpoint_every=segment_epochs if segment_epochs else None,
                         checkpoint_dir=checkpoint_dir if segment_epochs else None)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return OursRun(results, wall, cfg, splits["train"].spec, splits["val"].spec,
                   splits["val"].aux)


def launch_counts() -> Dict[str, int]:
    """The port's kernel launches so far in this process: K1 and K2 (the
    Kendall pair sums and gradient rows), K3 (the fused block) and P1's
    forward calls (the channel PReLUs and branch sums)."""
    from rankaae_tpu_torch.utils import tracing

    return {"K1": tracing.counter("kendall.fwd_launches"),
            "K2": tracing.counter("kendall.bwd_launches"), "K3": tracing.counter("k3.launches"),
            "P1": tracing.counter("prelu.fwd_launches")}


def _rounded(values) -> List[float]:
    return [round(float(x), 6) for x in values]


def seed_records(run: OursRun, device) -> List[Dict[str, Any]]:
    """Each seed's record, key for key the JAX script's
    (``scripts/parity_experiment.py:858-891``)."""
    from rankaae_tpu_torch.models.inference import InferenceModel
    from rankaae_tpu_torch.models.recalibrate import recalibrate_batch_stats

    cfg, val_spec, val_aux, train_spec = run.cfg, run.val_spec, run.val_aux, run.train_spec
    logs = run.results.logs
    out = []
    for s in range(run.results.n_trials):
        t = run.results.trial(s)
        model = InferenceModel(t["final_params"], t["final_batch_stats"], cfg, device=device)
        # the bn_recalibrate deployment: final weights, full-train BN statistics
        recal = InferenceModel(
            t["final_params"],
            recalibrate_batch_stats(cfg, t["final_params"], t["final_batch_stats"],
                                    train_spec, device=device),
            cfg, device=device)
        best = InferenceModel(t["best_params"], t["best_batch_stats"], cfg, device=device)
        best_recon = InferenceModel(t["best_recon_params"], t["best_recon_batch_stats"], cfg,
                                    device=device)
        trace = logs["val_recon"][s]
        out.append({
            "best_epoch": t["best_epoch"],
            "final": _final_stats(model.encode, model.decode, val_spec, val_aux,
                                  train_spec=train_spec),
            "final_recal": _final_stats(recal.encode, recal.decode, val_spec, val_aux,
                                        train_spec=train_spec),
            "best": _final_stats(best.encode, best.decode, val_spec, val_aux),
            "best_recon_epoch": t["best_recon_epoch"],
            "best_recon": _final_stats(best_recon.encode, best_recon.decode, val_spec,
                                       val_aux, train_spec=train_spec),
            "val_recon_min": float(np.min(trace)),
            "val_recon_min_epoch": int(np.argmin(trace)),
            "val_recon_trace": _rounded(trace),
            "lr_recon_trace": [float(x) for x in logs["lr_recon"][s]],
            "train_recon_eval": _train_eval_recon(model.encode, model.decode, train_spec),
            "metrics_trace": [_rounded(row) for row in logs["metrics"][s]],
            "component_traces": {k: _rounded(logs[k][s]) for k in TRACE_KEYS
                                 if k != "metrics"},
            "gain_trace": _rounded(logs["val_gain"][s]),
        })
    return out


# ---- aggregate: the reference's seeds against the port's ------------------ #

def _fmt_spread(vals, fmt="{:.5f}"):
    lo, med, hi = np.min(vals), np.median(vals), np.max(vals)
    return f"{fmt.format(med)} [{fmt.format(lo)}, {fmt.format(hi)}]"


def _median_ci(vals, n_boot=20000, seed=0, alpha=0.05):
    """Bootstrap CI of the median (percentile method)."""
    vals = np.asarray(vals, float)
    r = np.random.default_rng(seed)
    meds = np.median(
        vals[r.integers(0, len(vals), size=(n_boot, len(vals)))], axis=1)
    return (float(np.percentile(meds, 100 * alpha / 2)),
            float(np.percentile(meds, 100 * (1 - alpha / 2))))


def _stats_table(ref_stats, ours_stats):
    """Markdown comparison rows for two lists of _final_stats dicts."""
    o = lambda key: np.array([s[key] for s in ours_stats])      # noqa: E731
    r = lambda key: np.array([s[key] for s in ref_stats])       # noqa: E731
    lines = [
        f"| Quantity | reference (n={len(ref_stats)}) "
        f"| {STACK} (n={len(ours_stats)}) |",
        "|---|---|---|",
        f"| val recon MSE | {_fmt_spread(r('recon_mse'))} "
        f"| {_fmt_spread(o('recon_mse'))} |",
        f"| min per-style Shapiro-W | {_fmt_spread(r('shapiro_min'), '{:.4f}')} "
        f"| {_fmt_spread(o('shapiro_min'), '{:.4f}')} |",
        f"| max inter-style \\|rho\\| | {_fmt_spread(r('coupling'), '{:.4f}')} "
        f"| {_fmt_spread(o('coupling'), '{:.4f}')} |",
    ]
    for k in range(5):
        rv = np.array([s["style_desc_rho"][k] for s in ref_stats])
        ov = np.array([s["style_desc_rho"][k] for s in ours_stats])
        lines.append(
            f"| style{k+1}<->{DESCRIPTORS[k]} Spearman | {_fmt_spread(rv, '{:.4f}')} "
            f"| {_fmt_spread(ov, '{:.4f}')} |"
        )
    ratio = float(np.median(o("recon_mse")) / np.median(r("recon_mse")))
    lines += ["", f"Median recon-MSE ratio (ours/reference): **{ratio:.2f}x**."]
    return lines


_AMP_KEYS = ("recon_mse", "recon_mse_flex", "recon_mse_cal", "scale_bias")


def _amp_table(ref_stats, ours_stats):
    """Amplitude-drift decomposition rows, on the seeds of each side that
    carry the instrumented fields (none where a side has none)."""
    ref_stats = [s for s in ref_stats if all(k in s for k in _AMP_KEYS)]
    ours_stats = [s for s in ours_stats if all(k in s for k in _AMP_KEYS)]
    if not ref_stats or not ours_stats:
        return []
    o = lambda key: np.array([s[key] for s in ours_stats])      # noqa: E731
    r = lambda key: np.array([s[key] for s in ref_stats])       # noqa: E731
    drift = lambda v: int(np.sum(np.abs(v) > 0.03))             # noqa: E731
    rows = [
        ("plain val recon MSE", "recon_mse", "{:.5f}"),
        ("flex-objective recon MSE (per-sample clamped rescale — "
         "the TRAINING loss's view)", "recon_mse_flex", "{:.5f}"),
        ("one-scalar-calibrated recon MSE (median val gain divided out)",
         "recon_mse_cal", "{:.5f}"),
    ]
    if all("recon_mse_amp" in s for s in ref_stats + ours_stats):
        rows.append(("deployed recon MSE (amp_recalibrate: TRAIN-split gain "
                     "applied to val)", "recon_mse_amp", "{:.5f}"))
    lines = [
        "## Amplitude-drift decomposition (final-epoch models)",
        "",
        "The flex reconstruction objective (`use_flex_spec_target`) rescales "
        "the target toward the output's per-spectrum amplitude (detached, "
        "clamped to [0.7, 1.3]) and resists drift only through a 0.1-weighted "
        "penalty, so a trained model can converge in spectral shape while "
        "carrying a coherent output gain far from 1.  Plain val MSE then "
        "reports that drift; the rows below remove it three ways.",
        "",
        f"| Quantity | reference (n={len(ref_stats)}) "
        f"| {STACK} (n={len(ours_stats)}) |",
        "|---|---|---|",
    ]
    for label, key, fmt in rows:
        lines.append(f"| {label} | {_fmt_spread(r(key), fmt)} "
                     f"| {_fmt_spread(o(key), fmt)} |")
    lines += [
        f"| signed amplitude bias (median output/target gain - 1) "
        f"| {_fmt_spread(r('scale_bias'), '{:+.3f}')} "
        f"| {_fmt_spread(o('scale_bias'), '{:+.3f}')} |",
        f"| seeds with \\|bias\\| > 3% | {drift(r('scale_bias'))}"
        f"/{len(ref_stats)} | {drift(o('scale_bias'))}/{len(ours_stats)} |",
        "",
        f"Median flex-MSE ratio (ours/reference): "
        f"**{np.median(o('recon_mse_flex'))/np.median(r('recon_mse_flex')):.2f}x**; "
        f"median calibrated-MSE ratio: "
        f"**{np.median(o('recon_mse_cal'))/np.median(r('recon_mse_cal')):.2f}x**.",
        "",
    ]
    return lines


def _aggregate(json_dir: str, ref_dir: str, ae_form: str) -> List[str]:
    """The reference-against-port markdown (``scripts/parity_experiment.py:
    565-710``) from ``ref_dir``'s ``ref_seed_*.json`` and ``json_dir``'s
    ``ours.json``."""
    ref_files = sorted(glob.glob(os.path.join(ref_dir, "ref_seed_*.json")))
    if not ref_files:
        raise SystemExit(f"no ref_seed_*.json in {ref_dir}")
    refs = []
    for fn in ref_files:
        with open(fn) as f:
            refs.append(json.load(f))
    with open(os.path.join(json_dir, "ours.json")) as f:
        ours = json.load(f)
    epochs = refs[0]["epochs"]

    ref_best = [r["best"] for r in refs if r["best"]]
    ref_final = [r["final"] for r in refs]
    our_best = [s["best"] for s in ours["seeds"]]
    our_final = [s["final"] for s in ours["seeds"]]
    ref_bep = [r["best_epoch"] for r in refs]
    our_bep = [s["best_epoch"] for s in ours["seeds"]]
    device = ours.get("device", "not recorded")

    lines = [
        f"# Production-length ({epochs}-epoch) training parity: "
        f"reference (torch CPU) vs {STACK}",
        "",
        f"Same synthetic dataset ({refs[0]['rows']} rows, seed 42), same "
        f"config (`example/fix_config.yaml` hyperparameters, ae_form={ae_form}, "
        f"{epochs} epochs, AdamW, GRL, flex recon, activated Kendall; port "
        f"overrides {ours.get('overrides') or []}), independent RNG.  "
        f"Reference: {len(refs)} sequential torch-CPU runs (seeds "
        f"{min(r['seed'] for r in refs)}..{max(r['seed'] for r in refs)}); "
        f"ours: {len(ours['seeds'])} seeds ({ours.get('epochs')} epochs) trained "
        f"as one wave of `run_trials` on {device}.  Cells are median [min, max] "
        "across seeds.",
        "",
        "## Min-combined-metric-selected models (selection-behavior parity)",
        "",
        "Both sides select the min-combined-metric epoch (the port: "
        "`TrialResults.best_params`, `best_tracked.mpk`; torch: min-combined "
        "weights captured through the reference's callback hook).  This "
        "criterion fires early and selects poor reconstructors on both "
        "stacks; what `use_best_checkpoint: true` deploys is the "
        "min-val-recon model (`best_recon.mpk`).",
        "",
        *_stats_table(ref_best, our_best),
        "",
        f"Best epoch: reference {sorted(ref_bep)}, ours {sorted(our_bep)} "
        f"(medians {int(np.median(ref_bep))} and {int(np.median(our_bep))} of {epochs}).",
        "",
        "## Secondary: final-epoch models",
        "",
        ("Final-epoch weights are a BatchNorm-lottery sample once the plateau "
         "cascade has frozen the learning rates (the JAX package's "
         "`PARITY_RESULTS_1500.md` gives the mechanism); reported for "
         "completeness."
         if epochs >= 1000 else
         "Final-epoch weights still fluctuate epoch to epoch through "
         "BatchNorm running statistics tracking the noisy training batches; "
         "the floor below is the stable convergence comparison."),
        "",
        *_stats_table(ref_final, our_final),
        "",
        *_amp_table(ref_final, our_final),
        f"Wall clock: reference {np.sum([r['wall'] for r in refs]):.0f} s total "
        f"({np.mean([r['wall'] for r in refs]):.0f} s/run, torch CPU); ours "
        f"{ours['wall']:.1f} s for all {len(ours['seeds'])} seeds together on "
        f"{device} (set-up included).",
        "",
    ]

    ref_floor = [r["val_recon_min"] for r in refs if "val_recon_min" in r]
    our_floor = [s["val_recon_min"] for s in ours["seeds"] if "val_recon_min" in s]
    if ref_floor and our_floor:
        r_lo, r_hi = _median_ci(ref_floor)
        o_lo, o_hi = _median_ci(our_floor)
        overlap = (o_lo <= r_hi) and (r_lo <= o_hi)
        lines += [
            "## Reconstruction floor (min val recon MSE over the run)",
            "",
            f"| | reference (n={len(ref_floor)}) | {STACK} (n={len(our_floor)}) |",
            "|---|---|---|",
            f"| median [min, max] | {_fmt_spread(ref_floor)} "
            f"| {_fmt_spread(our_floor)} |",
            f"| median 95% bootstrap CI | [{r_lo:.5f}, {r_hi:.5f}] "
            f"| [{o_lo:.5f}, {o_hi:.5f}] |",
            "",
            f"Median floor ratio (ours/reference): "
            f"**{np.median(our_floor)/np.median(ref_floor):.2f}x**; the "
            f"median CIs {'OVERLAP' if overlap else 'do NOT overlap'}.  The "
            "min-val-recon model is what `use_best_checkpoint: true` "
            "deploys (`best_recon.mpk`).",
            "",
        ]
    our_brec = [s["best_recon"] for s in ours["seeds"] if "best_recon" in s]
    if our_brec:
        v = [b["recon_mse"] for b in our_brec]
        lines += [
            f"Ours best-recon model quality (re-evaluated): recon MSE {_fmt_spread(v)}.",
            "",
        ]
    return lines


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m rankaae_tpu_torch.tools.parity_experiment",
        description="The port's training-quality harness (--mode ours, --mode aggregate).")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--rows", type=int, default=2000)
    ap.add_argument("--seeds", type=int, default=8, help="seeds trained as one wave")
    ap.add_argument("--ae-form", default="FC", choices=["FC", "normal", "compact", "qved"])
    ap.add_argument("--act-dtype", default=None, choices=["float32", "bfloat16"],
                    help="activation_dtype")
    ap.add_argument("--rng", default=None,
                    help="refused: rng_impl shapes the JAX package's XLA program")
    ap.add_argument("--mode", default="ours", choices=["full", "ref", "ours", "aggregate"],
                    help="ours: train and write ours.json; aggregate: the reference's "
                         "seeds against ours.json (ref and full are refused)")
    ap.add_argument("--json-dir", default=os.path.join(tempfile.gettempdir(), "parity_json"))
    ap.add_argument("--ref-json-dir", default=None,
                    help="aggregate: the directory of ref_seed_*.json (default --json-dir)")
    ap.add_argument("--out", default=None,
                    help="aggregate: markdown file to write (default: standard output)")
    ap.add_argument("--segment-epochs", type=int, default=None,
                    help="checkpoint every N epochs into <json-dir>/train_state; a rerun "
                         "of the same command resumes from it")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    dest="overrides", help="config override (repeatable)")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> Optional[OursRun]:
    """The command line; returns the :class:`OursRun` of ``--mode ours``
    (its ``record`` is what ``ours.json`` holds)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = _parser()
    args = ap.parse_args(argv)
    if args.rng is not None:
        ap.error("--rng is not ported: rng_impl selects the JAX package's XLA PRNG, and "
                 "the port draws from its own seeded streams")
    if args.mode in ("ref", "full"):
        ap.error(f"--mode {args.mode} trains the torch reference from its checkout, which "
                 "this repository does not hold; use the committed ref_seed_*.json with "
                 "--mode aggregate")
    if args.segment_epochs is not None and args.segment_epochs < 1:
        ap.error("--segment-epochs must be at least 1")

    if args.mode == "aggregate":
        lines = _aggregate(args.json_dir, args.ref_json_dir or args.json_dir, args.ae_form)
        text = "\n".join(lines) + "\n"
        if args.out is None:
            sys.stdout.write(text)
        else:
            with open(args.out, "w") as f:
                f.write(text)
            print(f"wrote {args.out}")
        return None

    from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes_csv
    from rankaae_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg_dict = _apply_overrides(
        _experiment_config(args.epochs, ae_form=args.ae_form, act_dtype=args.act_dtype),
        args.overrides)
    os.makedirs(args.json_dir, exist_ok=True)
    # qved consumes 12-dim q-vectors: same generator on a 12-point grid
    data_dim = 12 if args.ae_form == "qved" else 256
    print(f"ours: training {args.seeds} seeds x {args.epochs} epochs on {device} ...")
    before = launch_counts()
    with tempfile.TemporaryDirectory(prefix="parity_data_") as tmp:
        csv_path = make_synthetic_xanes_csv(os.path.join(tmp, f"parity_data_{data_dim}.csv"),
                                            n_rows=args.rows, dim=data_dim, seed=42)
        run = run_ours(cfg_dict, csv_path, args.seeds, device,
                       segment_epochs=args.segment_epochs,
                       checkpoint_dir=os.path.join(args.json_dir, "train_state"))
    run.record = {
        "wall": run.wall, "epochs": args.epochs, "rows": args.rows,
        "overrides": args.overrides,
        "stack": STACK,
        "device": device_line(device),
        "seed_scheme": SEED_SCHEME,
        "command": shlex.join(["python", "-m", "rankaae_tpu_torch.tools.parity_experiment",
                               *argv]),
        "seeds": seed_records(run, device),
    }
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    out = os.path.join(args.json_dir, "ours.json")
    with open(out, "w") as f:
        json.dump(run.record, f, indent=1)
    print(f"wrote {out}: {run.wall:.1f} s of training on {run.record['device']}; kernel "
          f"launches (training and scoring) {json.dumps(launches)}; final MSEs "
          f"{[round(s['final']['recon_mse'], 5) for s in run.record['seeds']]}")
    return run


if __name__ == "__main__":
    main()
