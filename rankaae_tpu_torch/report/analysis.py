"""Model evaluation and selection over trained bundles (counterpart of
``rankaae_tpu/report/analysis.py``; reference ``sc/report/analysis.py``).

Every forward (the split's encode and decode, the 50 x ``n_sampling``
decoder sweep) runs through the port's
:class:`~rankaae_tpu_torch.models.inference.InferenceModel` on its device, so
on the card a conv bundle's eval-mode decodes reach the K3 kernel.  The
scoring (reconstruction error, the F1 threshold scan, the confusion matrix,
the style-descriptor correlations, the selection table) is numpy and scipy:
:func:`mean_absolute_error`, :func:`confusion_matrix` and :func:`f1_score`
compute what sklearn's functions of those names compute for these inputs,
with one difference: a non-finite reconstruction gives a NaN error, which
ranks its trial last, where sklearn raises.  matplotlib and seaborn are
imported only by the functions that draw.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
from numpy.polynomial import Polynomial
from scipy import stats
from scipy.interpolate import interp1d
from scipy.stats import shapiro, spearmanr

from rankaae_tpu_torch.models.inference import InferenceModel


def pyplot():
    """matplotlib's pyplot on the Agg backend (imported on first use)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# --------------------------------------------------------------------------- #
# sklearn's metrics, for the inputs the report gives them
# --------------------------------------------------------------------------- #

def mean_absolute_error(y_true, y_pred) -> np.ndarray:
    """Mean |y_pred - y_true| over the last axis: one error per spectrum for
    (N, L) inputs (sklearn's ``mean_absolute_error`` of each row pair)."""
    return np.mean(np.abs(np.asarray(y_pred) - np.asarray(y_true)), axis=-1)


def confusion_matrix(y_true, y_pred) -> np.ndarray:
    """sklearn's ``confusion_matrix``: rows the true labels, columns the
    predicted ones, over the sorted union of the labels seen."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.unique(np.concatenate([y_true, y_pred]))
    t = np.searchsorted(labels, y_true)
    p = np.searchsorted(labels, y_pred)
    cm = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(cm, (t, p), 1)
    return cm


def f1_score(y_true, y_pred, average: str = "weighted") -> float:
    """sklearn's ``f1_score(average="weighted")``: each label's
    2 tp / (2 tp + fp + fn) (0 where that is 0 / 0), weighted by the
    label's count in ``y_true``."""
    if average != "weighted":
        raise ValueError(f"only average='weighted' is implemented, got {average!r}")
    cm = confusion_matrix(y_true, y_pred)
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(axis=1)
    denom = 2 * tp + (cm.sum(axis=0) - tp) + (support - tp)
    f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)
    if support.sum() == 0:
        return 0.0
    return float(np.average(f1, weights=support))


# --------------------------------------------------------------------------- #
# the decoder sweep
# --------------------------------------------------------------------------- #

# plotly.express.colors.sequential.Plotly3 (the reference's colormap,
# analysis.py:20-30)
_PLOTLY3 = [
    "#0508b8", "#1910d8", "#3c19f0", "#6b1cfb", "#981cfd", "#bf1cfd",
    "#dd2bfd", "#f246fe", "#fc67fd", "#fe88fc", "#fea5fd", "#febefe",
    "#fec3fe",
]


def create_plotly_colormap(n_colors: int) -> List[str]:
    """Cubic-interpolated Plotly3 colormap (reference ``analysis.py:20-30``)."""
    rgb = np.array([[int(f"0x{h[i:i + 2]}", 16) for i in range(1, 7, 2)] for h in _PLOTLY3])
    x0 = np.linspace(1, n_colors, rgb.shape[0])
    x1 = np.linspace(1, n_colors, n_colors)
    target = np.stack([interp1d(x0, rgb[:, i], kind="cubic")(x1) for i in range(3)]
                      ).T.round().astype(int)
    return ["#" + "".join(f"{c:02x}" for c in row) for row in target]


def plot_spectra_variation(model: InferenceModel, istyle: int, n_spec: int = 50,
                           n_sampling: int = 1000, true_range: bool = True,
                           styles: Optional[np.ndarray] = None, amplitude: float = 2.0,
                           ax=None, energy_grid=None, colors=None,
                           plot_residual: bool = False, seed: int = 0, **kwargs):
    """Decoder sweep over one style (reference ``analysis.py:33-103``): style
    ``istyle`` runs over its [5th, 95th] percentile in ``n_spec`` steps, the
    other styles are N(0, 1) draws averaged over ``n_sampling`` (or 0 when
    ``n_sampling`` is 0).  One decode of n_spec x n_sampling rows; the draws
    are numpy's, from ``seed``, as in the JAX package."""
    nstyle = model.nstyle
    if true_range:
        left, right = np.percentile(styles[:, istyle], [5, 95])
    else:
        left, right = -amplitude, amplitude

    rng = np.random.default_rng(seed)
    if n_sampling == 0:
        c = np.linspace(left, right, n_spec, dtype=np.float32)
        con_c = np.zeros((n_spec, nstyle), np.float32)
        con_c[:, istyle] = c
        spec_out = model.decode(con_c)
        style_variation = c
    else:
        con_c = rng.standard_normal((n_spec, n_sampling, nstyle)).astype(np.float32)
        style_variation = np.linspace(left, right, n_spec, dtype=np.float32)
        con_c[..., istyle] = style_variation[:, None]
        spec_out = model.decode(con_c.reshape(n_spec * n_sampling, nstyle))
        spec_out = spec_out.reshape(n_spec, n_sampling, -1).mean(axis=1)

    if ax is not None:
        if colors is None:
            colors = create_plotly_colormap(n_spec)
        assert len(colors) == n_spec
        for spec, color in zip(spec_out, colors):
            if energy_grid is None:
                ax.plot(spec, c=color, **kwargs)
            elif plot_residual:
                ax.plot(energy_grid, spec_out[-1] - spec_out[0], **kwargs)
                ax.set_ylim([-0.5, 0.5])
                break
            else:
                ax.plot(energy_grid, spec, c=color, **kwargs)
        ax.set_title(f"Style {istyle + 1} varying from {left:.2f} to {right:.2f}", y=1)
    return style_variation, spec_out


# --------------------------------------------------------------------------- #
# style-descriptor scores
# --------------------------------------------------------------------------- #

def _f1_threshold_scan(style, positive, thresh_grid, direction):
    """F1(threshold) of the predictions ``style < th`` ("lt") or
    ``style > th`` ("gt") against the boolean ``positive``, for every
    threshold of the grid at once (``analysis.py:112-146`` in the JAX
    package; the reference loops sklearn's ``f1_score`` with the prediction
    as its first argument, which this matches)."""
    order = np.argsort(style, kind="stable")
    sorted_style = style[order]
    cum_pos = np.concatenate([[0], np.cumsum(positive[order])])
    total_pos = int(positive.sum())
    counts = np.searchsorted(sorted_style, thresh_grid, side="left")
    if direction == "lt":
        tp = cum_pos[counts]
        pred_n = counts
    else:
        counts_le = np.searchsorted(sorted_style, thresh_grid, side="right")
        tp = total_pos - cum_pos[counts_le]
        pred_n = len(style) - counts_le
    fp = pred_n - tp
    fn = total_pos - tp
    denom = 2 * tp + fp + fn
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)


def get_confusion_matrix(cn, style_cn, ax=None) -> Optional[Dict]:
    """A CN classifier from one style (reference ``analysis.py:234-311``):
    the max-F1 CN4/5 and CN5/6 thresholds over 700 in [-3.5, 3.5], the
    weighted F1 and the 3 x 3 confusion matrix.  None when the descriptor
    has more than three classes (not CN-like)."""
    result = {"F1 score": None, "CN45 Threshold": None, "CN56 Threshold": None}
    thresh_grid = np.linspace(-3.5, 3.5, 700)
    style_cn = np.asarray(style_cn)
    cn_classes = (np.asarray(cn) - 4).astype(int)
    cn_class_sets = sorted(set(cn_classes.tolist()))
    if len(cn_class_sets) > 3:
        return None

    cn4_f1 = _f1_threshold_scan(style_cn, cn_classes < 1, thresh_grid, "lt")
    cn6_f1 = _f1_threshold_scan(style_cn, cn_classes > 1, thresh_grid, "gt")
    cn45 = thresh_grid[int(np.argmax(cn4_f1))]
    cn56 = thresh_grid[int(np.argmax(cn6_f1))]

    pred = (style_cn > cn45).astype(int) + (style_cn > cn56).astype(int)
    cm = confusion_matrix(cn_classes, pred)
    if len(cn_class_sets) == 1:
        c = int(cn_class_sets[0])
        full = np.zeros((3, 3), int)
        full[c, c] = cm[0, 0]
        cm = full
    f1w = f1_score(cn_classes, pred, average="weighted")

    result["F1 score"] = round(float(f1w), 4)
    result["CN45 Threshold"] = round(float(cn45), 4)
    result["CN56 Threshold"] = round(float(cn56), 4)

    if ax is not None:
        import matplotlib as mpl
        import seaborn as sns

        sns.set_palette("bright", 2)
        ax[0].plot(thresh_grid, cn4_f1, label="CN4")
        ax[0].plot(thresh_grid, cn6_f1, label="CN6")
        ax[0].axvline(cn45, c="blue")
        ax[0].axvline(cn56, c="orange")
        ax[0].legend(loc="lower left", fontsize=12)

        sns.heatmap(cm, cmap="Blues", annot=True, fmt="d", cbar=False, ax=ax[1],
                    xticklabels=[f"CN{c + 4}" for c in range(3)],
                    yticklabels=[f"CN{c + 4}" for c in range(3)])
        ax[1].set_title(f"F1 Score = {f1w:.1%}", fontsize=12)
        ax[1].set_xlabel("Pred")
        ax[1].set_ylabel("True")

        colors = np.array(sns.color_palette("bright", 3))
        test_colors = np.array(
            [mpl.colors.colorConverter.to_rgba(c, alpha=0.6) for c in colors[cn_classes]])
        rand_y = np.random.uniform(style_cn.min(), style_cn.max(), len(cn_classes))
        ax[2].scatter(style_cn, rand_y, s=10.0, color=test_colors, alpha=0.8)
        ax[2].set_xlabel("Style 2")
        ax[2].set_ylabel("Random")
        ax[2].set_xlim([style_cn.min() - 1, style_cn.max() + 1])
        ax[2].set_ylim([style_cn.min() - 2, style_cn.max() + 1])
        ax[2].axvline(cn45, c="gray")
        ax[2].axvline(cn56, c="gray")
    return result


def get_max_inter_style_correlation(styles) -> float:
    """max |spearman(style_i, last style)| (reference ``analysis.py:313-325``:
    each style against the last one only)."""
    corr = [math.fabs(spearmanr(styles[:, i], styles[:, -1]).correlation)
            for i in range(styles.shape[1] - 1)]
    return round(max(corr), 4)


def get_descriptor_style_correlation(style, descriptor, ax=None, choice=("R2", "Spearman"),
                                     fit=True) -> Dict:
    """Linear R^2, Spearman rho and an optional quadratic fit between one
    style and one descriptor, NaN rows dropped (reference
    ``analysis.py:328-391``)."""
    order = np.argsort(style)
    style = np.asarray(style)[order]
    descriptor = np.asarray(descriptor)[order]
    mask = ~(np.isnan(descriptor) | np.isnan(style))
    style, descriptor = style[mask], descriptor[mask]

    accuracy = {
        "Spearman": None,
        "Linear": {"slope": None, "intercept": None, "R2": None},
        "Quadratic": {"Parameters": [None, None, None], "residue": None, "R2": None},
    }
    fitted = None
    if "R2" in choice:
        res = stats.linregress(style, descriptor)
        accuracy["Linear"]["R2"] = float(np.round(res.rvalue ** 2, 4))
        accuracy["Linear"]["intercept"] = float(np.round(res.intercept, 4))
        accuracy["Linear"]["slope"] = float(np.round(res.slope, 4))
        fitted = res.intercept + style * res.slope
    if "Spearman" in choice:
        accuracy["Spearman"] = float(np.round(spearmanr(style, descriptor).correlation, 4))
    if "Quadratic" in choice:
        p, info = Polynomial.fit(style, descriptor, 2, full=True)
        accuracy["Quadratic"]["Parameters"] = np.round(p.convert().coef, 4).tolist()
        accuracy["Quadratic"]["residue"] = float(np.round(info[0][0] / len(style), 4)) \
            if len(info[0]) else 0.0
        fitted = p(style)
        accuracy["Quadratic"]["R2"] = float(
            np.round(stats.linregress(fitted, descriptor).rvalue ** 2, 4))

    if ax is not None:
        ax.scatter(style, descriptor, s=10.0, c="blue", edgecolors="none", alpha=0.8)
        if fit and fitted is not None:
            ax.plot(style, fitted, lw=2, c="black", alpha=0.5)
    return accuracy


# --------------------------------------------------------------------------- #
# one model, every model
# --------------------------------------------------------------------------- #

def evaluate_model(test_ds, model: InferenceModel, reconstruct=True, accuracy=True,
                   style=True) -> Dict:
    """One model's scores (reference ``analysis.py:394-450``): the mean and
    std over spectra of each spectrum's reconstruction MAE, each
    descriptor's correlation with its style (CN by the confusion matrix
    and F1, the others by R^2, Spearman and a quadratic fit), and the
    largest inter-style Spearman."""
    descriptors = test_ds.aux
    result = {
        "Style-descriptor Corr": {},
        "Input": None,
        "Output": None,
        "Reconstruct Err": (None, None),
        "Inter-style Corr": None,
    }
    spec_in = np.asarray(test_ds.spec, np.float32)
    styles = model.encode(spec_in)
    result["Input"] = spec_in

    if reconstruct:
        spec_out = model.decode(styles)
        mae = mean_absolute_error(spec_in, spec_out)
        result["Reconstruct Err"] = [round(float(np.mean(mae)), 4), round(float(np.std(mae)), 4)]
        result["Output"] = spec_out

    if accuracy:
        for i in range(descriptors.shape[1]):
            if i == 1:  # CN
                result["Style-descriptor Corr"][i] = get_confusion_matrix(
                    descriptors[:, i], styles[:, i], ax=None)
            else:
                result["Style-descriptor Corr"][i] = get_descriptor_style_correlation(
                    descriptors[:, i], styles[:, i], ax=None,
                    choice=("R2", "Spearman", "Quadratic"))

    if style:
        result["Inter-style Corr"] = get_max_inter_style_correlation(styles)
    return result


def evaluate_all_models(model_path: str, test_ds, bundle_name: str = "final.mpk",
                        device=None) -> Dict[str, Dict]:
    """Scores of every ``job_*/<bundle_name>`` under ``model_path``
    (reference ``analysis.py:105-123``), each model on ``device`` (default
    ``"cuda"``).  ``best_recon.mpk`` (``use_best_checkpoint: true``) scores
    each trial's best-reconstruction model.  A swept ``lr_scale`` in the
    bundle's manifest is carried into its result."""
    result = {}
    for job in sorted(os.listdir(model_path)):
        if job.startswith("job_"):
            bundle = os.path.join(model_path, job, bundle_name)
            model = InferenceModel.from_bundle(bundle, device=device)
            result[job] = evaluate_model(test_ds, model)
            with open(bundle + ".json") as f:
                extra = json.load(f).get("extra", {})
            if "lr_scale" in extra:
                result[job]["lr_scale"] = extra["lr_scale"]
    return result


def load_evaluations(evaluation_path="./report_model_evaluations.pkl"):
    """A pickle this package's report wrote (``<output_name>_model_evaluation.pkl``)."""
    with open(evaluation_path, "rb") as f:
        return pickle.load(f)


# --------------------------------------------------------------------------- #
# selection
# --------------------------------------------------------------------------- #

# The heatmap's row labels are an output contract with the reference's
# figures, its misspelling of the reconstruction row included
# (reference analysis.py:137).
SELECTION_COLUMNS = (
    "Inter-style Corr",
    "Reconstuction Err",
    "Style_1 - CT Corr",
    "Style_2 - CN Corr",
    "Style_3 - OCN Corr",
    "Style_4 - Rstd Corr",
    "Style_5 - OO Corr",
)


@dataclasses.dataclass
class ModelSelection:
    """The ranked selection table: the metric matrix, its per-column
    z-scores, each job's score and the display order."""

    jobs: np.ndarray       # (n,) job names
    raw: np.ndarray        # (n, 7) metrics in SELECTION_COLUMNS order
    z: np.ndarray          # (n, 7) z-scores (failed rows zeroed)
    final: np.ndarray      # (n,) selection score
    failed: np.ndarray     # (n,) bool: a non-finite metric (a diverged trial)
    col_mean: np.ndarray   # (7,) column mean over the healthy trials
    col_std: np.ndarray    # (7,) column std over the healthy trials
    order: np.ndarray      # (n,) display order, failed trials last

    def take(self, attr: str) -> np.ndarray:
        return getattr(self, attr)[self.order]


def _metric_row(result: Dict) -> list:
    """One job's metrics in SELECTION_COLUMNS order; a missing correlation
    counts as 0."""
    row = [result["Inter-style Corr"], result["Reconstruct Err"][0]]
    for i in range(5):
        try:
            entry = result["Style-descriptor Corr"][i]
            row.append(entry["F1 score"] if i == 1 else entry["Spearman"])
        except (KeyError, TypeError):
            row.append(0)
    return row


def select_models(result_dict, sort_score=None, ascending=True) -> ModelSelection:
    """The selection table (``analysis.py:355-427`` in the JAX package):
    columns standardised over the healthy trials, the scoring rule applied,
    and the jobs ordered.  Trials with a non-finite metric are left out of
    the column statistics, zeroed in the z matrix and ordered last in
    either direction."""
    jobs = np.array(list(result_dict.keys()))
    raw = np.array([_metric_row(r) for r in result_dict.values()], dtype=float)

    failed = ~np.isfinite(raw).all(axis=1)
    healthy = raw[~failed] if (~failed).any() else np.zeros((1, raw.shape[1]))
    col_mean, col_std = healthy.mean(axis=0), healthy.std(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        z = (raw - col_mean) / col_std
    z[:, col_std == 0] = 0
    z[failed] = 0

    if callable(sort_score):
        final = np.asarray(sort_score(z), dtype=float)
    elif isinstance(sort_score, int) and sort_score >= 0:
        final = raw[:, sort_score]
    else:
        final = np.arange(len(raw), dtype=float)

    unusable = failed | ~np.isfinite(final)
    usable_idx = np.flatnonzero(~unusable)
    by_score = usable_idx[np.argsort(final[usable_idx])]
    if sort_score is not None and not ascending:
        by_score = by_score[::-1]
    order = np.concatenate([by_score, np.flatnonzero(unusable)])

    # a failed trial's score: the worst value for the direction
    sentinel = np.inf if (sort_score is None or ascending) else -np.inf
    final = np.where(unusable, sentinel, final)
    return ModelSelection(jobs=jobs, raw=raw, z=z, final=final, failed=failed,
                          col_mean=col_mean, col_std=col_std, order=order)


def selection_heatmap(sel: ModelSelection, top_n=None, true_value=True):
    """The top-n selection table as the reference's seaborn heatmap
    (z-coloured, annotated with the raw values or the z-scores)."""
    import seaborn as sns

    plt = pyplot()
    n = len(sel.order) if top_n is None else min(top_n, len(sel.order))
    z_t = sel.take("z")[:n].T
    annot = sel.take("raw")[:n].T if true_value else z_t
    fig, ax = plt.subplots(figsize=(n, len(SELECTION_COLUMNS)))
    ax.autoscale(enable=True)
    sns.heatmap(
        z_t, vmin=-3, vmax=3, cmap="Blues", cbar=True, annot=annot, ax=ax,
        yticklabels=[f"{name}\n{m:.3f}+-{s:.3f}" for name, m, s
                     in zip(SELECTION_COLUMNS, sel.col_mean, sel.col_std)],
        xticklabels=[f"{job}: {score:.2f} " for job, score
                     in zip(sel.take("jobs")[:n], sel.take("final")[:n])],
    )
    ax.set_yticklabels(ax.get_yticklabels(), rotation=0)
    ax.set_xticklabels(ax.get_xticklabels(), rotation=45, ha="left", va="bottom")
    ax.tick_params(labelbottom=False, labeltop=True, axis="both", length=0, labelsize=15)
    return fig


def sort_all_models(result_dict, sort_score=None, plot_score=False, ascending=True,
                    top_n=None, true_value=True):
    """:func:`select_models` and, with ``plot_score``, its heatmap, as the
    reference's ``sort_all_models`` (``analysis.py:130-231``): each job gets
    its ``Rank`` and ``Score``; returns (result_dict, ranked jobs, fig)."""
    sel = select_models(result_dict, sort_score=sort_score, ascending=ascending)
    for i, (job, score) in enumerate(zip(sel.take("jobs"), sel.take("final"))):
        result_dict[job]["Rank"] = i
        result_dict[job]["Score"] = round(float(score), 4)
    fig = selection_heatmap(sel, top_n=top_n, true_value=true_value) if plot_score else None
    return result_dict, sel.take("jobs"), fig


def qqplot_normal(x, ax=None, grid=True, seed=None):
    """Shapiro statistic, and a Q-Q plot against a sampled normal on ``ax``
    (reference ``analysis.py:453-476``)."""
    n = len(x)
    x_std = (x - x.mean()) / x.std()
    z_score = np.sort(x_std)
    rng = np.random.default_rng(seed)
    normal = rng.standard_normal(n)
    q_normal = np.quantile(normal, np.linspace(0, 1, n))
    stat = shapiro(z_score).statistic
    if ax is not None:
        ax.plot(q_normal, z_score, ls="", marker=".", color="k")
        ax.plot([q_normal.min(), q_normal.max()], [q_normal.min(), q_normal.max()],
                color="k", alpha=0.5)
        ax.grid(grid)
    return stat
