"""The report stage: score, rank and keep the best trial, and draw its report
(counterpart of ``rankaae_tpu/report/generate_report.py``; reference
``sc/report/generate_report.py``).

    python -m rankaae_tpu_torch.cli.generate_report -c cfg.yaml -w work_dir
        [--device cuda|cpu] [--no-figures]

Reads ``cfg.yaml`` and its ``data_file`` from the work dir and every
``training/job_*/final.mpk`` (``best_recon.mpk`` under
``use_best_checkpoint: true``) that ``train_sc`` wrote, and writes the JAX
CLI's files into the work dir: ``<output_name>.json`` (the top ``top_n``
trials' scores, ``Rank`` and ``Score``), ``.in``/``.out`` (the best model's
inputs and reconstructions), ``<output_name>_model_evaluation.pkl``,
``<output_name>_model_selection.png`` and ``<output_name>_best_model.png``
(or ``<output_name>_<plot_job>.png`` when ``plot_job`` names one job and
skips the selection), ``<output_name>_spec_in/_spec_out/_styles.txt`` and
``loss_curves.png``.  ``--no-figures`` computes everything the figures
show (the decoder sweeps included) but writes no PNG, for a machine without
matplotlib.  Quirks kept from the reference: the report's "test" set is
the **val** split (``generate_report.py:246``), and ``sorting_algorithm``
weighs the z-scored columns [-1, 0, 1, 1, 1, 1, 1] and divides by the
reconstruction column (``:16-45``).  Every model runs on ``device``
(default ``"cuda"``, which must exist).
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
from collections import OrderedDict

import numpy as np

from rankaae_tpu_torch.data.dataset import AuxSpectraDataset
from rankaae_tpu_torch.models.inference import InferenceModel
from rankaae_tpu_torch.report import analysis
from rankaae_tpu_torch.report.curves import LossCurvePlotter, Reconstruct
from rankaae_tpu_torch.utils.config import Parameters


def sorting_algorithm(x: np.ndarray) -> np.ndarray:
    """A trial's score from its z-scored metric row (reference
    ``generate_report.py:16-45``): columns [inter-style corr, recon err,
    5 style-descriptor corrs], score = (sum of the weighted columns) / the
    recon column, weights [-1, 0, 1, 1, 1, 1, 1]."""
    weight = [-1, 0, 1, 1, 1, 1, 1]
    off_set = 1 if np.sum(weight) == weight[1] else 0
    xx = x.copy()
    xx[:, 0] = x[:, 0] * weight[0]
    xx[:, 1] = x[:, 1] ** weight[1]
    for i in range(2, 7):
        xx[:, i] = x[:, i] * weight[i]
    return (off_set + xx[:, 0] + np.sum(xx[:, 2:], axis=1)) / xx[:, 1]


def _cosine_similarity(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    an = a / np.linalg.norm(a, axis=1, keepdims=True)
    bn = b / np.linalg.norm(b, axis=1, keepdims=True)
    return an @ bn.T


def plot_report(test_ds, model: InferenceModel, config=None, title="report", draw=True):
    """The best model's report (reference ``generate_report.py:48-176``): a
    decoder sweep per style, the 4 x 4 style-vs-descriptor grid, the Q-Q
    panels and the CN confusion panels.  Returns the figure, or None with
    ``draw=False``, which computes the same numbers without matplotlib."""
    n_aux = config.n_aux
    plot_residual = config.get("plot_residual", None) if hasattr(config, "get") else None
    n_sampling = config.get("n_sampling", 1000) if hasattr(config, "get") else 1000
    name_list = ["CT", "CN", "OCN", "Rstd", "OO"]

    result = analysis.evaluate_model(test_ds, model)
    style_correlation = result["Inter-style Corr"]

    test_grid = test_ds.grid
    test_styles = model.encode(np.asarray(test_ds.spec, np.float32))
    n_styles = test_styles.shape[1]
    descriptors = test_ds.aux
    if n_aux < 5:
        ts = np.zeros((test_styles.shape[0], 6))
        ts[:, : n_aux + 1] = test_styles
        test_styles = ts
        ds_ = np.zeros((descriptors.shape[0], 5))
        ds_[:, :n_aux] = descriptors
        descriptors = ds_
        if n_aux < 2:
            descriptors[:, 1] = 4

    fig = None
    if draw:
        fig = analysis.pyplot().figure(figsize=(12, 24), constrained_layout=True, dpi=100)
        gs = fig.add_gridspec(12, 6)
        fig.suptitle(f"{title:s}\nLeast correlation: {style_correlation:.4f}")

    def panel(rows, cols):
        return fig.add_subplot(gs[rows, cols]) if draw else None

    axs_spec = [panel(slice(r, r + 2), slice(c, c + 2))
                for r, c in ((0, 0), (0, 2), (0, 4), (2, 0), (2, 2), (2, 4))][:n_styles]
    ax5, ax6, ax7 = (panel(slice(r, r + 2), slice(4, 6)) for r in (4, 6, 8))

    spectra_reconstructed = []
    for istyle, ax in enumerate(axs_spec):
        _, spec_recon = analysis.plot_spectra_variation(
            model, istyle, true_range=True, styles=test_styles, amplitude=2, n_spec=50,
            n_sampling=n_sampling, energy_grid=test_grid, plot_residual=plot_residual, ax=ax)
        spectra_reconstructed.append(spec_recon)

    if plot_residual and draw:
        residuals = [s[-1] - s[0] for s in spectra_reconstructed]
        cos_sim = _cosine_similarity(np.stack(residuals), np.stack(residuals))
        for istyle, ax in enumerate(axs_spec):
            row = cos_sim[istyle]
            max_cos, max_j = -1.0, 0
            for j, v in enumerate(row):
                if j != istyle and v >= max_cos:
                    max_cos, max_j = v, j
            ax.text(0.95, 0.95, f"max_cos_sim: {max_cos:.2f}\nwith style{max_j + 1}",
                    va="top", ha="right", transform=ax.transAxes, fontsize=20)

    # style-vs-descriptor grid (CN left out)
    styles_no_s2 = np.delete(test_styles, 1, axis=1)
    descriptors_no_cn = np.delete(descriptors, 1, axis=1)
    name_list_no_cn = np.delete(name_list, 1, axis=0)
    for row in [4, 5, 6, 7]:
        for col in [0, 1, 2, 3]:
            ax = panel(row, col)
            choice = ("R2", "Spearman", "Quadratic") if col == 0 else ("R2", "Spearman")
            accuracy = analysis.get_descriptor_style_correlation(
                styles_no_s2[:, col], descriptors_no_cn[:, row - 4], ax=ax, choice=choice,
                fit=col == row - 4)
            if ax is not None:
                ax.set_title(f"{name_list_no_cn[row - 4]}: "
                             + "{0:.2f}/{1:.2f}".format(accuracy["Linear"]["R2"],
                                                        accuracy["Spearman"]))

    # Q-Q normality panels
    for col in [0, 1, 2, 3]:
        ax = panel(8, col)
        stat = analysis.qqplot_normal(styles_no_s2[:, col], ax)
        label_col = col + 1 if col > 0 else col  # style 2 (CN) is skipped
        if ax is not None:
            ax.set_title(f"style_{label_col + 1}: {stat:.2f}")
    ax = panel(9, 3)
    stat = analysis.qqplot_normal(test_styles[:, 1], ax)
    if ax is not None:
        ax.set_title(f"style_2: {stat:.2f}")

    analysis.get_confusion_matrix(descriptors[:, 1].astype(int), test_styles[:, 1],
                                  [ax5, ax6, ax7] if draw else None)
    return fig


def save_evaluation_result(save_dir, file_name, model_results, save_spectra=False, top_n=5):
    """The top ``top_n`` results to ``<file_name>.json`` and the best
    model's spectra to ``.in``/``.out`` (reference
    ``generate_report.py:179-203``)."""
    save_dict = OrderedDict()
    top_n = min(top_n, len(model_results))
    sorted_top_n = list(range(top_n))
    for job, result in model_results.items():
        if result["Rank"] in sorted_top_n:
            sorted_top_n[result["Rank"]] = job
    spec_in = spec_out = None
    for job in sorted_top_n:
        result = model_results[job]
        save_dict[job] = {k: v for k, v in result.items() if k not in ("Input", "Output")}
        if result["Rank"] == 0 and save_spectra:
            spec_in, spec_out = result["Input"], result["Output"]
    with open(os.path.join(save_dir, file_name + ".json"), "wt") as f:
        f.write(json.dumps(save_dict))
    if spec_out is not None:
        np.savetxt(os.path.join(save_dir, file_name + ".out"), spec_out)
        np.savetxt(os.path.join(save_dir, file_name + ".in"), spec_in)


def save_model_evaluations(save_dir, file_name, result):
    with open(os.path.join(save_dir, file_name + "_model_evaluation.pkl"), "wb") as f:
        pickle.dump(result, f)


def save_model_selection_plot(save_dir, file_name, fig):
    fig.savefig(os.path.join(save_dir, file_name + "_model_selection.png"), bbox_inches="tight")


def generate(work_dir: str, config: Parameters, device=None, figures: bool = True):
    """The report pipeline (reference ``generate_report.py:218-293``;
    ``rankaae_tpu/report/generate_report.py:193-250``), every model on
    ``device``.  Returns the path of the best model's report PNG (not
    written when ``figures`` is false)."""
    jobs_dir = os.path.join(work_dir, "training")
    file_name = config.get("data_file", None)
    output_name = config.get("output_name", "report")
    top_n = config.get("top_n", 5)

    if file_name is None:
        csvs = [f for f in os.listdir(work_dir) if f.endswith(".csv")]
        assert len(csvs) == 1, "Which data file are you going to use?"
        file_name = csvs[0]
    # the reference's quirk: the report's "test" set is the val split
    test_ds = AuxSpectraDataset(os.path.join(work_dir, file_name), split_portion="val",
                                n_aux=config.n_aux)
    # use_best_checkpoint: each trial's min-val-recon model, not its last epoch
    bundle_name = "best_recon.mpk" if config.get("use_best_checkpoint", False) else "final.mpk"

    plot_job = config.get("plot_job", None)
    if plot_job is not None:
        sorted_jobs = [plot_job]
        out_png = os.path.join(work_dir, f"{output_name}_{sorted_jobs[0]}.png")
    else:
        model_results = analysis.evaluate_all_models(jobs_dir, test_ds,
                                                     bundle_name=bundle_name, device=device)
        model_results, sorted_jobs, fig_sel = analysis.sort_all_models(
            model_results, plot_score=figures, top_n=top_n, sort_score=sorting_algorithm,
            ascending=False)
        save_model_evaluations(work_dir, output_name, model_results)
        if fig_sel is not None:
            save_model_selection_plot(work_dir, output_name, fig_sel)
        save_evaluation_result(work_dir, output_name, model_results, save_spectra=True,
                               top_n=top_n)
        out_png = os.path.join(work_dir, f"{output_name}_best_model.png")

    top_model = InferenceModel.from_bundle(os.path.join(jobs_dir, sorted_jobs[0], bundle_name),
                                           device=device)
    fig_top = plot_report(test_ds, top_model, config=config,
                          title="-".join([output_name, str(sorted_jobs[0])]), draw=figures)
    if fig_top is not None:
        fig_top.savefig(out_png, bbox_inches="tight")

    Reconstruct(name=output_name).evaluate(test_ds, top_model, path_to_save=work_dir)

    if figures:
        fig = LossCurvePlotter().plot_loss_curve(
            os.path.join(jobs_dir, sorted_jobs[0], "losses.csv"))
        fig.savefig(os.path.join(work_dir, "loss_curves.png"), bbox_inches="tight")
    return out_png


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-w", "--work_dir", type=str, default=".",
                        help="The folder where the model and data are.")
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="Config for training parameter in YAML format")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu; there is no silent fallback")
    parser.add_argument("--no-figures", action="store_true",
                        help="Compute the report but write no PNG (no matplotlib needed)")
    args = parser.parse_args(argv)
    work_dir = os.path.abspath(os.path.expanduser(args.work_dir))
    config = Parameters.from_yaml(os.path.join(work_dir, args.config))
    generate(work_dir, config, device=args.device, figures=not args.no_figures)
    print("Success: training report saved!")


if __name__ == "__main__":
    main()
