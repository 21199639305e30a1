"""The port's report stage against the JAX package's, on bundles the port's
``train_sc`` wrote.

A tiny FC config (the shape of ``tests/test_pipeline_e2e.py``: 600 rows, 2
trials with a learning-rate sweep, 3 layers, batch 128, 3 epochs) is
trained once by ``python -m rankaae_tpu_torch.cli.train_sc --device cpu``.
Then ``rankaae_tpu.report.generate_report.generate`` and the port's
``generate`` (through its CLI, ``--device cpu``) each report a copy of that
work dir.  They write the same files; ``<output_name>.json`` has the same
keys and ranks and every value within 1e-4 (``Reconstruct Err`` is rounded
to 4 decimals, so a value may differ by one unit in the last place), and
the ``.in``/``.out`` spectra and the reconstruction dumps agree within
1e-4.  Also held: ``use_best_checkpoint`` against the JAX package,
``plot_job``, ``--no-figures``, a trial with a NaN decoder ranked last, the
NaN masking of the selection in both directions against the JAX package's,
the numpy metrics against sklearn's, and the evaluator classes
(``report/curves.py``) ranking as the report does.
"""
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml
from sklearn import metrics as skm

from rankaae_tpu.report import analysis as jax_analysis
from rankaae_tpu.report.generate_report import generate as jax_generate
from rankaae_tpu.report.generate_report import sorting_algorithm as jax_sorting
from rankaae_tpu.utils.config import Parameters as JaxParameters

from rankaae_tpu_torch.cli import train_sc
from rankaae_tpu_torch.data.dataset import AuxSpectraDataset
from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes_csv
from rankaae_tpu_torch.report import analysis
from rankaae_tpu_torch.report.curves import (Evaluator, EvaluatorAll, Reporter,
                                             SpectraVariationEvaluator)
from rankaae_tpu_torch.report.generate_report import generate, sorting_algorithm
from rankaae_tpu_torch.utils.checkpoint import load_model_bundle, save_model_bundle
from rankaae_tpu_torch.utils.config import Parameters
from tests.test_failure_masking import _fake_result
from tests import torch_parity  # noqa: F401  (one torch thread a process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
#: the JSON's values are rounded to 4 decimals: two that differ by one unit
#: in the last place differ by 1e-4 up to the binary representation of the
#: two rounded numbers
ROUNDED_ATOL = ATOL + 1e-9
#: the quadratic fit's coefficients of a descriptor that spans a short range
#: are far more sensitive than the styles: RSTD spans 0.09, so its x^2
#: coefficient is ~30, and the normal form's styles, which differ by 2.9e-6
#: between the stacks, move it by 3e-4.  They are held to float32's
#: relative agreement on top of ATOL; every score the selection reads is
#: held to ATOL alone
COEFFICIENT_RTOL = 1e-5
CFG = {
    "data_file": "data.csv", "trials": 2, "timeout": 1, "max_epoch": 3, "batch_size": 128,
    "gradient_reversal": True, "alpha_flat_step": 739, "alpha_limit": 0.7172,
    "decoder_activation": "Softplus", "dis_beta": 1.1, "dis_dropout_rate": 0.056,
    "dis_noise": 0.56, "gen_beta": 1.1, "output_name": "report", "top_n": 2,
    "n_sampling": 10, "n_aux": 5, "nstyle": 6, "ae_form": "FC", "dim_in": 256,
    "dim_out": 256, "n_layers": 3, "FC_discriminator_layers": 3,
    "use_cnn_discriminator": False, "dropout_rate": 0.04, "sch_factor": 0.1,
    "sch_patience": 100, "lr_base": 0.001, "lr_ratio_Corr": 10, "lr_ratio_Mutual": 1,
    "lr_ratio_Reconn": 10, "lr_ratio_Smooth": 1, "lr_ratio_dis": 1, "lr_ratio_gen": 10,
    "optimizer_name": "AdamW", "spec_noise": 0.02, "use_flex_spec_target": True,
    "weight_decay": 0.01, "kendall_activation": True, "epoch_stop_smooth": 2,
}
OUTPUTS = ("report.json", "report.in", "report.out", "report_model_evaluation.pkl",
           "report_model_selection.png", "report_best_model.png", "report_spec_in.txt",
           "report_spec_out.txt", "report_styles.txt", "loss_curves.png")


def train_work_dir(root, **overrides):
    """A work dir with the data and config, trained by the port's CLI."""
    os.makedirs(root, exist_ok=True)
    make_synthetic_xanes_csv(os.path.join(root, "data.csv"), n_rows=600, dim=256, seed=5)
    write_config(root, "cfg.yaml", **overrides)
    train_sc.main(["-c", "cfg.yaml", "-w", str(root), "--device", "cpu", "--lr-sweep", "0.5,2"])
    return str(root)


def write_config(root, name, **overrides):
    with open(os.path.join(root, name), "w") as f:
        yaml.safe_dump({**CFG, **overrides}, f)


def copy_work_dir(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def assert_close_tree(got, ref, path=""):
    """Same keys (as the JSON writes them) and values within ATOL (the
    quadratic coefficients also within COEFFICIENT_RTOL)."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            assert_close_tree(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_close_tree(g, r, f"{path}[{i}]")
    elif ref is None or isinstance(ref, str):
        assert got == ref, path
    else:
        rtol = COEFFICIENT_RTOL if "/Quadratic/Parameters" in path else 0
        np.testing.assert_allclose(got, ref, atol=ROUNDED_ATOL, rtol=rtol, err_msg=path)


def report_files(work):
    return sorted(f for f in os.listdir(work)
                  if f.startswith(("report", "best_report")) or f == "loss_curves.png")


def assert_reports_match(port, jax, name="report"):
    with open(os.path.join(port, name + ".json")) as f:
        got = json.load(f)
    with open(os.path.join(jax, name + ".json")) as f:
        ref = json.load(f)
    assert list(got) == list(ref)                     # the same jobs in rank order
    assert [got[j]["Rank"] for j in got] == [ref[j]["Rank"] for j in ref]
    assert_close_tree(got, ref)
    for ext in (".in", ".out", "_spec_in.txt", "_spec_out.txt", "_styles.txt"):
        np.testing.assert_allclose(np.loadtxt(os.path.join(port, name + ext)),
                                   np.loadtxt(os.path.join(jax, name + ext)), atol=ATOL,
                                   err_msg=ext)
    return got


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return train_work_dir(tmp_path_factory.mktemp("trained") / "work")


@pytest.fixture(scope="module")
def jax_report(trained, tmp_path_factory):
    work = copy_work_dir(trained, tmp_path_factory.mktemp("jax") / "work")
    jax_generate(work, JaxParameters.from_yaml(os.path.join(work, "cfg.yaml")))
    return work


def test_report_matches_jax(trained, jax_report, tmp_path):
    work = copy_work_dir(trained, tmp_path / "port")
    res = subprocess.run(
        [sys.executable, "-m", "rankaae_tpu_torch.cli.generate_report", "-c", "cfg.yaml",
         "-w", work, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Success" in res.stdout
    assert report_files(work) == report_files(jax_report) == sorted(OUTPUTS)
    got = assert_reports_match(work, jax_report)
    assert {round(r["lr_scale"], 3) for r in got.values()} == {0.5, 2.0}
    with open(os.path.join(work, "report_model_evaluation.pkl"), "rb") as f:
        evaluations = pickle.load(f)
    assert sorted(evaluations) == ["job_1", "job_2"]


def test_best_checkpoint_report_matches_jax(trained, tmp_path):
    works = {}
    for side in ("port", "jax"):
        works[side] = copy_work_dir(trained, tmp_path / side)
        write_config(works[side], "best.yaml", use_best_checkpoint=True,
                     output_name="best_report")
    jax_generate(works["jax"], JaxParameters.from_yaml(os.path.join(works["jax"], "best.yaml")))
    generate(works["port"], Parameters.from_yaml(os.path.join(works["port"], "best.yaml")),
             device="cpu")
    assert report_files(works["port"]) == report_files(works["jax"])
    assert_reports_match(works["port"], works["jax"], "best_report")


def test_plot_job_and_no_figures(trained, tmp_path):
    work = copy_work_dir(trained, tmp_path / "port")
    write_config(work, "job.yaml", plot_job="job_2", n_sampling=0)
    generate(work, Parameters.from_yaml(os.path.join(work, "job.yaml")), device="cpu")
    # no selection: the one job's report and its dumps, no ranking files
    assert report_files(work) == sorted(["report_job_2.png", "report_spec_in.txt",
                                         "report_spec_out.txt", "report_styles.txt",
                                         "loss_curves.png"])
    bare = copy_work_dir(trained, tmp_path / "bare")
    generate(bare, Parameters.from_yaml(os.path.join(bare, "cfg.yaml")), device="cpu",
             figures=False)
    assert report_files(bare) == sorted(f for f in OUTPUTS if not f.endswith(".png"))


def test_nan_trial_ranks_last(trained, tmp_path):
    """A third trial whose decoder is NaN: its reconstruction error is NaN
    (sklearn would raise), so it fails, and it ranks last."""
    work = copy_work_dir(trained, tmp_path / "port")
    src, dst = (os.path.join(work, "training", j) for j in ("job_1", "job_3"))
    shutil.copytree(src, dst)
    for name in ("final.mpk", "best_recon.mpk"):
        params, stats, cfg, extra = load_model_bundle(os.path.join(src, name))
        params["dec"] = {k: {n: np.full_like(v, np.nan) for n, v in layer.items()}
                         for k, layer in params["dec"].items()}
        save_model_bundle(os.path.join(dst, name), params, stats, cfg, extra)
    write_config(work, "three.yaml", top_n=3)
    generate(work, Parameters.from_yaml(os.path.join(work, "three.yaml")), device="cpu",
             figures=False)
    with open(os.path.join(work, "report.json")) as f:
        report = json.load(f)
    assert list(report) == [j for j in report if j != "job_3"] + ["job_3"]
    assert report["job_3"]["Rank"] == 2 and report["job_3"]["Score"] == -np.inf
    assert np.isnan(report["job_3"]["Reconstruct Err"][0])


@pytest.mark.parametrize("ascending", [False, True])
def test_nan_masking_matches_jax(ascending):
    def results():
        return {"job_1": _fake_result(0.05, 0.8), "job_2": _fake_result(np.nan, np.nan),
                "job_3": _fake_result(0.04, 0.9), "job_4": _fake_result(0.06, 0.7, 0.5)}

    got, got_jobs, _ = analysis.sort_all_models(results(), sort_score=sorting_algorithm,
                                                ascending=ascending)
    ref, ref_jobs, _ = jax_analysis.sort_all_models(results(), sort_score=jax_sorting,
                                                    ascending=ascending)
    assert list(got_jobs) == list(ref_jobs) and got_jobs[-1] == "job_2"
    for job in ref:
        assert got[job]["Rank"] == ref[job]["Rank"]
        assert got[job]["Score"] == ref[job]["Score"]


def test_metrics_match_sklearn():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(40, 256)).astype(np.float32)
    b = (a + rng.normal(scale=0.1, size=a.shape)).astype(np.float32)
    np.testing.assert_allclose(analysis.mean_absolute_error(a, b),
                               [skm.mean_absolute_error(x, y) for x, y in zip(a, b)],
                               rtol=1e-6)
    for true_labels, pred_labels in (((0, 1, 2), (0, 1, 2)), ((0, 2), (0, 1, 2)),
                                     ((1,), (0, 1, 2)), ((0, 1, 2), (2,))):
        t = rng.choice(true_labels, size=300)
        p = rng.choice(pred_labels, size=300)
        np.testing.assert_array_equal(analysis.confusion_matrix(t, p),
                                      skm.confusion_matrix(t, p))
        np.testing.assert_allclose(analysis.f1_score(t, p),
                                   skm.f1_score(t, p, average="weighted", zero_division=0),
                                   rtol=1e-12)


def test_evaluator_classes_rank_as_the_report(trained, jax_report):
    ds = AuxSpectraDataset(os.path.join(trained, "data.csv"), "val", n_aux=5)
    reporter = Reporter(device="cpu")
    reporter.evaluate_all_models(os.path.join(trained, "training"), ds)
    table, fig = reporter.report()
    assert fig is None
    with open(os.path.join(jax_report, "report.json")) as f:
        assert list(table["job"]) == list(json.load(f))     # the JAX report's ranks
    final = os.path.join(trained, "training", "job_1", "final.mpk")
    ev = EvaluatorAll.from_file(os.path.join(trained, "data.csv"), final, device="cpu")
    result = ev.evaluate()
    assert result["Reconstruct Err"] == reporter.evaluations["job_1"]["Reconstruct Err"]
    back = Evaluator.from_dict(ev.as_dict())
    np.testing.assert_array_equal(back.result["Input"], ds.spec)
    assert back.metadata["model"] == final
    sweep = SpectraVariationEvaluator(n_spec=5, n_sampling=3)
    sweep.model, sweep.styles = ev.model, ev.model.encode(ds.spec)
    assert sweep.evaluate(2).shape == (5, 256) and sweep.istyle == 2
